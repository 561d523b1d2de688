"""Named host spans over the phases of the training steps.

A span is a record of the active ``torch.profiler`` session, on the host
timeline beside the ops it encloses: the benchmark's traced stretch, the
loop's ``--profile_steps`` trace and ``testing/nav_profile.py`` all see
them, and the session keeps and exports them.  With no session active a
span costs one enter and one exit.  Spans are ``_RecordFunctionFast``
records, not ``record_function``'s user annotations, which a CUDA session
mirrors onto the device timeline, where they would read as kernels.

No span encloses a whole step: a trace names each idle gap of the device by
the host record that overlaps it most, and a step-long span would take the
name of every gap.
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

BATCH_TO_DEVICE = "vt.batch_to_device"  # a host batch's copy to the device
FORWARD = "vt.forward"  # the pretraining loss, up to its gradients
BACKWARD = "vt.backward"  # autograd's gradients, zeros for unused parameters
GRAD_REDUCE = "vt.grad_reduce"  # the gradients' sum over the data-parallel ranks
OPTIMIZER = "vt.optimizer"  # the clip, the optimizer's update and its application
ENCODER = "vt.encoder"  # the dialog encoder of the navigation agents
DECODER = "vt.decoder"  # one training episode's loop of decoder steps
BATCHER = "vt.batcher"  # one navigation training batch built on the host


def span(name: str) -> _RecordFunctionFast:
    """A context manager that records ``name`` over its block in the
    active profiler session."""
    return _RecordFunctionFast(name)
