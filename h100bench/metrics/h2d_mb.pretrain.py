"""h2d_mb.pretrain: multimodal pretraining: bytes a step that the program's
``train/pretrain.py:batch_to_device`` carried to the card, the copies'
converted tensors (its ``bytes`` over its ``calls`` counters, all steps of
the run, read in the run's process after the loop), MB."""

import sys


def read(rec):
    if rec.loop != "pretrain" or rec.trace is None:
        return None
    module = sys.modules.get("visitron_torch.train.pretrain")
    fn = getattr(module, "batch_to_device", None)
    nbytes, calls = getattr(fn, "bytes", None), getattr(fn, "calls", None)
    if nbytes is None or not calls:
        return None
    return nbytes / calls / 1e6
