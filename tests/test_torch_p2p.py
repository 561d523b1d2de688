"""The port's one point-to-point transport (``parallel.mesh.p2p``): the
ring's shifts (cp) and the pipeline's stage transfers (pp) both go through
it, and it stages a CUDA tensor through the host under gloo.

  * the staging rule as a function of the backend's name and the device
    alone: gloo with a CUDA device stages, NCCL or a CPU device does not
    (no CUDA tensor is needed to check it);
  * on two gloo ranks of tests/torch_dist_worker.py (a pp mesh of 2), the
    helper direct and with staging forced through its own argument on CPU
    tensors (fp32 and bf16): a ring shift and a stage send / receive each
    way deliver the other rank's tensors bit for bit, a staged send's
    source may be overwritten before the wait, ``p2p_host_staged`` counts
    every staged send and receive with its bytes and nothing on the direct
    path; the public ``ring_shift`` and ``send_next`` / ``recv_prev`` /
    ``send_prev`` / ``recv_next`` deliver the same tensors.
"""

import numpy as np
import pytest
import torch

from test_torch_multiprocess import join_ranks, start_ranks
from visitron_torch.parallel import mesh as pm


@pytest.mark.parametrize("backend,device,staged", [
    ("gloo", torch.device("cuda"), True), ("gloo", torch.device("cuda", 1), True),
    ("gloo", torch.device("cpu"), False), ("nccl", torch.device("cuda"), False),
    ("nccl", torch.device("cpu"), False)])
def test_staged_rule_is_the_backend_and_the_device(backend, device, staged):
    assert pm._staged(backend, device) is staged


def _tensors():
    rng = np.random.default_rng(4)
    return [torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 2, 4, 6)).astype(np.float32)
                             ).to(torch.bfloat16)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [("p2p", {"case": "p2p", "tensors": _tensors(), "mesh": ("pp", 2)})]
    return join_ranks(start_ranks(str(tmp_path_factory.mktemp("p2p")), cases))["p2p"]


def _equal(got, want, what):
    assert got.dtype == want.dtype and torch.equal(got, want), what


@pytest.mark.parametrize("path", [False, True, "public"], ids=["direct", "staged", "public"])
def test_ring_shift_and_stage_transfers_deliver_the_other_ranks_tensors(ranks, path):
    tensors = _tensors()
    for rank, res in enumerate(ranks):
        got = res[path]
        other = [t[1 - rank] for t in tensors]
        for i, (a, b) in enumerate(zip(got["ring"], other)):
            _equal(a, b, f"rank {rank} ring tensor {i}")
        # Rank 0 sends its first tensor and receives rank 1's second.
        _equal(got["stage"], other[1] if rank == 0 else other[0], f"rank {rank} stage")


def test_staged_transfers_are_counted_and_direct_ones_are_not(ranks):
    tensors = _tensors()
    ring_bytes = 2 * sum(t[0].numel() * t.element_size() for t in tensors)
    for rank, res in enumerate(ranks):
        assert res[False]["calls"] == res[False]["nbytes"] == 0
        stage_bytes = tensors[0][0].numel() * 4 + tensors[1][0].numel() * 2
        # The ring: each tensor sent and received; the stages: one send, one receive.
        assert res[True]["calls"] == 2 * len(tensors) + 2, rank
        assert res[True]["nbytes"] == ring_bytes + stage_bytes, rank
        # The public helpers run direct on CPU tensors: nothing staged, each counted.
        counts = res["counts"]
        assert counts["p2p_host_staged"] == 0 and counts["ring_shift"] == 1
        sends = "send_next" if rank == 0 else "send_prev"
        recvs = "recv_next" if rank == 0 else "recv_prev"
        assert counts[sends] == counts[recvs] == 1
