"""The port's ring attention (``--mesh_cp``, ops/ring_attention.py) on the
CPU, against the JAX package's ``ring_attention`` on a (dp, cp) mesh of the 8
virtual CPU devices of tests/conftest.py and against its single-device
oracle ``hash_dropout_attention``.

  * ``_keep_mask4`` over absolute (batch, head, query, key) coordinates
    against the JAX hash, bit for bit, at offsets and a seed past 2**31;
    ``hash_dropout_attention``'s output and gradients against JAX's within
    1e-5 (fp32);
  * the ring gate and ``config_for_mesh`` on a cp mesh
    (tests/test_ring_attention.py:54-63, 105-120's cases);
  * on two gloo ranks of tests/torch_dist_worker.py at cp 2 (dp 1), with
    rate 0 and 0.1 (one seed on every rank) and an odd head count: each
    rank's output block and the gradients of sum(out * g) against JAX
    ``ring_attention`` on ``make_cp_mesh(dp=1, cp=2)`` and against
    ``hash_dropout_attention`` within 1e-5, with one send/recv batch a
    step each way;
  * two fp32 pretraining steps at cp 2 (dropouts 0) against JAX
    ``PretrainTrainer`` on ``make_cp_mesh(dp=1, cp=2)`` at
    test_torch_multiprocess.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multiprocess import (LR, PRE, _check_update, _np, _pretrain_batch,
                                     join_ranks, start_ranks)
from visitron_torch.convert import convert_pretrain_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models import config_for_mesh as t_config_for_mesh
from visitron_torch.ops import ring_attention as tmesh
from visitron_torch.parallel import Mesh
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_tpu import models as jm
from visitron_tpu.ops import attention as jatt
from visitron_tpu.parallel import make_cp_mesh
from visitron_tpu.train.pretrain import PretrainTrainer as JTrainer

CPU = torch.device("cpu")
B, H, S, D = 2, 3, 64, 16  # H 3: the ring has no head constraint
SEED = 2 ** 31 - 77


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(4))
    keep = (rng.random((B, S)) > 0.2).astype(np.float32)
    keep[:, :4] = 1.0  # never a fully masked row
    bias = ((1.0 - keep) * -1e9).astype(np.float32)
    return q, k, v, g, bias


@pytest.mark.parametrize("offsets", [(0, 0, 0), (3, 96, 32)])
def test_keep_mask4_is_the_jax_hash(offsets):
    b0, row0, col0 = offsets
    thr = jatt._threshold(0.1)
    want = np.asarray(jatt._keep_mask4(jnp.asarray(SEED, jnp.int32).astype(jnp.uint32), b0,
                                       row0, col0, (2, 3, 32, 48), thr))
    got = tmesh._keep_mask4(SEED, b0, row0, col0, (2, 3, 32, 48), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95


def test_hash_dropout_attention_matches_jax():
    q, k, v, g, bias = _inputs(1)
    jfn = lambda q, k, v: jatt.hash_dropout_attention(q, k, v, jnp.asarray(bias),  # noqa: E731
                                                      SEED, 0.1)
    want = np.asarray(jfn(*map(jnp.asarray, (q, k, v))))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tmesh.hash_dropout_attention(tq, tk, tv, torch.from_numpy(bias), SEED, 0.1)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5, rtol=0)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-5, rtol=0)


def test_ring_gate_and_cp_config_for_mesh():
    mesh = Mesh(dp=2, rank=1, device=CPU, axis="cp", size=4)
    assert tmesh.attention_supports_ring(mesh, 32, 32)
    assert not tmesh.attention_supports_ring(None, 32, 32)
    assert not tmesh.attention_supports_ring(mesh, 30, 30)  # S % cp != 0
    assert not tmesh.attention_supports_ring(mesh, 32, 64)  # cross-attention
    assert not tmesh.attention_supports_ring(Mesh(dp=2, rank=1, device=CPU, axis="sp",
                                                  size=4), 32, 32)
    cfg = TConfig(**{**PRE, "num_attention_heads": 4}, use_flash_attention=True)
    out = t_config_for_mesh(cfg, mesh)
    assert out.cp_mesh is mesh
    # The single-device kernels are off under cp: the ring is attention.
    assert not out.use_fused_attention and not out.use_flash_attention
    # Odd head counts are fine (the ring's advantage over Ulysses sp).
    t_config_for_mesh(cfg.replace(num_attention_heads=3), mesh)
    assert t_config_for_mesh(cfg, Mesh(dp=8, rank=0, device=CPU)).cp_mesh is None
    with pytest.raises(ValueError, match="requires a seed"):
        tmesh.ring_attention(*(torch.zeros(1, 1, 8, 16) for _ in range(3)),
                             torch.zeros(1, 8), None, 0.3, mesh=mesh)


@pytest.fixture(scope="module")
def cp(tmp_path_factory):
    q, k, v, g, bias = _inputs(2)
    cases = [(f"ring_{rate}", {"case": "ring", **{n: torch.from_numpy(a) for n, a in
                                                  zip("qkvg", (q, k, v, g))},
                               "bias": torch.from_numpy(bias), "seed": SEED,
                               "rate": rate, "mesh": ("cp", 2)}) for rate in (0.0, 0.1)]
    batches = [_pretrain_batch(seed) for seed in (2, 3)]
    plain = TTrainer(TConfig(**PRE), device="cpu", total_steps=100, learning_rate=LR)
    jtr = JTrainer(jm.BertConfig(**PRE), mesh=make_cp_mesh(dp=1, cp=2), total_steps=100,
                   learning_rate=LR)
    jstate = jtr.init_state(batches[0])
    p0 = convert_pretrain_params(_np(jstate["params"]), plain.model)
    cases.append(("pretrain", {"case": "pretrain", "bert": PRE, "params": p0,
                               "batches": batches, "lr": LR, "zero1": False, "fsdp": False,
                               "mesh": ("cp", 2)}))
    started = start_ranks(str(tmp_path_factory.mktemp("cp")), cases)
    ref = {}
    mesh = make_cp_mesh(dp=1, cp=2)
    for rate in (0.0, 0.1):
        args = [jnp.asarray(a) for a in (q, k, v)]
        ring = lambda q, k, v: jatt.ring_attention(  # noqa: E731
            q, k, v, jnp.asarray(bias), SEED if rate else None, rate, mesh=mesh)
        oracle = lambda q, k, v: jatt.hash_dropout_attention(  # noqa: E731
            q, k, v, jnp.asarray(bias), SEED, rate)
        ref[rate] = {name: (np.asarray(fn(*args)),
                            [np.asarray(t) for t in jax.grad(
                                lambda *a: jnp.sum(fn(*a) * g), argnums=(0, 1, 2))(*args)])
                     for name, fn in (("ring", ring), ("oracle", oracle))}
    jbundles = []
    for b in batches:
        jstate, bundle = jtr.step_fn()(jstate, b)
        jbundles.append({k: float(v) for k, v in _np(bundle).items()})
    ref["pretrain"] = {"start": p0, "bundles": jbundles,
                       "params": convert_pretrain_params(_np(jstate["params"]), plain.model),
                       "grads": [plain.loss_and_grads(p0, plain.to_device(b), None)[1]
                                 for b in batches]}
    return ref, join_ranks(started)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("against", ["ring", "oracle"])
def test_two_rank_ring_matches_jax(cp, rate, against):
    ref, got = cp
    want_out, want_grads = ref[rate][against]
    half = S // 2
    for rank, res in enumerate(got[f"ring_{rate}"]):
        blk = slice(rank * half, (rank + 1) * half)
        np.testing.assert_allclose(res["out"].numpy(), want_out[:, :, blk], atol=1e-5,
                                   rtol=0, err_msg=f"rank {rank} output")
        for name, jg in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(res[name].numpy(), jg[:, :, blk], atol=1e-5, rtol=0,
                                       err_msg=f"rank {rank} {name}")
        # One shift forward and one back, each a batch of send/recv pairs.
        assert res["counts"]["ring_shift"] == 2


def test_cp_pretraining_steps_match_the_jax_cp_trainer(cp):
    ref, got = cp
    r, ranks = ref["pretrain"], got["pretrain"]
    for rank in ranks:
        for i, bundle in enumerate(rank["bundles"]):
            for key, v in r["bundles"][i].items():
                np.testing.assert_allclose(bundle[key], v, rtol=1e-5,
                                           err_msg=f"step {i + 1} {key}")
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    _check_update(ranks[0]["params"], r["start"], r["params"], r["grads"], LR)
    counts = ranks[0]["counts"]
    # One shift a layer forward and one back (cp 2), for two steps.
    assert counts["ring_shift"] == 2 * 2 * PRE["num_hidden_layers"]
    assert counts["all_to_all"] == 0
