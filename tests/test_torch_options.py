"""The model options that no workload sets, against the JAX package with
the flax parameters carried across by visitron_torch.convert: history K/V
in VisitronBert, the bidirectional LSTM (alone and in OscarEncoder), and
``use_fused_layernorm`` off (flax's LayerNorm math, model-level); then
``run viewpoint --debug --no_use_fused_layernorm`` on the CPU.  fp32,
dropouts off; tolerance 1e-5 (outputs and gradients)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import visitron_torch.train.workspace as tws
from visitron_torch import convert
from visitron_torch import models as tm
from visitron_torch import run as trun
from visitron_torch.models import bert as tbert
from visitron_torch.models.layers import init_module_params
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_tpu import models as jm
from visitron_tpu.models import bert as jbert
from visitron_tpu.models import lstm as jlstm

TOL = 1e-5
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
# 3 layers, hidden 32; history of 6 over 4 fresh tokens.
HCFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=16, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, P, Q = 3, 6, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _grads_close(module, grads_t: dict, grads_j, tol=TOL):
    """Port gradients (by parameter name) against the JAX gradient tree,
    carried across like the parameters."""
    want = convert.flax_to_state_dict(_np_tree(grads_j), module)
    assert set(want) == set(grads_t)
    for name, g in grads_t.items():
        _close(g, want[name].numpy(), tol)


# -- history K/V -----------------------------------------------------------------

def _history_inputs(mask_kind: str):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, HCFG["vocab_size"], (B, Q)).astype(np.int32)
    hist = rng.standard_normal((HCFG["num_hidden_layers"], B, P, 32)).astype(np.float32)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "fresh":  # over the fresh tokens: ones prepended over the history
        mask = (np.arange(Q)[None] < np.array([[4], [2], [1]])).astype(np.int32)
    else:  # over history + fresh, with padded history keys
        mask = np.ones((B, P + Q), np.int32)
        mask[1, :3] = 0
        mask[2, P + 2:] = 0
    return ids, hist, mask


@pytest.mark.parametrize("mask_kind", ["none", "fresh", "history"])
def test_history_states_match_flax(mask_kind):
    ids, hist, mask = _history_inputs(mask_kind)
    rng = np.random.default_rng(6)
    w_seq = rng.standard_normal((B, Q, 32)).astype(np.float32)
    w_pool = rng.standard_normal((B, 32)).astype(np.float32)
    jmod = jm.VisitronBert(jm.BertConfig(**HCFG))
    jkw = {} if mask is None else {"attention_mask": jnp.asarray(mask)}
    jp = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                   history_states=jnp.asarray(hist), **jkw)

    def jloss(params, hs):
        seq, pooled = jmod.apply(params, jnp.asarray(ids), history_states=hs, **jkw)
        return jnp.sum(seq * w_seq) + jnp.sum(pooled * w_pool), (seq, pooled)

    (jl, (jseq, jpool)), (jg, jgh) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(hist))
    module = tm.VisitronBert(tm.BertConfig(**HCFG), image=False)
    sd = {k: v.requires_grad_(True)
          for k, v in convert.flax_to_state_dict(_np_tree(jp), module).items()}
    hs = _t(hist).clone().requires_grad_(True)
    tkw = {} if mask is None else {"attention_mask": _t(mask)}
    seq, pooled = functional_call(module, sd, (_t(ids),), {"history_states": hs, **tkw})
    loss = (seq * _t(w_seq)).sum() + (pooled * _t(w_pool)).sum()
    grads = torch.autograd.grad(loss, [*sd.values(), hs])
    _close(seq, jseq)
    _close(pooled, jpool)
    _close(loss, jl, 1e-4)
    _grads_close(module, dict(zip(sd, grads[:-1])), jg)
    _close(grads[-1], jgh)


def test_history_states_take_the_plain_attention_with_k2(monkeypatch):
    """With history every layer runs ``multi_head_attention`` (the JAX
    package's fused_ok needs no history) over P + Q keys; the LayerNorms stay
    on K2 (2 a layer + the embedding one)."""
    ids, hist, mask = _history_inputs("fresh")
    cfg = tm.BertConfig(**{**HCFG, "hidden_size": 128, "num_attention_heads": 2,
                           "intermediate_size": 64})
    module = tm.VisitronBert(cfg, image=False)
    sd = init_module_params(module, torch.Generator().manual_seed(0))
    calls = {"plain": [], "k2": 0}
    real_mha, real_ln = tbert.multi_head_attention, tbert.fused_add_layernorm

    def mha(q, k, v, **kw):
        calls["plain"].append(k.shape[2])
        return real_mha(q, k, v, **kw)

    def ln(*a):
        calls["k2"] += 1
        return real_ln(*a)

    monkeypatch.setattr(tbert, "multi_head_attention", mha)
    monkeypatch.setattr(tbert, "fused_add_layernorm", ln)
    for name in ("fused_attention_packed", "fused_attention", "flash_attention"):
        monkeypatch.setattr(tbert, name, lambda *a, **k: pytest.fail("a fused kernel ran"))
    hs = torch.zeros(cfg.num_hidden_layers, B, P, 128)
    with torch.inference_mode():
        functional_call(module, sd, (_t(ids),), {"history_states": hs,
                                                 "attention_mask": _t(mask)})
    assert calls == {"plain": [P + Q] * cfg.num_hidden_layers,
                     "k2": 2 * cfg.num_hidden_layers + 1}


def test_history_states_with_image_features_raise():
    cfg = tm.BertConfig(**HCFG, img_feature_dim=8)
    module = tm.VisitronBert(cfg)
    ids = torch.zeros(1, Q, dtype=torch.int64)
    with pytest.raises(ValueError, match="history states"):
        module(ids, img_feats=torch.zeros(1, 2, 8),
               img_location_embeddings=torch.zeros(1, 2, cfg.location_embed_dim),
               history_states=torch.zeros(cfg.num_hidden_layers, 1, P, 32))
    jmod = jm.VisitronBert(jm.BertConfig(**HCFG, img_feature_dim=8))
    with pytest.raises(ValueError, match="history states"):
        jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, Q), jnp.int32),
                  img_feats=jnp.zeros((1, 2, 8)),
                  img_location_embeddings=jnp.zeros((1, 2, 128)),
                  history_states=jnp.zeros((3, 1, P, 32)))


def test_remat_passes_the_history_through():
    ids, hist, mask = _history_inputs("history")
    outs = []
    for remat in (False, True):
        module = tm.VisitronBert(tm.BertConfig(**HCFG, remat=remat), image=False)
        sd = {k: v.requires_grad_(True) for k, v in
              init_module_params(module, torch.Generator().manual_seed(1)).items()}
        hs = _t(hist).clone().requires_grad_(True)
        seq, pooled = functional_call(module, sd, (_t(ids),), {"history_states": hs,
                                                               "attention_mask": _t(mask)})
        loss = seq.square().sum() + pooled.sum()
        outs.append((seq, torch.autograd.grad(loss, [*sd.values(), hs])))
    (seq0, g0), (seq1, g1) = outs
    torch.testing.assert_close(seq1, seq0, atol=0, rtol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


# -- the bidirectional LSTM ---------------------------------------------------------

def test_bidirectional_lstm_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 20, 12)).astype(np.float32)
    lengths = np.array([20, 7, 1, 13], np.int32)
    w = rng.standard_normal((4, 20, 20)).astype(np.float32)
    jmod = jlstm.LSTM(input_size=12, hidden_size=10, bidirectional=True)
    jp = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths))

    def jloss(params, xs):
        ys, (h, c) = jmod.apply(params, xs, jnp.asarray(lengths))
        return jnp.sum(ys * w) + jnp.sum(h) + 2 * jnp.sum(c), (ys, h, c)

    (_, (jys, jh, jc)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    module = tm.LSTM(12, 10, bidirectional=True)
    sd = {k: v.requires_grad_(True)
          for k, v in convert.flax_to_state_dict(_np_tree(jp), module).items()}
    xs = _t(x).clone().requires_grad_(True)
    ys, (h, c) = functional_call(module, sd, (xs, _t(lengths)))
    assert ys.shape == (4, 20, 20) and h.shape == c.shape == (4, 20)
    _close(ys, jys)
    _close(h, jh)
    _close(c, jc)
    for row, n in enumerate(lengths):
        assert not ys[row, n:].any()  # zero at pads, both directions
    loss = (ys * _t(w)).sum() + h.sum() + 2 * c.sum()
    grads = torch.autograd.grad(loss, [*sd.values(), xs])
    _grads_close(module, dict(zip(sd, grads[:-1])), jg)
    _close(grads[-1], jgx)


S_ENC = 16
ECFG = dict(vocab_size=61, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=S_ENC, type_vocab_size=4)


def _encoder_inputs(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, ECFG["vocab_size"], (3, S_ENC)).astype(np.int32)
    segs = rng.integers(0, 4, (3, S_ENC)).astype(np.int32)
    return ids, segs, np.array([S_ENC, 9, 2], np.int32)


@pytest.mark.parametrize("enc_hidden", [16, 12])
def test_bidirectional_oscar_encoder_matches_flax(enc_hidden):
    """2 x 16 = 32 != rnn 24 projects c0; 2 x 12 = 24 passes c_T through."""
    ids, segs, lengths = _encoder_inputs(2)
    jmod = jm.OscarEncoder(jm.BertConfig(**ECFG), hidden_size=enc_hidden,
                           decoder_hidden_size=24, bidirectional=True)
    jp = jmod.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(lengths))

    def jloss(params):
        ctx, h0, c0 = jmod.apply(params, jnp.asarray(ids), jnp.asarray(lengths),
                                 token_type_ids=jnp.asarray(segs))
        return jnp.sum(ctx ** 2) + jnp.sum(h0) + jnp.sum(c0 ** 2), (ctx, h0, c0)

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    module = tm.OscarEncoder(tm.BertConfig(**ECFG), hidden_size=enc_hidden,
                             decoder_hidden_size=24, bidirectional=True)
    assert module.project_c == (2 * enc_hidden != 24)
    sd = {k: v.requires_grad_(True)
          for k, v in convert.flax_to_state_dict(_np_tree(jp), module).items()}
    out = functional_call(module, sd, (_t(ids), _t(lengths)), {"token_type_ids": _t(segs)})
    assert out[0].shape == (3, S_ENC, 2 * enc_hidden)
    for got, want in zip(out, jout):
        _close(got, want)
    loss = (out[0] ** 2).sum() + out[1].sum() + (out[2] ** 2).sum()
    # The pooler takes no gradient here (zeros in JAX, None in torch).
    grads = torch.autograd.grad(loss, list(sd.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, sd.values())]
    _grads_close(module, dict(zip(sd, grads)), jg, 1e-4)


# -- use_fused_layernorm false ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_layernorm_matches_flax(dtype, residual):
    """``FlaxLayerNorm`` against the JAX package's FusedResidualLayerNorm
    with the flag off: the residual added in the input dtype, fp32
    statistics, fp32 output."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32) * 3 + 1
    res = rng.standard_normal((5, 7, 64)).astype(np.float32) if residual else None
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jbert.FusedResidualLayerNorm(jm.BertConfig(use_fused_layernorm=False))
    jargs = (jnp.asarray(x, jdt),) + (() if res is None else (jnp.asarray(res, jdt),))
    # Eagerly: under jit, XLA's CPU compiler keeps the bf16 sum in fp32 and
    # skips the rounding that flax's math (and the port) takes.
    with jax.disable_jit():
        want = jmod.apply({"params": {"scale": scale, "bias": bias}}, *jargs)
    ln = tbert.FlaxLayerNorm(64, 1e-12)
    targs = (_t(x).to(tdt),) + (() if res is None else (_t(res).to(tdt),))
    got = functional_call(ln, {"weight": _t(scale), "bias": _t(bias)}, targs)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-6)


def test_encoder_without_fused_layernorm_matches_flax(monkeypatch):
    ids, segs, lengths = _encoder_inputs(4)
    jcfg = jm.BertConfig(**ECFG, use_fused_layernorm=False)
    jmod = jm.OscarEncoder(jcfg, hidden_size=16, decoder_hidden_size=24)
    jp = jmod.init(jax.random.PRNGKey(4), jnp.asarray(ids), jnp.asarray(lengths))
    jout = jmod.apply(jp, jnp.asarray(ids), jnp.asarray(lengths),
                      token_type_ids=jnp.asarray(segs))
    monkeypatch.setattr(tbert, "fused_add_layernorm",
                        lambda *a: pytest.fail("K2 ran with use_fused_layernorm off"))
    module = tm.OscarEncoder(tm.BertConfig(**ECFG, use_fused_layernorm=False),
                             hidden_size=16, decoder_hidden_size=24)
    kinds = {type(m).__name__ for n, m in module.named_modules() if n.endswith("layer_norm")}
    assert kinds == {"FlaxLayerNorm"}
    sd = convert.flax_to_state_dict(_np_tree(jp), module)
    with torch.inference_mode():
        out = functional_call(module, sd, (_t(ids), _t(lengths)), {"token_type_ids": _t(segs)})
    for got, want in zip(out, jout):
        _close(got, want)


def test_run_viewpoint_without_fused_layernorm(tmp_path, monkeypatch):
    """``run viewpoint --debug --no_use_fused_layernorm`` trains 2 iterations
    on the CPU (a tiny BERT that keeps the workspace's flag) through flax's
    LayerNorm math, and no K2 launch."""
    orig = tws.Workspace.__dict__["_bert_config"].__func__
    seen = []

    def tiny(cfg, tok):
        bert = orig(cfg, tok).replace(hidden_size=32, num_hidden_layers=2,
                                      num_attention_heads=4, intermediate_size=64)
        seen.append(bert.use_fused_layernorm)
        return bert

    monkeypatch.setattr(tws.Workspace, "_bert_config", staticmethod(tiny))
    monkeypatch.setattr(tbert, "fused_add_layernorm",
                        lambda *a: pytest.fail("K2 ran with use_fused_layernorm off"))
    out = str(tmp_path / "vp")
    trun.main(["viewpoint", "--config",
               os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
               "--debug", "--no_use_bfloat16", "--no_use_fused_layernorm",
               "--max_seq_length", "64", "--logging_steps", "1", "--num_iterations", "2",
               "--saving_steps", "2", "--eval_iters", "2", "--output_dir", out],
              device="cpu")
    assert seen and not any(seen)
    assert CheckpointManager(out).steps() == [2]
    with open(os.path.join(out, "train.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 3  # header + 2 iterations
