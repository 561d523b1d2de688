"""visitron_torch models against the flax modules of the JAX package, with
the flax parameters carried across by visitron_torch.convert: BertTextModel,
the masked LSTM, OscarEncoder and one AttnDecoderLSTM step.  Tiny config
(2 layers, hidden 128, 2 heads of 64, S 128, rnn 24), fp32, with padding;
tolerance atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from visitron_torch import convert
from visitron_torch import models as tm
from visitron_torch.models import bert as tbert
from visitron_torch.models.layers import init_module_params
from visitron_tpu import models as jm
from visitron_tpu.models import lstm as jlstm

S = 128
ATOL = 1e-4
CFG = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, max_position_embeddings=S, type_vocab_size=4)


def _dialog(seed, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (b, S)).astype(np.int32)
    segs = rng.integers(0, 4, (b, S)).astype(np.int32)
    lengths = np.array([S, 77, 9][:b], np.int32)
    return ids, segs, lengths


def _port(module, flax_params):
    return module, convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, flax_params),
                                              module)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_bert_text_model_matches_flax():
    ids, segs, lengths = _dialog(0)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    jmod = jm.BertTextModel(jm.BertConfig(**CFG))
    jp = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    jseq, jpooled = jmod.apply(jp, jnp.asarray(ids), token_type_ids=jnp.asarray(segs),
                               attention_mask=jnp.asarray(mask))
    module, sd = _port(tm.BertTextModel(tm.BertConfig(**CFG)), jp)
    with torch.inference_mode():
        seq, pooled = functional_call(module, sd, (_t(ids),),
                                      {"token_type_ids": _t(segs), "attention_mask": _t(mask)})
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=ATOL, rtol=0)


def test_masked_lstm_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, 12)).astype(np.float32)
    lengths = np.array([20, 7, 1], np.int32)
    jmod = jlstm.LSTM(input_size=12, hidden_size=10)
    jp = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths))
    jys, (jh, jc) = jmod.apply(jp, jnp.asarray(x), jnp.asarray(lengths))
    module, sd = _port(tm.LSTM(12, 10), jp)
    ys, (h, c) = functional_call(module, sd, (_t(x), _t(lengths)))
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    assert not ys[2, 1:].any()  # zero at pads


@pytest.mark.parametrize("enc_hidden", [16, 24])
def test_oscar_encoder_matches_flax(enc_hidden):
    """enc_hidden 16 != rnn 24 projects c0; 24 passes c_T through."""
    ids, segs, lengths = _dialog(2)
    jmod = jm.OscarEncoder(jm.BertConfig(**CFG), hidden_size=enc_hidden,
                           decoder_hidden_size=24)
    jp = jmod.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(lengths))
    jout = jmod.apply(jp, jnp.asarray(ids), jnp.asarray(lengths),
                      token_type_ids=jnp.asarray(segs))
    module, sd = _port(tm.OscarEncoder(tm.BertConfig(**CFG), hidden_size=enc_hidden,
                                       decoder_hidden_size=24), jp)
    with torch.inference_mode():
        out = functional_call(module, sd, (_t(ids), _t(lengths)), {"token_type_ids": _t(segs)})
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_attn_decoder_step_matches_flax():
    rng = np.random.default_rng(3)
    b, feat, k1, t, ctx_dim, hid = 3, 36, 6, 11, 16, 24
    args = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, 4), (b, 36, feat), (b, k1, feat), (b, hid), (b, hid), (b, t, ctx_dim))]
    ctx_mask = np.arange(t)[None] >= np.array([[11], [4], [1]])
    jmod = jm.AttnDecoderLSTM(embedding_size=8, hidden_size=hid, feature_size=feat)
    jp = jmod.init(jax.random.PRNGKey(3), *map(jnp.asarray, args), jnp.asarray(ctx_mask))
    jout = jmod.apply(jp, *map(jnp.asarray, args), jnp.asarray(ctx_mask))
    module, sd = _port(tm.AttnDecoderLSTM(embedding_size=8, hidden_size=hid,
                                          feature_size=feat, ctx_size=ctx_dim), jp)
    with torch.inference_mode():
        out = functional_call(module, sd, (*map(_t, args), _t(ctx_mask)))
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_convert_refuses_missing_and_extra_keys():
    jp = jlstm.LSTM(input_size=4, hidden_size=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 4)), jnp.array([2]))
    tree = jax.tree_util.tree_map(np.asarray, jp)["params"]
    module = tm.LSTM(4, 3)
    convert.flax_to_state_dict(tree, module)  # complete: accepted
    missing = {"fwd": {k: v for k, v in tree["fwd"].items() if k != "wh"}}
    with pytest.raises(KeyError, match="missing"):
        convert.flax_to_state_dict(missing, module)
    extra = {"fwd": dict(tree["fwd"]), "other": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(KeyError, match="no counterpart"):
        convert.flax_to_state_dict(extra, module)
    wrong = {"fwd": {**tree["fwd"], "wh": np.zeros((12, 4), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        convert.flax_to_state_dict(wrong, module)


def test_port_modules_refuse_unported_paths(monkeypatch):
    # Image fusion and the flash kernels (K5), which the JAX package runs
    # where the fused gate refuses a shape, are ported: with the fused
    # kernels off, S 128 goes through flash and matches plain attention
    # (fp32, dropouts off) on the same parameters.
    flash = tm.VisitronBert(tm.BertConfig(**{**CFG, "use_fused_attention": False,
                                             "use_flash_attention": True}))
    plain = tm.VisitronBert(tm.BertConfig(**{**CFG, "use_fused_attention": False}))
    sd = init_module_params(flash, torch.Generator().manual_seed(4))
    ids_s, segs, lengths = (_t(a) for a in _dialog(5))
    kw = {"token_type_ids": segs,
          "attention_mask": (torch.arange(S)[None] < lengths[:, None]).int()}
    calls = []
    real = tbert.flash_attention
    monkeypatch.setattr(tbert, "flash_attention",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    with torch.inference_mode():
        got = functional_call(flash, sd, (ids_s,), kw)
        want = functional_call(plain, sd, (ids_s,), kw)
    assert len(calls) == CFG["num_hidden_layers"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)
