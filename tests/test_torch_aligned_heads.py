"""The pretraining heads at 8-aligned output widths (``layers.aligned_linear``):
the tied MLM decoder and the region-token head compute at their widths
rounded up to a multiple of 8, and what the loss and the gradients see is
the unpadded heads' mathematics.

On the CPU: vocab 101 and 11 classes (padded to 104 and 16) against a
test-local unpadded fp32 computation of the same heads; vocab 128 and 16
classes, which take no pad.  On the card (``gpu``, skipped without one): the
cell's widths (vocab 30,525, hidden 768) over 4,096 bf16 rows against an
unpadded bf16 ``F.linear`` product, and no unaligned GEMM kernel in the
profiled step.  Run them there with

    python -m pytest tests/test_torch_aligned_heads.py --noconftest -q
"""

import math

import pytest
import torch
import torch.nn.functional as F

from visitron_torch.models import BertConfig, PretrainModel, pretrain_loss
from visitron_torch.models.layers import aligned_linear, init_module_params
from visitron_torch.ops import crossentropy as tce

B, S = 2, 12
TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=S, type_vocab_size=2,
            img_feature_dim=8, location_embed_dim=4, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


def _model(vocab, classes, device="cpu", dtype=torch.float32, **extra):
    """A PretrainModel with drawn parameters and nonzero biases (a pad value
    out of place then shows)."""
    cfg = BertConfig(**{**TINY, **extra}, vocab_size=vocab, detector_classes=classes,
                     dtype=dtype)
    model = PretrainModel(cfg)
    params = init_module_params(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params["mlm_bias"] = torch.randn(vocab, generator=g)
    params["token_head.bias"] = torch.randn(classes, generator=g)
    model.load_state_dict(params)
    return model.to(device)


def _inputs(hidden, vocab, classes, b=B, s=S, device="cpu", seed=3):
    """(seq, pooled, MLM labels, token labels), half of each label kind -1."""
    g = torch.Generator().manual_seed(seed)
    seq = torch.randn(b, s, hidden, generator=g)
    pooled = torch.randn(b, hidden, generator=g)
    labels = torch.randint(0, vocab, (b, s), generator=g)
    labels[torch.rand(labels.shape, generator=g) < 0.5] = -1
    tokens = torch.randint(0, classes, (b, s), generator=g)
    tokens[torch.rand(tokens.shape, generator=g) < 0.5] = -1
    return [t.to(device) for t in (seq, pooled, labels, tokens)]


def _leaves(model):
    return {"word_embeddings": model.bert.word_embeddings.weight, "mlm_bias": model.mlm_bias,
            "token_head.weight": model.token_head.weight,
            "token_head.bias": model.token_head.bias}


@pytest.mark.parametrize("vocab,classes,padded", [(101, 11, 2), (128, 16, 0)])
def test_counter_reads_the_padded_products_of_a_forward(vocab, classes, padded):
    model = _model(vocab, classes)
    ids = torch.randint(0, vocab, (B, S), generator=torch.Generator().manual_seed(2))
    before = aligned_linear.padded
    with torch.no_grad():
        out = model(ids)
    assert aligned_linear.padded - before == padded
    assert out["mlm_logits"].shape == (B, S, vocab)
    assert out["token_logits"].shape == (B, S, classes)


def test_padded_mlm_buffer_is_what_k3_reads_and_gives_the_same_ce():
    model = _model(101, 11)
    seq, pooled, labels, _ = _inputs(32, 101, 11)
    with torch.no_grad():
        out = model.heads(seq, pooled)
    padded = out["mlm_logits_padded"]
    assert padded.shape == (B, S, 104) and padded.is_contiguous()
    assert torch.all(padded[..., 101:] == -math.inf)
    assert out["mlm_logits"].shape == (B, S, 101)
    assert out["mlm_logits"].data_ptr() == padded.data_ptr()  # a view, not a copy
    assert out["token_logits"].shape == (B, S, 11)

    rows, flat = padded.reshape(-1, 104), labels.reshape(-1)
    ce_p, lse_p = tce.masked_softmax_ce_reference(rows, flat)
    ce, lse = tce.masked_softmax_ce_reference(rows[:, :101].contiguous(), flat)
    torch.testing.assert_close(ce_p, ce, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    g = torch.rand(B * S, generator=torch.Generator().manual_seed(5))
    dx = tce.masked_softmax_ce_bwd_reference(rows, flat, lse_p, g)
    assert torch.all(dx[:, 101:] == 0)
    want = tce.masked_softmax_ce_bwd_reference(rows[:, :101].contiguous(), flat, lse, g)
    torch.testing.assert_close(dx[:, :101], want, atol=1e-6, rtol=1e-6)


def _unpadded_bundle(model, seq, labels, tokens):
    """The MLM and token terms of the bundle, fp32, with the heads as plain
    unpadded products."""
    x = model.mlm_layer_norm(F.gelu(model.mlm_transform(seq), approximate="none"))
    logits = F.linear(x, model.bert.word_embeddings.weight) + model.mlm_bias
    head = model.token_head
    token_logits = F.linear(seq, head.weight, head.bias)
    out = {}
    for name, lg, lb in (("mask", logits, labels), ("token", token_logits, tokens)):
        valid = lb != -1
        ce = F.cross_entropy(lg.flatten(0, 1), torch.where(valid, lb, 0).flatten(),
                             reduction="none")
        out[f"{name}_loss"] = torch.sum(ce * valid.flatten()) / valid.sum()
        right = (lg.argmax(-1) == lb) & valid
        out["words_accuracy" if name == "mask" else "token_accuracy"] = right.sum() / valid.sum()
    out["loss"] = out["mask_loss"] + out["token_loss"]
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_padded_heads_equal_the_unpadded_computation(fused):
    model = _model(101, 11, use_fused_mlm_ce=fused)
    seq, pooled, labels, tokens = _inputs(32, 101, 11)
    leaves = _leaves(model)
    got = pretrain_loss(model.heads(seq, pooled), labels, token_labels=tokens, cfg=model.cfg)
    want = _unpadded_bundle(model, seq, labels, tokens)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, atol=1e-5, rtol=1e-5, msg=key)
    g_got = torch.autograd.grad(got["loss"], list(leaves.values()))
    g_want = torch.autograd.grad(want["loss"], list(leaves.values()))
    for name, a, b in zip(leaves, g_got, g_want):
        assert a.shape == leaves[name].shape
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_heads_at_the_cells_widths_leave_the_unaligned_kernels(cuda):
    vocab, classes, hidden = 30525, 1601, 768
    model = _model(vocab, classes, device=cuda, dtype=torch.bfloat16, hidden_size=hidden,
                   num_attention_heads=12, intermediate_size=3072)
    seq, _, labels, tokens = _inputs(hidden, vocab, classes, 8, 512, device=cuda)  # 4,096 rows
    seq = seq.to(torch.bfloat16)
    leaves = _leaves(model)
    dec = [leaves["word_embeddings"], leaves["mlm_bias"]]
    heads = [leaves["token_head.weight"], leaves["token_head.bias"]]

    def step():  # the next-action head (36 classes over the pooled rows) stays unpadded
        out = model.heads(seq)
        bundle = pretrain_loss(out, labels, token_labels=tokens, cfg=model.cfg)
        return bundle, torch.autograd.grad(bundle["loss"], dec + heads)[:2]

    step()  # cuBLAS's and the kernels' first calls
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        bundle, grads = step()
        torch.cuda.synchronize()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert any("ce_fwd" in n for n in names), sorted(names)
    assert not [n for n in names if "align1" in n or "cutlass_75" in n], sorted(names)

    # The unpadded bf16 product, through the same K3 on its (R, vocab) logits.
    x = model.mlm_layer_norm(F.gelu(model.mlm_transform(seq), approximate="none"))
    logits = (F.linear(x.to(torch.bfloat16), leaves["word_embeddings"].to(torch.bfloat16))
              .float() + model.mlm_bias).to(torch.bfloat16)
    flat = labels.reshape(-1)
    ce = tce.fused_masked_softmax_ce(logits.reshape(-1, vocab), flat)
    mask_loss = ce.sum() / torch.sum(flat != -1)
    want = torch.autograd.grad(mask_loss, dec)
    torch.testing.assert_close(bundle["mask_loss"], mask_loss, atol=1e-4, rtol=1e-4)
    # The mean over ~2,000 labels leaves gradients of 1e-6 to 1e-3: an absolute
    # tolerance would pass zeros, so each leaf is held by its relative norm (a
    # zero gradient reads 1).
    for name, a, b in zip(("word_embeddings", "mlm_bias"), grads, want):
        assert a.shape == b.shape and float(b.norm()) > 0, name
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel < 1e-2, (name, rel)
