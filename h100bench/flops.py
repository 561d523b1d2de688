"""The yardstick's arithmetic: model FLOPs of a step, the chip's peaks, and
the operations and bytes of one launch of each measured kernel.

Model FLOPs count the matrix products that a step's forward and backward
passes need on the plain path (every product as an (M, K) x (K, N) of
2 M K N operations; a backward product only for an operand that takes a
gradient), so they equal what ``torch.utils.flop_counter.FlopCounterMode``
counts on the plain PyTorch path, and recomputation is not counted.

A launch's bound is max(bytes / peak bandwidth, operations / peak rate):
every input byte read once and every output byte written once, and the
operations the algorithm needs (the fused attention backward recomputes its
scores: five products).
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet): dense bf16 tensor rate and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

BF16, FP32 = 2, 4


def _mm(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def bert_flops(rows: int, batch: int, seq: int, cfg: dict, train: bool) -> float:
    """The transformer stack over ``rows`` = batch x seq tokens: the four
    Denses and the two attention products of each layer."""
    h, inter, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    dense = _mm(rows, h, 3 * h) + _mm(rows, h, h) + _mm(rows, h, inter) + _mm(rows, inter, h)
    attn = 2 * _mm(batch * seq, h, seq)  # QK^T and PV over every head
    fwd = layers * (dense + attn)
    return fwd * (3 if train else 1)


def ndh_flops(batch: int, seq: int, steps: int, cfg: dict, agent: dict, train: bool) -> float:
    """One NDH teacher-forced train step (``train``) or argmax rollout of
    ``steps`` decoder steps over a dialog batch trimmed to ``seq``: BERT, its
    pooler (forward only: nothing reads it), the masked encoder LSTM, the
    decoder's initial projection and ``steps`` AttnDecoderLSTM steps."""
    h = cfg["hidden_size"]
    enc, rnn, feat = agent["encoder_hidden_size"], agent["rnn_dim"], agent["feature_dim"] + 4
    emb, views, slots = agent["aemb"], 36, agent["max_candidates"] + 1
    b, s = batch, seq
    x = 3 if train else 1  # forward + backward of a product whose operands both take gradients
    w = 2 if train else 1  # one operand takes none: the weight's or the other operand's
    total = bert_flops(b * s, b, s, cfg, train)
    total += _mm(b, h, h)  # pooler
    total += x * _mm(b * s, h, 4 * enc)  # LSTM input projection
    # Recurrent products: the first step's h is zeros, which take no gradient.
    total += _mm(b, enc, 4 * enc) * (s if not train else 3 * s - 1)
    total += x * _mm(b, enc, rnn)  # decoder_init
    step = (w * _mm(b, 4, emb)  # action embedding (input: a table row)
            + x * _mm(b, rnn, feat) + 2 * w * _mm(b, views, feat)  # panorama attention
            + x * _mm(b, emb + feat, 4 * rnn) + x * _mm(b, rnn, 4 * rnn)  # LSTM cell
            + x * (_mm(b, rnn, enc) + 2 * _mm(b, s, enc) + _mm(b, enc + rnn, rnn))  # dialog
            + x * _mm(b, rnn, feat) + w * _mm(b, slots, feat)  # candidate scores
            + _mm(b, slots, feat))  # the scorer's attended context: computed, never read
    return total + steps * step


def pretrain_flops(batch: int, text: int, img: int, cfg: dict) -> float:
    """One pretraining step over batch x (text + img) tokens: the image
    projections (their inputs take no gradient), BERT, the pooler and the
    next-action head on [CLS], the MLM transform and tied decoder and the
    region-token head over every position.  chip_smoke.py's
    ``pretrain_flops`` counts the attention backward as five products and
    leaves out the pooler and the next-action head; this count is the plain
    path's."""
    h, s = cfg["hidden_size"], text + img
    rows = batch * s
    total = 2 * (_mm(batch * img, cfg["img_feature_dim"], h) + _mm(batch * img, 128, h))
    total += bert_flops(rows, batch, s, cfg, True)
    total += 3 * (_mm(batch, h, h) + _mm(batch, h, cfg["action_space"]))
    total += 3 * (_mm(rows, h, h) + _mm(rows, h, cfg["vocab_size"])
                  + _mm(rows, h, cfg["detector_classes"]))
    return total


# -- kernel launches: (operations, bytes) ------------------------------------

def attention_fwd(batch: int, heads: int, seq: int, dim: int, lse: bool) -> tuple:
    """K1f / K4f: q, k, v and the fp32 key bias in, the output (and the fp32
    lse where the backward keeps it) out; QK^T and PV."""
    tok = batch * seq * heads * dim
    return (4.0 * batch * heads * seq * seq * dim,
            4 * tok * BF16 + batch * seq * FP32 + (batch * heads * seq * FP32 if lse else 0))


def attention_bwd(batch: int, heads: int, seq: int, dim: int) -> tuple:
    """K1b / K4b: q, k, v, dout, the key bias and the lse in, dq, dk, dv
    out; five products (the scores again, dP, dV, dQ, dK)."""
    tok = batch * seq * heads * dim
    return (10.0 * batch * heads * seq * seq * dim,
            7 * tok * BF16 + batch * seq * FP32 + batch * heads * seq * FP32)


def layernorm_fwd(rows: int, hidden: int, residual: bool) -> tuple:
    """K2f: x (and the residual) in, y out, fp32 scale and shift; about
    eight operations an element."""
    act = rows * hidden * BF16
    return 8.0 * rows * hidden, act * (3 if residual else 2) + 2 * hidden * FP32


def layernorm_bwd(rows: int, hidden: int, residual: bool) -> tuple:
    """K2b: dy, x (and the residual) and the fp32 scale in, dh and the fp32
    dscale, dshift out; about twelve operations an element."""
    act = rows * hidden * BF16
    return 12.0 * rows * hidden, act * (4 if residual else 3) + 3 * hidden * FP32


def bound_s(launches) -> float:
    """The least time of ``launches`` ((operations, bytes) each) on one H100."""
    return sum(max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) for ops, nbytes in launches)


def bert_launches(batch: int, seq: int, cfg: dict, train: bool, embed_rows: int | None = None,
                  head_rows: int = 0) -> dict:
    """{"attn": [...], "ln": [...]} launches of one BERT pass: the fused
    attention of each layer, the embedding LayerNorm (over ``embed_rows``,
    default every token; no residual), two residual LayerNorms a layer, and
    ``head_rows`` of an MLM-head LayerNorm without a residual."""
    heads, layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    dim, h = cfg["hidden_size"] // heads, cfg["hidden_size"]
    rows = batch * seq
    embed_rows = rows if embed_rows is None else embed_rows
    attn = [attention_fwd(batch, heads, seq, dim, train)] * layers
    ln = [(embed_rows, False)] + [(rows, True)] * (2 * layers)
    if head_rows:
        ln.append((head_rows, False))
    out_ln = [layernorm_fwd(r, h, res) for r, res in ln]
    if train:
        attn += [attention_bwd(batch, heads, seq, dim)] * layers
        out_ln += [layernorm_bwd(r, h, res) for r, res in ln]
    return {"attn": attn, "ln": out_ln}
