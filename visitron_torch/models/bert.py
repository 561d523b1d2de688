"""Multimodal (Oscar-style) BERT in PyTorch (visitron_tpu/models/bert.py).

Same structure and parameter names as the flax modules, so a converted
checkpoint (visitron_torch/convert.py) loads one to one:

  * one fused QKV projection per layer; q, k and v are strided views of its
    (B, S, 3*H) output and go straight into the attention kernels with no
    split or transpose copies.  The dispatch is the JAX package's
    (BertSelfAttention): where ``attention_supports_fused`` takes the shape
    (128 <= S <= 768, S % 128 == 0, head dim 64 or 128), the packed kernel
    K1 runs for S <= ``fused_packed_max_seq`` and the (B, H, S, D) kernel K4
    on views of the same projection above it; where the fused gate refuses
    and ``use_flash_attention`` is set, the flash kernels K5 take every
    shape ``attention_supports_flash`` takes (S % 128 == 0: the long joint
    sequences past S 768), on the same views; other shapes take the plain
    ``multi_head_attention``, as the JAX package does;
  * ``remat``: each layer runs under a selective checkpoint that keeps only
    its Denses' outputs and recomputes the rest in the backward, replaying
    the layer's dropout draws;
  * image-region fusion (``embed_joint``): projected region features plus
    location embeddings, dropped out and concatenated after the text, and
    ``attend_vocab``, the tied MLM decoder (a plain product at the
    vocabulary rounded up to a multiple of 8);
  * every LayerNorm is the fused add+LayerNorm kernel (K2,
    ops/layernorm.py): the embedding LayerNorm without a residual, two
    residual LayerNorms per layer; with ``use_fused_layernorm`` off, flax's
    LayerNorm math in plain PyTorch instead (``FlaxLayerNorm``: the residual
    added in the input dtype, fp32 statistics and output);
  * ``history_states``: one (B, P, H) state per layer, prepended to that
    layer's keys and values (queries stay over the fresh tokens), the key
    mask extended with ones over it; such a layer always takes the plain
    ``multi_head_attention``, as the JAX package's gate decides;
  * activations in ``BertConfig.dtype`` (bf16 on the card), parameters in
    fp32: each Dense casts its input and its fp32 parameters to that dtype
    (flax ``Dense(dtype=...)``), explicitly rather than through autocast;
  * exact (erf) gelu;
  * on a rank of a mesh (``config_for_mesh``): under tp each layer's QKV,
    intermediate, attention-output and output Denses hold this rank's
    blocks (``ParallelDense``: Megatron's column and row splits, one
    all-reduce forward and one backward around each half of a layer) and
    attention runs on its heads; under sp the joint sequence is embedded
    token-sharded (``embed_joint``) and self-attention exchanges tokens for
    heads and back with two all-to-alls a layer; under cp the tokens stay
    sharded and attention runs the ring.  The kernels run on the rank's
    heads with their seed folded by the mesh coordinates
    (``DropoutRng.seed_offset``, as the JAX mesh wrappers fold it); history
    K/V and shapes the gates refuse take the plain attention on the rank's
    heads, its dropout mask drawn over every head and sliced.

There is no backend gate: the kernels' wrappers run the CUDA kernels for
tensors on the card and their plain twins for tensors on the CPU.  Dropout
applies only in a training pass, which passes a ``DropoutRng`` as ``rng``:
hidden dropout after the embedding LayerNorm, on the image embeddings and
after each layer's two output projections, and the kernels' hash dropout on
the attention probabilities with a fresh seed per layer and step (the plain
attention draws its mask from ``rng.masks``).  ``rng=None`` is the
deterministic (serving) pass.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from visitron_torch.models.layers import (Dense, DropoutRng, Embed, aligned_linear,
                                          maybe_drop)
from visitron_torch.ops.attention import (attention_supports_flash,
                                          attention_supports_fused, flash_attention,
                                          fused_attention, fused_attention_packed,
                                          multi_head_attention)
from visitron_torch.ops.layernorm import fused_add_layernorm
from visitron_torch.ops.masking import make_attention_bias
from visitron_torch.ops.ring_attention import attention_supports_ring, ring_attention
from visitron_torch.parallel.mesh import (all_to_all, copy_to_axis, reduce_from_axis,
                                          token_range)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # Multimodal extensions (model_utils.py:75-83):
    img_feature_dim: int = 2054
    location_embed_dim: int = 128
    use_img_layernorm: bool = False
    action_space: int = 36
    detector_classes: int = 1601
    dtype: torch.dtype = torch.float32  # activation dtype (bfloat16 on the card)
    # Attention dispatch (BertSelfAttention): the fused kernels where
    # attention_supports_fused takes the shape, packed (K1) up to
    # fused_packed_max_seq and (B, H, S, D) (K4) above; with
    # use_flash_attention, the flash kernels (K5) where the fused gate
    # refuses and attention_supports_flash takes the shape (the long joint
    # sequences, S > 768).
    use_fused_attention: bool = True
    fused_packed_layout: bool = True
    fused_packed_max_seq: int = 512
    use_flash_attention: bool = False
    # The MLM loss through the fused masked softmax-CE kernel (K3), with the
    # MLM logits kept in ``dtype`` (models/pretrain.py).
    use_fused_mlm_ce: bool = True
    # Every LayerNorm through the fused add+LayerNorm kernel (K2); off, flax's
    # LayerNorm math in plain PyTorch (FlaxLayerNorm).
    use_fused_layernorm: bool = True
    # Recompute each transformer layer in the backward, keeping only the
    # outputs of its 2-D products (the Denses): the JAX package's
    # nn.remat(policy=dots_with_no_batch_dims_saveable).  More operations for
    # less activation memory.
    remat: bool = False
    # Set by config_for_mesh (parallel.Mesh objects).  tp_mesh: tensor
    # parallelism, each rank holding 1/tp of the fused QKV and intermediate
    # kernels' rows and of the two output kernels' columns, with the Megatron
    # all-reduces around them (ParallelDense).  sp_mesh: Ulysses sequence
    # parallelism, the joint sequence token-sharded through the encoder and
    # self-attention head-sharded between two all-to-alls a layer.  cp_mesh:
    # ring-attention context parallelism, the tokens sharded through
    # attention itself.
    tp_mesh: Any = None
    sp_mesh: Any = None
    cp_mesh: Any = None

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)

    @property
    def token_mesh(self):
        """The mesh whose axis shards the tokens (sp or cp), or None."""
        return self.sp_mesh if self.sp_mesh is not None else self.cp_mesh

    def without_mesh(self) -> "BertConfig":
        """This config for one device: the mesh-free twin that evaluation
        and the single-device parameter layout use."""
        return self.replace(tp_mesh=None, sp_mesh=None, cp_mesh=None)


def config_for_mesh(cfg: BertConfig, mesh) -> BertConfig:
    """``cfg`` for a rank of ``mesh`` (visitron_tpu/models/bert.py:
    config_for_mesh): unchanged without a mesh or on a dp-only or pp one.  An sp
    mesh sets ``sp_mesh``; sp must divide the heads.  A cp mesh sets
    ``cp_mesh`` and turns the fused and flash kernels off: attention runs
    the ring.  A tp mesh sets ``tp_mesh``; tp must divide the heads and the
    intermediate size.  (The JAX config also names the mesh the kernels'
    shard_map wrappers run on; a rank here calls the kernels on its heads,
    the fold of their seed in ``DropoutRng.seed_offset``.)"""
    axis = getattr(mesh, "axis", None)
    if mesh is None or axis is None or mesh.size <= 1 or axis == "pp":
        # A pp rank runs whole layers of its stage on whole rows
        # (parallel/pipeline.py).
        return cfg
    if axis == "sp":
        if cfg.num_attention_heads % mesh.size:
            raise ValueError(f"sp={mesh.size} must divide "
                             f"num_attention_heads={cfg.num_attention_heads}")
        return cfg.replace(sp_mesh=mesh)
    if axis == "cp":
        return cfg.replace(cp_mesh=mesh, use_fused_attention=False,
                           use_flash_attention=False)
    if cfg.num_attention_heads % mesh.size or cfg.intermediate_size % mesh.size:
        raise ValueError(f"tp={mesh.size} must divide num_attention_heads="
                         f"{cfg.num_attention_heads} and intermediate_size="
                         f"{cfg.intermediate_size}")
    return cfg.replace(tp_mesh=mesh)


def _dense(in_features: int, out_features: int, cfg: BertConfig,
           tp: str | None = None) -> Dense:
    """A BERT Dense; under a tp mesh the layer's split ``tp`` ("qkv",
    "col" or "row", :func:`parallel.shard_params_rules`) makes it a
    :class:`ParallelDense`."""
    if tp is not None and cfg.tp_mesh is not None:
        return ParallelDense(in_features, out_features, cfg, tp)
    return Dense(in_features, out_features, dtype=cfg.dtype,
                 init_std=cfg.initializer_range)


class ParallelDense(Dense):
    """This rank's block of a tensor-parallel Dense (Megatron): a column
    split ("qkv": the q, k and v rows of this rank's heads; "col": a
    contiguous block of the output rows) takes its input through
    ``copy_to_axis`` (identity forward, gradient all-reduced over tp) and
    outputs its block of the features; a row split ("row": a contiguous
    block of the input columns) sums its partial product over tp
    (``reduce_from_axis``) and adds its replicated bias once, after the
    all-reduce."""

    def __init__(self, in_features: int, out_features: int, cfg: BertConfig, kind: str):
        tp = cfg.tp_mesh.size
        if kind == "row":
            in_features //= tp
        else:
            out_features //= tp
        super().__init__(in_features, out_features, dtype=cfg.dtype,
                         init_std=cfg.initializer_range)
        self.tp_kind, self.mesh = kind, cfg.tp_mesh

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A column split's input, its gradient summed over tp."""
        return copy_to_axis(x, self.mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_kind != "row":
            return super().forward(self.enter(x))
        dt = self.dtype
        y = reduce_from_axis(F.linear(x.to(dt), self.weight.to(dt)), self.mesh)
        return y + self.bias.to(dt)


def _embed(num: int, cfg: BertConfig) -> Embed:
    return Embed(num, cfg.hidden_size, dtype=cfg.dtype,
                 init_std=cfg.initializer_range)


class FusedResidualLayerNorm(nn.Module):
    """``LayerNorm(x [+ residual])`` through the K2 kernel; output in x's
    dtype (the kernel's semantics: residual added in fp32)."""

    def __init__(self, cfg: BertConfig, hidden: int):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x, residual=None):
        return fused_add_layernorm(x, residual, self.weight, self.bias, self.eps)

    def initial_params(self, g: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` math in plain PyTorch (fast
    variance, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``) of
    ``x [+ residual]``, the sum taken in the input dtype; fp32 output.  The
    optional image LayerNorm, and every LayerNorm with
    ``use_fused_layernorm`` off (the JAX package's FusedResidualLayerNorm
    fallback); not a kernel in either package."""

    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x, residual=None):
        if residual is not None:
            x = x + residual
        h = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = h.mean(dim=-1, keepdim=True)
        var = torch.clamp((h * h).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (h - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias

    def initial_params(self, g: torch.Generator) -> dict:
        return {"weight": torch.ones(self.weight.shape),
                "bias": torch.zeros(self.bias.shape)}


def _layer_norm(cfg: BertConfig, hidden: int) -> nn.Module:
    """The model's residual LayerNorm: the K2 kernel, or flax's math with
    ``use_fused_layernorm`` off."""
    if cfg.use_fused_layernorm:
        return FusedResidualLayerNorm(cfg, hidden)
    return FlaxLayerNorm(hidden, cfg.layer_norm_eps)


class BertEmbeddings(nn.Module):
    """Position + token-type embeddings added to the (shared) word
    embeddings, then the embedding LayerNorm (no residual)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.position_embeddings = _embed(cfg.max_position_embeddings, cfg)
        self.token_type_embeddings = _embed(cfg.type_vocab_size, cfg)
        self.layer_norm = _layer_norm(cfg, cfg.hidden_size)
        self.dropout_prob = cfg.hidden_dropout_prob

    def forward(self, word_emb, position_ids, token_type_ids,
                rng: DropoutRng | None = None):
        emb = word_emb + self.position_embeddings(position_ids)
        emb = emb + self.token_type_embeddings(token_type_ids)
        return maybe_drop(self.layer_norm(emb), self.dropout_prob, rng)


def _tokens_to_heads(qkv, mesh, heads: int, d: int):
    """The sp reshard before attention (all-to-all #1): this rank's
    (B, S/sp, 3 H D) projection -> q, k, v of its H/sp heads over the whole
    sequence, packed (B, S, (H/sp) D) views of one buffer (a contiguous head
    group each, the JAX packed wrapper's column shard)."""
    x = qkv.unflatten(-1, (3, mesh.size, heads // mesh.size, d)).permute(3, 0, 1, 2, 4, 5)
    x = all_to_all(x, mesh).permute(1, 0, 2, 3, 4, 5)  # (B, sp, S/sp, 3, H/sp, D)
    x = x.reshape(x.shape[0], -1, 3, x.shape[4] * d)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def _heads_to_tokens(ctx, mesh):
    """The sp reshard after attention (all-to-all #2): this rank's heads
    over the whole sequence, (B, S, H/sp, D) -> its tokens with every head,
    (B, S/sp, H D)."""
    b, s, hl, d = ctx.shape
    x = ctx.reshape(b, mesh.size, s // mesh.size, hl, d).permute(1, 0, 2, 3, 4)
    x = all_to_all(x, mesh)  # (sp: head groups, B, S/sp, H/sp, D)
    return x.permute(1, 2, 0, 3, 4).reshape(b, s // mesh.size, mesh.size * hl * d)


class BertSelfAttention(nn.Module):
    """Self-attention over the fused QKV projection.  Under tp the
    projection holds this rank's heads (H/tp); under sp the projection runs
    on this rank's tokens and two all-to-alls put its H/sp heads over the
    whole sequence around attention; under cp the ring runs on its tokens
    (JAX BertSelfAttention's dispatch)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg.hidden_size, 3 * cfg.hidden_size, cfg, tp="qkv")
        tp = 1 if cfg.tp_mesh is None else cfg.tp_mesh.size
        self.heads = cfg.num_attention_heads // tp  # this rank's projection's heads

    def forward(self, hidden, key_bias, history_state=None,
                rng: DropoutRng | None = None):
        cfg = self.cfg
        heads = cfg.num_attention_heads  # the model's H
        d = cfg.hidden_size // heads
        width = self.heads * d
        if history_state is None:
            qkv = self.qkv(hidden)
            if cfg.sp_mesh is not None:
                q, k, v = _tokens_to_heads(qkv, cfg.sp_mesh, heads, d)
            else:
                q, k, v = qkv.split(width, dim=-1)
        else:
            if cfg.token_mesh is not None:
                raise ValueError("history states do not run on an sp or cp mesh")
            # Queries over the fresh tokens through the first third of the
            # QKV weight, keys and values over history + fresh through the
            # other two (modeling_bert.py:37-45).
            enter = getattr(self.qkv, "enter", lambda x: x)
            dt = cfg.dtype
            w, b = self.qkv.weight.to(dt), self.qkv.bias.to(dt)
            fresh = enter(hidden).to(dt)
            q = F.linear(fresh, w[:width], b[:width])
            kv_in = torch.cat([enter(history_state).to(dt), fresh], dim=1)
            k, v = F.linear(kv_in, w[width:], b[width:]).split(width, dim=-1)
        h = q.shape[-1] // d  # the heads attention runs on here
        s = q.shape[1]
        rate = 0.0 if rng is None else float(cfg.attention_probs_dropout_prob)
        split = lambda t: t.unflatten(-1, (h, d)).transpose(1, 2)  # noqa: E731
        if cfg.cp_mesh is not None:
            if history_state is not None or not attention_supports_ring(
                    cfg.cp_mesh, s * cfg.cp_mesh.size, s * cfg.cp_mesh.size):
                raise ValueError(f"the ring does not take a {s}-token block here")
            seed = rng.seed() if rate > 0.0 else None
            lo = cfg.cp_mesh.axis_index * s
            ctx = ring_attention(split(q), split(k), split(v),
                                 key_bias[:, lo:lo + s].contiguous(), seed, rate,
                                 mesh=cfg.cp_mesh)
            return ctx.transpose(1, 2).flatten(2).to(cfg.dtype)
        # With history the JAX package's fused_ok is false: plain attention.
        fused = (history_state is None and cfg.use_fused_attention
                 and attention_supports_fused(s, s, d))
        flash = (history_state is None and not fused and cfg.use_flash_attention
                 and attention_supports_flash(s, s, d))
        seed = rng.seed() if (fused or flash) and rate > 0.0 else None
        if fused and cfg.fused_packed_layout and s <= cfg.fused_packed_max_seq:
            out = fused_attention_packed(q, k, v, key_bias, h, seed, rate)
            return self._out(out.unflatten(-1, (h, d)))
        if fused:
            ctx = fused_attention(split(q), split(k), split(v), key_bias, seed, rate)
        elif flash:
            ctx = flash_attention(split(q), split(k), split(v), key_bias, seed, rate)
        else:
            # Under tp the replicated mask generator draws the mask of every
            # head, and this rank keeps its heads' (the JAX package draws
            # one mask over all H heads).
            tp = cfg.tp_mesh
            block = None if tp is None else (tp.axis_index * h, heads)
            ctx = multi_head_attention(split(q), split(k), split(v),
                                       bias=key_bias[:, None, None, :],
                                       dropout_rate=rate,
                                       generator=None if rng is None else rng.masks,
                                       head_block=block)
        return self._out(ctx.transpose(1, 2))

    def _out(self, ctx):
        """(B, S, h, D) attention output -> (B, S, h D) in the compute dtype;
        under sp, back to this rank's tokens with every head."""
        if self.cfg.sp_mesh is not None:
            return _heads_to_tokens(ctx, self.cfg.sp_mesh).to(self.cfg.dtype)
        return ctx.flatten(2).to(self.cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.attention = BertSelfAttention(cfg)
        self.attention_output = _dense(h, h, cfg, tp="row")
        self.attention_layer_norm = _layer_norm(cfg, h)
        self.intermediate = _dense(h, cfg.intermediate_size, cfg, tp="col")
        self.output = _dense(cfg.intermediate_size, h, cfg, tp="row")
        self.output_layer_norm = _layer_norm(cfg, h)

    def forward(self, hidden, key_bias, history_state=None,
                rng: DropoutRng | None = None):
        dt = self.cfg.dtype
        p = self.cfg.hidden_dropout_prob
        attn = self.attention_output(self.attention(hidden, key_bias, history_state, rng))
        hidden = self.attention_layer_norm(maybe_drop(attn, p, rng), hidden).to(dt)
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        out = maybe_drop(self.output(inter), p, rng)
        return self.output_layer_norm(out, hidden).to(dt)


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of ``remat``: keep the outputs of the 2-D
    products (jax.checkpoint_policies.dots_with_no_batch_dims_saveable: the
    Denses), recompute everything else (attention, LayerNorms, gelu,
    dropout)."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(layer: nn.Module, hidden, key_bias, history_state,
                 rng: DropoutRng | None):
    """``layer(hidden, key_bias, history_state, rng=rng)`` under a selective
    checkpoint.

    The recompute runs in the backward, after any ``functional_call`` around
    the model has put its parameters back, so the layer's parameters (the
    live tensors, under such a call) go in as arguments.  Its randomness
    must replay too: the kernels' seeds and the hidden-dropout masks come
    from ``rng``'s generators, which checkpoint's RNG preservation does not
    cover.  So the layer draws from generators that start at ``rng``'s
    states on every run, and ``rng`` then moves on as one run moved it."""
    names, params = zip(*layer.named_parameters())
    replay = None
    if rng is not None:
        states = (rng.masks.get_state(), rng.seeds.get_state())
        replay = DropoutRng(masks=torch.Generator(device=rng.masks.device),
                            seeds=torch.Generator(), seed_offset=rng.seed_offset)

    def run(h, kb, hs, *ps):
        if replay is not None:
            replay.masks.set_state(states[0])
            replay.seeds.set_state(states[1])
        return functional_call(layer, dict(zip(names, ps)), (h, kb, hs), {"rng": replay})

    out = checkpoint(run, hidden, key_bias, history_state, *params, use_reentrant=False,
                     preserve_rng_state=False,
                     context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                  _save_products))
    if rng is not None:
        rng.masks.set_state(replay.masks.get_state())
        rng.seeds.set_state(replay.seeds.get_state())
    return out


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_layers = cfg.num_hidden_layers
        self.remat = cfg.remat
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", BertLayer(cfg))

    def forward(self, hidden, key_bias, history_states=None,
                rng: DropoutRng | None = None):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            hs = None if history_states is None else history_states[i]
            if self.remat and torch.is_grad_enabled():
                hidden = _remat_layer(layer, hidden, key_bias, hs, rng)
            else:
                hidden = layer(hidden, key_bias, hs, rng=rng)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = _dense(cfg.hidden_size, cfg.hidden_size, cfg)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class VisitronBert(nn.Module):
    """BertImgModelwithLocationEmbeds parity (encoder.py:161-303).

    Joint sequence = [text tokens] ++ [projected image regions]; returns
    (sequence_output, pooled_output).  ``attend_vocab`` is the transposed
    word-embedding product of the tied MLM decoder (encoder.py:332-335).
    ``image=False`` builds the text-only model (BertTextModel): the flax
    module creates its image projections only where they are called, so the
    text path has none."""

    def __init__(self, cfg: BertConfig, image: bool = True):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = _embed(cfg.vocab_size, cfg)
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        self.pooler = BertPooler(cfg)
        self.image = image
        if image:
            self.img_embedding = _dense(cfg.img_feature_dim, cfg.hidden_size, cfg)
            self.location_embeds = _dense(cfg.location_embed_dim, cfg.hidden_size, cfg)
            if cfg.use_img_layernorm:
                self.img_layer_norm = FlaxLayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def attend_vocab(self, x):
        """(..., H) -> (..., vocab8) logits against the tied word embeddings,
        in ``cfg.dtype`` (flax ``Embed.attend``), at the vocabulary rounded
        up to a multiple of 8 (:func:`aligned_linear`: BERT's 30,522 and
        Oscar's 30,525 rows would put the product and its backward on
        unaligned GEMM kernels).  The first ``vocab`` columns are the
        logits; the pad columns are zero, and the caller keeps them out of
        every softmax."""
        return aligned_linear(x.to(self.cfg.dtype), self.word_embeddings.weight)

    def embed_joint(self, input_ids, token_type_ids=None, attention_mask=None,
                    position_ids=None, img_feats=None, img_location_embeddings=None,
                    history_states=None, rng: DropoutRng | None = None):
        """Everything before the transformer stack: the text embeddings and,
        with ``img_feats``, the image embeddings concatenated after them;
        returns (embeddings in ``cfg.dtype``, (B, K) fp32 key bias).  With
        ``history_states`` the mask gains ones in front over the history
        (always visible) where it does not cover it already.  Under an sp or
        cp mesh the embeddings are this rank's block of the joint sequence
        (``parallel.token_range``: text and image inputs sliced before they
        are embedded, the text with its global position ids); the key bias
        covers the whole sequence."""
        cfg = self.cfg
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if history_states is not None and img_feats is not None:
            raise ValueError("cannot take image features while using encoder history states")
        if img_feats is not None and not self.image:
            raise ValueError("this VisitronBert was built without image projections")
        n_text = input_ids.shape[1]
        n_img = 0 if img_feats is None else img_feats.shape[1]
        lo, hi = token_range(cfg.token_mesh, n_text + n_img)
        parts = []
        if lo < n_text:
            t = slice(lo, min(hi, n_text))
            parts.append(self.embeddings(self.word_embeddings(input_ids[:, t]),
                                         position_ids[:, t], token_type_ids[:, t],
                                         rng).to(cfg.dtype))
        if hi > n_text:
            t = slice(max(lo, n_text) - n_text, hi - n_text)
            img = self.img_embedding(img_feats[:, t].to(cfg.dtype))
            img = img + self.location_embeds(img_location_embeddings[:, t].to(cfg.dtype))
            if cfg.use_img_layernorm:
                img = self.img_layer_norm(img).to(cfg.dtype)
            parts.append(maybe_drop(img, cfg.hidden_dropout_prob, rng))
        emb = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        key_len = n_text + n_img
        if history_states is not None:
            key_len += history_states[0].shape[1]
            if attention_mask.shape[-1] < key_len:
                pad = attention_mask.new_ones(
                    attention_mask.shape[:-1] + (key_len - attention_mask.shape[-1],))
                attention_mask = torch.cat([pad, attention_mask], dim=-1)
        if attention_mask.shape[-1] != key_len:
            raise ValueError(f"attention_mask covers {attention_mask.shape[-1]} tokens, "
                             f"the keys number {key_len}")
        key_bias = make_attention_bias(attention_mask)[:, 0, 0, :].contiguous()
        return emb, key_bias

    def pool(self, seq):
        """The pooled [CLS] output, or None on a rank of an sp or cp mesh
        whose tokens do not hold the first one (its heads add nothing that
        depends on it)."""
        mesh = self.cfg.token_mesh
        if mesh is not None and mesh.axis_index != 0:
            return None
        return self.pooler(seq)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, img_feats=None, img_location_embeddings=None,
                history_states=None, rng: DropoutRng | None = None):
        emb, key_bias = self.embed_joint(input_ids, token_type_ids, attention_mask,
                                         position_ids, img_feats,
                                         img_location_embeddings, history_states, rng)
        seq = self.encoder(emb, key_bias, history_states, rng=rng)
        return seq, self.pool(seq)


class BertTextModel(nn.Module):
    """Text-only view of VisitronBert (used by OscarEncoder); same parameter
    structure (``bert.*``)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = VisitronBert(cfg, image=False)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None, rng: DropoutRng | None = None):
        return self.bert(input_ids, token_type_ids=token_type_ids,
                         attention_mask=attention_mask, position_ids=position_ids,
                         rng=rng)
