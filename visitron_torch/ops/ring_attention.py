"""Context-parallel attention on a rank's share of a (dp, cp) mesh
(visitron_tpu/ops/attention.py: ``_keep_mask4``, ``hash_dropout_attention``,
``attention_supports_ring`` and ``ring_attention``).

``ring_attention`` keeps each rank's query block while the K/V/bias blocks
rotate around the cp row (``parallel.ring_shift``: one batched send/recv
pair a step, the next block's transfer issued before the current block's
products), with an online softmax over the blocks.  As in the JAX package
it is plain tensor operations, differentiable through autograd (the shifts'
backward sends the blocks' gradients back), and its dropout hashes the
absolute (batch, head, query, key) coordinates (``_keep_mask4``), so its
keep masks are those of the single-device ``hash_dropout_attention`` bit
for bit.

(The JAX mesh wrappers of K1, K4 and K5 under tp and sp have no module
here: a rank holds its (B/dp, H/X) block already and calls the kernels'
wrappers on it, with its fold in ``DropoutRng.seed_offset``.)
"""

from __future__ import annotations

import torch

from visitron_torch.ops.attention import _M32, _mul32, _threshold


def _keep_mask4(seed_u32: int, b0: int, row0: int, col0: int, shape, threshold: int,
                device=None) -> torch.Tensor:
    """Keep mask of a (B, H, Q, K) block whose first element sits at the
    absolute (b0, 0, row0, col0): the murmur3-finaliser hash of the absolute
    (batch, head, query, key) coordinates (uint32 arithmetic held in int64,
    as ``ops.attention._keep_mask``)."""
    b, h, q, k = shape
    ar = lambda n, o: (torch.arange(n, dtype=torch.int64, device=device) + o) & _M32  # noqa: E731
    bi, hi, r, c = ar(b, b0), ar(h, 0), ar(q, row0), ar(k, col0)
    s = (int(seed_u32) & _M32) ^ _mul32(bi, 0xC2B2AE3D)[:, None] ^ _mul32(hi, 0x27D4EB2F)[None, :]
    x = _mul32(r, 0x9E3779B1)[:, None] ^ _mul32(c, 0x85EBCA77)[None, :]
    x = x[None, None] ^ s[:, :, None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= threshold


def hash_dropout_attention(q, k, v, key_bias, seed, rate: float):
    """The single-device oracle of :func:`ring_attention`: plain attention
    of (B, H, S, D) q/k/v with a (B, S) key bias, its probabilities dropped
    by the position hash over global coordinates."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    probs = torch.softmax(s + key_bias[:, None, None, :].to(ct), dim=-1)
    if rate > 0.0:
        keep = _keep_mask4(seed, 0, 0, 0, probs.shape, _threshold(rate), probs.device)
        probs = torch.where(keep, probs, 0.0) / (1.0 - rate)
    return torch.matmul(probs.to(v.dtype).to(ct), v.to(ct)).to(v.dtype)


def attention_supports_ring(mesh, q_len: int, k_len: int) -> bool:
    """Gate of :func:`ring_attention`: a cp mesh with cp > 1 and
    self-attention over a joint sequence of ``q_len`` tokens that cp
    divides (the rank's block is q_len / cp).  Heads are unconstrained."""
    return (getattr(mesh, "axis", None) == "cp" and mesh.size > 1
            and q_len == k_len and q_len % mesh.size == 0)


def ring_attention(q, k, v, key_bias, seed=None, rate: float = 0.0, *, mesh):
    """Attention of this rank's (B/dp, H, S/cp, D) query block over the
    whole sequence, its K/V blocks and (B/dp, S/cp) key-bias block rotating
    around the cp row; returns this rank's (B/dp, H, S/cp, D) output in q's
    dtype.  ``seed`` (required at ``rate`` > 0) is the one seed of every
    rank: the mask hashes absolute coordinates."""
    from visitron_torch.parallel.mesh import ring_shift

    if rate > 0.0 and seed is None:
        raise ValueError("ring_attention: rate > 0 requires a seed (refusing a "
                         "silent constant seed)")
    cp, my = mesh.size, mesh.axis_index
    b_loc, _, s_loc, d = q.shape
    b0, row0 = mesh.dp_index * b_loc, my * s_loc
    ct = torch.promote_types(q.dtype, torch.float32)
    thr = _threshold(rate) if rate > 0.0 else 0
    qf = q.to(ct) * (1.0 / float(d) ** 0.5)
    m = torch.full(q.shape[:3], float("-inf"), dtype=ct, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=ct, device=q.device)  # noqa: E741
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=ct, device=q.device)
    kb, vb, bb = k, v, key_bias
    for i in range(cp):
        shift = ring_shift([kb, vb, bb], mesh) if i + 1 < cp else None
        blk = (my + i) % cp  # the global block of the K/V held now
        s = torch.matmul(qf, kb.to(ct).transpose(-1, -2)) + bb[:, None, None, :].to(ct)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        if rate > 0.0:
            keep = _keep_mask4(seed, b0, row0, blk * s_loc, p.shape, thr, p.device)
            p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - rate))
        acc = acc * alpha[..., None] + torch.matmul(p.to(vb.dtype).to(ct), vb.to(ct))
        m = m_cur
        if shift is not None:
            kb, vb, bb = shift.finish()
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    return (acc * l_inv[..., None]).to(q.dtype)
