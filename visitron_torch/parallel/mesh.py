"""Parallelism across processes: the process group, the (dp, tp|sp|cp|pp)
mesh, the shard rules of ZeRO-1, FSDP and tensor parallelism, and the
collectives of a training step (visitron_tpu/parallel/mesh.py; the pp mesh
is visitron_tpu/parallel/pipeline.py's ``make_pp_mesh``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``: XLA
inserts the gradient all-reduce, ZeRO-1 / FSDP are placements that the
partitioner turns into reduce-scatters and all-gathers, and the tp, sp and
cp axes are sharding constraints and shard_map regions.  Here every rank is
one process with one device (``python -m torch.distributed.run
--nproc_per_node N``), and the collectives are explicit, issued from this
module alone:

  * :func:`init_process_group` joins the group that torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or the caller describes: NCCL on ``cuda:LOCAL_RANK``,
    gloo only when the caller asks for the CPU (or names gloo);
    :func:`destroy_process_group` leaves it.  A group that does not form
    raises; nothing falls back to one process;
  * :class:`Mesh` is a (dp, X) grid over every rank of the group, X being
    the size of a second axis ``tp`` (tensor parallelism), ``sp`` (Ulysses
    sequence parallelism), ``cp`` (ring-attention context parallelism) or
    ``pp`` (pipeline stages, ``parallel/pipeline.py``), 1 for a dp-only
    mesh.  Rank r sits at (r // X, r % X), the row-major grid
    of ``mesh_utils.create_device_mesh``; the mesh holds one process group
    per dp column (``dp_group``: the ranks of one axis index) and per row
    (``axis_group``: the ranks of one dp index), made by every rank in the
    same order (:func:`make_mesh`, :func:`make_sp_mesh`,
    :func:`make_cp_mesh`, :func:`make_pp_mesh`, :func:`maybe_mesh`);
  * :func:`all_reduce_sum` sums a list of tensors over a group in flat
    buckets of at most ``BUCKET_BYTES``; :func:`reduce_scatter` and
    :func:`all_gather` move leaves sharded on an axis, also through one flat
    buffer per dtype; :func:`all_to_all` (sp's tokens <-> heads reshards),
    :func:`ring_shift` (cp's send/recv pair), :func:`copy_to_axis` /
    :func:`reduce_from_axis` (tp's two Megatron operators),
    :func:`send_next` / :func:`recv_prev` and :func:`send_prev` /
    :func:`recv_next` (pp's stage-to-stage transfers, activations forward
    and their gradients back), :func:`broadcast` (``replicate_state``) and
    :func:`all_gather_object` complete the set.  Each keeps a call counter,
    ``<helper>.calls``, raised by one per collective it issues (the kernel
    wrappers' ``launches`` counterpart); a group that cannot carry a
    collective raises.  The ring's and the stages' sends and receives go
    through one point-to-point helper, :func:`p2p`, which stages a CUDA
    tensor through the host under gloo, whose send/recv take host memory
    only: chosen by the backend's name and the device, never after a failed
    try, and counted (:func:`p2p_host_staged`);
  * the shard rules: over dp, a leaf is sharded on the first axis, in the
    JAX package's layout, whose size is >= dp and divisible by dp; leaves
    that no axis fits, and every leaf at dp 1, stay replicated
    (``zero1_opt_rules`` / ``fsdp_param_rules`` / ``fsdp_opt_rules``).  The
    port stores Dense kernels transposed (out, in), so the rules walk a
    Dense weight's axes in the order (1, 0) (:func:`jax_axis_orders`).
    Over tp, :func:`shard_params_rules` names the four Dense kernels of a
    BERT layer that split (the modules' ``tp_kind``);
  * :class:`DataParallel` is what a trainer's step does around its forward
    and backward under a mesh: the global counts, the gradient all-reduce
    (dp, ZeRO-1) or reduce-scatter (FSDP) over the ranks that shard the
    data, the sharded optimizer update with the global-norm clip summed
    over the shards, the parameter all-gather, and the gather to and the
    shard from a checkpoint's single-device layout.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# The larger of a bucket's leaves, or this many bytes: a bucket is one
# collective over one flat buffer (the extra copy of the gradients is at
# most this large at a time).
BUCKET_BYTES = 256 << 20

# The dropout seed fold of the JAX mesh wrappers: seed + dp_index * 1000003
# + head_axis_index * 7919 (ops/attention.py:456, :956, :999).
DP_SEED_STRIDE = 1000003
AXIS_SEED_STRIDE = 7919


# -- the process group ----------------------------------------------------------------

def launched_by_torchrun() -> bool:
    """Whether torchrun's environment describes this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device=None, *, backend: str | None = None,
                       init_method: str | None = None, rank: int | None = None,
                       world_size: int | None = None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the run's process group and return this rank's device.

    ``device`` None is ``cuda:LOCAL_RANK`` with NCCL; a CPU device takes
    gloo.  ``backend`` names the backend instead (gloo with CUDA tensors is
    what two ranks sharing one card use).  ``init_method`` / ``rank`` /
    ``world_size`` default to torchrun's ``env://`` rendezvous."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: a CUDA device was asked for and none "
                               "is available; pass device='cpu' for gloo on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"backend": backend, "timeout": datetime.timedelta(seconds=timeout_s)}
    if init_method is not None:
        kw.update(init_method=init_method, rank=rank, world_size=world_size)
    elif rank is not None or world_size is not None:
        kw.update(rank=rank, world_size=world_size)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return dev


def destroy_process_group() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard_info(mesh: Mesh | None) -> tuple[int, int]:
    """(host_id, num_hosts) for per-host data sharding: ``mesh``'s (dp
    index, dp) -- the ranks of one dp row read the same rows -- (0, 1)
    without a mesh."""
    return (0, 1) if mesh is None else (mesh.dp_index, mesh.dp)


# -- the mesh ----------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, ``axis``) grid over the ranks of the default process group:
    ``dp`` rows of ``size`` ranks, this process being ``rank``, on
    ``device``.  ``axis`` is "tp", "sp", "cp" or "pp" (None, and ``size`` 1,
    for a dp-only mesh).  ``dp_group`` holds the ranks of this rank's axis index
    (its dp column), ``axis_group`` those of its dp index (its row); None is
    the default group.  A Mesh built by hand, without a group, serves the
    seed-fold, rule and slicing functions of a given rank."""

    dp: int
    rank: int
    device: torch.device
    axis: str | None = None
    size: int = 1
    dp_group: object = None
    axis_group: object = None

    @property
    def backend(self) -> str:
        return dist.get_backend()

    @property
    def dp_index(self) -> int:
        return self.rank // self.size

    @property
    def axis_index(self) -> int:
        return self.rank % self.size

    @property
    def world(self) -> int:
        return self.dp * self.size

    @property
    def tp(self) -> int:
        """The tp size: the second axis's where it is tp, else 1."""
        return self.size if self.axis == "tp" else 1

    @property
    def tokens_sharded(self) -> bool:
        """Whether the second axis shards the tokens (sp, cp): then the
        ranks of a row hold different tokens of the same rows."""
        return self.axis in ("sp", "cp") and self.size > 1

    def fold_seed(self, seed: int) -> int:
        """``seed`` for this rank's share of the activations: seed + dp_index
        x 1000003, as the JAX mesh wrappers fold dp_index into the kernels'
        dropout seed, plus axis_index x 7919 where the axis shards the tokens
        (sp, cp) or the layers (pp: a stage's ranks hold other layers of the
        same rows, and draw their own masks, as the JAX pipeline folds the
        stage into its dropout key, visitron_tpu/parallel/pipeline.py:152-154).
        The ranks of a tp row hold the same (replicated) activations, so
        their hidden-dropout masks and sampled actions are drawn alike.  The
        port folds the hidden-dropout and sampling generators' seeds this
        way."""
        out = int(seed) + self.dp_index * DP_SEED_STRIDE
        if self.tokens_sharded or self.axis == "pp":
            out += self.axis_index * AXIS_SEED_STRIDE
        return out

    def kernel_seed(self, seed: int) -> int:
        """The attention kernels' dropout seed on this rank's head shard:
        seed + dp_index x 1000003 + axis_index x 7919 (the JAX mesh
        wrappers' fold; the kernels read its low 32 bits, so the int32
        wrap-around of the JAX sum gives the same bits).  ``seed`` itself
        under cp, whose ring hashes absolute coordinates.  Under pp the same
        fold gives each stage of each dp row its own seeds; the microbatches
        of a stage draw one after the other from its seed generator, so every
        (microbatch, layer, stage, dp shard) hashes its own keep mask, where
        the JAX pipeline folds (step, stage) and the dp index into its key
        (pipeline.py:152-154, :243-249): the two agree in distribution."""
        if self.axis == "cp":
            return int(seed)
        return int(seed) + self.dp_index * DP_SEED_STRIDE + self.axis_index * AXIS_SEED_STRIDE


def _grid(dp: int | None, axis: str | None, size: int, device) -> Mesh:
    """The (dp, ``axis``) mesh over every rank of the process group, with
    its column and row groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "python -m torch.distributed.run, or call "
                           "visitron_torch.parallel.init_process_group")
    if size < 1:
        raise ValueError(f"--mesh_{axis} must be >= 1, got {size}")
    world = dist.get_world_size()
    if world % size:
        raise ValueError(f"the world size {world} is not a multiple of {axis} {size}")
    if dp is not None and dp * size != world:
        raise ValueError(f"--mesh_dp {dp} x {axis or 'tp'} {size} differs from the world "
                         f"size {world}: the port's mesh spans every rank (--mesh_dp 0 "
                         "means the whole world)")
    dp, rank = world // size, dist.get_rank()
    if device is None:  # NCCL's device, or gloo's default, the CPU
        device = ("cpu" if dist.get_backend() == "gloo"
                  else torch.device("cuda", torch.cuda.current_device()))
    dp_group = axis_group = None
    if size > 1:
        # Every rank makes every group, in the same order: the columns, then
        # the rows.
        for a in range(size):
            g = dist.new_group([d * size + a for d in range(dp)])
            if rank % size == a:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * size + a for a in range(size)])
            if rank // size == d:
                axis_group = g
    return Mesh(dp=dp, rank=rank, device=torch.device(device),
                axis=axis if size > 1 else None, size=size, dp_group=dp_group,
                axis_group=axis_group)


def make_mesh(dp: int | None = None, tp: int = 1, device=None) -> Mesh:
    """The (dp, tp) mesh over every rank of the initialised process group,
    on ``device`` (None: NCCL's current card, or the CPU under gloo).
    ``dp`` None, or world / tp; any other count is refused (the JAX package
    idles the devices a smaller mesh leaves out, the port has no idle
    ranks)."""
    return _grid(dp, "tp", tp, device)


def make_sp_mesh(dp: int | None, sp: int, device=None) -> Mesh:
    """A (dp, sp) mesh: data-parallel rows of sequence-parallel groups
    (visitron_tpu/parallel/mesh.py:make_sp_mesh).  The tokens of every
    activation are sharded over sp, and self-attention reshards tokens to
    heads and back with two all-to-alls a layer; parameters stay
    replicated."""
    return _grid(dp, "sp", sp, device)


def make_cp_mesh(dp: int | None, cp: int, device=None) -> Mesh:
    """A (dp, cp) mesh: data-parallel rows of ring-attention groups
    (visitron_tpu/parallel/mesh.py:make_cp_mesh).  The tokens stay sharded
    over cp through attention itself: the K/V shards rotate around the row
    (``ops/ring_attention.ring_attention``); parameters stay replicated."""
    return _grid(dp, "cp", cp, device)


def make_pp_mesh(dp: int | None, pp: int, device=None) -> Mesh:
    """A (dp, pp) mesh: data-parallel rows of pp-stage pipelines
    (visitron_tpu/parallel/pipeline.py:make_pp_mesh).  Rank r holds stage
    r % pp of dp row r // pp: the row group is one pipeline, whose ranks
    pass activations down and gradients up (:func:`send_next` and its
    peers), the column group the ranks of one stage, over which its
    gradients are averaged.  ``dp`` None, or world / pp."""
    return _grid(dp, "pp", pp, device)


def maybe_mesh(dp: int = 0, tp: int = 1, device=None) -> Mesh | None:
    """The run's (dp, tp) mesh from ``--mesh_dp`` / ``--mesh_tp``: None
    without a process group (one process, nothing to shard), else
    :func:`make_mesh` over the whole world (``dp`` 0 or world / tp)."""
    if not dist.is_initialized():
        if dp in (0, 1) and tp == 1:
            return None
        n = max(dp, 1) * tp
        raise ValueError(f"--mesh_dp {dp} --mesh_tp {tp} needs {n} ranks: launch with "
                         f"python -m torch.distributed.run --nproc_per_node {n}")
    return make_mesh(dp=dp or None, tp=tp, device=device)


def is_primary(mesh: Mesh | None) -> bool:
    """Whether this process writes the run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        dist.barrier()


def _group(mesh: Mesh, over: str) -> tuple[object, int, int]:
    """(process group, its size, this rank's index in it) of ``over``:
    "dp" (this rank's column), "axis" (its row), "world", or "data" (the
    ranks that shard the data: the world where the axis shards the tokens,
    else the dp column)."""
    if over == "data":
        over = "world" if mesh.tokens_sharded else "dp"
    if over == "dp":
        return mesh.dp_group, mesh.dp, mesh.dp_index
    if over == "axis":
        if mesh.size == 1:
            raise ValueError("a dp-only mesh has no second axis")
        return mesh.axis_group, mesh.size, mesh.axis_index
    if over == "world":
        return None, mesh.world, mesh.rank
    raise ValueError(f"unknown group {over!r}")


# -- collectives ----------------------------------------------------------------------------

# reduce_scatter_single / all_gather_single are the newer names of the same
# operations (reduce_scatter_tensor / all_gather_into_tensor).
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _buckets(tensors: list, limit: int | None = None) -> list[list[int]]:
    """Indices of ``tensors`` in buckets of one dtype and at most ``limit``
    (default ``BUCKET_BYTES``) bytes (a larger tensor is a bucket of its
    own), in order."""
    limit = BUCKET_BYTES if limit is None else limit
    out, open_ = [], {}
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        cur = open_.get(t.dtype)
        if cur is None or cur[1] + nbytes > limit:
            cur = [[], 0]
            open_[t.dtype] = cur
            out.append(cur)
        cur[0].append(i)
        cur[1] += nbytes
    return [idx for idx, _ in out]


def _aligned(n: int, t: torch.Tensor) -> int:
    """``n`` elements of ``t``'s dtype rounded up to a multiple of 16 bytes."""
    step = max(16 // t.element_size(), 1)
    return -(-n // step) * step


def all_reduce_sum(tensors: list, mesh: Mesh, over: str = "dp") -> list:
    """The elementwise sum over the ranks of group ``over`` (see
    :func:`_group`; "dp": the whole world on a dp-only mesh) of each tensor
    in ``tensors`` (new tensors, views of the reduced flat buckets; None
    entries stay None).  Each view starts on a 16-byte boundary of its
    bucket, as a tensor of its own would, so that vectorised kernels can
    read it."""
    group = _group(mesh, over)[0]
    out = list(tensors)
    live = [i for i, t in enumerate(tensors) if t is not None]
    for bucket in _buckets([tensors[i] for i in live]):
        idx = [live[j] for j in bucket]
        sizes = [_aligned(tensors[i].numel(), tensors[i]) for i in idx]
        pad = tensors[idx[0]].new_zeros(16)
        pieces = []
        for i, size in zip(idx, sizes):
            pieces.append(tensors[i].reshape(-1))
            if size > tensors[i].numel():
                pieces.append(pad[:size - tensors[i].numel()])
        flat = torch.cat(pieces)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        all_reduce_sum.calls += 1
        for i, part in zip(idx, flat.split(sizes)):
            out[i] = part[:tensors[i].numel()].view(tensors[i].shape)
    return out


all_reduce_sum.calls = 0


def global_sum(x: torch.Tensor, mesh: Mesh | None, over: str = "data") -> torch.Tensor:
    """``x`` summed over the ranks that shard the data (a count over the
    global batch); ``x`` itself without a mesh."""
    if mesh is None:
        return x
    return all_reduce_sum([x], mesh, over)[0]


def _moved(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``t`` as (n, rest): its ``axis`` first, split into n blocks."""
    return t.movedim(axis, 0).reshape(n, -1)


def reduce_scatter(tensors: list, axes: list, mesh: Mesh, over: str = "dp") -> list:
    """Each ``tensors[i]`` summed over the ranks of ``over``, and this
    rank's block of it on ``axes[i]`` (the dp shard), through one flat
    buffer per dtype."""
    group, n, _ = _group(mesh, over)
    out = [None] * len(tensors)
    for bucket in _buckets(tensors, limit=1 << 62):
        rows = torch.cat([_moved(tensors[i], axes[i], n) for i in bucket], dim=1)
        flat = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
        _reduce_scatter_flat(flat, rows.reshape(-1), op=dist.ReduceOp.SUM, group=group)
        reduce_scatter.calls += 1
        for i, part in zip(bucket, flat.split([tensors[i].numel() // n for i in bucket])):
            shape = list(tensors[i].shape)
            shape[axes[i]] //= n
            out[i] = part.view([shape[axes[i]]] + shape[:axes[i]]
                               + shape[axes[i] + 1:]).movedim(0, axes[i])
    return out


reduce_scatter.calls = 0


def all_gather(shards: list, axes: list, mesh: Mesh, over: str = "dp") -> list:
    """The full tensors whose blocks on ``axes[i]``, in the order of the
    ranks of ``over``, are the ranks' ``shards[i]`` (None entries stay
    None), through one flat buffer per dtype."""
    group, n, _ = _group(mesh, over)
    out = list(shards)
    live = [i for i, s in enumerate(shards) if s is not None]
    for bucket in _buckets([shards[i] for i in live], limit=1 << 62):
        idx = [live[j] for j in bucket]
        flat = torch.cat([shards[i].movedim(axes[i], 0).reshape(-1) for i in idx])
        rows = torch.empty((n, flat.numel()), dtype=flat.dtype, device=flat.device)
        _all_gather_flat(rows.view(-1), flat, group=group)
        all_gather.calls += 1
        for i, part in zip(idx, rows.split([shards[i].numel() for i in idx], dim=1)):
            moved = list(shards[i].movedim(axes[i], 0).shape)
            full = part.reshape([n * moved[0]] + moved[1:])
            out[i] = full.movedim(0, axes[i]).contiguous()
    return out


all_gather.calls = 0


def broadcast(tensors: list, mesh: Mesh, src: int = 0) -> list:
    """Rank ``src``'s values of ``tensors`` on every rank (new tensors)."""
    out = list(tensors)
    for bucket in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        dist.broadcast(flat, src=src)
        broadcast.calls += 1
        for i, part in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
            out[i] = part.view(tensors[i].shape).clone()
    return out


broadcast.calls = 0


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's ``obj``, in rank order."""
    got = [None] * mesh.world
    dist.all_gather_object(got, obj)
    all_gather_object.calls += 1
    return got


all_gather_object.calls = 0


def _exchange(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One ``all_to_all_single`` over ``mesh``'s row: block i of ``x``'s
    axis 0 goes to the row's rank i, and block i of the result came from
    it."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.axis_group)
    all_to_all.calls += 1
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange` in both directions: equal blocks make the exchange
    its own adjoint."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _exchange(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.mesh), None


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-to-all over ``mesh``'s row (sp's reshard): ``x``'s
    axis 0, of the row's size, holds the blocks to send, rank i's first;
    the result holds the blocks received, from rank i at i."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all: axis 0 of {tuple(x.shape)} must be the "
                         f"{mesh.axis} size {mesh.size}")
    return _AllToAll.apply(x, mesh)


all_to_all.calls = 0


def _neighbours(mesh: Mesh, step: int) -> tuple[int, int]:
    """(the global rank this rank sends to, the one it receives from) when
    blocks move ``step`` places down the row (step 1: rank a receives from
    a + 1 and sends to a - 1, the JAX ring's ppermute)."""
    base, a, n = mesh.dp_index * mesh.size, mesh.axis_index, mesh.size
    return base + (a - step) % n, base + (a + step) % n


def _staged(backend: str, device) -> bool:
    """Whether a send or receive of a tensor on ``device`` goes through the
    host: under gloo with a CUDA tensor (gloo's send/recv read and write host
    memory only; a CUDA tensor aborts the rank).  Chosen by the backend's
    name and the device alone, never after a failed try."""
    return torch.device(device).type == "cuda" and backend == "gloo"


def p2p_host_staged(t: torch.Tensor, device="cpu") -> torch.Tensor:
    """``t`` copied to ``device`` for a transfer staged through the host: a
    send's host copy, made when the send is issued (the caller may reuse
    ``t`` at once), or a received host buffer's copy on the receiving rank's
    device.  Counted: ``calls`` one per staged send or receive, ``nbytes``
    the bytes staged."""
    p2p_host_staged.calls += 1
    p2p_host_staged.nbytes += t.numel() * t.element_size()
    return t.detach().to(device, copy=True)


p2p_host_staged.calls = 0
p2p_host_staged.nbytes = 0


class _P2P:
    """Sends and receives in flight (:func:`p2p`); :meth:`wait` waits for
    them and returns the received tensors on the device."""

    def __init__(self, works, sent, bufs, device, staged):
        # ``sent`` (the staged host copies among them) must outlive the sends.
        self.works, self.sent, self.bufs = works, sent, bufs
        self.device, self.staged = device, staged

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        self.sent = None
        if self.staged:
            return [p2p_host_staged(b, self.device) for b in self.bufs]
        return self.bufs


def p2p(sends: list, recvs: list, device, group=None, staged: bool | None = None) -> _P2P:
    """Issue ``sends`` ((tensor, global rank) pairs) and ``recvs`` ((shape,
    dtype, global rank) triples) over ``group`` (None: the default group)
    and return at once; the handle's ``wait()`` gives the received tensors
    on ``device``.  Send i is issued before receive i, pair by pair, so two
    ranks that exchange tensors issue their ops in the same order (gloo's
    batched send/recv needs it); several ops go as one batch
    (``batch_isend_irecv``, NCCL's group call), a lone op alone.  The
    transfers go through the host where :func:`_staged` says so for
    ``device``; ``staged`` True stages CPU tensors too (the same copies and
    counts, without a card)."""
    if staged is None:
        staged = _staged(dist.get_backend(group), device)
    device = torch.device(device)
    sent = [p2p_host_staged(t.contiguous()) if staged else t.detach().contiguous()
            for t, _ in sends]
    bufs = [torch.empty(shape, dtype=dtype, device="cpu" if staged else device)
            for shape, dtype, _ in recvs]
    ops = []
    for i in range(max(len(sends), len(recvs))):
        if i < len(sends):
            ops.append(dist.P2POp(dist.isend, sent[i], sends[i][1], group))
        if i < len(recvs):
            ops.append(dist.P2POp(dist.irecv, bufs[i], recvs[i][2], group))
    if len(ops) == 1:
        works = [ops[0].op(ops[0].tensor, ops[0].peer, ops[0].group)]
    else:
        works = dist.batch_isend_irecv(ops)
    return _P2P(works, sent, bufs, device, staged)


def _start_shift(tensors: list, mesh: Mesh, step: int) -> _P2P:
    """Issue one send/recv pair per tensor to the ring neighbours
    ``step`` places away (one batch of P2P ops)."""
    dst, src = _neighbours(mesh, step)
    ring_shift.calls += 1
    return p2p([(t, dst) for t in tensors], [(t.shape, t.dtype, src) for t in tensors],
               tensors[0].device, mesh.axis_group)


class _Shifted(torch.autograd.Function):
    """The received blocks of a shift issued by :func:`ring_shift`; the
    backward sends each block's gradient back to where the block came from
    (the shift the other way)."""

    @staticmethod
    def forward(ctx, pending, *sent):
        bufs = pending["work"].wait()
        ctx.mesh, ctx.step = pending["mesh"], pending["step"]
        ctx.mark_non_differentiable(*[b for b, t in zip(bufs, sent) if not t.requires_grad])
        return tuple(bufs)

    @staticmethod
    def backward(ctx, *grads):
        want = [i for i, need in enumerate(ctx.needs_input_grad[1:]) if need]
        out = [None] * len(grads)
        if want:
            bufs = _start_shift([grads[i] for i in want], ctx.mesh, -ctx.step).wait()
            for i, b in zip(want, bufs):
                out[i] = b
        return (None, *out)


class ring_shift:  # noqa: N801 (a counted collective, used like the other helpers)
    """``tensors`` moved one place down ``mesh``'s row (rank a receives rank
    a + 1's, modulo the row): constructing it issues the send/recv pairs
    and returns at once, so that the caller computes on the current blocks
    while they travel; :meth:`finish` waits and returns the received
    blocks on the device, differentiable (their gradients travel back the
    other way).  Under gloo with CUDA tensors the blocks go through the
    host (:func:`p2p`): their host copies are made here, and the received
    blocks reach the device in :meth:`finish`."""

    calls = 0

    def __init__(self, tensors: list, mesh: Mesh, step: int = 1):
        self.sent = tensors
        work = _start_shift([t.detach() for t in tensors], mesh, step)
        self.pending = {"work": work, "mesh": mesh, "step": step}

    def finish(self) -> list:
        return list(_Shifted.apply(self.pending, *self.sent))


def _stage_peer(mesh: Mesh, step: int) -> int:
    """The global rank of the stage ``step`` places down this rank's pp row
    (no wrap: the first stage has no previous one, the last no next)."""
    a = mesh.axis_index + step
    if not 0 <= a < mesh.size:
        raise ValueError(f"stage {mesh.axis_index} of {mesh.size} has no stage {a}")
    return mesh.dp_index * mesh.size + a


def _send(t: torch.Tensor, mesh: Mesh, step: int) -> None:
    p2p([(t.detach(), _stage_peer(mesh, step))], [], t.device).wait()


def _recv(shape, dtype, mesh: Mesh, step: int, fn) -> torch.Tensor:
    t0 = time.perf_counter()
    out = p2p([], [(shape, dtype, _stage_peer(mesh, step))], mesh.device).wait()[0]
    fn.seconds += time.perf_counter() - t0
    return out


def send_next(t: torch.Tensor, mesh: Mesh) -> None:
    """Send ``t`` (a stage's output) to the next stage of this rank's pp
    row."""
    _send(t, mesh, 1)
    send_next.calls += 1


def recv_prev(shape, dtype, mesh: Mesh) -> torch.Tensor:
    """The tensor the previous stage of this rank's pp row sends (a
    ``shape`` / ``dtype`` tensor on ``mesh.device``).  ``recv_prev.seconds``
    adds up the host time spent in it: with gloo the wait for the sender,
    with NCCL the enqueue only."""
    out = _recv(shape, dtype, mesh, -1, recv_prev)
    recv_prev.calls += 1
    return out


def send_prev(t: torch.Tensor, mesh: Mesh) -> None:
    """Send ``t`` (the gradient of a stage's input) to the previous stage."""
    _send(t, mesh, -1)
    send_prev.calls += 1


def recv_next(shape, dtype, mesh: Mesh) -> torch.Tensor:
    """The tensor the next stage sends (the gradient of this stage's
    output); ``seconds`` as :func:`recv_prev`'s."""
    out = _recv(shape, dtype, mesh, 1, recv_next)
    recv_next.calls += 1
    return out


for _fn in (send_next, recv_prev, send_prev, recv_next):
    _fn.calls = 0
recv_prev.seconds = recv_next.seconds = 0.0


class _CopyToAxis(torch.autograd.Function):
    """Megatron's ``f``: identity forward, gradient all-reduced over the row
    (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum([g], ctx.mesh, "axis")[0], None


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's ``g``: the partial products all-reduced over the row,
    identity backward (the output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum([x], mesh, "axis")[0].clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToAxis.apply(x, mesh)


def reduce_from_axis(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromAxis.apply(x, mesh)


COLLECTIVES = (all_reduce_sum, reduce_scatter, all_gather, broadcast, all_gather_object,
               all_to_all, ring_shift, send_next, recv_prev, send_prev, recv_next,
               p2p_host_staged)


def reset_collective_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = 0
    p2p_host_staged.nbytes = 0
    recv_prev.seconds = recv_next.seconds = 0.0


def collective_counts() -> dict:
    return {fn.__name__: fn.calls for fn in COLLECTIVES}


# -- trees -----------------------------------------------------------------------------------

def _leaves(tree) -> list:
    """Leaves of nested dicts (sorted keys) and lists, in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(item) for item in node]
        return next(it)

    return build(like)


def replicate_state(mesh: Mesh, tree):
    """``tree`` with every tensor leaf broadcast from rank 0 (one flat
    buffer per dtype), other leaves as they are."""
    leaves = _leaves(tree)
    idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    got = broadcast([leaves[i] for i in idx], mesh)
    for i, t in zip(idx, got):
        leaves[i] = t
    return _unflatten(tree, leaves)


def shard_batch(mesh: Mesh | None, batch: dict, axes: dict | None = None) -> dict:
    """This rank's rows of a global host batch, P("dp"): the dp_index-th of
    dp equal blocks of every array's (and list's) axis 0, or of the axis
    ``axes`` gives a key (None: the value is replicated).  The ranks of one
    dp row get the same rows."""
    if mesh is None:
        return batch
    axes = axes or {}
    out = {}
    for key, value in batch.items():
        axis = axes.get(key, 0)
        if axis is None:
            out[key] = value
            continue
        n = (len(value) if isinstance(value, list) else value.shape[axis])
        if n % mesh.dp:
            raise ValueError(f"shard_batch: {key} has {n} rows, not a multiple of "
                             f"dp {mesh.dp}")
        lo, hi = mesh.dp_index * n // mesh.dp, (mesh.dp_index + 1) * n // mesh.dp
        if isinstance(value, list):
            out[key] = value[lo:hi]
        else:
            index = [slice(None)] * value.ndim
            index[axis] = slice(lo, hi)
            out[key] = value[tuple(index)]
    return out


def token_range(mesh: Mesh | None, seq_len: int) -> tuple[int, int]:
    """[lo, hi) of the joint sequence that this rank's tokens cover: the
    axis_index-th of ``size`` equal blocks where the axis shards the tokens
    (sp, cp), the whole sequence otherwise."""
    if mesh is None or not mesh.tokens_sharded:
        return 0, seq_len
    if seq_len % mesh.size:
        raise ValueError(f"the joint sequence of {seq_len} tokens does not split over "
                         f"{mesh.axis} {mesh.size}")
    n = seq_len // mesh.size
    return mesh.axis_index * n, (mesh.axis_index + 1) * n


# -- shard rules ----------------------------------------------------------------------------

def jax_axis_orders(module: torch.nn.Module) -> dict:
    """{parameter name: the port's axes in the JAX package's order} for the
    parameters whose layout differs: a Dense weight is stored (out, in),
    flax's kernel (in, out)."""
    from visitron_torch.models.layers import Dense

    return {f"{prefix}.weight" if prefix else "weight": (1, 0)
            for prefix, m in module.named_modules() if isinstance(m, Dense)}


def shard_params_rules(module: torch.nn.Module) -> dict:
    """{parameter name: its tp split} for the parameters of ``module`` that
    split over tp (the JAX package's ``shard_params_rules``, restated for
    the port): the fused QKV kernel ("qkv": the rows of heads
    [t H/tp, (t+1) H/tp) of each of q, k and v, what the JAX wrappers'
    in_specs hand attention), the intermediate kernel ("col": a contiguous
    block of its output rows), both with their biases, and the attention
    output and output kernels ("row": a contiguous block of their input
    columns; their biases stay replicated and are added once, after the
    all-reduce).  The modules name their split (``tp_kind``), so nothing
    else of a model matches; every other parameter is replicated."""
    out = {}
    for prefix, m in module.named_modules():
        kind = getattr(m, "tp_kind", None)
        if kind is None:
            continue
        out[f"{prefix}.weight"] = kind
        if kind != "row" and getattr(m, "bias", None) is not None:
            out[f"{prefix}.bias"] = kind
    return out


def _tp_view(t: torch.Tensor, kind: str) -> tuple[torch.Tensor, int]:
    """(``t`` as the view whose ``axis`` splits contiguously, axis): qkv's
    rows as (3, H*D, ...) split on axis 1, a column split's rows on axis 0,
    a row split's columns on axis 1."""
    if kind == "qkv":
        return t.unflatten(0, (3, -1)), 1
    return t, (0 if kind == "col" else 1)


def tp_slice(t: torch.Tensor, kind: str | None, mesh: Mesh) -> torch.Tensor:
    """This rank's tp block (a new tensor) of a full leaf of split ``kind``
    (None: the leaf itself)."""
    if kind is None or mesh.tp == 1:
        return t
    view, axis = _tp_view(t, kind)
    n = view.shape[axis] // mesh.tp
    if n * mesh.tp != view.shape[axis]:
        raise ValueError(f"tp {mesh.tp} does not divide axis {axis} of {tuple(view.shape)}")
    block = view.narrow(axis, mesh.axis_index * n, n)
    return (block.flatten(0, 1) if kind == "qkv" else block).clone()


def tp_gather(blocks: list, kinds: list, mesh: Mesh) -> list:
    """The full leaves whose tp blocks are the row's ``blocks`` (leaves of
    kind None as they are), in one all-gather per dtype."""
    out = list(blocks)
    idx = [i for i, k in enumerate(kinds) if k is not None and blocks[i] is not None]
    if not idx or mesh.tp == 1:
        return out
    views = [_tp_view(blocks[i], kinds[i]) for i in idx]
    full = all_gather([v for v, _ in views], [a for _, a in views], mesh, "axis")
    for i, f in zip(idx, full):
        out[i] = f.flatten(0, 1) if kinds[i] == "qkv" else f
    return out


def shard_axis(shape, dp: int, order=None) -> int | None:
    """The dp shard axis of a leaf (JAX's rule: the first axis, in the JAX
    layout's ``order``, of size >= dp that dp divides), or None."""
    if dp <= 1 or len(shape) == 0:
        return None
    for axis in (order or range(len(shape))):
        if shape[axis] >= dp and shape[axis] % dp == 0:
            return axis
    return None


def fsdp_param_rules(mesh: Mesh, params: dict, orders: dict | None = None):
    """The shard axis of each parameter (None: replicated), in ``params``'
    nesting; ``orders`` maps a flat parameter name to its JAX axis order
    (:func:`jax_axis_orders`), keyed per part for nested params."""
    orders = orders or {}

    def rule(node, order_map):
        if isinstance(node, dict):
            return {k: rule(v, order_map.get(k, {}) if isinstance(v, dict) else
                            order_map.get(k)) for k, v in node.items()}
        return shard_axis(tuple(node.shape), mesh.dp, order_map)

    return {k: rule(v, orders.get(k, {}) if isinstance(v, dict) else orders.get(k))
            for k, v in params.items()}


def _congruent(node, axes) -> bool:
    """Whether ``node`` is a sub-tree of the parameter tree ``axes`` (a
    moment: the same keys at every level, tensors at its leaves)."""
    if not isinstance(node, dict) or not isinstance(axes, dict):
        return False
    for key, value in node.items():
        if key not in axes:
            return False
        ref = axes[key]
        if isinstance(ref, dict):
            if not _congruent(value, ref):
                return False
        elif not isinstance(value, torch.Tensor):
            return False
    return True


def fsdp_opt_rules(param_axes: dict, opt_state):
    """The shard axis of each optimizer-state leaf: a moment's leaf takes
    its parameter's axis; counts and other leaves stay replicated (None).
    Under a dp-only mesh these are also ``zero1_opt_rules``'s axes."""

    def rule(node):
        if _congruent(node, param_axes):
            return _pick(param_axes, node)
        if isinstance(node, dict):
            return {k: rule(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rule(v) for v in node]
        return None

    return rule(opt_state)


zero1_opt_rules = fsdp_opt_rules


def _pick(axes, node):
    """``axes`` restricted to ``node``'s keys."""
    return {k: _pick(axes[k], v) if isinstance(v, dict) else axes[k]
            for k, v in node.items()}


def _block(t, axis, mesh: Mesh):
    """This rank's dp block of ``t`` on ``axis`` (a view), ``t`` for None."""
    if axis is None or not isinstance(t, torch.Tensor):
        return t
    n = t.shape[axis] // mesh.dp
    return t.narrow(axis, mesh.dp_index * n, n)


def reshard_state(mesh: Mesh, tree, axes):
    """This rank's shards of a full (single-device layout) ``tree``, copied
    out of it, so the full tensors can go."""
    return _unflatten(tree, [t if a is None else _block(t, a, mesh).clone()
                             for t, a in zip(_leaves(tree), _leaves(axes))])


def zero1_shard_opt_state(mesh: Mesh, optimizer, params: dict, axes: dict):
    """A fresh optimizer state over this rank's shards of ``params``."""
    return optimizer.init(_unflatten(params, [_block(t, a, mesh) for t, a in
                                              zip(_leaves(params), _leaves(axes))]))


def gather_state(mesh: Mesh, tree, axes):
    """The full tensors of a sharded ``tree`` (every rank takes part)."""
    leaves, ax = _leaves(tree), _leaves(axes)
    idx = [i for i, a in enumerate(ax) if a is not None]
    if not idx:
        return tree
    full = all_gather([leaves[i] for i in idx], [ax[i] for i in idx], mesh)
    for i, t in zip(idx, full):
        leaves[i] = t
    return _unflatten(tree, leaves)


def _map_moments(opt_state, ref: dict, fn):
    """``opt_state`` with ``fn(moment)`` in place of each sub-tree congruent
    with the parameter tree ``ref`` (Adam's mu and nu)."""
    if _congruent(opt_state, ref):
        return fn(opt_state)
    if isinstance(opt_state, dict):
        return {k: _map_moments(v, ref, fn) for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return [_map_moments(v, ref, fn) for v in opt_state]
    return opt_state


def _kinds_tree(params: dict, kinds) -> dict:
    """``kinds`` ({name: split}, nested as ``params``, for the split leaves
    only) as a tree congruent with ``params``, None at the other leaves."""
    kinds = kinds or {}
    return {k: _kinds_tree(v, kinds.get(k)) if isinstance(v, dict) else kinds.get(k)
            for k, v in params.items()}


# -- the step under a mesh ----------------------------------------------------------------

@dataclass
class DataParallel:
    """What a trainer does around its forward and backward under a mesh.

    The gradients are summed over the ranks that shard the data: the dp
    column under tp (its ranks hold the same rows; the tp-split leaves stay
    local, and the replicated ones are the same on every rank of a row),
    the whole world under sp and cp (each rank's tokens are its own).
    ``zero1``: the optimizer state is sharded over dp at rest; each rank
    updates its blocks from the summed gradient and the parameter delta is
    all-gathered over dp.  ``fsdp``: the parameters, gradients and optimizer
    state are sharded over dp at rest (the tp-split leaves are not); the
    step all-gathers the parameters and reduce-scatters the gradients.
    ``axes`` (from :meth:`plan`) is the dp shard axis of each parameter,
    ``tp_kinds`` its tp split; at dp 1 nothing is dp-sharded, and the step
    is the single-device step plus the collectives of a world of one."""

    mesh: Mesh
    zero1: bool = False
    fsdp: bool = False
    axes: dict | None = None
    tp_kinds: dict | None = None

    def __post_init__(self):
        if not isinstance(self.mesh, Mesh):
            raise TypeError(f"DataParallel needs a parallel.Mesh, got "
                            f"{type(self.mesh).__name__}")

    @property
    def sharded(self) -> bool:
        return (self.zero1 or self.fsdp) and any(
            a is not None for a in _leaves(self.axes or {}))

    @property
    def split(self) -> bool:
        """Whether some leaves are split over tp."""
        return self.tp_kinds is not None and any(
            k is not None for k in _leaves(self.tp_kinds))

    def plan(self, params: dict, orders: dict | None = None,
             tp_kinds: dict | None = None) -> None:
        """The placement of full ``params``: ``tp_kinds`` (the splits of
        :func:`shard_params_rules`, nested as ``params``) under tp,
        then the dp axes of the tp blocks (:func:`fsdp_param_rules`; under
        FSDP the tp-split leaves are not dp-sharded, as in the JAX
        package's fsdp_param_rules)."""
        if tp_kinds is not None and self.mesh.tp > 1:
            self.tp_kinds = _kinds_tree(params, tp_kinds)
        else:
            self.tp_kinds = None
        local = self.tp_local(params)
        axes = fsdp_param_rules(self.mesh, local, orders)
        if self.fsdp and self.split:
            axes = _unflatten(axes, [None if k is not None else a for a, k in
                                     zip(_leaves(axes), _leaves(self.tp_kinds))])
        self.axes = axes

    def tp_local(self, params: dict) -> dict:
        """This rank's tp blocks of full ``params`` (new tensors; the
        replicated leaves as they are)."""
        if not self.split:
            return params
        kinds = _pick(self.tp_kinds, params)
        return _unflatten(params, [tp_slice(t, k, self.mesh) for t, k in
                                   zip(_leaves(params), _leaves(kinds))])

    def tp_full(self, params: dict) -> dict:
        """The full leaves of tp blocks in ``params``' layout (every rank of
        the row takes part)."""
        if not self.split:
            return params
        kinds = _pick(self.tp_kinds, params)
        return _unflatten(params, tp_gather(_leaves(params), _leaves(kinds), self.mesh))

    def place(self, params: dict, optimizer) -> tuple[dict, object]:
        """(params, opt_state) at rest from full, identical ``params``."""
        params = self.tp_local(params)
        if not self.sharded:
            return params, optimizer.init(params)
        opt_state = zero1_shard_opt_state(self.mesh, optimizer, params, self.axes)
        if self.fsdp:
            params = reshard_state(self.mesh, params, self.axes)
        return params, opt_state

    def full_params(self, params: dict) -> dict:
        """The parameters of the forward: gathered over dp under FSDP (tp
        blocks stay blocks)."""
        if self.fsdp and self.sharded:
            return gather_state(self.mesh, params, self.axes)
        return params

    def single_device_params(self, params: dict) -> dict:
        """The single-device layout of ``params`` (every rank takes part):
        what a mesh-free evaluation runs on."""
        return self.tp_full(self.full_params(params))

    def global_count(self, x: torch.Tensor) -> torch.Tensor:
        return global_sum(x, self.mesh)

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The optimizer clip's global norm (``clip_by_global_norm``'s
        ``norm``) of a gradient tree: the parameter tree, this rank's dp
        blocks of it (ZeRO-1 / FSDP) or a part of either (a
        ``multi_transform`` group).  Each leaf's squared norm is summed over
        the ranks that hold its other blocks: over dp for the dp-sharded
        leaves' blocks, over tp for the tp-split leaves, over both where
        both hold; a replicated leaf is counted once.  Without either, the
        plain norm."""
        from visitron_torch.train.optim import global_norm

        leaves = _leaves(grads)
        if not self.sharded and not self.split:
            return global_norm(leaves)
        n = len(leaves)
        on_dp = ([a is not None for a in _leaves(_pick(self.axes, grads))] if self.sharded
                 else [False] * n)
        on_tp = ([k is not None for k in _leaves(_pick(self.tp_kinds, grads))] if self.split
                 else [False] * n)
        sq = torch.stack(torch._foreach_norm(leaves)).float() ** 2
        total = None
        for dp_f, tp_f, over in ((False, False, None), (True, False, "dp"),
                                 (False, True, "axis"), (True, True, "world")):
            mask = [a == dp_f and b == tp_f for a, b in zip(on_dp, on_tp)]
            if not any(mask):
                continue
            part = torch.sum(sq[torch.tensor(mask, device=sq.device)])
            if over is not None:
                part = all_reduce_sum([part], self.mesh, over)[0]
            total = part if total is None else total + part
        return torch.sqrt(total)

    def reduce(self, grads: dict, metrics: dict | None = None) -> tuple[dict, dict]:
        """(gradients, metrics) summed over the ranks that shard the data:
        the full gradients (dp, ZeRO-1), or this rank's dp blocks of the
        sharded ones (FSDP: a reduce-scatter over dp, then, where the axis
        shards the tokens, an all-reduce of the blocks over the row); the
        metrics (0-d tensors) ride in the all-reduce's buckets."""
        metrics = metrics or {}
        names = sorted(metrics)
        g = _leaves(grads)
        ax = _leaves(self.axes) if self.fsdp and self.sharded else [None] * len(g)
        scatter = [i for i, a in enumerate(ax) if a is not None and g[i] is not None]
        keep = [i for i in range(len(g)) if i not in set(scatter)]
        extra = [metrics[k].reshape(1).float() for k in names]
        summed = all_reduce_sum([g[i] for i in keep] + extra, self.mesh, "data")
        out = list(g)
        for i, t in zip(keep, summed):
            out[i] = t
        if scatter:
            blocks = reduce_scatter([g[i] for i in scatter], [ax[i] for i in scatter],
                                    self.mesh)
            if self.mesh.tokens_sharded:
                blocks = all_reduce_sum(blocks, self.mesh, "axis")
            for i, t in zip(scatter, blocks):
                out[i] = t
        vals = summed[len(keep):]
        return _unflatten(grads, out), {k: v.reshape(()) for k, v in zip(names, vals)}

    def update(self, optimizer, grads: dict, opt_state, params: dict, apply_updates):
        """(params, opt_state) after one optimizer step from the reduced
        ``grads``."""
        if not self.sharded:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state
        ax = _leaves(self.axes)
        if self.fsdp:  # grads and params are this rank's blocks already
            g_sh, p_sh = grads, params
        else:
            g_sh = _unflatten(grads, [_block(t, a, self.mesh)
                                      for t, a in zip(_leaves(grads), ax)])
            p_sh = _unflatten(params, [_block(t, a, self.mesh)
                                       for t, a in zip(_leaves(params), ax)])
        upd, opt_state = optimizer.update(g_sh, opt_state, p_sh)
        if self.fsdp:
            return apply_updates(params, upd), opt_state
        u = _leaves(upd)
        idx = [i for i, a in enumerate(ax) if a is not None and u[i] is not None]
        for i, t in zip(idx, all_gather([u[i].contiguous() for i in idx],
                                        [ax[i] for i in idx], self.mesh)):
            u[i] = t
        return apply_updates(params, _unflatten(upd, u)), opt_state

    def opt_axes(self, opt_state):
        return fsdp_opt_rules(self.axes or {}, opt_state)

    def gather(self, params: dict, opt_state) -> tuple[dict, object]:
        """The single-device layout of (params, opt_state), for a checkpoint
        (every rank takes part)."""
        if self.sharded:
            if self.fsdp:
                params = gather_state(self.mesh, params, self.axes)
            opt_state = gather_state(self.mesh, opt_state, self.opt_axes(opt_state))
        if self.split:
            params = self.tp_full(params)
            opt_state = _map_moments(opt_state, self.tp_kinds, self.tp_full)
        return params, opt_state

    def shard(self, params: dict, opt_state) -> tuple[dict, object]:
        """This rank's (params, opt_state) from the single-device layout of a
        checkpoint."""
        if self.split:
            opt_state = _map_moments(opt_state, self.tp_kinds, self.tp_local)
            params = self.tp_local(params)
        if not self.sharded:
            return params, opt_state
        opt_state = reshard_state(self.mesh, opt_state, self.opt_axes(opt_state))
        if self.fsdp:
            params = reshard_state(self.mesh, params, self.axes)
        return params, opt_state
