"""Data parallelism across processes: the process group, the dp "mesh", the
shard rules of ZeRO-1 and FSDP and the collectives of a training step
(visitron_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``: XLA
inserts the gradient all-reduce, and ZeRO-1 / FSDP are placements that the
partitioner turns into reduce-scatters and all-gathers.  Here every rank is
one process with one device (``python -m torch.distributed.run
--nproc_per_node N``), and the collectives are explicit, issued from this
module alone:

  * :func:`init_process_group` joins the group that torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or the caller describes: NCCL on ``cuda:LOCAL_RANK``,
    gloo only when the caller asks for the CPU (or names gloo);
    :func:`destroy_process_group` leaves it.  A group that does not form
    raises; nothing falls back to one process;
  * :class:`Mesh` is the dp axis over every rank of the group
    (:func:`make_mesh`, :func:`maybe_mesh`); tp is not ported (ROADMAP
    item 10b);
  * :func:`all_reduce_sum` sums a list of tensors over the ranks in flat
    buckets of at most ``BUCKET_BYTES``; :func:`reduce_scatter` and
    :func:`all_gather` move leaves sharded on an axis, also through one flat
    buffer per dtype; :func:`broadcast` (``replicate_state``) and
    :func:`all_gather_object` complete the set.  Each keeps a call counter,
    ``<helper>.calls``, raised by one per collective it issues (the kernel
    wrappers' ``launches`` counterpart);
  * the shard rules: a leaf is sharded over dp on the first axis, in the
    JAX package's layout, whose size is >= dp and divisible by dp; leaves
    that no axis fits, and every leaf at dp 1, stay replicated
    (``zero1_opt_rules`` / ``fsdp_param_rules`` / ``fsdp_opt_rules``).  The
    port stores Dense kernels transposed (out, in), so the rules walk a
    Dense weight's axes in the order (1, 0) (:func:`jax_axis_orders`);
  * :class:`DataParallel` is what a trainer's step does around its forward
    and backward: the global counts, the gradient all-reduce (dp, ZeRO-1)
    or reduce-scatter (FSDP), the sharded optimizer update with the
    global-norm clip summed over the shards, the parameter all-gather, and
    the gather to and the shard from a checkpoint's single-device layout.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# The larger of a bucket's leaves, or this many bytes: a bucket is one
# collective over one flat buffer (the extra copy of the gradients is at
# most this large at a time).
BUCKET_BYTES = 256 << 20

# The dropout seed fold of the JAX mesh wrappers: seed + dp_index * 1000003
# (+ tp_index * 7919, with tp not ported).
DP_SEED_STRIDE = 1000003


def _unported_axis(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}: tensor, pipeline, sequence and context parallelism are not ported "
        "yet (ROADMAP item 10b); the port runs data parallelism (dp) only")


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
    """(host_id, num_hosts) for per-host data sharding: ``mesh``'s (rank,
    dp), (0, 1) without a mesh."""
    return (0, 1) if mesh is None else (mesh.rank, mesh.dp)


# -- the mesh ----------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Mesh:
    """The dp axis over the ranks of the default process group: ``dp``
    ranks, this process being ``rank``, on ``device`` (a Mesh built by hand,
    without a group, serves the seed-fold and rule functions of a given
    rank)."""

    dp: int
    rank: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def fold_seed(self, seed: int) -> int:
        """``seed`` for this rank's rows: seed + rank x 1000003, as the JAX
        mesh wrappers fold dp_index into the kernels' dropout seed (the
        kernels read its low 32 bits).  The port folds the hidden-dropout
        and sampling generators' seeds the same way."""
        return int(seed) + self.rank * DP_SEED_STRIDE


def make_mesh(dp: int | None = None, tp: int = 1, device=None) -> Mesh:
    """The dp mesh over every rank of the initialised process group, on
    ``device`` (None: NCCL's current card, or the CPU under gloo).  ``dp``
    None or the world size; any other count is refused (the JAX package
    idles the devices a smaller mesh leaves out, the port has no idle
    ranks)."""
    if tp != 1:
        raise _unported_axis("--mesh_tp")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "python -m torch.distributed.run, or call "
                           "visitron_torch.parallel.init_process_group")
    world = dist.get_world_size()
    if dp is not None and dp != world:
        raise ValueError(f"--mesh_dp {dp} differs from the world size {world}: the "
                         "port's mesh spans every rank (0 means the whole world)")
    if device is None:  # NCCL's device, or gloo's default, the CPU
        device = ("cpu" if dist.get_backend() == "gloo"
                  else torch.device("cuda", torch.cuda.current_device()))
    return Mesh(dp=world, rank=dist.get_rank(), device=torch.device(device))


def maybe_mesh(dp: int = 0, tp: int = 1, device=None) -> Mesh | None:
    """The run's mesh from ``--mesh_dp`` / ``--mesh_tp``: None without a
    process group (one process, nothing to shard), else :func:`make_mesh`
    over the whole world (``dp`` 0 or the world size)."""
    if tp != 1:
        raise _unported_axis("--mesh_tp")
    if not dist.is_initialized():
        if dp in (0, 1):
            return None
        raise ValueError(f"--mesh_dp {dp} needs {dp} ranks: launch with python -m "
                         f"torch.distributed.run --nproc_per_node {dp}")
    return make_mesh(dp=dp or None, device=device)


def is_primary(mesh: Mesh | None) -> bool:
    """Whether this process writes the run's files (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        dist.barrier()


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


def all_reduce_sum(tensors: list, mesh: Mesh) -> list:
    """The elementwise sum over the ranks of each tensor in ``tensors``
    (new tensors, views of the reduced flat buckets; None entries stay
    None).  Each view starts on a 16-byte boundary of its bucket, as a
    tensor of its own would, so that vectorised kernels can read it."""
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
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        all_reduce_sum.calls += 1
        for i, part in zip(idx, flat.split(sizes)):
            out[i] = part[:tensors[i].numel()].view(tensors[i].shape)
    return out


all_reduce_sum.calls = 0


def global_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over the ranks (a count over the global batch); ``x``
    itself without a mesh."""
    if mesh is None:
        return x
    return all_reduce_sum([x], mesh)[0]


def _moved(t: torch.Tensor, axis: int, dp: int) -> torch.Tensor:
    """``t`` as (dp, rest): its ``axis`` first, split into dp blocks."""
    return t.movedim(axis, 0).reshape(dp, -1)


def reduce_scatter(tensors: list, axes: list, mesh: Mesh) -> list:
    """Each ``tensors[i]`` summed over the ranks, and this rank's block of
    it on ``axes[i]`` (the dp shard), through one flat buffer per dtype."""
    dp, out = mesh.dp, [None] * len(tensors)
    for bucket in _buckets(tensors, limit=1 << 62):
        rows = torch.cat([_moved(tensors[i], axes[i], dp) for i in bucket], dim=1)
        flat = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
        _reduce_scatter_flat(flat, rows.reshape(-1), op=dist.ReduceOp.SUM)
        reduce_scatter.calls += 1
        for i, part in zip(bucket, flat.split([tensors[i].numel() // dp for i in bucket])):
            shape = list(tensors[i].shape)
            shape[axes[i]] //= dp
            out[i] = part.view([shape[axes[i]]] + shape[:axes[i]]
                               + shape[axes[i] + 1:]).movedim(0, axes[i])
    return out


reduce_scatter.calls = 0


def all_gather(shards: list, axes: list, mesh: Mesh) -> list:
    """The full tensors whose dp blocks on ``axes[i]`` are the ranks'
    ``shards[i]`` (None entries stay None), through one flat buffer per
    dtype."""
    dp, out = mesh.dp, list(shards)
    live = [i for i, s in enumerate(shards) if s is not None]
    for bucket in _buckets([shards[i] for i in live], limit=1 << 62):
        idx = [live[j] for j in bucket]
        flat = torch.cat([shards[i].movedim(axes[i], 0).reshape(-1) for i in idx])
        rows = torch.empty((dp, flat.numel()), dtype=flat.dtype, device=flat.device)
        _all_gather_flat(rows.view(-1), flat)
        all_gather.calls += 1
        for i, part in zip(idx, rows.split([shards[i].numel() for i in idx], dim=1)):
            moved = list(shards[i].movedim(axes[i], 0).shape)
            full = part.reshape([dp * moved[0]] + moved[1:])
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
    got = [None] * mesh.dp
    dist.all_gather_object(got, obj)
    all_gather_object.calls += 1
    return got


all_gather_object.calls = 0

COLLECTIVES = (all_reduce_sum, reduce_scatter, all_gather, broadcast, all_gather_object)


def reset_collective_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = 0


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
    """This rank's rows of a global host batch, P("dp"): the r-th of dp
    equal blocks of every array's (and list's) axis 0, or of the axis
    ``axes`` gives a key (None: the value is replicated)."""
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
        lo, hi = mesh.rank * n // mesh.dp, (mesh.rank + 1) * n // mesh.dp
        if isinstance(value, list):
            out[key] = value[lo:hi]
        else:
            index = [slice(None)] * value.ndim
            index[axis] = slice(lo, hi)
            out[key] = value[tuple(index)]
    return out


# -- shard rules ----------------------------------------------------------------------------

def jax_axis_orders(module: torch.nn.Module) -> dict:
    """{parameter name: the port's axes in the JAX package's order} for the
    parameters whose layout differs: a Dense weight is stored (out, in),
    flax's kernel (in, out)."""
    from visitron_torch.models.layers import Dense

    return {f"{prefix}.weight" if prefix else "weight": (1, 0)
            for prefix, m in module.named_modules() if isinstance(m, Dense)}


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
    return t.narrow(axis, mesh.rank * n, n)


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


# -- the data-parallel step ----------------------------------------------------------------

@dataclass
class DataParallel:
    """What a trainer does around its forward and backward under a dp mesh.

    ``zero1``: the optimizer state is sharded at rest; each rank updates its
    blocks from the all-reduced gradient and the parameter delta is
    all-gathered.  ``fsdp``: the parameters, gradients and optimizer state
    are sharded at rest; the step all-gathers the parameters and
    reduce-scatters the gradients.  ``axes`` (from :meth:`plan`) is the
    shard axis of each parameter; at dp 1 nothing is sharded, and the step
    is the single-device step plus the collectives of a world of one."""

    mesh: Mesh
    zero1: bool = False
    fsdp: bool = False
    axes: dict | None = None

    def __post_init__(self):
        if not isinstance(self.mesh, Mesh):  # e.g. a mesh with a tp axis
            raise _unported_axis(f"a {type(self.mesh).__name__} mesh")

    @property
    def sharded(self) -> bool:
        return (self.zero1 or self.fsdp) and any(
            a is not None for a in _leaves(self.axes or {}))

    def plan(self, params: dict, orders: dict | None = None) -> None:
        self.axes = fsdp_param_rules(self.mesh, params, orders)

    def place(self, params: dict, optimizer) -> tuple[dict, object]:
        """(params, opt_state) at rest from full, identical ``params``."""
        if not self.sharded:
            return params, optimizer.init(params)
        opt_state = zero1_shard_opt_state(self.mesh, optimizer, params, self.axes)
        if self.fsdp:
            params = reshard_state(self.mesh, params, self.axes)
        return params, opt_state

    def full_params(self, params: dict) -> dict:
        """The parameters of the forward: gathered under FSDP."""
        if self.fsdp and self.sharded:
            return gather_state(self.mesh, params, self.axes)
        return params

    def global_count(self, x: torch.Tensor) -> torch.Tensor:
        return global_sum(x, self.mesh)

    def global_norm(self, leaves: list) -> torch.Tensor:
        """The optimizer clip's global norm (``clip_by_global_norm``'s
        ``norm``) of a gradient tree's leaves, in order.  Under ZeRO-1 /
        FSDP these are this rank's blocks of the sharded leaves (per
        :attr:`axes`) beside full replicated ones: the blocks' squared norms
        are summed over the ranks, the replicated leaves' counted once.
        Without sharding, the plain norm."""
        from visitron_torch.train.optim import global_norm

        if not self.sharded:
            return global_norm(leaves)
        mask = [a is not None for a in _leaves(self.axes)]
        if len(mask) != len(leaves):
            raise ValueError(f"global_norm: {len(leaves)} gradient leaves for "
                             f"{len(mask)} planned parameters")
        sq = torch.stack(torch._foreach_norm(leaves)).float() ** 2
        on = torch.tensor(mask, device=sq.device)
        part = global_sum(torch.sum(torch.where(on, sq, 0.0)), self.mesh)
        return torch.sqrt(part + torch.sum(torch.where(on, 0.0, sq)))

    def reduce(self, grads: dict, metrics: dict | None = None) -> tuple[dict, dict]:
        """(gradients, metrics) summed over the ranks: the full gradients
        (dp, ZeRO-1), or this rank's blocks of the sharded ones (FSDP); the
        metrics (0-d tensors) ride in the all-reduce's buckets."""
        metrics = metrics or {}
        names = sorted(metrics)
        g = _leaves(grads)
        ax = _leaves(self.axes) if self.fsdp and self.sharded else [None] * len(g)
        scatter = [i for i, a in enumerate(ax) if a is not None and g[i] is not None]
        keep = [i for i in range(len(g)) if i not in set(scatter)]
        extra = [metrics[k].reshape(1).float() for k in names]
        summed = all_reduce_sum([g[i] for i in keep] + extra, self.mesh)
        out = list(g)
        for i, t in zip(keep, summed):
            out[i] = t
        if scatter:
            for i, t in zip(scatter, reduce_scatter([g[i] for i in scatter],
                                                    [ax[i] for i in scatter], self.mesh)):
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
        if not self.sharded:
            return params, opt_state
        if self.fsdp:
            params = gather_state(self.mesh, params, self.axes)
        return params, gather_state(self.mesh, opt_state, self.opt_axes(opt_state))

    def shard(self, params: dict, opt_state) -> tuple[dict, object]:
        """This rank's (params, opt_state) from the single-device layout of a
        checkpoint."""
        if not self.sharded:
            return params, opt_state
        opt_state = reshard_state(self.mesh, opt_state, self.opt_axes(opt_state))
        if self.fsdp:
            params = reshard_state(self.mesh, params, self.axes)
        return params, opt_state
