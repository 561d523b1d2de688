"""The train loop of every trainer of the port: fine-tuning, turn-based,
classifier, speaker and pretraining (the loops each trainer of
visitron_tpu/train/, the JAX package's ``run_speaker`` and ``run
pretrain`` write out for themselves).

``restore_latest`` resumes a state from the latest checkpoint; the caller
then replays its batch schedule to that iteration.  ``run_loop`` runs the
iterations and owns what every trainer does around a step: losses stay on
the device until the logging boundary, where ``_log`` reads them back once
(with the last step's aux values; a trainer may log its own way) and
``check_finite`` guards against divergence; checkpoints are written every
``saving_steps`` and at the last iteration, or at each ``EpochEnd`` marker
of the batches (pretraining); on SIGTERM the current iteration is saved and
the loop stops, reporting the preemption so that the caller skips its val
sweep (the grace window ends at the checkpoint); ``profile_steps`` writes a
torch.profiler trace of that many steps, from the second on, into
<output_dir>/profile/trace.json.

Under data parallelism (a trainer whose ``dp`` is a
``parallel.DataParallel``) every rank runs the loop: the stop is the
ranks' consensus (``PreemptionGuard``), a checkpoint gathers the sharded
state into the single-device layout on every rank and rank 0 writes it,
the ranks leave the loop together once its writes are on disk, and a
restore reads that layout on every rank and keeps the rank's shards; logs,
CSV and the profile are rank 0's.
"""

from __future__ import annotations

import itertools
import os
from typing import NamedTuple

import torch

from visitron_torch.parallel.mesh import barrier, is_primary
from visitron_torch.train.logging import MetricsLogger, check_finite
from visitron_torch.train.preemption import PreemptionGuard


class EpochEnd(NamedTuple):
    """A marker in a loop's batches: epoch ``epoch`` ends here."""
    epoch: int


def restore_latest(ckpt, state: dict, logger, dp=None) -> tuple[dict, int]:
    """(state, iteration): ``state`` with the params and optimizer state of
    the latest checkpoint and that checkpoint's iteration, or (state, 0)
    when there is none.  ``dp``: each rank keeps its shards of the
    single-device layout that the checkpoint holds."""
    start_it = ckpt.latest()
    if start_it is None:
        return state, 0
    params, opt_state = state["params"], state["opt_state"]
    if dp is not None:
        params, opt_state = dp.gather(params, opt_state)
    restored = ckpt.restore(start_it, {"params": params, "opt_state": opt_state})
    if dp is not None:
        restored["params"], restored["opt_state"] = dp.shard(restored["params"],
                                                             restored["opt_state"])
    logger.info("resumed from checkpoint-%d", start_it)
    return {**state, **restored}, start_it


def save_checkpoint(trainer, it: int, state: dict, wait: bool | None = None) -> None:
    """Checkpoint ``it`` of ``state``: gathered to the single-device layout
    under a sharded ``trainer.dp`` (every rank takes part), written by rank
    0."""
    params, opt_state = state["params"], state["opt_state"]
    dp = getattr(trainer, "dp", None)
    if dp is not None:
        params, opt_state = dp.gather(params, opt_state)
    if is_primary(getattr(dp, "mesh", None)):
        trainer.ckpt.save(it, params, opt_state, wait=wait)


def run_loop(trainer, step, batches, state: dict, start_it: int = 0,
             profile_steps: int = 0, on_save=None, log=None, on_epoch_end=None,
             limit: int | None = -1, metrics: MetricsLogger | None = None
             ) -> tuple[dict, bool]:
    """(state, preempted) after ``state, out = step(state, batch)`` over
    ``batches`` for iterations start_it + 1 .. (``out`` is the loss or (loss,
    aux)); ``trainer`` gives the run's ``cfg``, ``ckpt``, ``logger`` and
    ``device`` (and ``dp`` under data parallelism).

    ``limit``: the number of batches to take (-1: up to ``num_iterations``,
    None: all).  Without ``on_epoch_end`` a checkpoint lands every
    ``saving_steps`` and at ``num_iterations``, and ``on_save(it, state)``
    runs after each (the speaker's held-out word CE; not after a preemption
    save); with it, a checkpoint lands at each ``EpochEnd`` of ``batches``,
    and then ``on_epoch_end(epoch, it, state)`` runs.  ``log(it, outs)``
    replaces the logging at the boundary (``outs``: the steps' outputs since
    the last one); ``metrics`` is the train.csv logger the callbacks share
    (None: the loop's own); the loop closes it."""
    cfg = trainer.cfg
    dp = getattr(trainer, "dp", None)
    primary = is_primary(getattr(dp, "mesh", None))
    if metrics is None:
        metrics = MetricsLogger(cfg.output_dir, "train", is_main_process=primary)
    if limit == -1:
        limit = max(cfg.num_iterations - start_it, 0)
    if limit is not None:
        batches = itertools.islice(batches, limit)
    outs, it, saved_it, i = [], start_it, None, 0
    profiler = None
    with PreemptionGuard() as guard:
        for batch in batches:
            if isinstance(batch, EpochEnd):
                if saved_it != it:
                    save_checkpoint(trainer, it, state)
                    saved_it = it
                on_epoch_end(batch.epoch, it, state)
                continue
            it += 1
            if profile_steps and i == 1 and primary:  # the first step warms up
                profiler = _start_profiler(trainer.device)
            state, out = step(state, batch)
            if profiler is not None and i == profile_steps:
                _stop_profiler(profiler, cfg.output_dir)
                profiler = None
            i += 1
            # The loss stays on the device until the logging boundary: a
            # read-back per step would stall the host on the device.
            outs.append(out)
            if it % cfg.logging_steps == 0:
                if log is not None:
                    log(it, outs)
                else:
                    _log(trainer.logger, metrics, it, outs)
                outs.clear()
            if on_epoch_end is None and (it % cfg.saving_steps == 0
                                         or it == cfg.num_iterations):
                save_checkpoint(trainer, it, state)
                saved_it = it
                if on_save is not None:
                    on_save(it, state)
            if guard.should_stop(it):
                if saved_it != it:
                    save_checkpoint(trainer, it, state, wait=True)
                trainer.logger.info("termination signal: saved checkpoint-%d, stopping "
                                    "(restart with --resume)", it)
                break
    if profiler is not None:
        _stop_profiler(profiler, cfg.output_dir)
    trainer.ckpt.wait_until_finished()
    metrics.close()
    # No rank goes on (to a resume of this run, say) before rank 0's
    # checkpoints are on disk.
    barrier(getattr(dp, "mesh", None))
    return state, guard.stop


def _log(logger, metrics: MetricsLogger, it: int, outs: list) -> None:
    """One read-back of the mean loss since the last boundary and the last
    step's aux values; checked, logged and written to train.csv."""
    losses = [o[0] if isinstance(o, tuple) else o for o in outs]
    aux = outs[-1][1] if isinstance(outs[-1], tuple) else None
    names = sorted(aux or {})
    vals = torch.stack([torch.stack(losses).mean()]
                       + [aux[k].float() for k in names]).tolist()
    avg = check_finite(vals[0], it, logger)
    extra = dict(zip(names, vals[1:]))
    logger.info("iter %d loss %.4f %s", it, avg, extra or "")
    metrics.log({"loss": avg, **extra}, step=it)


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=acts)
    profiler.start()
    return profiler


def _stop_profiler(profiler, output_dir: str) -> None:
    profiler.stop()
    out = os.path.join(output_dir, "profile")
    os.makedirs(out, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(out, "trace.json"))
