"""The train loop of the fine-tuning, turn-based, classifier and speaker
trainers (the loop each trainer of visitron_tpu/train/ and the JAX
package's ``run_speaker`` write out for themselves).

``restore_latest`` resumes a state from the latest checkpoint; the caller
then replays its batch schedule to that iteration.  ``run_loop`` runs the
iterations up to ``num_iterations`` and owns what every trainer does around
a step: losses stay on the device until the logging boundary, where
``_log`` reads them back once (with the last step's aux values) and
``check_finite`` guards against divergence; checkpoints are written every
``saving_steps`` and at the last iteration; on SIGTERM the current
iteration is saved and the loop stops, reporting the preemption so that the
caller skips its val sweep (the grace window ends at the checkpoint);
``profile_steps`` writes a torch.profiler trace of that many steps, from the
second on, into <output_dir>/profile/trace.json.
"""

from __future__ import annotations

import itertools
import os

import torch

from visitron_torch.train.logging import MetricsLogger, check_finite
from visitron_torch.train.preemption import PreemptionGuard


def restore_latest(ckpt, state: dict, logger) -> tuple[dict, int]:
    """(state, iteration): ``state`` with the params and optimizer state of
    the latest checkpoint and that checkpoint's iteration, or (state, 0)
    when there is none."""
    start_it = ckpt.latest()
    if start_it is None:
        return state, 0
    restored = ckpt.restore(start_it, {"params": state["params"],
                                       "opt_state": state["opt_state"]})
    logger.info("resumed from checkpoint-%d", start_it)
    return {**state, **restored}, start_it


def run_loop(trainer, step, batches, state: dict, start_it: int = 0,
             profile_steps: int = 0, on_save=None) -> tuple[dict, bool]:
    """(state, preempted) after ``state, out = step(state, batch)`` over
    ``batches`` for iterations start_it + 1 .. ``num_iterations`` (``out``
    is the loss or (loss, aux)); ``trainer`` gives the run's ``cfg``,
    ``ckpt``, ``logger`` and ``device``.  ``on_save(it, state)`` runs after
    each save at ``saving_steps`` and at the last iteration (the speaker's
    held-out word CE), not after a preemption save."""
    cfg, ckpt = trainer.cfg, trainer.ckpt
    metrics = MetricsLogger(cfg.output_dir, "train")
    losses, aux = [], None
    profiler = None
    with PreemptionGuard() as guard:
        for i, batch in enumerate(itertools.islice(batches,
                                                   max(cfg.num_iterations - start_it, 0))):
            it = start_it + i + 1
            if profile_steps and i == 1:  # the first step warms up
                profiler = _start_profiler(trainer.device)
            state, out = step(state, batch)
            loss, aux = out if isinstance(out, tuple) else (out, None)
            if profiler is not None and i == profile_steps:
                _stop_profiler(profiler, cfg.output_dir)
                profiler = None
            # The loss stays on the device until the logging boundary: a
            # read-back per step would stall the host on the device.
            losses.append(loss)
            if it % cfg.logging_steps == 0:
                _log(trainer.logger, metrics, it, losses, aux)
                losses.clear()
            saved = it % cfg.saving_steps == 0 or it == cfg.num_iterations
            if saved:
                ckpt.save(it, state["params"], state["opt_state"])
                if on_save is not None:
                    on_save(it, state)
            if guard.should_stop(it):
                if not saved:
                    ckpt.save(it, state["params"], state["opt_state"], wait=True)
                trainer.logger.info("termination signal: saved checkpoint-%d, stopping "
                                    "(restart with --resume)", it)
                break
    if profiler is not None:
        _stop_profiler(profiler, cfg.output_dir)
    ckpt.wait_until_finished()
    metrics.close()
    return state, guard.stop


def _log(logger, metrics: MetricsLogger, it: int, losses: list, aux: dict | None) -> None:
    """One read-back of the mean loss since the last boundary and the last
    step's aux values; checked, logged and written to train.csv."""
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
