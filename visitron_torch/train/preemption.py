"""Preemption-safe training: checkpoint-and-exit on SIGTERM
(visitron_tpu/train/preemption.py).

Accelerator fleets preempt with a SIGTERM grace window.  Every train loop
runs under a :class:`PreemptionGuard`: the signal handler only sets a flag
(async-signal-safe: it never raises into a step or a checkpoint write), and
the loop polls :meth:`PreemptionGuard.should_stop` at its step boundary,
writes a full exact-resume checkpoint (params + optimizer state) at the
current iteration, and returns cleanly.  ``--resume`` then continues from
that step, data schedule included (``NavEpisodeBatcher.skip_batches``,
``PretrainDataset.set_epoch``).

In a data-parallel run of several processes the stop decision is a
consensus (visitron_tpu/train/preemption.py:85-104): every ``sync_every``
steps each rank gathers every rank's flag, and all stop when any flag is
set, at the same step, so a lone latched rank never leaves the others
waiting in the next collective.
"""

from __future__ import annotations

import signal
import threading

import torch.distributed as dist


class PreemptionGuard:
    """Context manager that latches termination signals into a flag.

    Usage::

        with PreemptionGuard() as guard:
            for batch in batches:
                ...train step...
                it += 1
                if guard.should_stop(it):
                    ckpt.save(it, params, opt_state, wait=True)
                    break

    * Handlers are installed only in the main thread (Python restricts
      ``signal.signal`` to it); elsewhere the guard is inert and ``fired``
      stays False.
    * A previously installed *callable* handler is chained after the flag is
      set, so external supervisors keep their semantics; SIG_DFL/SIG_IGN are
      not re-invoked (the default SIGTERM action would kill the process
      before the checkpoint happens; latching the flag IS the override).
    * Original handlers are restored on exit.
    * ``fired`` is the latch; ``should_stop(it)`` is the stop decision train
      loops use; ``stop`` caches the last decision for post-loop code
      (skip-val, ``preempted``).
    """

    #: The consensus cadence (steps) of a run over several processes: it
    #: bounds the latch-to-checkpoint delay; one process decides every step.
    SYNC_EVERY = 25

    def __init__(self, signals=(signal.SIGTERM,), sync_every: int | None = None):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._fired = False
        self._stop = False
        self._sync_every = int(sync_every or self.SYNC_EVERY)

    @property
    def fired(self) -> bool:
        """A termination signal reached this process."""
        return self._fired

    @property
    def stop(self) -> bool:
        """Last :meth:`should_stop` decision."""
        return self._stop

    def should_stop(self, it: int) -> bool:
        """Stop decision at step boundary ``it`` (1-based iteration count):
        the latched flag in one process; in a process group of several,
        every ``sync_every`` steps, whether any rank's flag is set (every
        rank evaluates it at the same step and gets the same answer)."""
        if self._stop:
            return True
        if not dist.is_initialized() or dist.get_world_size() == 1:
            self._stop = self._fired
        elif it % self._sync_every == 0:
            from visitron_torch.parallel import make_mesh
            from visitron_torch.parallel.mesh import all_gather_object

            self._stop = any(all_gather_object(self._fired, make_mesh()))
        return self._stop

    def _handle(self, signum, frame):
        self._fired = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> bool:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        return False
