"""Experiment logging: stdout + CSV + optional TensorBoard
(visitron_tpu/train/logging.py).

Covers the reference observability surface (train.py:63,134-173: tensorboardX
scalars, pandas CSV per save step, rank-gated python logging) without the
pandas dependency in the hot path.  The CSV columns are the JAX package's.
"""

from __future__ import annotations

import csv
import logging
import os
import time


def check_finite(value: float, it: int, logger: logging.Logger) -> float:
    """Fail fast on training divergence.

    Called on the loss at the logging boundary (where the device->host fetch
    already happens, so this adds no sync).  A NaN/inf loss otherwise trains
    on silently — burning accelerator-hours on garbage gradients and, worse,
    overwriting good checkpoints at the next save.  The reference has no
    such guard (train.py's loop logs whatever comes back)."""
    import math

    if not math.isfinite(value):
        logger.error(
            "non-finite training loss %r at iter %d — aborting (restart "
            "from the last finite checkpoint with --resume, with a lower "
            "learning rate / higher max_grad_norm clip)", value, it)
        raise FloatingPointError(
            f"training diverged: loss={value!r} at iteration {it}")
    return value


def setup_logger(name: str = "visitron_torch", output_dir: str | None = None,
                 is_main_process: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if is_main_process else logging.WARNING)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if output_dir and is_main_process:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "train.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Appends metric rows to CSV, mirrors to TensorBoard when available."""

    def __init__(self, output_dir: str, name: str = "metrics",
                 use_tensorboard: bool = True, is_main_process: bool = True):
        self.enabled = is_main_process
        self.output_dir = output_dir
        self.csv_path = os.path.join(output_dir, f"{name}.csv")
        self._rows: list[dict] = []
        self._fields: list[str] = []
        self._tb = None
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
                except ImportError:
                    self._tb = None

    def log(self, metrics: dict, step: int | None = None, prefix: str = "") -> None:
        if not self.enabled:
            return
        row = {("%s%s" % (prefix, k)): v for k, v in metrics.items()}
        row["step"] = step if step is not None else time.time()
        # Rows are buffered and the file rewritten so late-appearing keys
        # (e.g. a second split's prefix) are never dropped.
        self._rows.append(row)
        for k in row:
            if k not in self._fields:
                self._fields = sorted(set(self._fields) | set(row.keys()))
                break
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(self._rows)
        if self._tb is not None and step is not None:
            for k, v in row.items():
                if isinstance(v, (int, float)) and k != "step":
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
