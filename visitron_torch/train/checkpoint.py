"""Checkpoint manager (visitron_tpu/train/checkpoint.py): the JAX package's
``checkpoint-{step}`` layout and guarantees, with torch payloads.

A checkpoint is a directory ``<output_dir>/checkpoint-{step}`` holding

  * ``params.pt`` and ``opt_state.pt``: separate payloads, so eval paths
    read the parameters without the optimizer state; each is a nested
    dict (lists for the optimizer chain) of CPU tensors and Python
    numbers, written with ``torch.save`` and read with
    ``torch.load(weights_only=True)``;
  * ``meta.json``: ``{"step": step}`` plus ``extra``, written last, once
    the payloads are durable (written to a temporary name, fsynced, then
    renamed).  It is the completeness marker: :meth:`steps` lists only
    directories that have one, so ``--resume`` never picks up a
    half-written checkpoint (a process killed mid-save).

Async saves (``async_save=True`` / ``--async_checkpoints``): the
device-to-host copy runs on the caller's thread, the write on a background
thread that commits the marker after the payloads are durable; the train
loop goes on meanwhile.  A new save, ``wait=True`` and
:meth:`wait_until_finished` first finish the write in flight (and raise its
error, if it failed).

The dropout and sampling generators are not saved, as the JAX package
saves no PRNG key: a resumed run restarts its random streams from the
seed, so resume is exact when no dropout or sampling draws (dropouts 0,
teacher forcing).
"""

from __future__ import annotations

import json
import os
import re
import threading

import torch

PAYLOADS = ("params", "opt_state")


def _to_host(tree, copy: bool):
    """``tree`` with every tensor detached on the CPU (a copy where ``copy``
    or the tensor lives on a device); lists for tuples."""
    if isinstance(tree, dict):
        return {k: _to_host(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v, copy) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if copy or t.device.type != "cpu" else t
    if isinstance(tree, (int, float, bool)):
        return tree
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def place_like(saved, template, where: str):
    """``saved`` in the structure, device and dtype of ``template``; raises
    on a missing or extra key, a list of another length or a shape
    mismatch."""
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise TypeError(f"{where}: checkpoint holds {type(saved).__name__}, "
                            "the template a dict")
        missing, extra = sorted(set(template) - set(saved)), sorted(set(saved) - set(template))
        if missing or extra:
            raise KeyError(f"{where}: keys missing from the checkpoint {missing}, "
                           f"keys the template lacks {extra}")
        return {k: place_like(saved[k], template[k], f"{where}/{k}") for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise KeyError(f"{where}: the checkpoint's sequence does not match the "
                           f"template's {len(template)} entries")
        return [place_like(s, t, f"{where}/{i}")
                for i, (s, t) in enumerate(zip(saved, template))]
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise TypeError(f"{where}: checkpoint holds {type(saved).__name__}, "
                            "the template a tensor")
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"{where}: checkpoint shape {tuple(saved.shape)} != "
                             f"template shape {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, (int, float)) and not isinstance(template, bool):
        if isinstance(saved, torch.Tensor) or not isinstance(saved, (int, float)):
            raise TypeError(f"{where}: checkpoint holds {type(saved).__name__}, "
                            "the template a number")
        return type(template)(saved)
    raise TypeError(f"{where}: unsupported template leaf {type(template).__name__}")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _durable_write(path: str, write) -> None:
    """``write(file)`` to a temporary name, fsync, rename to ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, output_dir: str, async_save: bool = False):
        self.output_dir = os.path.abspath(output_dir)
        self.async_save = async_save
        os.makedirs(self.output_dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step}")

    def _flush(self) -> None:
        """Block until the write in flight (if any) and its marker are
        durable; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") from err

    def wait_until_finished(self) -> None:
        """Public flush: call after the train loop (and before process exit)
        when running with ``async_save``."""
        self._flush()

    def _write(self, path: str, payloads: dict, meta: dict) -> None:
        os.makedirs(path, exist_ok=True)
        marker = os.path.join(path, "meta.json")
        if os.path.exists(marker):  # an overwrite is incomplete until re-marked
            os.remove(marker)
        for name, obj in payloads.items():
            _durable_write(os.path.join(path, f"{name}.pt"),
                           lambda f, obj=obj: torch.save(obj, f))
        _fsync_dir(path)
        _durable_write(marker, lambda f: f.write(json.dumps(meta, default=str).encode()))
        _fsync_dir(path)

    def _write_in_background(self, path: str, payloads: dict, meta: dict) -> None:
        try:
            self._write(path, payloads, meta)
        except BaseException as err:  # handed to the caller's thread by _flush
            self._error = err

    def save(self, step: int, params, opt_state=None, extra: dict | None = None,
             wait: bool | None = None) -> str:
        """Write checkpoint ``step``: ``params`` and, if given, ``opt_state``.

        ``wait=None`` uses the manager default (sync unless ``async_save``);
        pass ``wait=True`` for saves the caller exits right after (the
        preemption checkpoint, the final save)."""
        wait = (not self.async_save) if wait is None else wait
        self._flush()  # one write in flight at a time, markers in order
        path = self.path(step)
        payloads = {"params": _to_host(params, copy=not wait)}
        if opt_state is not None:
            payloads["opt_state"] = _to_host(opt_state, copy=not wait)
        meta = {"step": step}
        meta.update(extra or {})
        if wait:
            self._write(path, payloads, meta)
        else:
            self._thread = threading.Thread(target=self._write_in_background,
                                            args=(path, payloads, meta), daemon=True,
                                            name=f"checkpoint-{step}")
            self._thread.start()
        return path

    def restore(self, step: int, template: dict) -> dict:
        """The payloads named by ``template``'s keys ("params", "opt_state"),
        each leaf put into the template's structure, device and dtype."""
        out = {}
        for name, tmpl in template.items():
            out[name] = place_like(self.restore_raw(step, name), tmpl, name)
        return out

    def restore_raw(self, step: int, name: str = "params"):
        """A payload as saved (CPU tensors), without a template: eval paths
        read RL checkpoints, whose params carry the critic, this way."""
        if name not in PAYLOADS:
            raise KeyError(f"unknown checkpoint payload {name!r}")
        return torch.load(os.path.join(self.path(step), f"{name}.pt"),
                          map_location="cpu", weights_only=True)

    def steps(self) -> list[int]:
        """Completed checkpoints only: a directory without its meta.json
        marker is an in-flight or crashed write and is not listed."""
        out = []
        if not os.path.isdir(self.output_dir):
            return out
        for name in os.listdir(self.output_dir):
            m = re.fullmatch(r"checkpoint-(\d+)", name)
            if m and os.path.exists(os.path.join(self.output_dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None
