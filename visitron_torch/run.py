"""CLI entry point: ``python -m visitron_torch.run <task> [--flags]``
(visitron_tpu/run.py), on the card.

  viewpoint   NDH(+R2R/R4R/RxR) viewpoint-selection fine-tune + val
              (``--test_only``: the test split's submission from the latest
              checkpoint)
  turn_based  low-level action-space training + val
  classifier  question-asking classifier training + val, from a viewpoint
              run's checkpoint (``--model_name_or_path``)
  pretrain    multimodal (MLM + action + region-token) pretraining
  datagen     pretraining-example generation (path walks)

``--config run_configs/....json`` reads an experiment file; flags given
after it override its values (only those present on the command line, so
a flag set to its default still wins).  ``--debug`` runs in a synthetic
world.

The JAX package's other tasks are not ported yet and exit with a message
naming their ROADMAP items: speaker and augment (item 7), extract_scene and
extract_regions (item 9).  Device meshes, ZeRO-1 and FSDP (item 10) raise.
"""

from __future__ import annotations

import dataclasses
import sys

from visitron_torch.config import RunConfig, refuse_unported_hardware
from visitron_torch.train.workspace import Workspace

UNPORTED_TASKS = {
    "speaker": "ROADMAP item 7",
    "augment": "ROADMAP item 7",
    "extract_scene": "ROADMAP item 9",
    "extract_regions": "ROADMAP item 9",
}


def _train_and_val(trainer, cfg: RunConfig, do_val: bool, **train_kw):
    """``trainer.train`` (resuming with ``--resume``), then, unless
    ``do_val`` is off or the run was preempted, ``trainer.val`` over the
    checkpoints of ``--eval_iters`` ([-1]: all; reference train.py:182-189)."""
    state = trainer.train(resume=cfg.resume, **train_kw)
    if do_val and not trainer.preempted:
        trainer.val(steps=None if cfg.eval_iters == [-1] else cfg.eval_iters)
    return state


def run_viewpoint(cfg: RunConfig, do_val: bool = True, device=None):
    from visitron_torch.train.finetune import ViewpointTrainer

    trainer = ViewpointTrainer(cfg, _workspace_for_nav(cfg, device), device=device)
    if cfg.test_only:
        # Roll out the test split from the latest checkpoint and write the
        # EvalAI submission (train.py:575-579).
        trainer.test_submission()
        return None
    return _train_and_val(trainer, cfg, do_val, profile_steps=cfg.profile_steps)


def run_turn_based(cfg: RunConfig, do_val: bool = True, device=None):
    from visitron_torch.train.turn_based import TurnBasedTrainer

    return _train_and_val(TurnBasedTrainer(cfg, _workspace_for_nav(cfg, device),
                                           device=device), cfg, do_val)


def run_classifier(cfg: RunConfig, do_val: bool = True, device=None):
    from visitron_torch.train.classifier import ClassifierTrainer

    return _train_and_val(ClassifierTrainer(cfg, _workspace_for_nav(cfg, device),
                                            device=device), cfg, do_val)


def _workspace_for_nav(cfg: RunConfig, device=None) -> Workspace:
    if cfg.debug:
        return Workspace.synthetic_workspace(cfg, device=device)
    from visitron_torch.data.datasets import load_split

    scans = set()
    for splits in (["train"], ["val_seen"], ["val_unseen"]):
        try:
            for item in load_split(cfg.data_root, splits, "NDH"):
                scans.add(item["scan"])
        except FileNotFoundError:
            pass
    for ds, flag in (("R2R", cfg.add_r2r_data), ("R4R", cfg.add_r4r_data)):
        if flag:
            for item in load_split(cfg.data_root, ["train"], ds):
                scans.add(item["scan"])
    if cfg.add_rxr_data:
        for item in load_split(cfg.data_root, ["train"], "RxR"):
            scans.add(item["scan"])
    return Workspace.from_config(cfg, scans=scans, device=device)


def run_pretrain(cfg: RunConfig, device=None):
    from visitron_torch.train.pretrain import pretrain_loop

    return pretrain_loop(cfg, _workspace_for_nav(cfg, device), device=device)


def run_datagen(cfg: RunConfig, device=None):
    """Write the per-path-step pretraining JSONs under
    ``<data_root>/pretrain_data`` (reference
    scripts/generate_pretraining_data.py, minus the 8-process simulator
    pool: the closed-form walk needs none); with ``--debug``, under the
    synthetic task data in ``<output_dir>/synthetic_task_data``."""
    import os

    from visitron_torch.pipelines.pretrain_datagen import write_pretrain_data
    from visitron_torch.train.logging import setup_logger

    ws = _workspace_for_nav(cfg, device)
    logger = setup_logger(output_dir=cfg.output_dir)
    if ws.synthetic is not None:
        # The JAX package's counts (no test split), as its datagen writes.
        root = os.path.join(cfg.output_dir, "synthetic_task_data")
        ws.synthetic.write_task_data(root)
    else:
        root = cfg.data_root
    tables = {s: ws.runtime.tables[s] for s in ws.graphs}
    for ds, flag in (("NDH", cfg.add_ndh_data), ("R2R", cfg.add_r2r_data),
                     ("R4R", cfg.add_r4r_data), ("RxR", cfg.add_rxr_data)):
        if not flag:
            continue
        splits = ["train"] if ds == "RxR" else ["train", "val_seen", "val_unseen"]
        out = write_pretrain_data(root, splits, ds, ws.graphs, tables)
        logger.info("wrote %s pretraining data under %s", ds, out)


# Each task runs through run_<task>, looked up when it runs.
TASKS = ("viewpoint", "turn_based", "classifier", "pretrain", "datagen")


def main(argv=None, device=None):
    """Run ``argv`` (default: the command line); ``device`` None runs on the
    card, ``"cpu"`` on the CPU."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    task, rest = argv[0], argv[1:]
    if task in UNPORTED_TASKS:
        raise SystemExit(f"task {task!r} is not ported to visitron_torch yet "
                         f"({UNPORTED_TASKS[task]})")
    if task not in TASKS:
        raise SystemExit(f"unknown task {task!r}; see --help")
    if rest and rest[0] == "--config":
        explicit = RunConfig.cli_overrides(rest[2:])
        cfg = dataclasses.replace(RunConfig.from_json(rest[1]), **explicit)
    else:
        explicit = RunConfig.cli_overrides(rest)
        cfg = RunConfig.from_args(rest)
    # FSDP belongs to the pretrain task, ZeRO-1 to pretrain and viewpoint: an
    # explicit flag elsewhere is an error, a value inherited from a shared
    # config file only warns (as in the JAX package).
    if cfg.fsdp and task != "pretrain":
        if "fsdp" in explicit:
            raise SystemExit("--fsdp applies to the pretrain task; use --zero1 for the "
                             "fine-tune loops")
        print(f"warning: config-file fsdp=true is ignored by task {task!r}",
              file=sys.stderr)
        cfg = dataclasses.replace(cfg, fsdp=False)
    if cfg.zero1 and task not in ("pretrain", "viewpoint"):
        if "zero1" in explicit:
            raise SystemExit("--zero1 applies to the pretrain and viewpoint tasks")
        print(f"warning: config-file zero1=true is ignored by task {task!r}",
              file=sys.stderr)
        cfg = dataclasses.replace(cfg, zero1=False)
    refuse_unported_hardware(cfg)
    globals()[f"run_{task}"](cfg, device=device)


if __name__ == "__main__":
    main()
