"""CLI entry point: ``python -m visitron_torch.run <task> [--flags]``
(visitron_tpu/run.py), on the card.

  viewpoint  NDH(+R2R/R4R/RxR) viewpoint-selection fine-tune + val
             (``--test_only``: the test split's submission from the latest
             checkpoint)
  pretrain   multimodal (MLM + action + region-token) pretraining

``--config run_configs/....json`` reads an experiment file; flags given
after it override its values (only those present on the command line, so
a flag set to its default still wins).  ``--debug`` runs in a synthetic
world.

The JAX package's other tasks are not ported yet and exit with a message
naming their ROADMAP items: turn_based (item 5), classifier (item 6),
speaker and augment (item 7), datagen (item 4), extract_scene and
extract_regions (item 9).  Device meshes, ZeRO-1 and FSDP (item 10) raise.
"""

from __future__ import annotations

import dataclasses
import sys

from visitron_torch.config import RunConfig, refuse_unported_hardware
from visitron_torch.train.workspace import Workspace

UNPORTED_TASKS = {
    "turn_based": "ROADMAP item 5",
    "classifier": "ROADMAP item 6",
    "speaker": "ROADMAP item 7",
    "augment": "ROADMAP item 7",
    "datagen": "ROADMAP item 4",
    "extract_scene": "ROADMAP item 9",
    "extract_regions": "ROADMAP item 9",
}


def run_viewpoint(cfg: RunConfig, do_val: bool = True, device=None):
    from visitron_torch.train.finetune import ViewpointTrainer

    ws = _workspace_for_nav(cfg, device)
    trainer = ViewpointTrainer(cfg, ws, device=device)
    if cfg.test_only:
        # Roll out the test split from the latest checkpoint and write the
        # EvalAI submission (train.py:575-579).
        trainer.test_submission()
        return None
    state = trainer.train(resume=cfg.resume, profile_steps=cfg.profile_steps)
    if do_val and not trainer.preempted:
        # --eval_iters selects checkpoint iterations; [-1] means all
        # (reference train.py:182-189).
        steps = None if cfg.eval_iters == [-1] else cfg.eval_iters
        trainer.val(steps=steps)
    return state


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
    if task not in ("viewpoint", "pretrain"):
        raise SystemExit(f"unknown task {task!r}; see --help")
    if rest and rest[0] == "--config":
        explicit = RunConfig.cli_overrides(rest[2:])
        cfg = dataclasses.replace(RunConfig.from_json(rest[1]), **explicit)
    else:
        explicit = RunConfig.cli_overrides(rest)
        cfg = RunConfig.from_args(rest)
    # FSDP belongs to the pretrain task: an explicit flag elsewhere is an
    # error, a value inherited from a shared config file only warns (as in
    # the JAX package).
    if cfg.fsdp and task != "pretrain":
        if "fsdp" in explicit:
            raise SystemExit("--fsdp applies to the pretrain task; use --zero1 for the "
                             "fine-tune loops")
        print(f"warning: config-file fsdp=true is ignored by task {task!r}",
              file=sys.stderr)
        cfg = dataclasses.replace(cfg, fsdp=False)
    refuse_unported_hardware(cfg)
    if task == "viewpoint":
        run_viewpoint(cfg, device=device)
    else:
        run_pretrain(cfg, device=device)


if __name__ == "__main__":
    main()
