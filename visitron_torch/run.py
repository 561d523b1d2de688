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
  speaker     train a speaker (trajectory -> instruction) on the nav data
  augment     caption sampled walks with a trained speaker -> R2R-format
              augmentation JSON (``viewpoint --aug_data``)
  extract_scene    ResNet-152 scene features of every panorama from its
                   skybox JPEGs -> the reference TSV
  extract_regions  bottom-up Faster R-CNN region features of every view ->
                   the reference region pickle store

``--config run_configs/....json`` reads an experiment file; flags given
after it override its values (only those present on the command line, so
a flag set to its default still wins).  ``--debug`` runs in a synthetic
world.

Parallelism: launched as ``python -m torch.distributed.run
--nproc_per_node N -m visitron_torch.run <task> ...`` the training tasks
(viewpoint, turn_based, classifier, pretrain) run one rank a process over
NCCL, each on ``cuda:LOCAL_RANK`` (gloo on the CPU when ``device="cpu"``),
on a (dp, X) mesh of N ranks: ``--mesh_tp X`` (tensor parallelism, every
training task), ``--mesh_sp X`` (Ulysses sequence parallelism) or
``--mesh_cp X`` (ring-attention context parallelism) or ``--mesh_pp X``
(GPipe pipeline stages, on one host; ``--pipeline_microbatches``),
pretrain only, with ``--mesh_dp`` 0 or N / X; ``--zero1`` (pretrain,
viewpoint) and ``--fsdp`` (pretrain, not with ``--mesh_pp``) shard the
optimizer state or the whole training state over dp; rank 0 writes the
files, and runs validation on the single-device layout (every rank of a
pp mesh runs the pipelined evaluation).  The other tasks run in one
process.
"""

from __future__ import annotations

import dataclasses
import sys

import torch
import torch.distributed as dist

from visitron_torch import parallel
from visitron_torch.config import PRETRAIN_AXES, RunConfig
from visitron_torch.train.workspace import Workspace

# The tasks that train data-parallel over a process group.
DP_TASKS = ("viewpoint", "turn_based", "classifier", "pretrain")


def _train_and_val(trainer, cfg: RunConfig, do_val: bool, **train_kw):
    """``trainer.train`` (resuming with ``--resume``), then, unless
    ``do_val`` is off or the run was preempted, ``trainer.val`` over the
    checkpoints of ``--eval_iters`` ([-1]: all; reference train.py:182-189)."""
    state = trainer.train(resume=cfg.resume, **train_kw)
    if do_val and not trainer.preempted and parallel.is_primary(trainer.mesh):
        trainer.val(steps=None if cfg.eval_iters == [-1] else cfg.eval_iters)
    return state


def run_viewpoint(cfg: RunConfig, do_val: bool = True, device=None):
    from visitron_torch.train.finetune import ViewpointTrainer

    trainer = ViewpointTrainer(cfg, _workspace_for_nav(cfg, device), device=device)
    if cfg.test_only:
        # Roll out the test split from the latest checkpoint and write the
        # EvalAI submission (train.py:575-579), on rank 0.
        if parallel.is_primary(trainer.mesh):
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


def _speaker_for(cfg: RunConfig, ws: Workspace, device=None):
    from visitron_torch.agents.speaker import SpeakerAgent

    tok = ws.tokenizer
    return SpeakerAgent(
        runtime=ws.runtime, feature_dim=cfg.lstm_img_feature_dim, vocab_size=len(tok),
        bos_id=tok.vocab[tok.cls_token], eos_id=tok.vocab[tok.sep_token],
        pad_id=tok.pad_token_id, episode_len=cfg.episode_len, max_words=cfg.max_words,
        hidden_size=cfg.rnn_dim, dropout=cfg.dropout, learning_rate=cfg.learning_rate,
        seed=cfg.seed, feat_dropout=cfg.speaker_feat_dropout,
        movement_frame=cfg.speaker_movement_frame, device=device)


def run_speaker(cfg: RunConfig, device=None):
    """Train a speaker on the nav training data's (teacher trajectory, text)
    pairs through the shared train loop; at each checkpoint the held-out
    word CE of four val_seen batches is logged (when the split exists).
    Checkpoints land in --output_dir for ``augment``."""
    import types

    from visitron_torch.agents.batcher import NavEpisodeBatcher
    from visitron_torch.agents.speaker import SpeakerAgent
    from visitron_torch.train.checkpoint import CheckpointManager
    from visitron_torch.train.finetune import nav_batcher, viewpoint_instances
    from visitron_torch.train.logging import setup_logger
    from visitron_torch.train.loop import restore_latest, run_loop

    ws = _workspace_for_nav(cfg, device)
    logger = setup_logger(output_dir=cfg.output_dir)
    instances = viewpoint_instances(cfg, ws, ["train"], logger)
    sp = _speaker_for(cfg, ws, device)
    batch_size = cfg.train_batch_size(1)
    batcher = nav_batcher(cfg, ws, instances, batch_size)
    text_by_idx = {i.inst_idx: SpeakerAgent.instance_text(i) for i in instances}
    val_batches = []
    try:
        val_inst = viewpoint_instances(cfg, ws, ["val_seen"], logger)
        vb = NavEpisodeBatcher(val_inst, ws.runtime, batch_size=batch_size,
                               path_type=cfg.path_type, seed=cfg.seed)
        val_text = {i.inst_idx: SpeakerAgent.instance_text(i) for i in val_inst}
        val_batches = [sp.attach_words(b, ws.tokenizer, val_text)
                       for b in vb.train_batches(4, episode_len=cfg.episode_len)]
    except FileNotFoundError:
        logger.info("no val_seen split; skipping speaker validation")
    eval_loss = sp.eval_loss_fn()

    def log_val(it, state):
        if val_batches:
            ce = torch.stack([eval_loss(state["params"], b) for b in val_batches]).mean()
            logger.info("speaker ckpt %d val word-CE %.4f", it, float(ce))

    trainer = types.SimpleNamespace(
        cfg=cfg, logger=logger, device=sp.device,
        ckpt=CheckpointManager(cfg.output_dir, async_save=cfg.async_checkpoints))
    state, start_it = sp.init_state(), 0
    if cfg.resume:
        state, start_it = restore_latest(trainer.ckpt, state, logger)
        batcher.skip_batches(start_it)
    batches = (sp.attach_words(b, ws.tokenizer, text_by_idx)
               for b in batcher.train_batches(cfg.num_iterations - start_it,
                                              episode_len=cfg.episode_len))
    state, _ = run_loop(trainer, sp.train_step_fn(), batches, state, start_it,
                        on_save=log_val)
    return state


def run_augment(cfg: RunConfig, device=None):
    """Caption sampled shortest-path walks with the latest speaker
    checkpoint of --speaker_checkpoint (or --output_dir) and write
    R2R-format augmentation JSON to <output_dir>/aug_data.json; with
    --aug_targets each record carries a target word of the NDH train
    split."""
    import os
    import tempfile

    import numpy as np

    from visitron_torch.agents.speaker import write_aug_records
    from visitron_torch.data.datasets import load_split
    from visitron_torch.train.checkpoint import CheckpointManager

    ws = _workspace_for_nav(cfg, device)
    sp = _speaker_for(cfg, ws, device)
    ckpt = CheckpointManager(cfg.speaker_checkpoint or cfg.output_dir)
    step = ckpt.latest()
    if step is None:
        raise SystemExit(f"no speaker checkpoint under {ckpt.output_dir!r}; run "
                         "`run.py speaker` first or pass --speaker_checkpoint")
    params = ckpt.restore(step, {"params": sp.init_params()})["params"]
    target_vocab = None
    if cfg.aug_targets:
        # Targets of the NDH train split, so that the records carry the
        # real instances' [TAR] span.
        if ws.synthetic is not None:
            with tempfile.TemporaryDirectory(prefix="visitron_synth_") as root:
                ws.synthetic.write_task_data(root)
                items = load_split(root, ["train"], "NDH")
        else:
            items = load_split(cfg.data_root, ["train"], "NDH")
        target_vocab = sorted({str(item["target"]) for item in items})
    records = sp.augment(params, ws.tokenizer, np.random.default_rng(cfg.seed), cfg.num_aug,
                         temperature=cfg.aug_temperature,
                         keep_fraction=cfg.aug_keep_fraction or None,
                         target_vocab=target_vocab)
    out = os.path.join(cfg.output_dir, "aug_data.json")
    os.makedirs(cfg.output_dir, exist_ok=True)
    write_aug_records(records, out)
    print(f"wrote {len(records)} augmentation records to {out}")
    return out


def _extract_graphs(cfg: RunConfig) -> dict:
    """Nav graphs for the offline pipelines (which come before any feature
    store, so no Workspace): every scan with a connectivity file."""
    import os

    from visitron_torch.graph import load_nav_graphs

    scans = sorted(
        f.removesuffix("_connectivity.json")
        for f in os.listdir(cfg.connectivity_dir)
        if f.endswith("_connectivity.json"))
    return load_nav_graphs(cfg.connectivity_dir, scans)


def run_extract_scene(cfg: RunConfig, device=None):
    """Scene (ResNet) features from skybox JPEGs -> TSV
    (scripts/precompute_resnet_img_features.py parity): the six uint8 faces
    of each panorama go to the card, which resamples the 36 views and runs
    the backbone; the host only decodes JPEGs."""
    from visitron_torch.pipelines.rendering import SkyboxRenderer
    from visitron_torch.pipelines.scene_features import SceneFeatureExtractor
    from visitron_torch.train.logging import setup_logger

    logger = setup_logger(output_dir=cfg.output_dir)
    # Reference geometry: 640x480 VFOV 60 (precompute_resnet_img_features.py);
    # --debug without a checkpoint shrinks the render for smoke runs.
    w, h = (64, 48) if cfg.debug and not cfg.resnet_checkpoint else (640, 480)
    renderer = SkyboxRenderer(cfg.matterport_dir, image_w=w, image_h=h, vfov=60)
    # "default" = bf16 for scene features (config.py:feature_extract_dtype).
    dt = torch.float32 if cfg.feature_extract_dtype == "float32" else torch.bfloat16
    kw = dict(image_w=w, image_h=h, vfov=60, dtype=dt, device=device)
    if cfg.resnet_checkpoint:
        ex = SceneFeatureExtractor.from_torch_checkpoint(cfg.resnet_checkpoint, **kw)
    else:
        logger.warning("no --resnet_checkpoint; using a randomly initialized "
                       "backbone (debug only)")
        ex = SceneFeatureExtractor.random_init(depth=50, **kw)
    out = cfg.img_feature_file or f"{cfg.output_dir}/scene_features.tsv"
    ex.extract_all(_extract_graphs(cfg), renderer.load_faces, out_tsv=out,
                   logger=logger, provider="faces")
    logger.info("wrote scene features to %s", out)
    return out


def run_extract_regions(cfg: RunConfig, device=None):
    """Bottom-up region features from skybox JPEGs -> pickle store
    (scripts/precompute_bottom-up_features.py + add_orientation parity)."""
    import numpy as np

    from visitron_torch.models.detector import BottomUpDetector
    from visitron_torch.pipelines.region_features import (RegionFeatureExtractor,
                                                          StubDetector)
    from visitron_torch.pipelines.rendering import SkyboxRenderer
    from visitron_torch.train.logging import setup_logger

    logger = setup_logger(output_dir=cfg.output_dir)
    # Reference geometry: 600x600 VFOV 80 (precompute_bottom-up_features.py);
    # --debug with the stub shrinks the render for smoke runs.
    side = 60 if cfg.debug and not cfg.detector_weights else 600
    renderer = SkyboxRenderer(cfg.matterport_dir, image_w=side, image_h=side, vfov=80)
    if cfg.detector_weights:
        state = dict(np.load(cfg.detector_weights, allow_pickle=True))
        # "default" = fp32 for the detector: bf16 backbone drift can flip
        # which boxes survive NMS (config.py:feature_extract_dtype).
        dt = torch.bfloat16 if cfg.feature_extract_dtype == "bfloat16" else torch.float32
        detector = BottomUpDetector.from_caffe_dump(state, dtype=dt, device=device)
        with open(cfg.objects_vocab) as f:
            classes = f.read().splitlines()
        with open(cfg.attributes_vocab) as f:
            attributes = f.read().splitlines()
    elif cfg.debug:
        logger.warning("no --detector_weights; StubDetector (--debug)")
        detector = StubDetector()
        classes = ["__background__"] + [f"c{i}" for i in range(detector.num_classes - 1)]
        attributes = ["__no_attribute__"] + [f"a{i}" for i in range(detector.num_attributes - 1)]
    else:
        raise SystemExit("extract_regions needs --detector_weights (VG Faster "
                         "R-CNN dump) + --objects_vocab/--attributes_vocab, "
                         "or --debug for the stub")
    ex = RegionFeatureExtractor(detector, classes, attributes, image_w=side,
                                image_h=side, vfov=80, device=device)
    # The uint8 faces go to the card, which renders the views; they reach the
    # detector without leaving it.
    store = ex.extract_all(_extract_graphs(cfg), renderer.load_faces, provider="faces")
    prefix = cfg.region_feature_prefix or f"{cfg.output_dir}/region_features"
    store.to_pickle(prefix)
    logger.info("wrote region store (%d keys) to %s*", len(store), prefix)
    return prefix


# Each task runs through run_<task>, looked up when it runs.
TASKS = ("viewpoint", "turn_based", "classifier", "pretrain", "datagen", "speaker",
         "augment", "extract_scene", "extract_regions")


def main(argv=None, device=None):
    """Run ``argv`` (default: the command line); ``device`` None runs on the
    card, ``"cpu"`` on the CPU."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    task, rest = argv[0], argv[1:]
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
    for axis in PRETRAIN_AXES:
        if getattr(cfg, axis) > 1 and task != "pretrain":
            if axis in explicit:
                raise SystemExit(f"--{axis} applies to the pretrain task; use --mesh_tp "
                                 "for the fine-tune loops")
            print(f"warning: config-file {axis}={getattr(cfg, axis)} is ignored by task "
                  f"{task!r}", file=sys.stderr)
            cfg = dataclasses.replace(cfg, **{axis: 1})
    joined = not dist.is_initialized() and parallel.launched_by_torchrun()
    if joined:
        # Under torchrun: this rank's process group, NCCL on cuda:LOCAL_RANK
        # (gloo when the caller asks for the CPU).  A group that does not
        # form raises.
        device = parallel.init_process_group(device)
    if dist.is_initialized() and dist.get_world_size() > 1 and task not in DP_TASKS:
        raise SystemExit(f"task {task!r} runs in one process; data parallelism is for "
                         f"{', '.join(DP_TASKS)}")
    try:
        globals()[f"run_{task}"](cfg, device=device)
    finally:
        if joined:
            parallel.destroy_process_group()


if __name__ == "__main__":
    main()
