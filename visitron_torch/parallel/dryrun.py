"""A multi-rank dry run: ranks that take the port's mesh arms through one
training step each and print one line of losses (the counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``, whose arms it runs).

    python -m visitron_torch.parallel.dryrun --ranks 4               # cards
    python -m visitron_torch.parallel.dryrun --ranks 4 --device cpu  # CPU

starts ``--ranks`` processes (an even count of at least 4) that join a
group through a ``file://`` rendezvous in a temporary directory: NCCL with
one rank per card (``--device cuda``, the default; ``--ranks`` cards), or
gloo on the CPU (``--device cpu``, the rehearsal).  It runs, at the JAX dry
run's tiny BERT (hidden 64, 2 layers, 4 heads) on random batches from
``--seed``:

  * tp (dp ranks/2, tp 2): two pretraining steps, and a viewpoint
    teacher-forced step in a synthetic world;
  * sp + ZeRO-1 (dp ranks/2, sp 2): a pretraining step;
  * FSDP (dp ranks): a pretraining step, its largest parameter sharded;
  * ring cp (dp ranks/2, cp 2): a pretraining step;
  * pipeline (dp ranks/2, pp 2): a GPipe pretraining step of 2
    microbatches (the JAX dry run's ``pipeline(dp=2,pp=2)`` arm).

Every loss must be finite; rank 0 prints ``dryrun ok: ...`` and the command
exits 0, else it exits 1.  Each process imports torch and the port only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from visitron_torch import parallel

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BERT = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=64, type_vocab_size=4,
            img_feature_dim=32, action_space=36, detector_classes=8)


def example_batch(n: int, seq: int, img: int, rng: np.random.Generator) -> dict:
    """A random pretraining batch of ``n`` rows: ``seq`` text tokens (the
    last few of each row padded), ``img`` region features, MLM and region
    labels on about 15% of the tokens."""
    s = seq + img
    mask = np.ones((n, s), np.int32)
    lengths = rng.integers(seq // 2, seq + 1, n)
    mask[:, :seq] = np.arange(seq)[None, :] < lengths[:, None]
    labels = np.where(rng.random((n, s)) < 0.15, rng.integers(0, BERT["vocab_size"], (n, s)), -1)
    labels[:, seq:] = -1
    tokens = np.where(rng.random((n, s)) < 0.15,
                      rng.integers(0, BERT["detector_classes"], (n, s)), -1)
    return {"input_ids": rng.integers(0, BERT["vocab_size"], (n, seq)).astype(np.int32),
            "token_type_ids": np.zeros((n, seq), np.int32), "attention_mask": mask,
            "labels": labels.astype(np.int32), "token_labels": tokens.astype(np.int32),
            "img_feats": rng.standard_normal((n, img, BERT["img_feature_dim"])).astype(
                np.float32),
            "img_location_embeddings": rng.standard_normal((n, img, 128)).astype(np.float32),
            "next_action": rng.integers(-1, BERT["action_space"], n).astype(np.int32)}


def pretrain_losses(mesh, batch: dict, steps: int = 1, **kw) -> list[float]:
    """The losses of ``steps`` pretraining steps on ``mesh`` (this rank's
    rows of ``batch``)."""
    from visitron_torch.models import BertConfig
    from visitron_torch.train import PretrainTrainer

    trainer = PretrainTrainer(BertConfig(**BERT), mesh=mesh, total_steps=10,
                              device=mesh.device, **kw)
    state = trainer.init_state()
    step = trainer.step_fn()
    losses = []
    for _ in range(steps):
        state, bundle = step(state, parallel.shard_batch(mesh, batch))
        losses.append(float(bundle["loss"]))
    if kw.get("fsdp") and mesh.dp > 1:
        big = max(trainer.init_params().items(), key=lambda kv: kv[1].numel())[0]
        if state["params"][big].numel() * mesh.dp != trainer.init_params()[big].numel():
            raise RuntimeError(f"fsdp: {big} is not dp-sharded after the step")
    return losses


def pipeline_loss(mesh, batch: dict, microbatches: int) -> float:
    """The loss of one GPipe pretraining step on the (dp, pp) ``mesh``."""
    from visitron_torch.models import BertConfig
    from visitron_torch.parallel.pipeline import PipelinePretrainTrainer

    trainer = PipelinePretrainTrainer(BertConfig(**BERT), mesh,
                                      num_microbatches=microbatches, total_steps=10)
    _, bundle = trainer.step_fn()(trainer.init_state(), parallel.shard_batch(mesh, batch))
    return float(bundle["loss"])


def nav_loss(mesh, seed: int) -> float:
    """One teacher-forced viewpoint step on ``mesh`` in a synthetic world."""
    from visitron_torch.agents import NavEpisodeBatcher, NavRuntime, ViewpointAgent
    from visitron_torch.data import (SceneFeatureTable, WordPieceTokenizer,
                                     build_nav_instances, build_wordpiece_vocab)
    from visitron_torch.models import BertConfig
    from visitron_torch.testing import SyntheticWorld
    from visitron_torch.testing.synthetic import _TARGETS, _WORDS

    world = SyntheticWorld(seed=seed, num_scans=1, viewpoints_per_scan=16, scene_feat_dim=32)
    table = SceneFeatureTable.pack(world.graphs, world.scene_features(), vfov=60)
    runtime = NavRuntime.build(world.graphs, table, device=mesh.device)
    tok = WordPieceTokenizer(build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)],
                                                   vocab_size=512))
    n = 2 * mesh.dp
    with tempfile.TemporaryDirectory() as d:
        world.write_task_data(d, counts={"train": n})
        instances = build_nav_instances(d, ["train"], tok, max_seq_length=64)
    cfg = BertConfig(vocab_size=len(tok), hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
                     type_vocab_size=4)
    agent = ViewpointAgent(cfg, runtime, feature_dim=32, episode_len=4, rnn_dim=16,
                           encoder_hidden_size=16, aemb=8, device=mesh.device, mesh=mesh)
    batcher = NavEpisodeBatcher(instances, runtime, batch_size=n // mesh.dp,
                                path_type="planner_path", host_id=mesh.dp_index,
                                num_hosts=mesh.dp)
    _, loss = agent.train_step_fn()(agent.init_state(),
                                    next(batcher.train_batches(1, episode_len=4)))
    return float(loss)


def run_rank(ranks: int, seed: int) -> str:
    """This rank's arms; the summary line."""
    batch = example_batch(2 * ranks, 48, 16, np.random.default_rng(seed))
    tp = parallel.make_mesh(tp=2)
    tp_losses = pretrain_losses(tp, batch, steps=2)
    nav = nav_loss(tp, seed + 1)
    sp = pretrain_losses(parallel.make_sp_mesh(None, 2), batch, zero1=True)
    fsdp = pretrain_losses(parallel.make_mesh(), batch, fsdp=True)
    cp = pretrain_losses(parallel.make_cp_mesh(None, 2), batch)
    pp = pipeline_loss(parallel.make_pp_mesh(None, 2), batch, 2)
    losses = tp_losses + [nav] + sp + fsdp + cp + [pp]
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"dryrun: a non-finite loss in {losses}")
    half = ranks // 2
    return (f"dryrun ok: {ranks} {dist.get_backend()} ranks, tp(dp={half},tp=2) pretrain loss="
            f"{tp_losses[-1]:.4f}, nav loss={nav:.4f}, sp+zero1(dp={half},sp=2) loss="
            f"{sp[0]:.4f}, fsdp(dp={ranks}) loss={fsdp[0]:.4f}, ring-cp(dp={half},cp=2) "
            f"loss={cp[0]:.4f}, pipeline(dp={half},pp=2) loss={pp:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, one rank per card (default); cpu: gloo ranks")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the ranks may take")
    args = ap.parse_args(argv)
    if args.ranks < 4 or args.ranks % 2:
        raise SystemExit("--ranks must be an even count of at least 4")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and cards < args.ranks:
        raise SystemExit(f"--device cuda runs one rank per card: {args.ranks} ranks, "
                         f"{cards} cards (--device cpu rehearses on gloo CPU ranks)")
    if args.rank is not None:  # one rank, started below
        torch.set_num_threads(1)
        device = "cpu" if args.device == "cpu" else f"cuda:{args.rank}"
        parallel.init_process_group(device, init_method=args.init, rank=args.rank,
                                    world_size=args.ranks, timeout_s=args.timeout)
        try:
            line = run_rank(args.ranks, args.seed)
        finally:
            parallel.destroy_process_group()
        if args.rank == 0:
            print(line, flush=True)
        return 0
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{os.path.join(d, 'pg')}"
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        procs = [subprocess.Popen([sys.executable, "-m", "visitron_torch.parallel.dryrun",
                                   "--ranks", str(args.ranks), "--seed", str(args.seed),
                                   "--device", args.device, "--rank", str(r), "--init", init,
                                   "--timeout", str(args.timeout)], env=env, cwd=REPO)
                 for r in range(args.ranks)]
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=args.timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return 0 if codes == [0] * args.ranks else 1


if __name__ == "__main__":
    sys.exit(main())
