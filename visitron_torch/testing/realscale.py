"""The deployment's world resident on the device (tools/realscale_smoke.py's
counterpart).

The production deployment keeps the whole world on the device: 10,800
viewpoints (Matterport's 90 scans x 120 viewpoints) x 36 views x 2048-d
scene features, 1,592,524,800 bytes of bfloat16, with the candidate and
next-hop tables beside it.  This module builds a synthetic world with those
statistics, packs its scene table as bfloat16 on the host (no fp32 copy of
the whole table), places it with one copy from page-locked memory, and runs
the JAX tool's two teacher-forced steps of BERT-base (bf16, batch 64) at
each of its two shapes: T 10 on planner_path and T 40 on trusted_path.

    from visitron_torch.testing import realscale
    rw = realscale.build_world()                  # on the card
    instances, tok = realscale.instances(rw)
    for path_type, episode_len in realscale.SHAPES:
        agent = realscale.make_agent(rw, tok, episode_len)
        batch = realscale.first_batch(rw, instances, path_type, episode_len)
        state, losses = realscale.train_steps(agent, batch, 2)

Every function takes the sizes as keywords, so the tests run it on the CPU
(``device="cpu"``) at a few viewpoints; :func:`run` is the tool.  The world's
generator is drawn in the JAX tool's order: graphs, scene features, task data.
"""

from __future__ import annotations

import json
import resource
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from visitron_torch import geometry as geo
from visitron_torch._device import resolve_device
from visitron_torch.agents import NavEpisodeBatcher, NavRuntime, ViewpointAgent
from visitron_torch.data import SceneFeatureTable, WordPieceTokenizer, build_wordpiece_vocab
from visitron_torch.data.candidates import build_candidate_tables
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.models import BertConfig
from visitron_torch.testing.synthetic import _TARGETS, _WORDS, SyntheticWorld

SEQ = 512
FEAT_DIM = 2048
BATCH = 64
VOCAB_SIZE = 4096
TRAIN_INSTANCES = 128
# Matterport's statistics (precompute_bottom-up_features.py:410-420 accounting).
WORLD = dict(seed=7, num_scans=90, viewpoints_per_scan=120, scene_feat_dim=FEAT_DIM,
             dialog_turns=(2, 6), words_per_turn=(10, 30))
SHAPES = (("planner_path", 10), ("trusted_path", 40))


@dataclass
class RealscaleWorld:
    world: SyntheticWorld
    table: SceneFeatureTable
    runtime: NavRuntime
    seconds: dict  # host seconds: "world", "pack", "candidate_tables", "placement"


def build_world(device=None, **world_kw) -> RealscaleWorld:
    """The world (``WORLD``, updated by ``world_kw``), its bfloat16 scene
    table packed on the host (page-locked where a card is present), the
    candidate tables, and the runtime on ``device`` (None: the card), each
    step timed by the host clock (the placement up to a device sync)."""
    dev = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    world = SyntheticWorld(**{**WORLD, **world_kw})
    features = world.scene_features()
    seconds["world"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = SceneFeatureTable.pack(world.graphs, features, vfov=60, dtype=torch.bfloat16)
    del features
    seconds["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hfov = geo.camera_hfov(table.image_w, table.image_h, np.radians(table.vfov))
    tables = build_candidate_tables(world.graphs, hfov)
    seconds["candidate_tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime = NavRuntime.build(world.graphs, table, hfov=hfov, tables=tables,
                               device_dtype=torch.bfloat16, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds["placement"] = time.perf_counter() - t0
    return RealscaleWorld(world, table, runtime, seconds)


def tokenizer(vocab_size: int = VOCAB_SIZE) -> WordPieceTokenizer:
    return WordPieceTokenizer(build_wordpiece_vocab(
        [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=vocab_size))


def instances(rw: RealscaleWorld, n: int = TRAIN_INSTANCES, seq: int = SEQ,
              vocab_size: int = VOCAB_SIZE):
    """(``n`` train instances at max length ``seq``, the tokenizer)."""
    tok = tokenizer(vocab_size)
    with tempfile.TemporaryDirectory() as d:
        root = rw.world.write_task_data(d, counts={"train": n})
        return build_nav_instances(root, ["train"], tok, max_seq_length=seq), tok


def make_agent(rw: RealscaleWorld, tok, episode_len: int, seq: int = SEQ,
               dtype=torch.bfloat16, bert: dict | None = None, **agent_kw) -> ViewpointAgent:
    """BERT-base (``bert`` overrides its fields) in ``dtype`` on the runtime's
    device, the agent's defaults otherwise, as the JAX tool builds it."""
    cfg = BertConfig(vocab_size=len(tok), max_position_embeddings=seq, type_vocab_size=4,
                     dtype=dtype, **(bert or {}))
    return ViewpointAgent(cfg, rw.runtime, feature_dim=rw.world.scene_feat_dim,
                          episode_len=episode_len, device=rw.runtime.device, **agent_kw)


def first_batch(rw: RealscaleWorld, instances, path_type: str, episode_len: int,
                batch_size: int = BATCH) -> dict:
    """The first batch of the training schedule, with its teacher arrays."""
    batcher = NavEpisodeBatcher(instances, rw.runtime, batch_size=batch_size,
                                path_type=path_type)
    return next(batcher.train_batches(1, episode_len=episode_len))


def train_steps(agent: ViewpointAgent, batch: dict, n: int = 2):
    """(state, losses): ``n`` teacher-forced steps on ``batch`` from a fresh
    state; the losses are 0-d tensors on the device."""
    step = agent.train_step_fn()
    state = agent.init_state()
    losses = []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(loss)
    return state, losses


def memory_gib(device) -> dict:
    """The card's allocator: in use, peak, and the card's total (GiB)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(dev) / 2**30,
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev) / 2**30,
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory / 2**30}


def run(device=None, log=print, agent: dict | None = None, **world_kw) -> dict:
    """The JAX tool's run: the world, then two steps at each of ``SHAPES``,
    a JSON line each; returns the lines' records and the world's numbers.
    ``agent``: :func:`make_agent`'s keywords (None: BERT-base, the agent's
    defaults)."""
    t0 = time.perf_counter()
    rw = build_world(device, **world_kw)
    table = rw.table.table
    log(f"world built: {table.shape[0]} viewpoints, table {table.nbytes / 1e9:.2f} GB "
        f"{str(table.dtype)[6:]}, {time.perf_counter() - t0:.0f}s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in rw.seconds.items())})")
    inst, tok = instances(rw)
    out = {"viewpoints": int(table.shape[0]), "table_bytes": int(table.nbytes),
           "seconds": rw.seconds, "shapes": []}
    for path_type, episode_len in SHAPES:
        model = make_agent(rw, tok, episode_len, **(agent or {}))
        batch = first_batch(rw, inst, path_type, episode_len)
        t1 = time.perf_counter()
        state, losses = train_steps(model, batch, 2)
        losses = [float(x) for x in losses]
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite losses {losses} at T {episode_len} {path_type}")
        rec = {"shape": f"T={episode_len} {path_type} batch={BATCH}",
               "viewpoints": out["viewpoints"], "losses": [round(x, 4) for x in losses],
               "first_two_steps_s": round(time.perf_counter() - t1, 1),
               "device_mem_gib": {k: round(v, 2) for k, v in
                                  memory_gib(rw.runtime.device).items()}}
        log(json.dumps(rec))
        out["shapes"].append(rec)
        del state, model
    out["host_peak_rss_gib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(json.dumps({"viewpoints": out["viewpoints"], "table_bytes": out["table_bytes"],
                    "host_seconds": {k: round(v, 2) for k, v in rw.seconds.items()},
                    "host_peak_rss_gib": round(out["host_peak_rss_gib"], 2)}))
    log("realscale smoke ok")
    return out
