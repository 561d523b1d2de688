"""The end-to-end science run on a synthetic world at reference model scale
(tools/synthetic_e2e.py's counterpart).

Trains the viewpoint-selection agent (BERT-base dialog encoder in bf16,
2048-d scene features, 512-token dialogs, Adam 1e-4) on synthetic NDH
episodes, and scores its argmax rollouts on the first 48 training episodes
with ``Evaluator`` before and after training: the train -> rollout ->
Evaluator loop, whose Goal Progress and Success Rate rise only if training
works.  Synthetic dialogs are random text, so there is nothing to generalise
from: fitting the training episodes is the signal.

    from visitron_torch.testing import science
    out = science.run(iters=1000)                 # on the card

:func:`setup`, :func:`evaluate` and :func:`train` are the pieces, with the
sizes as keywords, so the tests run them on the CPU (``device="cpu"``) at a
tiny width.  The world's generator is drawn in the JAX tool's order: graphs,
scene features, task data.
"""

from __future__ import annotations

import json
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from visitron_torch._device import resolve_device
from visitron_torch.agents import NavEpisodeBatcher, NavRuntime, ViewpointAgent
from visitron_torch.data import SceneFeatureTable
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.evaluation import Evaluator
from visitron_torch.models import BertConfig
from visitron_torch.testing.realscale import tokenizer
from visitron_torch.testing.synthetic import SyntheticWorld

WORLD = dict(seed=5, num_scans=4, viewpoints_per_scan=50, scene_feat_dim=2048)
VAL_INSTANCES = 48
LOG_EVERY = 50
SUMMARY_KEYS = (("gp", "dist_to_end_reduction"), ("sr", "success_rate"), ("spl", "spl"),
                ("ndtw", "ndtw"))


@dataclass
class Science:
    world: SyntheticWorld
    runtime: NavRuntime
    agent: ViewpointAgent
    train_batcher: NavEpisodeBatcher
    val_batcher: NavEpisodeBatcher
    evaluator: Evaluator
    batch: int
    episode_len: int


def setup(batch: int = 32, episodes: int = 200, seq: int = 512, episode_len: int = 10,
          path_type: str = "planner_path", remat: bool = False, device=None,
          dtype=torch.bfloat16, world: dict | None = None, bert: dict | None = None,
          vocab_size: int = 4096, **agent_kw) -> Science:
    """The JAX tool's set-up (``world`` and ``bert`` update ``WORLD`` and
    BERT-base; ``agent_kw`` the agent's defaults) on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    w = SyntheticWorld(**{**WORLD, **(world or {})})
    table = SceneFeatureTable.pack(w.graphs, w.scene_features(), vfov=60)
    runtime = NavRuntime.build(w.graphs, table, device_dtype=torch.bfloat16, device=dev)
    tok = tokenizer(vocab_size)
    with tempfile.TemporaryDirectory() as d:
        w.write_task_data(d, counts={"train": episodes})
        train_inst = build_nav_instances(d, ["train"], tok, max_seq_length=seq)
    val_inst = train_inst[:VAL_INSTANCES]
    cfg = BertConfig(vocab_size=len(tok), max_position_embeddings=seq, type_vocab_size=4,
                     dtype=dtype, remat=remat, **(bert or {}))
    agent = ViewpointAgent(cfg, runtime, feature_dim=w.scene_feat_dim,
                           episode_len=episode_len, learning_rate=1e-4, device=dev,
                           **agent_kw)
    return Science(
        world=w, runtime=runtime, agent=agent,
        train_batcher=NavEpisodeBatcher(train_inst, runtime, batch_size=batch,
                                        path_type=path_type),
        val_batcher=NavEpisodeBatcher(val_inst, runtime, batch_size=batch,
                                      path_type=path_type),
        evaluator=Evaluator([it.raw for it in val_inst], w.graphs, path_type=path_type),
        batch=batch, episode_len=episode_len)


def evaluate(sc: Science, params) -> dict:
    """The Evaluator's summary of the argmax rollouts of the validation
    episodes."""
    results = sc.agent.test(params, sc.val_batcher.eval_batches(), feedback="argmax")
    summary, _ = sc.evaluator.score_results(
        {k: v for k, v in results.items() if k in sc.evaluator.instr_ids})
    return summary


def brief(summary: dict) -> dict:
    """GP, SR, SPL and nDTW of an Evaluator summary."""
    return {short: float(summary[key]) for short, key in SUMMARY_KEYS}


def train(sc: Science, state: dict, iters: int, log=None):
    """(state, losses, seconds): ``iters`` teacher-forced steps over the
    training schedule.  The losses stay on the device until the end (one
    read-back every ``LOG_EVERY`` steps when ``log`` is given, as the JAX
    tool prints them); ``seconds`` by the host clock up to the last step's
    loss read back."""
    step = sc.agent.train_step_fn()
    losses = []
    t0 = time.perf_counter()
    for i, batch in enumerate(sc.train_batcher.train_batches(iters,
                                                             episode_len=sc.episode_len)):
        state, loss = step(state, batch)
        losses.append(loss)
        if log is not None and (i + 1) % LOG_EVERY == 0:
            log(json.dumps({"tag": "train", "step": i + 1, "loss": round(float(loss), 4),
                            "actions_per_sec": round(sc.batch * sc.episode_len * (i + 1)
                                                     / (time.perf_counter() - t0), 1)}))
    losses = torch.stack(losses).float().cpu().tolist() if losses else []
    return state, losses, time.perf_counter() - t0


def run(iters: int = 1000, log=print, **setup_kw) -> dict:
    """The JAX tool's run: Evaluator before, ``iters`` steps, Evaluator
    after, a JSON line each (and the loss every ``LOG_EVERY`` steps).
    Returns the two summaries, every step's loss, the host seconds of the
    training loop and nav actions/s over it (batch x T a step)."""
    sc = setup(**setup_kw)
    state = sc.agent.init_state()

    def scored(params, tag, step):
        summary = brief(evaluate(sc, params))
        log(json.dumps({"tag": tag, "step": step,
                        **{k: round(v, 3) for k, v in summary.items()}}))
        return summary

    before = scored(state["params"], "before", 0)
    state, losses, seconds = train(sc, state, iters, log)
    after = scored(state["params"], "after", iters)
    if not np.isfinite(after["gp"]):
        raise RuntimeError(f"non-finite Goal Progress after training: {after}")
    return {"before": before, "after": after, "losses": losses, "seconds": seconds,
            "actions_per_s": sc.batch * sc.episode_len * iters / seconds if iters else None,
            "state": state, "science": sc}
