"""The back-translation augmentation A/B on a learnable synthetic world
(tools/aug_ab.py's counterpart).

The plain synthetic world's dialogs are random words, so nothing in them
carries over to a held-out episode.  Here the world describes each path in
relative turn words (``directional_language``), so that what the follower
learns from language can generalise, and the A/B asks whether a speaker's
captions of sampled walks help it on held-out episodes:

  1. train a speaker (trajectory -> instruction) on the train split;
  2. caption sampled shortest-path walks as R2R-format records (the
     ``run speaker`` / ``augment`` / ``--aug_data`` flow);
  3. train a fresh follower under the same iteration budget on each arm:
     ``baseline`` (train only), ``aug`` (train + records), ``aug_only``
     (the records alone) and ``real_only`` (as many fresh real episodes);
  4. score each arm's argmax rollouts of the held-out episodes.

    from visitron_torch.testing import aug_ab
    out = aug_ab.run(iters=2400, speaker_iters=4800, feat_dropout=0.6,
                     movement_frame=True)              # on the card

``run`` logs one JSON line per event with the JAX tool's tags and keys, in
its order: ``speaker`` (every 100 speaker iterations), ``aug``,
``fidelity``, ``train_{arm}`` (every 200 iterations), ``val_{arm}`` and
``delta_aug_minus_baseline``.  The world's generator is drawn in the JAX
tool's order (graphs, scene features, task data, then the ``real_only``
episodes), so the instances and oracle records equal the JAX package's.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from visitron_torch._device import resolve_device
from visitron_torch.agents import NavEpisodeBatcher, NavRuntime, ViewpointAgent
from visitron_torch.agents.speaker import (SpeakerAgent, build_aug_instances,
                                           write_aug_records)
from visitron_torch.data import SceneFeatureTable
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.evaluation import Evaluator
from visitron_torch.models import BertConfig
from visitron_torch.testing.realscale import tokenizer
from visitron_torch.testing.synthetic import _TARGETS, SyntheticWorld

WORLD = dict(seed=13, num_scans=3, viewpoints_per_scan=40, scene_feat_dim=64,
             dialog_turns=(0, 1), directional_language=True)
VOCAB_SIZE = 1024
BERT = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256)
ARMS = ("baseline", "aug", "aug_only", "real_only")
SPEAKER_LOG_EVERY = 100
TRAIN_LOG_EVERY = 200
METRICS = (("gp", "dist_to_end_reduction"), ("sr", "success_rate"), ("spl", "spl"),
           ("ndtw", "ndtw"))


def parse_hops(sentence: str) -> list[str] | None:
    """Parse a directional sentence into its per-hop turn categories.

    Grammar (testing/synthetic.py:_directional_sentence): ``go`` then for each
    hop ``straight`` | ``turn left`` | ``turn right`` | ``turn around``
    followed by ``then``, closed with ``stop there``.  Returns the category
    list (e.g. ["straight", "left"]) or None if the text doesn't parse."""
    toks = sentence.split()
    if not toks or toks[0] != "go":
        return None
    body = toks[1:]
    if body[-2:] == ["stop", "there"]:
        body = body[:-2]
    hops: list[str] = []
    i = 0
    while i < len(body):
        if body[i] == "straight":
            hops.append("straight")
            i += 1
        elif body[i] == "turn" and i + 1 < len(body) and body[i + 1] in (
                "left", "right", "around"):
            hops.append(body[i + 1])
            i += 2
        else:
            return None
        if i < len(body) and body[i] == "then":
            i += 1
    return hops


def caption_fidelity(records: list[dict], world, runtime) -> dict:
    """Score captions against the world's oracle directional sentences.

    The probe that closes the loop on the aug A/B: ``hop_acc`` (per-hop turn
    -category accuracy over aligned positions), ``exact`` (full-sentence
    category match), ``parse`` (fraction of captions in the directional
    grammar at all), ``len_mae`` (mean |caption hops - oracle hops|)."""
    n = len(records)
    parsed = exact = 0
    hop_hits = hop_total = 0
    len_err = 0.0
    for rec in records:
        g = world.graphs[rec["scan"]]
        oracle = parse_hops(world._directional_sentence(
            g, [g.index[p] for p in rec["path"]], rec["heading"]))
        cap = parse_hops(rec["instructions"][0])
        if oracle is None:
            raise ValueError(f"the world's own sentence for {rec['path_id']} does not parse")
        if cap is None:
            len_err += len(oracle)
            hop_total += len(oracle)
            continue
        parsed += 1
        exact += cap == oracle
        m = min(len(cap), len(oracle))
        hop_hits += sum(c == o for c, o in zip(cap[:m], oracle[:m]))
        hop_total += max(len(cap), len(oracle))
        len_err += abs(len(cap) - len(oracle))
    return {"n": n, "parse": round(parsed / n, 3), "exact": round(exact / n, 3),
            "hop_acc": round(hop_hits / max(hop_total, 1), 3),
            "len_mae": round(len_err / n, 3)}


def rotated_captions(records: list[dict]) -> list[dict]:
    """The records with each caption moved one walk on: the control of
    ``caption_fidelity``.  A speaker that ignores the trajectory it is
    given scores on its own walks about what it scores here."""
    caps = [r["instructions"] for r in records]
    return [{**r, "instructions": c} for r, c in zip(records, caps[1:] + caps[:1])]


@dataclass
class AugAB:
    world: SyntheticWorld
    runtime: NavRuntime
    tok: object
    train_inst: list
    val_inst: list
    cfg: BertConfig
    evaluator: Evaluator
    batch: int
    episode_len: int
    seq: int
    seed: int
    device: torch.device


def setup(train_episodes: int = 150, val_episodes: int = 64, batch: int = 32,
          episode_len: int = 8, seq: int = 128, seed: int = 88, device=None,
          world: dict | None = None, bert: dict | None = None) -> AugAB:
    """The JAX tool's world, runtime (bf16 tables), vocabulary, train and
    val_unseen instances, BERT configuration and Evaluator on ``device``
    (None: the card); ``world`` and ``bert`` update ``WORLD`` and ``BERT``."""
    dev = resolve_device(device)
    w = SyntheticWorld(**{**WORLD, **(world or {})})
    table = SceneFeatureTable.pack(w.graphs, w.scene_features(), vfov=60)
    runtime = NavRuntime.build(w.graphs, table, device_dtype=torch.bfloat16, device=dev)
    tok = tokenizer(VOCAB_SIZE)
    with tempfile.TemporaryDirectory() as d:
        w.write_task_data(d, counts={"train": train_episodes, "val_unseen": val_episodes})
        train_inst = build_nav_instances(d, ["train"], tok, max_seq_length=seq)
        val_inst = build_nav_instances(d, ["val_unseen"], tok, max_seq_length=seq)
    cfg = BertConfig(vocab_size=len(tok), max_position_embeddings=seq, type_vocab_size=4,
                     dtype=torch.bfloat16, **{**BERT, **(bert or {})})
    evaluator = Evaluator([it.raw for it in val_inst], w.graphs, path_type="planner_path")
    return AugAB(world=w, runtime=runtime, tok=tok, train_inst=train_inst,
                 val_inst=val_inst, cfg=cfg, evaluator=evaluator, batch=batch,
                 episode_len=episode_len, seq=seq, seed=seed, device=dev)


def make_agent(ab: AugAB) -> ViewpointAgent:
    """A fresh follower (the same initial parameters in every arm)."""
    return ViewpointAgent(ab.cfg, ab.runtime, feature_dim=ab.world.scene_feat_dim,
                          episode_len=ab.episode_len, rnn_dim=128, encoder_hidden_size=128,
                          aemb=32, learning_rate=1e-4, seed=ab.seed, device=ab.device)


def evaluate(ab: AugAB, agent: ViewpointAgent, params, tag: str, log=print) -> dict:
    """GP, SR, SPL and nDTW of the argmax rollouts of the held-out
    episodes, logged as the JAX tool's ``tag`` line."""
    vb = NavEpisodeBatcher(ab.val_inst, ab.runtime, batch_size=ab.batch,
                           path_type="planner_path")
    results = agent.test(params, vb.eval_batches(), feedback="argmax")
    scored = {k: v for k, v in results.items() if k in ab.evaluator.instr_ids}
    summary, _ = ab.evaluator.score_results(scored)
    line = {"tag": tag, **{short: round(float(summary[key]), 3) for short, key in METRICS}}
    log(json.dumps(line))
    return line


def make_speaker(ab: AugAB, feat_dropout: float = 0.0,
                 movement_frame: bool = False) -> SpeakerAgent:
    tok = ab.tok
    return SpeakerAgent(runtime=ab.runtime, feature_dim=ab.world.scene_feat_dim,
                        vocab_size=len(tok), bos_id=tok.vocab[tok.cls_token],
                        eos_id=tok.vocab[tok.sep_token], pad_id=tok.pad_token_id,
                        episode_len=ab.episode_len, max_words=48, hidden_size=128, wemb=64,
                        learning_rate=1e-3, movement_frame=movement_frame,
                        feat_dropout=feat_dropout, seed=ab.seed, device=ab.device)


def train_speaker(ab: AugAB, sp: SpeakerAgent, iters: int, log=print):
    """(state, every step's word CE): ``iters`` speaker steps on the train
    split's teacher trajectories and texts, the word CE logged every
    ``SPEAKER_LOG_EVERY`` steps (one read-back each)."""
    batcher = NavEpisodeBatcher(ab.train_inst, ab.runtime, batch_size=ab.batch,
                                path_type="planner_path", seed=ab.seed)
    text_by_idx = {i.inst_idx: SpeakerAgent.instance_text(i) for i in ab.train_inst}
    state = sp.init_state()
    step = sp.train_step_fn()
    losses = []
    for it, batch in enumerate(batcher.train_batches(iters, episode_len=ab.episode_len), 1):
        state, loss = step(state, sp.attach_words(batch, ab.tok, text_by_idx))
        losses.append(loss.detach())
        if it % SPEAKER_LOG_EVERY == 0:
            log(json.dumps({"tag": "speaker", "step": it, "word_ce": round(float(loss), 4)}))
    return state, to_list(losses)


def oracle_records(ab: AugAB, sp: SpeakerAgent, n_aug: int, aug_seed: int,
                   targets: bool = False) -> list[dict]:
    """The perfect speaker: the walks ``augment`` would sample, each
    captioned with the world's own directional sentence."""
    rng = np.random.default_rng(aug_seed)
    walks = sp.sample_walks(rng, n_aug, min_hops=2, max_hops=ab.episode_len - 2)
    offsets = ab.runtime.feat_table.scan_offsets
    records = []
    for i in range(n_aug):
        scan = walks["scans"][i]
        g = ab.world.graphs[scan]
        path = g.shortest_path(int(walks["start_rows"][i]) - offsets[scan],
                               int(walks["goal_rows"][i]) - offsets[scan])
        rec = {"scan": scan, "path": path, "heading": walks["headings"][i],
               "path_id": f"AUG_{i}",
               "instructions": [ab.world._directional_sentence(
                   g, [g.index[p] for p in path], walks["headings"][i])]}
        if targets:
            rec["target"] = str(rng.choice(_TARGETS))
        records.append(rec)
    return records


def aug_instances(ab: AugAB, records: list[dict]) -> list:
    """The records through ``write_aug_records`` / ``build_aug_instances``,
    as ``--aug_data`` reads them."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "aug.json")
        write_aug_records(records, path)
        return build_aug_instances(path, ab.tok, max_seq_length=ab.seq)


def real_only_instances(ab: AugAB, n: int) -> list:
    """``n`` fresh real episodes, the world's generator continued (so
    disjoint from train and val): the ``aug_only`` probe's ceiling."""
    with tempfile.TemporaryDirectory() as d:
        ab.world.write_task_data(d, counts={"train": n})
        return build_nav_instances(d, ["train"], ab.tok, max_seq_length=ab.seq)


def train_arm(ab: AugAB, instances: list, iters: int, tag: str, log=print):
    """(agent, state, every step's loss): a fresh follower trained
    ``iters`` teacher-forced steps on ``instances``, the loss logged every
    ``TRAIN_LOG_EVERY`` steps (one read-back each)."""
    agent = make_agent(ab)
    batcher = NavEpisodeBatcher(instances, ab.runtime, batch_size=ab.batch,
                                path_type="planner_path", seed=ab.seed)
    state = agent.init_state()
    step = agent.train_step_fn()
    losses = []
    for i, batch in enumerate(batcher.train_batches(iters, episode_len=ab.episode_len)):
        state, loss = step(state, batch)
        losses.append(loss.detach())
        if (i + 1) % TRAIN_LOG_EVERY == 0:
            log(json.dumps({"tag": f"train_{tag}", "step": i + 1,
                            "loss": round(float(loss), 4)}))
    return agent, state, to_list(losses)


def to_list(losses: list) -> list:
    """Losses kept on the device, read back once."""
    return torch.stack(losses).float().cpu().tolist() if losses else []


def run(iters: int = 800, speaker_iters: int = 600, n_aug: int = 300,
        train_episodes: int = 150, val_episodes: int = 64, batch: int = 32,
        episode_len: int = 8, seq: int = 128, keep_frac: float = 0.0,
        temperature: float = 0.0, arms: str = "baseline,aug", targets: bool = False,
        oracle_captions: bool = False, aug_seed: int = 3, feat_dropout: float = 0.0,
        movement_frame: bool = False, seed: int = 88, device=None, log=print,
        on_stage=None, world: dict | None = None, bert: dict | None = None) -> dict:
    """The JAX tool's A/B with its arguments and defaults.  ``on_stage``,
    where given, is called with each stage's name as it ends: ``setup``,
    ``speaker`` (speaker training; not with ``oracle_captions``),
    ``augment`` (the records built), then ``train_{arm}`` and
    ``val_{arm}`` for each arm.  Returns the speaker's word CE a step, the
    records, the fidelity, each arm's losses a step, held-out metrics and
    instance count, the delta, the host seconds of each stage and the
    set-up (``AugAB``); ``control`` is the fidelity of the records with
    their captions rotated one walk on (``rotated_captions``), not a line
    of the JAX tool's."""
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if ab.device.type == "cuda":
            torch.cuda.synchronize(ab.device)
        now = time.perf_counter()
        seconds[name], t0 = now - t0, now
        if on_stage is not None:
            on_stage(name)

    arm_names = [a.strip() for a in arms.split(",") if a.strip()]
    for a in arm_names:
        if a not in ARMS:
            raise ValueError(f"unknown arm {a!r}: choose from {', '.join(ARMS)}")
    ab = setup(train_episodes=train_episodes, val_episodes=val_episodes, batch=batch,
               episode_len=episode_len, seq=seq, seed=seed, device=device, world=world,
               bert=bert)
    lap("setup")
    sp = make_speaker(ab, feat_dropout=feat_dropout, movement_frame=movement_frame)
    speaker_losses = None
    if oracle_captions:
        records = oracle_records(ab, sp, n_aug, aug_seed, targets)
    else:
        sp_state, speaker_losses = train_speaker(ab, sp, speaker_iters, log)
        lap("speaker")
        records = sp.augment(sp_state["params"], ab.tok, np.random.default_rng(aug_seed),
                             n_aug, min_hops=2, max_hops=episode_len - 2,
                             temperature=temperature, keep_fraction=keep_frac or None,
                             target_vocab=list(_TARGETS) if targets else None)
        del sp_state
    aug_inst = aug_instances(ab, records)
    lap("augment")
    log(json.dumps({"tag": "aug", "records": len(records), "instances": len(aug_inst)}))
    fidelity = caption_fidelity(records, ab.world, ab.runtime)
    log(json.dumps({"tag": "fidelity", **fidelity}))
    control = caption_fidelity(rotated_captions(records), ab.world, ab.runtime)

    arm_instances = {"baseline": ab.train_inst, "aug": ab.train_inst + aug_inst,
                     "aug_only": aug_inst}
    if "real_only" in arm_names:
        arm_instances["real_only"] = real_only_instances(ab, n_aug)
    results = {}
    for tag in arm_names:
        agent, state, losses = train_arm(ab, arm_instances[tag], iters, tag, log)
        lap(f"train_{tag}")
        val = evaluate(ab, agent, state["params"], f"val_{tag}", log)
        lap(f"val_{tag}")
        results[tag] = {"losses": losses, "val": val, "instances": len(arm_instances[tag])}
        del agent, state
    delta = None
    if "aug" in results and "baseline" in results:
        delta = {k: round(results["aug"]["val"][k] - results["baseline"]["val"][k], 3)
                 for k, _ in METRICS}
        log(json.dumps({"tag": "delta_aug_minus_baseline", **delta}))
    return {"speaker_losses": speaker_losses, "records": records,
            "aug_instances": len(aug_inst), "fidelity": fidelity, "control": control,
            "arms": results,
            "delta": delta, "seconds": seconds, "setup": ab}
