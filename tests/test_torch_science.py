"""The end-to-end science run (visitron_torch.testing.science,
tools/torch_synthetic_e2e.py) against the JAX tool's loop on the CPU
(tools/synthetic_e2e.py:54-107, its visitron_tpu calls repeated here) at a
tiny width: BERT 1 x 64, fp32, every dropout 0, batch 4, 3 iterations, the
JAX parameters carried across by visitron_torch.convert.  Each iteration's
loss agrees within 1e-5 relative, and the Evaluator's "before" summary
(argmax rollouts of the same parameters) is equal; the tool's run gives both
summaries, every step's loss and the actions/s."""

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch.convert import convert_agent_params
from visitron_torch.testing import science
from visitron_tpu.agents import NavRuntime as JRuntime
from visitron_tpu.agents import ViewpointAgent as JAgent
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.data import SceneFeatureTable as JTable
from visitron_tpu.data import WordPieceTokenizer as JTokenizer
from visitron_tpu.data import build_wordpiece_vocab as j_build_vocab
from visitron_tpu.data.datasets import build_nav_instances as j_build_nav_instances
from visitron_tpu.evaluation import Evaluator as JEvaluator
from visitron_tpu.models import BertConfig as JConfig
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

BATCH = 4
ITERS = 3
EPISODES = 12
SEQ = 128
EP_LEN = 10
WORLD = dict(num_scans=2, viewpoints_per_scan=12, scene_feat_dim=32)
TINY = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
            intermediate_size=128, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
AGENT = dict(rnn_dim=24, encoder_hidden_size=16, aemb=8, dropout=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(world=WORLD, bert=TINY, agent=AGENT, episodes=EPISODES, batch=BATCH,
              seq=SEQ):
    """tools/synthetic_e2e.py:54-83 at the given size (``world`` updates the
    tool's seed-5 world): the world, runtime, instances, agent, batchers and
    evaluator."""
    world = JWorld(**science.WORLD | world)
    table = JTable.pack(world.graphs, world.scene_features(), vfov=60)
    runtime = JRuntime.build(world.graphs, table, device_dtype=jnp.bfloat16)
    tok = JTokenizer(j_build_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=4096))
    with tempfile.TemporaryDirectory() as d:
        world.write_task_data(d, counts={"train": episodes})
        train_inst = j_build_nav_instances(d, ["train"], tok, max_seq_length=seq)
        val_inst = train_inst[:science.VAL_INSTANCES]
    cfg = JConfig(vocab_size=len(tok), max_position_embeddings=seq, type_vocab_size=4,
                  dtype=jnp.float32, **bert)
    agent = JAgent(cfg, runtime, feature_dim=world.scene_feat_dim, episode_len=EP_LEN,
                   max_seq_length=seq, learning_rate=1e-4, **agent)
    return {"agent": agent, "world": world,
            "train_b": JBatcher(train_inst, runtime, batch_size=batch,
                                path_type="planner_path"),
            "val_b": JBatcher(val_inst, runtime, batch_size=batch, path_type="planner_path"),
            "evaluator": JEvaluator([it.raw for it in val_inst], world.graphs,
                                    path_type="planner_path")}


def _jax_summary(j, params) -> dict:
    """The JAX Evaluator's summary of the argmax rollouts of ``j``'s
    validation episodes."""
    results = j["agent"].test(params, j["val_b"].eval_batches(), feedback="argmax")
    summary, _ = j["evaluator"].score_results(
        {k: v for k, v in results.items() if k in j["evaluator"].instr_ids})
    return summary


def _port():
    return science.setup(batch=BATCH, episodes=EPISODES, seq=SEQ, episode_len=EP_LEN,
                         device="cpu", dtype=torch.float32, world=WORLD, bert=TINY, **AGENT)


@pytest.fixture(scope="module")
def runs():
    """The JAX loop (evaluate before, ITERS steps) and the port's from the
    JAX agent's initial parameters."""
    j = _jax_tool()
    jagent = j["agent"]
    state = jagent.init_state()
    sc = _port()
    params = convert_agent_params(jax.tree_util.tree_map(np.asarray, state["params"]),
                                  sc.agent)
    jbefore = _jax_summary(j, state["params"])
    step = jagent.train_step_fn()
    jlosses = []
    for batch in j["train_b"].train_batches(ITERS, episode_len=EP_LEN):
        jb = {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, list)}
        state, loss = step(state, jb)
        jlosses.append(float(loss))
    tstate = sc.agent.init_state(params=params)
    tbefore = science.evaluate(sc, tstate["params"])
    tstate, tlosses, seconds = science.train(sc, tstate, ITERS)
    return {"jbefore": jbefore, "tbefore": tbefore, "jlosses": jlosses, "tlosses": tlosses,
            "sc": sc, "seconds": seconds}


def test_setup_is_the_jax_tools(runs):
    sc = runs["sc"]
    assert sc.runtime.feats.dtype == torch.bfloat16
    assert sc.agent.learning_rate == 1e-4 and sc.agent.episode_len == EP_LEN
    assert len(sc.val_batcher.instances) == min(EPISODES, science.VAL_INSTANCES)
    assert sc.train_batcher.path_type == sc.val_batcher.path_type == "planner_path"


def test_losses_match_the_jax_loop(runs):
    assert len(runs["tlosses"]) == len(runs["jlosses"]) == ITERS
    np.testing.assert_allclose(runs["tlosses"], runs["jlosses"], rtol=1e-5, atol=0)
    assert runs["seconds"] > 0


def test_before_summary_equals_the_jax_one(runs):
    assert runs["tbefore"].keys() == runs["jbefore"].keys()
    for k, v in runs["jbefore"].items():
        assert runs["tbefore"][k] == pytest.approx(v, rel=0, abs=1e-12), k
    assert science.brief(runs["tbefore"]).keys() == {"gp", "sr", "spl", "ndtw"}


def test_run_reports_both_summaries_and_every_loss():
    lines = []
    out = science.run(iters=2, log=lines.append, batch=BATCH, episodes=EPISODES, seq=SEQ,
                      episode_len=EP_LEN, device="cpu", dtype=torch.float32, world=WORLD,
                      bert=TINY, **AGENT)
    assert [line.split(",")[0] for line in lines] == ['{"tag": "before"',
                                                      '{"tag": "after"']
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    for tag in ("before", "after"):
        assert set(out[tag]) == {"gp", "sr", "spl", "ndtw"}
        assert all(np.isfinite(v) for v in out[tag].values())
    assert out["actions_per_s"] == pytest.approx(BATCH * EP_LEN * 2 / out["seconds"])


# The learning curve over the chip run's 1000 iterations (chip_smoke.py phase
# 44: BERT-base, 2048-d) at a width the CPU can train: BERT 2 x 128, 200
# episodes, batch 32, fp32, both loops from the JAX agent's initial parameters.
# With every dropout 0 the two runs are one function and agree step for step;
# with the dropouts on, each draws its own masks ("stream" 0: each agent's
# default generator, else both reseeded), so the curves agree only in
# distribution: phase 44's gates must give both the same verdict.  Each run
# prints a JSON line (pytest -s).
CURVE = dict(iters=1000, episodes=200, batch=32, seq=128)
CURVE_BERT = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=256)
CURVE_AGENT = dict(rnn_dim=128, encoder_hidden_size=128)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _gates(before, after, losses, window=50) -> dict:
    """Phase 44's gates on one run."""
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    return {"loss_ratio": last / first, "gp_gain": after["gp"] - before["gp"],
            "passed": last <= 0.6 * first and after["gp"] - before["gp"] >= 1.0
            and after["sr"] > before["sr"]}


@pytest.mark.slow
@pytest.mark.parametrize("feat_dim,dropout,stream", [
    (256, False, 0), (256, True, 0), (256, True, 1), (256, True, 2), (2048, True, 0),
    (2048, True, 1)])
def test_learning_curve_matches_the_jax_package(feat_dim, dropout, stream):
    from visitron_torch.models.layers import DropoutRng

    world = {"scene_feat_dim": feat_dim}
    bert = CURVE_BERT | ({} if dropout else NO_DROPOUT)
    agent = CURVE_AGENT | ({} if dropout else {"dropout": 0.0})
    j = _jax_tool(world, bert, agent, CURVE["episodes"], CURVE["batch"], CURVE["seq"])
    state = j["agent"].init_state()
    sc = science.setup(batch=CURVE["batch"], episodes=CURVE["episodes"], seq=CURVE["seq"],
                       episode_len=EP_LEN, device="cpu", dtype=torch.float32, world=world,
                       bert=bert, **agent)
    tstate = sc.agent.init_state(params=convert_agent_params(
        jax.tree_util.tree_map(np.asarray, state["params"]), sc.agent))
    if stream:
        state["rng"] = jax.random.PRNGKey(1000 + stream)
        tstate["rng"] = DropoutRng(masks=torch.Generator().manual_seed(1000 + stream),
                                   seeds=torch.Generator().manual_seed(2000 + stream))
    runs = {}
    before = science.brief(_jax_summary(j, state["params"]))
    step, losses = j["agent"].train_step_fn(), []
    for batch in j["train_b"].train_batches(CURVE["iters"], episode_len=EP_LEN):
        state, loss = step(state, {k: np.asarray(v) for k, v in batch.items()
                                   if not isinstance(v, list)})
        losses.append(float(loss))
    runs["jax"] = (before, science.brief(_jax_summary(j, state["params"])), losses)
    before = science.brief(science.evaluate(sc, tstate["params"]))
    tstate, losses, _ = science.train(sc, tstate, CURVE["iters"])
    runs["port"] = (before, science.brief(science.evaluate(sc, tstate["params"])), losses)
    gates = {who: _gates(*run) for who, run in runs.items()}
    jl, tl = np.asarray(runs["jax"][2]), np.asarray(runs["port"][2])
    rel = np.abs(tl - jl) / np.abs(jl)
    for who, (before, after, losses) in runs.items():
        print(json.dumps({"who": who, "feat_dim": feat_dim, "dropout": dropout,
                          "stream": stream, **CURVE, "before": before, "after": after,
                          **gates[who], "max_rel_loss_diff": float(rel.max()),
                          "at_step": int(rel.argmax()) + 1}), flush=True)
    assert runs["port"][0] == pytest.approx(runs["jax"][0], rel=0, abs=1e-12)
    assert np.isfinite(tl).all() and np.isfinite(jl).all()
    if not dropout:
        # One function, but XLA and PyTorch sum in other orders in fp32, and
        # the difference grows over 1000 Adam steps (at most 0.34% a step).
        np.testing.assert_allclose(tl, jl, rtol=1e-2, atol=0)
        assert runs["port"][1] == pytest.approx(runs["jax"][1], rel=0, abs=1e-6)
    assert gates["port"]["passed"] == gates["jax"]["passed"], gates
