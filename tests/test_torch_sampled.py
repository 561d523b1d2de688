"""The port's student-forced and RL fine-tuning, its sampling strategies and
its NDH evaluator against the JAX package, on the CPU in fp32 with every
dropout at 0 (the port with device="cpu", i.e. its plain twins): the
sample-teacher batches, ``sampled_episode_loss`` (argmax and teacher
feedback) and one ``sample_train_step_fn("argmax")`` step, ``rl_episode_loss``
under one deterministic stand-in sampler on both sides, the action
distribution of every strategy, and ``Evaluator`` on the port's rollouts.
The JAX parameters, critic included, are carried across by
visitron_torch.convert.  Tiny config: 2 layers, hidden 128, 2 heads of 64,
S 128, batch 4, 3-step episodes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch.agents import decoding as tdec
from visitron_torch.convert import convert_agent_params
from visitron_torch.evaluation import Evaluator as TEvaluator
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train.optim import tree_leaves
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents import decoding as jdec
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.evaluation import Evaluator as JEvaluator
from visitron_tpu.models import BertConfig as JConfig
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

SEQ = 128
EP_LEN = 3
BATCH = 4
LR = 5e-5
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, max_position_embeddings=SEQ, type_vocab_size=4,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
AGENT = dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
             aemb=8, dropout=0.0, learning_rate=LR)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)
COUNTS = {"train": 10, "val_unseen": 10}
DRAWS = 20_000


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny steps gain nothing from intra-op threads, and with several
    test workers per machine the threads only contend; restored after each
    test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")), counts=COUNTS)
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")), counts=COUNTS)
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jinst = jd.build_nav_instances(jroot, ["train"], jtok, max_seq_length=SEQ)
    tinst = td.build_nav_instances(troot, ["train"], ttok, max_seq_length=SEQ)
    tval = td.build_nav_instances(troot, ["val_unseen"], ttok, max_seq_length=SEQ)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, tw.scene_features(), vfov=60), device="cpu")
    jagent = ja.ViewpointAgent(JConfig(vocab_size=len(jtok), **SMALL), jrt, **AGENT,
                               max_seq_length=SEQ)
    tagent = ta.ViewpointAgent(TConfig(vocab_size=len(ttok), **SMALL), trt, **AGENT,
                               device="cpu")
    jstate = jagent.init_state(with_critic=True)
    jparams = jax.tree_util.tree_map(np.asarray, jstate["params"])
    tparams = convert_agent_params(jparams, tagent)
    jbatcher = JBatcher(jinst, jrt, batch_size=BATCH)
    jbatch = jbatcher.with_sample_teacher(next(jbatcher.train_batches(1)))
    tbatcher = ta.NavEpisodeBatcher(tinst, trt, batch_size=BATCH)
    tbatch = tbatcher.with_sample_teacher(next(tbatcher.train_batches(1)))
    return {"jinst": jinst, "tinst": tinst, "tval": tval, "jrt": jrt, "trt": trt,
            "jagent": jagent, "tagent": tagent, "jstate": jstate, "jparams": jparams,
            "tparams": tparams, "jbatch": jbatch, "tbatch": tbatch, "tw": tw}


def _arrays(batch):
    return {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, list)}


def _grads_close(tgrads, jgrads, tagent):
    jgrads = convert_agent_params(jax.tree_util.tree_map(np.asarray, jgrads), tagent)
    assert set(tgrads) == set(jgrads)
    for part in tgrads:
        assert set(tgrads[part]) == set(jgrads[part])
        for name, g in tgrads[part].items():
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), jgrads[part][name].numpy(),
                                       atol=1e-4, rtol=0, err_msg=f"{part} {name}")
    return jgrads


# -- (a) batches --------------------------------------------------------------------

def test_sample_teacher_batches_match_jax(pair):
    jb = JBatcher(pair["jinst"], pair["jrt"], batch_size=BATCH, seed=5)
    tb = ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], batch_size=BATCH, seed=5)
    # 10 instances in batches of 4: epochs wrap and re-window.
    for jbatch, tbatch in zip(jb.train_batches(5), tb.train_batches(5)):
        assert "teacher" not in tbatch and "teacher" not in jbatch
        jbatch, tbatch = jb.with_sample_teacher(jbatch), tb.with_sample_teacher(tbatch)
        assert jbatch.keys() == tbatch.keys()
        assert jbatch["inst_idx"] == tbatch["inst_idx"]
        for k, v in _arrays(jbatch).items():
            assert tbatch[k].dtype == v.dtype, k
            np.testing.assert_array_equal(tbatch[k], v, err_msg=k)
    assert tbatch["teacher_col"].shape == (BATCH, WORLD["viewpoints_per_scan"])
    # Eval batches with and without teacher arrays.
    for ep in (None, EP_LEN):
        for jbatch, tbatch in zip(jb.eval_batches(ep), tb.eval_batches(ep)):
            assert jbatch.keys() == tbatch.keys()
            for k, v in _arrays(jbatch).items():
                np.testing.assert_array_equal(tbatch[k], v, err_msg=k)


def test_sample_rollout_arrays_match_jax_with_unreachable_goal(pair):
    """Columns of every viewpoint as goal, and the host teacher agrees with
    the columns wherever the goal is reachable."""
    jrt, trt = pair["jrt"], pair["trt"]
    scans = sorted(trt.graphs)
    goals = [trt.feat_table.scan_offsets[s] + v for s in scans
             for v in range(trt.graphs[s].num_viewpoints)]
    items = [s for s in scans for _ in range(trt.graphs[s].num_viewpoints)]
    want = jrt.sample_rollout_arrays(items, np.asarray(goals))
    got = trt.sample_rollout_arrays(items, np.asarray(goals))
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert (got["dist_col"][got["teacher_col"] >= 0] < 1e6).all()


# -- (b) the sampled loss ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sampled(pair):
    """``jax.value_and_grad`` of the JAX package's sampled loss (no critic),
    by feedback, computed once."""
    jagent = pair["jagent"]
    jb = _arrays(jagent.trim_batch(pair["jbatch"]))
    params = {k: v for k, v in pair["jstate"]["params"].items() if k != "critic"}
    cache = {}

    def get(feedback):
        if feedback not in cache:
            cache[feedback] = jax.value_and_grad(jax.jit(
                lambda p: jagent._sampled_episode_loss(
                    pair["jrt"], p, jb, jax.random.PRNGKey(0), True, feedback)))(params)
        return cache[feedback]

    return params, get


@pytest.mark.parametrize("feedback", ["argmax", "teacher"])
def test_sampled_episode_loss_matches_jax(pair, jax_sampled, feedback):
    tagent = pair["tagent"]
    jloss, jgrads = jax_sampled[1](feedback)
    tparams = {k: v for k, v in pair["tparams"].items() if k != "critic"}
    tbatch = tagent.trim_batch(pair["tbatch"])
    tloss, _, tgrads = tagent.value_and_grads(tparams, lambda p: (
        tagent.sampled_episode_loss(p, tbatch, None, None, feedback), None))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _grads_close(tgrads, jgrads, tagent)


def test_sample_train_step_argmax_matches_jax(pair, jax_sampled):
    """One whole ``sample_train_step_fn("argmax")`` step against the JAX
    step's loss and optax's update of the JAX gradients (the JAX step's
    body, ``_sampled_episode_loss`` then ``optimizer.update``).  The first
    Adam step moves each parameter by +-lr wherever |g| >> eps (see
    tests/test_torch_train.py)."""
    jagent, tagent = pair["jagent"], pair["tagent"]
    jparams, get = jax_sampled
    jloss, jgrads = get("argmax")
    updates, _ = jax.jit(jagent.optimizer.update)(jgrads, jagent.optimizer.init(jparams),
                                                  jparams)
    jnew = convert_agent_params(jax.tree_util.tree_map(
        lambda p, u: np.asarray(p) + np.asarray(u), jparams, updates), tagent)
    jgrads = convert_agent_params(jax.tree_util.tree_map(np.asarray, jgrads), tagent)
    state = tagent.init_state()
    tparams = {k: v for k, v in pair["tparams"].items() if k != "critic"}
    state["params"], state["opt_state"] = tparams, tagent.optimizer.init(tparams)
    tnew, tl = tagent.sample_train_step_fn("argmax")(state, pair["tbatch"])
    np.testing.assert_allclose(float(tl), float(jloss), rtol=1e-5)
    assert tnew["sampler"] is state["sampler"] and tnew["rng"] is state["rng"]
    for part in ("encoder", "decoder"):
        for name, p in tnew["params"][part].items():
            delta = np.abs(p.numpy() - jnew[part][name].numpy())
            big = np.abs(jgrads[part][name].numpy()) > 1e-5
            assert delta.max() <= 2 * LR + 1e-6, name
            assert (delta[big] <= LR * 1e-2 + 1e-6).all(), name
            moved = np.abs(p.numpy() - tparams[part][name].numpy())
            assert (moved[big] > 0.5 * LR).all(), name


# -- (c) the RL loss ----------------------------------------------------------------------

def _noise(k1):
    return np.random.default_rng(11).gumbel(size=(BATCH, k1)).astype(np.float32)


def test_rl_episode_loss_matches_jax_under_a_stand_in_sampler(pair, monkeypatch):
    """Both packages draw their actions from argmax(logit + one fixed noise
    table): the port through ``decoding.categorical``, the JAX package through
    ``jax.random.categorical``, called unjitted so that no cached trace keeps
    the real sampler."""
    jagent, tagent = pair["jagent"], pair["tagent"]
    noise = _noise(pair["trt"].max_candidates + 1)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw: jnp.argmax(logits + noise, axis))
    monkeypatch.setattr(tdec, "categorical", lambda logit, generator=None: torch.argmax(
        logit + torch.from_numpy(noise), dim=-1))
    jb = _arrays(jagent.trim_batch(pair["jbatch"]))
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jagent._rl_episode_loss(pair["jrt"], p, jb, jax.random.PRNGKey(0), True),
        has_aux=True)(pair["jstate"]["params"])
    tbatch = tagent.trim_batch(pair["tbatch"])
    tloss, taux, tgrads = tagent.value_and_grads(
        pair["tparams"], lambda p: tagent.rl_episode_loss(p, tbatch, None, None))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert set(taux) == set(jaux) == {"policy_loss", "critic_loss", "entropy", "ml_loss",
                                      "mean_return"}
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(jaux["entropy"]) > 0 and float(jaux["critic_loss"]) > 0
    jg = _grads_close(tgrads, jgrads, tagent)
    assert any(float(g.abs().max()) > 1e-3 for g in jg["critic"].values())


def test_rl_needs_the_critic(pair):
    tagent = pair["tagent"]
    params = {k: v for k, v in pair["tparams"].items() if k != "critic"}
    with pytest.raises(KeyError, match="with_critic"):
        tagent.rl_episode_loss(params, tagent.trim_batch(pair["tbatch"]), None, None)
    batch = next(ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], BATCH).train_batches(1))
    with pytest.raises(KeyError, match="with_sample_teacher"):
        tagent.sampled_episode_loss(params, tagent.trim_batch(batch), None, None)


def test_critic_params_and_converter(pair):
    tagent = pair["tagent"]
    p = tagent.init_params(3, with_critic=True)
    assert set(p) == {"encoder", "decoder", "critic"}
    assert set(p["critic"]) == {n for n, _ in tagent.critic.named_parameters()}
    assert p["critic"]["dense_0.weight"].shape == (AGENT["rnn_dim"], AGENT["rnn_dim"])
    # The encoder and decoder draws do not depend on the critic's.
    q = tagent.init_params(3)
    for part in ("encoder", "decoder"):
        for name, t in q[part].items():
            assert torch.equal(t, p[part][name]), name
    with pytest.raises(KeyError):
        convert_agent_params({**pair["jparams"], "speaker": {}}, tagent)


# -- (d) action selection ---------------------------------------------------------------

LOGIT = np.array([0.3, -0.4, 1.1, 0.9, -1e9, 0.0, -1e9, -0.8], np.float32)
TAKEN = np.array([False, True, True, False, False, False, False, False])
TEMP = 0.7


def _softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max())
    return e / e.sum()


def _want(feedback):
    """The distribution of one draw, from the JAX package's formulas
    (visitron_tpu/agents/decoding.py)."""
    if feedback == "sample":
        return _softmax(LOGIT)
    if feedback == "temperature":
        return _softmax(LOGIT / TEMP)
    if feedback == "penalty":
        return _softmax(np.where(TAKEN, LOGIT / TEMP * TEMP, LOGIT / TEMP))
    if feedback == "topk":
        top = np.argsort(-LOGIT, kind="stable")[:3]
        p = np.zeros(len(LOGIT))
        p[top] = _softmax(LOGIT[top])
        return p
    return 0.4 / len(LOGIT) + 0.6 * _softmax(LOGIT)  # nucleus


@pytest.mark.parametrize("feedback", ["sample", "temperature", "penalty", "topk",
                                      "nucleus"])
def test_select_action_frequencies_match_the_distribution(feedback):
    logit = torch.from_numpy(np.tile(LOGIT, (DRAWS, 1)))
    taken = torch.from_numpy(np.tile(TAKEN, (DRAWS, 1)))
    g = torch.Generator().manual_seed(0)
    a = tdec.select_action(feedback, logit, g, temperature=TEMP, taken_mask=taken)
    assert a.shape == (DRAWS,) and a.dtype == torch.int64
    freq = np.bincount(a.numpy(), minlength=len(LOGIT)) / DRAWS
    want = _want(feedback)
    bound = 5 * np.sqrt(want * (1 - want) / DRAWS)
    assert (np.abs(freq - want) <= bound).all(), (freq, want)
    assert (freq[want == 0] == 0).all()
    if feedback == "nucleus":
        assert (freq[LOGIT < -1e8] > 0).all()  # masked slots get the uniform share
    if feedback == "topk":
        assert set(np.flatnonzero(freq)) == set(np.argsort(-LOGIT)[:3])
    # The same generator state gives the same draws.
    again = tdec.select_action(feedback, logit, torch.Generator().manual_seed(0),
                               temperature=TEMP, taken_mask=taken)
    assert torch.equal(a, again)


def test_penalty_restores_the_taken_logits():
    """penalty divides by T and multiplies the taken actions' logits back:
    with T far from 1 the taken slots keep their untempered odds."""
    logit = torch.tensor([[2.0, 0.0, -1e9]]).repeat(DRAWS, 1)
    taken = torch.tensor([[True, False, False]]).repeat(DRAWS, 1)
    a = tdec.select_action("penalty", logit, torch.Generator().manual_seed(1),
                           temperature=0.25, taken_mask=taken)
    want = _softmax([2.0, 0.0])[0]  # untempered for slot 0, 0 / T = 0 for slot 1
    freq = float((a == 0).double().mean())
    assert abs(freq - want) <= 5 * np.sqrt(want * (1 - want) / DRAWS)


def test_teacher_and_argmax_equal_jax():
    rng = np.random.default_rng(2)
    logit = rng.standard_normal((64, 16)).astype(np.float32)
    logit[:, 10:] = -1e9
    logit[0, 3] = logit[0, 5] = logit[0].max() + 1  # a tie: the first maximum
    target = rng.integers(0, 16, 64).astype(np.int32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jdec.select_action("argmax", jnp.asarray(logit), key))
    got = tdec.select_action("argmax", torch.from_numpy(logit))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 3
    want = np.asarray(jdec.select_action("teacher", jnp.asarray(logit), key,
                                         target=jnp.asarray(target)))
    got = tdec.select_action("teacher", torch.from_numpy(logit),
                             target=torch.from_numpy(target))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_matches_softmax_and_never_picks_masked_slots():
    logit = torch.tensor([[1.0, -1e9, 0.0, 2.0]]).repeat(DRAWS, 1)
    a = tdec.categorical(logit, torch.Generator().manual_seed(4))
    freq = np.bincount(a.numpy(), minlength=4) / DRAWS
    want = _softmax([1.0, -1e9, 0.0, 2.0])
    assert freq[1] == 0
    assert (np.abs(freq - want) <= 5 * np.sqrt(want * (1 - want) / DRAWS)).all()


# -- (e) the evaluator ------------------------------------------------------------------

def _gt(instances):
    return [it.raw for it in instances if it.raw.get("end_panos")]


@pytest.mark.parametrize("path_type", ["trusted_path", "planner_path"])
def test_evaluator_matches_jax_on_the_ports_rollouts(pair, path_type, tmp_path):
    tagent, graphs = pair["tagent"], pair["tw"].graphs
    tagent.test(pair["tparams"], ta.NavEpisodeBatcher(
        pair["tval"], pair["trt"], batch_size=BATCH, path_type=path_type).eval_batches())
    results = dict(tagent.results)
    gt = _gt(pair["tval"])
    assert len(gt) == COUNTS["val_unseen"]
    assert all("trusted_path" not in item for item in gt)
    jev, tev = JEvaluator(gt, graphs, path_type), TEvaluator(gt, graphs, path_type)
    assert {k: v["trusted_path"] for k, v in tev.gt.items() if "trusted_path" in v} == \
        {k: v["trusted_path"] for k, v in jev.gt.items() if "trusted_path" in v}
    jsum, jscores = jev.score_results(results)
    tsum, tscores = tev.score_results(results)
    assert tsum == jsum
    assert tscores == jscores
    assert tsum["spl"] <= tsum["success_rate"]
    assert max(len(p) for p in results.values()) > 2  # some episodes move
    out = tmp_path / "preds.json"
    tagent.write_results(str(out))
    assert tev.score(str(out)) == jev.score(str(out))


def test_evaluator_refuses_bad_trajectories_like_jax(pair):
    graphs = pair["tw"].graphs
    gt = _gt(pair["tval"])
    item = gt[0]
    g = graphs[item["scan"]]
    start = item["planner_path"][0]
    far = next(v for v in g.viewpoints
               if v != start and not g.adjacency[g.index[start], g.index[v]])
    ok = {it["inst_idx"]: [(it["planner_path"][0], 0.0, 0.0)] for it in gt}
    jev, tev = JEvaluator(gt, graphs), TEvaluator(gt, graphs)
    assert tev.score_results(ok) == jev.score_results(ok)
    jump = {**ok, item["inst_idx"]: [(start, 0.0, 0.0), (far, 0.0, 0.0)]}
    for ev in (jev, tev):
        with pytest.raises(ValueError, match="no such edge"):
            ev.score_results(jump)
    wrong_start = {**ok, item["inst_idx"]: [(far, 0.0, 0.0)]}
    with pytest.raises(AssertionError):
        jev.score_results(wrong_start)
    with pytest.raises(ValueError, match="start position"):
        tev.score_results(wrong_start)
    missing = dict(list(ok.items())[1:])
    with pytest.raises(AssertionError):
        jev.score_results(missing)
    with pytest.raises(ValueError, match="not provided"):
        tev.score_results(missing)


def test_nav_graph_distance_and_path_length_match_jax(pair):
    from visitron_tpu.testing import SyntheticWorld

    jg = SyntheticWorld(**WORLD).graphs
    for scan, tg in pair["tw"].graphs.items():
        nodes = tg.shortest_path(0, tg.num_viewpoints - 1)
        assert tg.path_length(nodes) == jg[scan].path_length(nodes)
        assert tg.distance(nodes[0], 3) == jg[scan].distance(nodes[0], 3)
        np.testing.assert_allclose(tg.path_length(nodes),
                                   tg.distance(0, tg.num_viewpoints - 1))


# -- (f) short training runs ---------------------------------------------------------------

def _dropout_agent(pair):
    cfg = TConfig(vocab_size=pair["tagent"].cfg.vocab_size,
                  **{**SMALL, "hidden_dropout_prob": 0.1,
                     "attention_probs_dropout_prob": 0.1})
    return ta.ViewpointAgent(cfg, pair["trt"], **{**AGENT, "dropout": 0.5,
                                                  "learning_rate": 1e-3}, device="cpu")


def _moved(before, after):
    return {(part, n) for part, d in before.items() for n, t in d.items()
            if not torch.equal(t, after[part][n])}


def test_short_sampled_and_rl_runs_move_every_parameter(pair):
    agent = _dropout_agent(pair)
    pooler = {("encoder", "bert.bert.pooler.dense.weight"),
              ("encoder", "bert.bert.pooler.dense.bias")}
    state = agent.init_state()
    step = agent.sample_train_step_fn("sample")
    for _ in range(2):
        new, loss = step(state, pair["tbatch"])
        assert torch.isfinite(loss)
        assert _moved(state["params"], new["params"]) == {
            (p, n) for p, d in state["params"].items() for n in d} - pooler
        state = new
    assert state["opt_state"][1]["count"] == 2

    state = agent.init_state(with_critic=True)
    rl = agent.rl_train_step_fn()
    for _ in range(2):
        new, (loss, aux) = rl(state, pair["tbatch"])
        assert torch.isfinite(loss) and all(torch.isfinite(v) for v in aux.values())
        assert _moved(state["params"], new["params"]) == {
            (p, n) for p, d in state["params"].items() for n in d} - pooler
        assert all(torch.isfinite(t).all() for t in tree_leaves(new["params"]))
        state = new


@pytest.mark.parametrize("feedback", ["argmax", "topk", "nucleus", "temperature",
                                      "penalty", "teacher"])
def test_sample_train_step_with_each_strategy(pair, feedback):
    agent = _dropout_agent(pair)
    state = agent.init_state()
    new, loss = agent.sample_train_step_fn(feedback)(state, pair["tbatch"])
    assert torch.isfinite(loss)
    assert all(torch.isfinite(t).all() for t in tree_leaves(new["params"]))
    assert _moved(state["params"], new["params"])


@pytest.mark.parametrize("feedback,submit", [("sample", False), ("topk", False),
                                             ("nucleus", False), ("temperature", False),
                                             ("penalty", False), ("penalty", True)])
def test_test_rollout_with_each_strategy_is_valid_and_seeded(pair, feedback, submit):
    tagent, rt = pair["tagent"], pair["trt"]

    def run(seed):
        return tagent.test(pair["tparams"], ta.NavEpisodeBatcher(
            pair["tval"], rt, batch_size=BATCH).eval_batches(), feedback=feedback,
            generator=torch.Generator().manual_seed(seed), submit=submit)

    results = run(5)
    assert set(results) == {it.inst_idx for it in pair["tval"]}
    by_idx = {it.inst_idx: it for it in pair["tval"]}
    for idx, path in results.items():
        g = rt.graphs[by_idx[idx].scan]
        assert 1 <= len(path) <= EP_LEN + 1
        for (a, _, _), (b, _, _) in zip(path, path[1:]):
            assert g.adjacency[g.index[a], g.index[b]]
    assert run(5) == results
    with pytest.raises(ValueError):
        tagent.sample_train_step_fn("bogus")
