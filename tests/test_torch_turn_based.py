"""The port's turn-based (low-level action space) navigation against the JAX
package's, on the CPU in fp32 with every dropout at 0: the runtime's turn
helpers and the teacher episodes of ``with_turn_teacher`` (identical),
``TurnBasedDecoderLSTM`` (1e-5), the episode loss (1e-5 relative), its
gradients (1e-4) and one Adam step, the argmax trajectories (identical), the
sampled strategy's first-step action frequencies (5 sigma), and ``run
turn_based --debug`` (train, resume, val; its logged losses against the JAX
trainer's, 1e-4).  Tiny config: 2 layers, hidden 128, 2 heads of 64, S 128,
rnn 24, batch 4."""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

import visitron_torch.train.workspace as tws
import visitron_tpu.train.workspace as jws
from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch import run as trun
from visitron_torch.agents import decoding as tdec
from visitron_torch.agents.turn_based import END_ID, TurnBasedAgent
from visitron_torch.config import RunConfig as TConfig
from visitron_torch.convert import convert_agent_params, convert_opt_state, flax_to_state_dict
from visitron_torch.models import BertConfig as TBert
from visitron_torch.models import TurnBasedDecoderLSTM
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.turn_based import TurnBasedTrainer
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.agents.turn_based import TurnBasedAgent as JAgent
from visitron_tpu.config import RunConfig as JConfig
from visitron_tpu.models import BertConfig as JBert
from visitron_tpu.models.decoder import TurnBasedDecoderLSTM as JDecoder
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS
from visitron_tpu.train.turn_based import TurnBasedTrainer as JTrainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SEQ = 128
EP_LEN = 12
BATCH = 4
LR = 1e-4
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, max_position_embeddings=SEQ, type_vocab_size=4,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
AGENT = dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
             aemb=8, dropout=0.0, learning_rate=LR)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the steps are tiny, and test workers share the
    machine; restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")), counts={"train": 10})
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")), counts={"train": 10})
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jinst = jd.build_nav_instances(jroot, ["train"], jtok, max_seq_length=SEQ)
    tinst = td.build_nav_instances(troot, ["train"], ttok, max_seq_length=SEQ)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, tw.scene_features(), vfov=60), device="cpu")
    jagent = JAgent(JBert(vocab_size=len(jtok), **SMALL), jrt, **AGENT, max_seq_length=SEQ)
    tagent = TurnBasedAgent(TBert(vocab_size=len(ttok), **SMALL), trt, **AGENT, device="cpu")
    jstate = jagent.init_state()
    jparams = jax.tree_util.tree_map(np.asarray, jstate["params"])
    jbatcher = JBatcher(jinst, jrt, batch_size=BATCH, path_type="trusted_path")
    tbatcher = ta.NavEpisodeBatcher(tinst, trt, batch_size=BATCH, path_type="trusted_path")
    jbatch = jbatcher.with_turn_teacher(next(jbatcher.train_batches(1)), EP_LEN)
    tbatch = tbatcher.with_turn_teacher(next(tbatcher.train_batches(1)), EP_LEN)
    return {"jinst": jinst, "tinst": tinst, "jrt": jrt, "trt": trt, "jagent": jagent,
            "tagent": tagent, "jstate": jstate, "jparams": jparams,
            "tparams": convert_agent_params(jparams, tagent), "jbatch": jbatch,
            "tbatch": tbatch}


def _arrays(batch):
    return {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, list)}


# -- the runtime's turn helpers and the teacher ------------------------------------------

def test_navigable_and_turns_match_jax_at_every_pose(pair):
    """navigable_at (order, relative angles) and apply_turn_action for
    every action, at every viewpoint and view, equal the JAX package's."""
    jrt, trt = pair["jrt"], pair["trt"]
    for row in range(jrt.count_h.shape[0]):
        for view in range(36):
            assert trt.navigable_at(row, view) == jrt.navigable_at(row, view), (row, view)
            for action in range(6):
                assert (trt.apply_turn_action(row, view, action)
                        == jrt.apply_turn_action(row, view, action))


def test_turn_teacher_arrays_match_jax(pair):
    """with_turn_teacher over a schedule that wraps the epoch (10 instances
    in batches of 4), at 40 steps: every array identical."""
    jb = JBatcher(pair["jinst"], pair["jrt"], batch_size=BATCH, seed=5,
                  path_type="trusted_path")
    tb = ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], batch_size=BATCH, seed=5,
                              path_type="trusted_path")
    ended = 0
    for jbatch, tbatch in zip(jb.train_batches(4), tb.train_batches(4)):
        jbatch, tbatch = jb.with_turn_teacher(jbatch, 40), tb.with_turn_teacher(tbatch, 40)
        assert jbatch.keys() == tbatch.keys() and jbatch["inst_idx"] == tbatch["inst_idx"]
        for k, v in _arrays(jbatch).items():
            np.testing.assert_array_equal(tbatch[k], v, err_msg=k)
            assert tbatch[k].dtype == v.dtype, k
        ended += int((tbatch["teacher"] == END_ID).sum())
    assert ended > 0  # some episodes end inside 40 steps


# -- the decoder, the loss and the train step ----------------------------------------------

def test_turn_decoder_step_matches_jax():
    """One TurnBasedDecoderLSTM step on seeded inputs (padded context keys
    masked): h_1, c_1, alpha and the logits within 1e-5."""
    rng = np.random.default_rng(0)
    b, s, feat, ctx_dim, hidden = 3, 9, 20, 16, 24
    action = rng.integers(0, 8, (b,)).astype(np.int32)
    feature = rng.normal(size=(b, feat)).astype(np.float32)
    h0, c0 = (rng.normal(size=(b, hidden)).astype(np.float32) for _ in range(2))
    ctx = rng.normal(size=(b, s, ctx_dim)).astype(np.float32)
    mask = np.arange(s)[None, :] >= np.array([9, 5, 2])[:, None]
    jdec = JDecoder(embedding_size=8, hidden_size=hidden, dropout_ratio=0.0,
                    feature_size=feat)
    jparams = jdec.init(jax.random.PRNGKey(3), action, feature, h0, c0, ctx, mask)
    want = jdec.apply(jparams, action, feature, h0, c0, ctx, mask)
    tdec_ = TurnBasedDecoderLSTM(embedding_size=8, hidden_size=hidden, feature_size=feat,
                                 ctx_size=ctx_dim, dropout_ratio=0.0)
    tdec_.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams),
                                             tdec_))
    got = tdec_(torch.from_numpy(action).long(), torch.from_numpy(feature),
                torch.from_numpy(h0), torch.from_numpy(c0), torch.from_numpy(ctx),
                torch.from_numpy(mask))
    for name, g, w in zip(("h_1", "c_1", "alpha", "logit"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_turn_episode_loss_gradients_and_adam_step_match_jax(pair):
    """The episode loss (1e-5 relative), every gradient (1e-4), and the
    parameters after one Adam step: within lr * 1e-2 where |g| > 1e-5, and
    within 2 lr anywhere (tests/test_torch_train.py's rule)."""
    jagent, tagent = pair["jagent"], pair["tagent"]
    jb = _arrays(ja.ViewpointAgent.trim_batch(pair["jbatch"]))
    loss_fn = jax.jit(lambda p: jagent._episode_loss(
        pair["jrt"], p, jb, jax.random.PRNGKey(0), deterministic=False))
    jloss, jgrads = jax.value_and_grad(loss_fn)(pair["jstate"]["params"])
    jgrads = convert_agent_params(jax.tree_util.tree_map(np.asarray, jgrads), tagent)
    tbatch = tagent.trim_batch(pair["tbatch"])
    assert tbatch["ids"].shape == jb["ids"].shape
    state = tagent.init_state()
    state["params"] = pair["tparams"]
    state["opt_state"] = convert_opt_state(
        jax.tree_util.tree_map(np.asarray, pair["jstate"]["opt_state"]), tagent.optimizer,
        state["params"])
    tloss, _, tgrads = tagent.value_and_grads(
        state["params"], lambda p: (tagent.episode_loss(p, tbatch, state["rng"]), None))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for part in ("encoder", "decoder"):
        assert set(tgrads[part]) == set(jgrads[part])
        for name, g in tgrads[part].items():
            np.testing.assert_allclose(g.numpy(), jgrads[part][name].numpy(), atol=1e-4,
                                       rtol=0, err_msg=name)
    assert float(tgrads["decoder"]["decoder2action.weight"].abs().max()) > 1e-3

    jnew, jl = jagent.train_step_fn()(pair["jstate"], _arrays(pair["jbatch"]))
    tnew, tl = tagent.train_step_fn()(state, pair["tbatch"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jnew = convert_agent_params(jax.tree_util.tree_map(np.asarray, jnew["params"]), tagent)
    for part in ("encoder", "decoder"):
        for name, p in tnew["params"][part].items():
            delta = np.abs(p.numpy() - jnew[part][name].numpy())
            big = np.abs(jgrads[part][name].numpy()) > 1e-5
            assert delta.max() <= 2 * LR + 1e-6, name
            assert (delta[big] <= LR * 1e-2 + 1e-6).all(), name
    assert tnew["opt_state"][1]["count"] == 1


def test_eval_loss_matches_the_deterministic_episode_loss(pair):
    tagent = pair["tagent"]
    got = tagent.eval_loss_fn()(pair["tparams"], pair["tbatch"])
    want = tagent.episode_loss(pair["tparams"], tagent.trim_batch(pair["tbatch"]))
    assert float(got) == float(want)
    with pytest.raises(ValueError, match="needs an rng"):
        tagent.eval_loss_fn(use_dropout=True)(pair["tparams"], pair["tbatch"])


# -- the student rollout -------------------------------------------------------------------

def test_argmax_trajectories_match_jax(pair):
    """test(feedback="argmax") over every batch of the split, 40 steps:
    the same trajectories (viewpoints, headings, elevations)."""
    jagent, tagent = pair["jagent"], pair["tagent"]
    jb = JBatcher(pair["jinst"], pair["jrt"], batch_size=BATCH)
    tb = ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], batch_size=BATCH)
    jagent.episode_len = tagent.episode_len = 40
    try:
        want = jagent.test(pair["jstate"]["params"], jb.eval_batches(), feedback="argmax")
        got = tagent.test(pair["tparams"], tb.eval_batches(), feedback="argmax")
    finally:
        jagent.episode_len = tagent.episode_len = EP_LEN
    assert len(got) == len(pair["tinst"])
    assert {k: [tuple(p) for p in v] for k, v in got.items()} == {
        k: [tuple(p) for p in v] for k, v in want.items()}
    assert max(len(v) for v in got.values()) > 2


def test_sampled_first_actions_follow_the_policy(pair, monkeypatch):
    """feedback "sample": the first step's actions of 4096 rollouts of one
    episode follow softmax(logit) of that step within 5 sigma an action.
    The dialog is encoded once and its outputs repeated for the rows."""
    tagent = pair["tagent"]
    seen = []
    orig_draw, orig_encode = tdec.categorical, tagent.encode

    def record(logit, generator=None):
        a = orig_draw(logit, generator)
        seen.append((logit, a))
        return a

    def encode_once(params, batch, rng=None):
        n = len(batch["scans"])
        first = {k: v[:1] for k, v in batch.items()}
        return tuple(x.expand(n, *x.shape[1:]) for x in orig_encode(params, first))

    monkeypatch.setattr(tdec, "categorical", record)
    monkeypatch.setattr(tagent, "encode", encode_once)
    n = 4096
    one = {k: (v[:1].repeat(n, 0) if isinstance(v, np.ndarray) else v[:1] * n)
           for k, v in pair["tbatch"].items()}
    tagent.episode_len = 1
    try:
        tagent.rollout_student(pair["tparams"], one, feedback="sample",
                               generator=torch.Generator().manual_seed(0))
    finally:
        tagent.episode_len = EP_LEN
    (logits, actions), = seen
    assert torch.allclose(logits, logits[:1].expand_as(logits), atol=1e-6)
    p = torch.softmax(logits[0], dim=-1).numpy()
    freq = np.bincount(actions.numpy(), minlength=6) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 5 * sigma + 1e-9).all(), (freq, p)
    assert (p > 0.02).sum() >= 3  # a spread policy, not a near-argmax one


# -- the trainer and the CLI ----------------------------------------------------------------

def _tiny(bert_cls):
    def make(cfg, tokenizer):
        return bert_cls(vocab_size=len(tokenizer), img_feature_dim=cfg.img_feature_dim,
                        detector_classes=cfg.detector_classes,
                        hidden_dropout_prob=cfg.drop_out,
                        attention_probs_dropout_prob=cfg.drop_out,
                        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=64, max_position_embeddings=64, type_vocab_size=4)

    return staticmethod(make)


@pytest.fixture()
def tiny_bert(monkeypatch):
    monkeypatch.setattr(jws.Workspace, "_bert_config", _tiny(JBert))
    monkeypatch.setattr(tws.Workspace, "_bert_config", _tiny(TBert))


BASE = dict(debug=True, max_seq_length=64, lstm_img_feature_dim=48, img_feature_dim=56,
            encoder_hidden_size=16, rnn_dim=24, aemb=8, num_iterations=3, logging_steps=1,
            saving_steps=3, per_gpu_train_batch_size=2, per_gpu_eval_batch_size=4,
            path_type="planner_path", use_bfloat16=False, drop_out=0.0, dropout=0.0,
            learning_rate=LR)


def _losses(out):
    with open(os.path.join(out, "train.csv")) as f:
        return {int(float(r["step"])): float(r["loss"]) for r in csv.DictReader(f)}


def test_trainer_matches_the_jax_trainer(tmp_path, tiny_bert):
    """Three teacher-forced iterations of both trainers from the JAX
    trainer's initial state (10-step episodes on the --debug world): the
    logged losses within 1e-4 + 1e-4 |ref|."""
    jcfg = JConfig(**BASE, output_dir=str(tmp_path / "jax"), mesh_dp=1)
    jtr = JTrainer(jcfg, jws.Workspace.synthetic_workspace(jcfg))
    tcfg = TConfig(**BASE, output_dir=str(tmp_path / "torch"))
    ttr = TurnBasedTrainer(tcfg, tws.Workspace.synthetic_workspace(tcfg, device="cpu"),
                           device="cpu")
    jstate = jtr.agent.init_state()
    host = jax.tree_util.tree_map(np.asarray, {"params": jstate["params"],
                                               "opt_state": jstate["opt_state"]})
    tstate = ttr.agent.init_state()
    tstate["params"] = convert_agent_params(host["params"], ttr.agent)
    tstate["opt_state"] = convert_opt_state(host["opt_state"], ttr.agent.optimizer,
                                            tstate["params"])
    ttr.train(state=tstate)
    jtr.train(state=jstate)
    tl, jl = _losses(tcfg.output_dir), _losses(jcfg.output_dir)
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for it in tl:
        assert abs(tl[it] - jl[it]) <= 1e-4 + 1e-4 * abs(jl[it]), (it, tl[it], jl[it])


def test_run_turn_based_trains_resumes_and_validates(tmp_path, tiny_bert):
    """run turn_based with turn_based_train/ndh_oscar_setting.json (player
    path: 40-step episodes): 2 iterations, then --resume to 3, then val of
    the last checkpoint (NDH metrics and the loss, finite)."""
    out = str(tmp_path / "tb")
    argv = ["turn_based", "--config",
            os.path.join(REPO, "run_configs/turn_based_train/ndh_oscar_setting.json"),
            "--debug", "--no_use_bfloat16", "--drop_out", "0", "--dropout", "0",
            "--logging_steps", "1", "--max_seq_length", "64", "--per_gpu_eval_batch_size",
            "4", "--lstm_img_feature_dim", "48", "--rnn_dim", "24", "--encoder_hidden_size",
            "16", "--saving_steps", "2", "--output_dir", out]
    trun.main(argv + ["--num_iterations", "2", "--eval_iters", "2"], device="cpu")
    trun.main(argv + ["--num_iterations", "3", "--resume", "--eval_iters", "3"],
              device="cpu")
    mgr = CheckpointManager(out)
    assert mgr.steps() == [2, 3]
    assert mgr.restore_raw(3, "opt_state")[1]["count"] == 3
    assert sorted(_losses(out)) == [3]  # train.csv holds the resumed run's iterations
    with open(os.path.join(out, "val.csv")) as f:
        rows = list(csv.DictReader(f))
    assert {int(float(r["step"])) for r in rows} == {3}
    values = [float(v) for r in rows for k, v in r.items() if k != "step" and v]
    assert len(values) == 22 and np.isfinite(values).all()  # 11 values x 2 splits
    preds = json.load(open(os.path.join(out, "preds_turn_val_seen_3.json")))
    assert len(preds) == 4 and all(p["trajectory"] for p in preds)
