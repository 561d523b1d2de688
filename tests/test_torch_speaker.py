"""The port's speaker and back-translation augmentation against the JAX
package's, on the CPU in fp32: ``SpeakerEncoder`` / ``SpeakerDecoder``
forward (1e-5, dropout off) and gradients (1e-4), the trajectory features in
both frames (1e-6), one deterministic train step (loss and the parameters
after Adam, 1e-5; the converted optax.adam state), a JAX speaker trained 40
steps and converted (greedy captions up to the first near tie, ``augment``
records field by field at temperature 0, with targets and under the
quality gate), ``build_aug_instances`` (identical instances), the dropouts
and sampled captions in distribution (5 sigma), and ``run speaker ->
augment -> viewpoint --aug_data`` with a speaker resume.  Sizes of
tests/test_speaker.py: hidden 32, wemb 16, 6-step episodes, 16 words."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visitron_torch.train.workspace as tws
from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch import run as trun
from visitron_torch.agents.speaker import SpeakerAgent as TSpeaker
from visitron_torch.agents.speaker import build_aug_instances as t_build_aug
from visitron_torch.agents.speaker import write_aug_records
from visitron_torch.config import RunConfig as TConfig
from visitron_torch.convert import convert_agent_params, convert_opt_state
from visitron_torch.models import BertConfig as TBert
from visitron_torch.models.layers import DropoutRng
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.optim import tree_leaves
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.agents.speaker import SpeakerAgent as JSpeaker
from visitron_tpu.agents.speaker import build_aug_instances as j_build_aug
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

SEQ = 64
EP_LEN = 6
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64,
             region_feat_dim=70)
SPEAKER = dict(episode_len=EP_LEN, max_words=16, hidden_size=32, wemb=16,
               learning_rate=5e-3)
# Greedy decoding compares argmaxes; the packages agree to ~1e-6 in fp32, so
# tokens are compared up to the first step whose JAX top-2 margin is below
# this.
MARGIN = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speaker_kw(tok, world, **kw):
    return dict(feature_dim=world.scene_feat_dim, vocab_size=len(tok),
                bos_id=tok.vocab[tok.cls_token], eos_id=tok.vocab[tok.sep_token],
                pad_id=tok.pad_token_id, **{**SPEAKER, **kw})


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both packages' private seed-7 worlds, runtimes, tokenizers, train
    instances and speakers (dropout 0.5, as the JAX tests train)."""
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")))
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")))
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jinst = jd.build_nav_instances(jroot, ["train"], jtok, max_seq_length=SEQ)
    tinst = td.build_nav_instances(troot, ["train"], ttok, max_seq_length=SEQ)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, tw.scene_features(), vfov=60), device="cpu")
    return {"jw": jw, "tw": tw, "jtok": jtok, "ttok": ttok, "jinst": jinst, "tinst": tinst,
            "jrt": jrt, "trt": trt, "troot": troot}


def _speakers(pair, **kw):
    js = JSpeaker(runtime=pair["jrt"], **_speaker_kw(pair["jtok"], pair["jw"], **kw))
    ts = TSpeaker(runtime=pair["trt"], device="cpu",
                  **_speaker_kw(pair["ttok"], pair["tw"], **kw))
    return js, ts


def _batches(pair, n, seed=88):
    """n teacher batches of 8 with words, the same in both packages."""
    jb = JBatcher(pair["jinst"], pair["jrt"], batch_size=8, path_type="trusted_path",
                  seed=seed)
    tb = ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], batch_size=8,
                              path_type="trusted_path", seed=seed)
    jtext = {i.inst_idx: JSpeaker.instance_text(i) for i in pair["jinst"]}
    ttext = {i.inst_idx: TSpeaker.instance_text(i) for i in pair["tinst"]}
    js, ts = _speakers(pair)
    out = []
    for jbatch, tbatch in zip(jb.train_batches(n, episode_len=EP_LEN),
                              tb.train_batches(n, episode_len=EP_LEN)):
        jwords = js.attach_words(jbatch, pair["jtok"], jtext)
        twords = ts.attach_words(tbatch, pair["ttok"], ttext)
        for k, v in jwords.items():
            np.testing.assert_array_equal(twords[k], v, err_msg=k)
        out.append(twords)
    return out


@pytest.fixture(scope="module")
def trained(pair):
    """The JAX speaker trained 40 steps (tests/test_speaker.py's fixture)
    and its parameters converted into the port's speaker."""
    js, ts = _speakers(pair)
    state = js.init_state()
    step = js.train_step_fn()
    for batch in _batches(pair, 40):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    jparams = jax.tree_util.tree_map(np.asarray, state["params"])
    return {"js": js, "ts": ts, "jparams": state["params"],
            "tparams": convert_agent_params(jparams, ts)}


def _jax_feats(js, pair, batch, movement_frame=False):
    js.movement_frame = movement_frame
    return js._traj_feats(pair["jrt"], *(jnp.asarray(batch[k]) for k in
                                          ("cur_row", "view", "teacher", "active")))


# -- the modules ---------------------------------------------------------------------

@pytest.mark.parametrize("movement_frame", [False, True])
def test_traj_feats_match_jax(pair, movement_frame):
    batch = _batches(pair, 1)[0]
    js, ts = _speakers(pair, movement_frame=movement_frame)
    ja_t, jf_t = _jax_feats(js, pair, batch, movement_frame)
    ta_t, tf_t = ts.traj_feats(*(ts.device_batch(batch)[k] for k in
                                 ("cur_row", "view", "teacher", "active")))
    np.testing.assert_allclose(ta_t.numpy(), np.asarray(ja_t), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tf_t.numpy(), np.asarray(jf_t), atol=1e-6, rtol=1e-6)
    # Stopped and ended steps embed as zeros.
    assert (ta_t.numpy()[~batch["active"]] == 0).all()


def test_movement_frame_changes_only_the_angle_dims(pair):
    batch = ts_batch = _batches(pair, 1)[0]
    _, ts = _speakers(pair)
    _, tm = _speakers(pair, movement_frame=True)
    args = [ts.device_batch(ts_batch)[k] for k in ("cur_row", "view", "teacher", "active")]
    a0, f0 = ts.traj_feats(*args)
    a1, f1 = tm.traj_feats(*args)
    d = pair["tw"].scene_feat_dim
    assert torch.equal(a0[..., :d], a1[..., :d]) and torch.equal(f0, f1)
    assert not torch.allclose(a0[..., d:][batch["active"]], a1[..., d:][batch["active"]])


def _module_outputs(pair, trained, batch):
    """The encoder's ctx and the decoder's logits, h1, c1 of both packages
    from the trained speaker's parameters, deterministic."""
    js, ts = trained["js"], trained["ts"]
    ja_t, jf_t = _jax_feats(js, pair, batch)
    lengths = jnp.asarray(batch["active"].sum(1), jnp.int32)
    jctx = js.encoder.apply(trained["jparams"]["encoder"], ja_t, jf_t, lengths)
    mask = jnp.arange(EP_LEN)[None, :] >= lengths[:, None]
    h0 = jnp.zeros((len(lengths), js.hidden_size))
    jdec = js.decoder.apply(trained["jparams"]["decoder"], jnp.asarray(batch["words"][:, :-1]),
                            jctx, mask, h0, h0)
    return jctx, jdec


def test_encoder_and_decoder_forward_match_jax(pair, trained):
    from torch.func import functional_call

    batch = _batches(pair, 1, seed=3)[0]
    ts, tparams = trained["ts"], trained["tparams"]
    jctx, (jlogits, jh, jc) = _module_outputs(pair, trained, batch)
    db = ts.device_batch(batch)
    ctx, mask = ts.encode_traj(tparams, db)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-5, rtol=1e-5)
    h0 = torch.zeros((8, ts.hidden_size))
    logits, h, c = functional_call(ts.decoder, tparams["decoder"],
                                   (db["words"][:, :-1], ctx, mask, h0, h0))
    for name, got, want in (("logits", logits, jlogits), ("h1", h, jh), ("c1", c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_loss_gradients_match_jax(pair, trained):
    batch = _batches(pair, 1, seed=4)[0]
    js, ts = trained["js"], trained["ts"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: js._loss(
        pair["jrt"], p, jb, jax.random.PRNGKey(0), True))(trained["jparams"])
    tloss, _, tgrads = ts.value_and_grads(
        trained["tparams"], lambda p: (ts.loss(p, ts.device_batch(batch)), None))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = convert_agent_params(jax.tree_util.tree_map(np.asarray, jgrads), ts)
    for part in want:
        for name, g in want[part].items():
            np.testing.assert_allclose(tgrads[part][name].numpy(), g.numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{part}.{name}")


def test_train_step_matches_jax(pair):
    """One step with the dropouts at 0 from the same initial parameters, at
    speaker.json's learning rate 1e-4: the loss, the parameters after Adam,
    and the Adam state against the converted optax state.  (The first Adam
    step moves a parameter by lr * g / (|g| + eps): +-lr unless |g| is near
    eps, where the two packages' fp32 sums may move it by up to 2 lr.)"""
    js, ts = _speakers(pair, dropout=0.0, learning_rate=1e-4)
    jstate = js.init_state()
    jparams0 = jax.tree_util.tree_map(np.asarray, jstate["params"])
    batch = _batches(pair, 1, seed=5)[0]
    tstate = ts.init_state()
    tstate["params"] = convert_agent_params(jparams0, ts)
    tstate["opt_state"] = convert_opt_state(
        jax.tree_util.tree_map(np.asarray, jstate["opt_state"]), ts.optimizer,
        tstate["params"])
    jnew, jloss = js.train_step_fn()(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tloss = ts.train_step_fn()(tstate, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = convert_agent_params(jax.tree_util.tree_map(np.asarray, jnew["params"]), ts)
    for part in want:
        for name, p in want[part].items():
            np.testing.assert_allclose(tnew["params"][part][name].numpy(), p.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=f"{part}.{name}")
    opt = convert_opt_state(jax.tree_util.tree_map(np.asarray, jnew["opt_state"]),
                            ts.optimizer, tstate["params"])
    assert opt[0]["count"] == tnew["opt_state"][0]["count"] == 1
    for got, exp in zip(tree_leaves(tnew["opt_state"][0]["nu"]), tree_leaves(opt[0]["nu"])):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=1e-9, rtol=1e-4)


def test_feat_dropout_leaves_the_deterministic_ce_alone(pair, trained):
    """feat_dropout only acts in training: the held-out CE is the same
    with and without it."""
    batch = _batches(pair, 1)[0]
    _, fd = _speakers(pair, feat_dropout=0.5)
    base = float(trained["ts"].eval_loss_fn()(trained["tparams"], batch))
    assert float(fd.eval_loss_fn()(trained["tparams"], batch)) == base
    state = fd.init_state()
    state, loss = fd.train_step_fn()(state, batch)
    assert np.isfinite(float(loss))


# -- generation and augmentation ------------------------------------------------------

def _jax_greedy_margins(trained, pair, batch, ids):
    """The top-2 logit margin of each JAX greedy step: the greedy tokens fed
    back teacher-forced reproduce the decode loop's logits."""
    js = trained["js"]
    ja_t, jf_t = _jax_feats(js, pair, batch)
    lengths = jnp.asarray(batch["active"].sum(1), jnp.int32)
    jp = trained["jparams"]
    ctx = js.encoder.apply(jp["encoder"], ja_t, jf_t, lengths)
    mask = jnp.arange(EP_LEN)[None, :] >= lengths[:, None]
    h0 = jnp.zeros((len(lengths), js.hidden_size))
    words = np.concatenate([np.full((len(ids), 1), js.bos_id), ids[:, :-1]], 1)
    logits = np.asarray(js.decoder.apply(jp["decoder"], jnp.asarray(words), ctx, mask, h0,
                                         h0)[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_greedy_captions_match_jax_up_to_near_ties(pair, trained):
    js, ts = trained["js"], trained["ts"]
    rng = np.random.default_rng(0)
    steps = ties = 0
    for _ in range(4):
        arrays = ts.walk_arrays(ts.sample_walks(rng, 16))
        jids = np.asarray(js.generate_fn(0.0)(
            trained["jparams"], {k: jnp.asarray(v) for k, v in arrays.items()},
            jax.random.PRNGKey(0)))
        tids = ts.generate_fn(0.0)(trained["tparams"], arrays).numpy()
        margins = _jax_greedy_margins(trained, pair, arrays, jids)
        for row in range(len(jids)):
            # After EOS both emit padding, whatever the logits.
            ended = np.flatnonzero(jids[row] == js.eos_id)
            end = ended[0] + 1 if len(ended) else jids.shape[1]
            near = np.flatnonzero(margins[row, :end] < MARGIN)
            stop = near[0] if len(near) else jids.shape[1]
            ties, steps = ties + len(near), steps + end
            np.testing.assert_array_equal(tids[row, :stop], jids[row, :stop])
    assert ties <= 0.01 * steps, f"{ties} of {steps} greedy steps are near ties"


def _augment_both(trained, pair, **kw):
    jrec = trained["js"].augment(trained["jparams"], pair["jtok"],
                                 np.random.default_rng(kw.pop("seed")), **kw)
    return jrec, trained["ts"], kw


@pytest.mark.parametrize("case", ["plain", "targets", "keep_fraction"])
def test_augment_records_match_jax(pair, trained, case):
    kw = {"plain": dict(n=10, batch_size=6),
          "targets": dict(n=8, batch_size=6, target_vocab=["lamp", "sofa", "table"]),
          "keep_fraction": dict(n=6, batch_size=6, keep_fraction=0.5)}[case]
    seed = {"plain": 0, "targets": 2, "keep_fraction": 1}[case]
    jrec = trained["js"].augment(trained["jparams"], pair["jtok"],
                                 np.random.default_rng(seed), **kw)
    ts = trained["ts"]
    reads, walks = ts.readbacks, []
    sample_walks = ts.sample_walks
    ts.sample_walks = lambda *a: walks.append(1) or sample_walks(*a)
    try:
        trec = ts.augment(trained["tparams"], pair["ttok"], np.random.default_rng(seed),
                          **kw)
    finally:
        del ts.sample_walks
    assert len(trec) == len(jrec) == kw["n"]
    for t, j in zip(trec, jrec):
        assert t.keys() == j.keys()
        for k in j:
            if k == "speaker_ce":
                assert t[k] == pytest.approx(j[k], abs=1e-4)
            else:
                assert t[k] == j[k], k
    # One read-back of the ids a batch, one more of the scores under the gate.
    assert ts.readbacks - reads == len(walks) * (2 if case == "keep_fraction" else 1)


def test_build_aug_instances_match_jax(pair, trained, tmp_path):
    records = trained["ts"].augment(trained["tparams"], pair["ttok"],
                                    np.random.default_rng(2), n=6, batch_size=6,
                                    target_vocab=["lamp", "sofa"])
    for i, rec in enumerate(records):  # half with targets, half bare R2R
        if i % 2:
            del rec["target"]
    path = str(tmp_path / "aug.json")
    write_aug_records(records, path)
    for kw in ({}, {"oscar_setting": True}, {"tar_back": True}):
        jinst = j_build_aug(path, pair["jtok"], max_seq_length=SEQ, **kw)
        tinst = t_build_aug(path, pair["ttok"], max_seq_length=SEQ, **kw)
        assert len(tinst) == len(jinst) == 6
        for t, j in zip(tinst, jinst):
            for field in ("inst_idx", "scan", "length", "start_pano", "planner_path",
                          "player_path", "trusted_path", "end_panos", "raw"):
                assert getattr(t, field) == getattr(j, field), field
            np.testing.assert_array_equal(t.token_ids, j.token_ids)
            np.testing.assert_array_equal(t.segment_ids, j.segment_ids)


def test_sampled_first_word_follows_the_softmax(pair, trained):
    """temperature 1: the first word's frequencies over many draws against
    the softmax of the first step's logits, 5 sigma a word."""
    from torch.func import functional_call

    ts, params = trained["ts"], trained["tparams"]
    arrays = pair["trt"].teacher_rollout_arrays(
        [pair["tw"].scans[0]], np.array([0], np.int32), np.array([12], np.int32),
        np.array([5], np.int32), EP_LEN)
    n = 20000
    batch = {k: np.repeat(v, n, axis=0) for k, v in arrays.items()}
    ids = ts.generate_fn(1.0)(params, batch, torch.Generator().manual_seed(0))
    db = ts.device_batch(arrays)
    ctx, mask = ts.encode_traj(params, db)
    h0 = torch.zeros((1, ts.hidden_size))
    with torch.no_grad():
        logits = functional_call(ts.decoder, params["decoder"],
                                 (torch.tensor([[ts.bos_id]]), ctx, mask, h0, h0))[0]
    p = torch.softmax(logits[0, 0].double(), -1).numpy()
    freq = np.bincount(ids[:, 0].numpy(), minlength=len(p)) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 5 * sigma + 1e-12).all()
    assert (p > 0.01).sum() >= 2  # the draw is not trivially one word
    # Later steps: an ended item emits padding only.
    ended = (ids == ts.eos_id).cumsum(1) > 0
    after = torch.cat([torch.zeros((n, 1), dtype=torch.bool), ended[:, :-1]], 1)
    assert (ids[after] == ts.pad_id).all()


def test_dropout_keep_rates(pair):
    """The modules' dropouts and the per-episode feature dropout keep
    values at 1 - rate (5 sigma) and scale them by 1 / (1 - rate)."""
    _, ts = _speakers(pair, feat_dropout=0.6)
    batch = ts.device_batch(_batches(pair, 1)[0])
    d = ts.feature_dim
    rng = DropoutRng(masks=torch.Generator().manual_seed(0),
                     seeds=torch.Generator().manual_seed(0))
    seen = {}
    real = ts.encoder.forward

    def spy(a_t, f_t, lengths, rng=None):
        seen["a"], seen["f"] = a_t, f_t
        return real(a_t, f_t, lengths, rng=rng)

    ts.encoder.forward = spy
    clean = ts.traj_feats(*(batch[k] for k in ("cur_row", "view", "teacher", "active")))
    ts.encode_traj(ts.init_params(), batch, rng)
    ratio = seen["a"][..., :d] / clean[0][..., :d]
    live = clean[0][..., :d] != 0
    kept = ratio[live]
    assert torch.allclose(kept[kept != 0], torch.tensor(1 / 0.4))
    # One mask per episode: the panorama's (never zeroed at a stop) at every
    # live step of the action features.
    episode_keep = seen["f"][:, 0, 0, :d] != 0
    assert (((seen["a"][..., :d] != 0) == episode_keep[:, None, :]) | ~live).all()
    assert ((seen["f"][..., :d] != 0) == episode_keep[:, None, None, :]).all()
    # The angle dims and the panorama's angle dims are kept.
    assert torch.equal(seen["a"][..., d:], clean[0][..., d:])
    assert torch.equal(seen["f"][..., d:], clean[1][..., d:])
    n = episode_keep.numel()
    assert abs(float(episode_keep.float().mean()) - 0.4) <= 5 * np.sqrt(0.4 * 0.6 / n)
    # maybe_drop inside the modules: rate 0.5 on a large tensor.
    from visitron_torch.models.layers import maybe_drop

    x = torch.ones(200_000)
    kept = (maybe_drop(x, 0.5, rng) != 0).float().mean()
    assert abs(float(kept) - 0.5) <= 5 * np.sqrt(0.25 / x.numel())


# -- the CLI --------------------------------------------------------------------------

def _tiny(cfg, tokenizer):
    return TBert(vocab_size=len(tokenizer), hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=max(cfg.max_seq_length, 512), type_vocab_size=4,
                 img_feature_dim=cfg.img_feature_dim, detector_classes=cfg.detector_classes,
                 hidden_dropout_prob=cfg.drop_out, attention_probs_dropout_prob=cfg.drop_out)


def test_cli_speaker_augment_and_aug_data_fine_tune(tmp_path, monkeypatch, caplog):
    """run speaker (2 iterations, then --resume to 4), run augment
    (--aug_targets), run viewpoint --aug_data: the train split grows by
    num_aug; the speaker's checkpoints and Adam count continue."""
    monkeypatch.setattr(tws.Workspace, "_bert_config", staticmethod(_tiny))
    small = ["--debug", "--lstm_img_feature_dim", "64", "--max_seq_length", str(SEQ),
             "--rnn_dim", "32", "--max_words", "12", "--logging_steps", "1",
             "--per_gpu_train_batch_size", "4", "--path_type", "planner_path"]
    spk = str(tmp_path / "spk")
    trun.main(["speaker", *small, "--num_iterations", "2", "--saving_steps", "2",
               "--output_dir", spk], device="cpu")
    trun.main(["speaker", *small, "--num_iterations", "4", "--saving_steps", "2",
               "--resume", "--output_dir", spk], device="cpu")
    mgr = CheckpointManager(spk)
    assert mgr.steps() == [2, 4]
    assert mgr.restore_raw(4, "opt_state")[0]["count"] == 4
    assert "speaker ckpt 4 val word-CE" in caplog.text
    with open(os.path.join(spk, "train.csv")) as f:
        assert [int(float(r["step"])) for r in csv.DictReader(f)] == [3, 4]  # the resumed run

    with pytest.raises(SystemExit, match="no speaker checkpoint"):
        trun.main(["augment", *small, "--output_dir", str(tmp_path / "none")], device="cpu")
    aug = str(tmp_path / "aug")
    trun.main(["augment", *small, "--speaker_checkpoint", spk, "--num_aug", "5",
               "--aug_targets", "--output_dir", aug], device="cpu")
    records = json.load(open(os.path.join(aug, "aug_data.json")))
    assert len(records) == 5 and all(r["target"] for r in records)

    from visitron_torch.train.finetune import ViewpointTrainer

    nav = str(tmp_path / "nav")
    trun.main(["viewpoint", *small, "--aug_data", os.path.join(aug, "aug_data.json"),
               "--num_iterations", "1", "--saving_steps", "1", "--eval_iters", "1",
               "--output_dir", nav], device="cpu")
    assert CheckpointManager(nav).steps() == [1]
    cfg = TConfig.from_args(small[:-4] + ["--output_dir", nav])
    base = ViewpointTrainer(cfg, tws.Workspace.synthetic_workspace(cfg, device="cpu"),
                            device="cpu")
    cfg_aug = TConfig.from_args(small[:-4] + ["--output_dir", nav, "--aug_data",
                                              os.path.join(aug, "aug_data.json")])
    with_aug = ViewpointTrainer(cfg_aug, tws.Workspace.synthetic_workspace(cfg_aug,
                                                                           device="cpu"),
                                device="cpu")
    assert len(with_aug._instances(["train"])) == len(base._instances(["train"])) + 5
    assert len(with_aug._instances(["val_seen"])) == len(base._instances(["val_seen"]))
