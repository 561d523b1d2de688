"""The port's question-asking classifier against the JAX package's, on the
CPU in fp32 with every dropout at 0: the CVDN episodes and the classifier
instances (equal), ``prepare_batch`` (identical arrays), the loss and the
question logits (1e-5), the gradients (1e-4; the frozen encoder's are zero
in both), one ``only_finetune_classifier`` step against optax's
``multi_transform`` (only the question head moves; the clip's norm over the
head alone), ``evaluate``'s metrics, the metrics function and
``ImageBertForActionPrediction``, the trainer's logged losses against the
JAX trainer's (1e-4), and ``run classifier`` from a viewpoint run of the
port.  Tiny config: 2 layers, hidden 128, 2 heads of 64, rnn 24, batch 4,
12-step episodes."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import visitron_torch.train.workspace as tws
import visitron_tpu.train.workspace as jws
from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch import run as trun
from visitron_torch.agents.classifier import (ClassifierAgent, bce_with_logits,
                                              question_head_labels)
from visitron_torch.config import RunConfig as TConfig
from visitron_torch.convert import convert_agent_params, convert_opt_state, flax_to_state_dict
from visitron_torch.evaluation import binary_classification_metrics
from visitron_torch.models import BertConfig as TBert
from visitron_torch.models import ImageBertForActionPrediction
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train import optim as topt
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.classifier import ClassifierTrainer
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.classifier import ClassifierAgent as JAgent
from visitron_tpu.config import RunConfig as JConfig
from visitron_tpu.data.classifier_dataset import build_classifier_instances as jbuild
from visitron_tpu.data.datasets import load_classifier_episodes as jload
from visitron_tpu.evaluation import binary_classification_metrics as jmetrics
from visitron_tpu.models import BertConfig as JBert
from visitron_tpu.models.classification import ImageBertForActionPrediction as JImageBert
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS
from visitron_tpu.train.classifier import ClassifierTrainer as JTrainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SEQ = 128
EP_LEN = 12
LR = 1e-3
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
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")))
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")))
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, tw.scene_features(), vfov=60), device="cpu")
    out = {"jroot": jroot, "troot": troot, "jtok": jtok, "ttok": ttok, "jrt": jrt,
           "trt": trt,
           "jinst": jbuild(jroot, ["train"], jtok, max_seq_length=SEQ),
           "tinst": td.build_classifier_instances(troot, ["train"], ttok,
                                                  max_seq_length=SEQ)}
    for flag in (False, True):
        jagent = JAgent(JBert(vocab_size=len(jtok), **SMALL), jrt, **AGENT,
                        only_finetune_classifier=flag, max_seq_length=SEQ)
        tagent = ClassifierAgent(TBert(vocab_size=len(ttok), **SMALL), trt, **AGENT,
                                 only_finetune_classifier=flag, device="cpu")
        out[flag] = (jagent, tagent)
    jagent, tagent = out[False]
    out["jstate"] = jagent.init_state()
    out["jparams"] = jax.tree_util.tree_map(np.asarray, out["jstate"]["params"])
    out["tparams"] = convert_agent_params(out["jparams"], tagent)
    out["jbatch"] = jagent.prepare_batch(out["jinst"][:4])
    out["tbatch"] = tagent.prepare_batch(out["tinst"][:4])
    return out


def _arrays(batch):
    return {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, list)}


# -- data ----------------------------------------------------------------------------------

def test_episodes_and_instances_match_jax(pair):
    for splits in (["train"], ["val_seen", "val_unseen"]):
        assert (td.load_classifier_episodes(pair["troot"], splits)
                == jload(pair["jroot"], splits))
    for t, j in zip(pair["tinst"], pair["jinst"], strict=True):
        for name in ("inst_idx", "scan", "start_pano", "player_path", "planner_path",
                     "request_locations", "max_timestep", "raw"):
            assert getattr(t, name) == getattr(j, name), name
        for name in ("token_ids", "segment_ids", "lengths"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
            assert getattr(t, name).dtype == getattr(j, name).dtype
        assert [t.language_at(k) for k in range(15)] == [j.language_at(k) for k in range(15)]


def test_prepare_batch_matches_jax(pair):
    """Identical arrays; the port encodes the E real snapshots alone, where
    the JAX package pads E up to a multiple of 8 for its jit shapes, so the
    JAX snapshot arrays are compared cut to E."""
    jagent, tagent = pair[False]
    events = set()
    for lo in range(0, 12, 4):
        jb = jagent.prepare_batch(pair["jinst"][lo:lo + 4])
        tb = tagent.prepare_batch(pair["tinst"][lo:lo + 4])
        assert jb.keys() == tb.keys() and jb["inst_idx"] == tb["inst_idx"]
        e = int(tb["step2event"].max()) + 1
        assert tb["lang_ids"].shape[0] == e
        for k, v in _arrays(jb).items():
            if k.startswith("lang_"):
                v = v[:e]
            np.testing.assert_array_equal(tb[k], v, err_msg=k)
            assert tb[k].dtype == v.dtype, k
        events.add(int(tb["step2event"].max()))
    assert max(events) >= 1  # some batch re-encodes mid-episode


def test_bce_with_logits_is_torch_pos_weighted_bce():
    logits = torch.tensor([[0.3, -1.2], [2.0, 0.0]])
    targets = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    crit = torch.nn.BCEWithLogitsLoss(pos_weight=torch.tensor([5.0]), reduction="none")
    torch.testing.assert_close(bce_with_logits(logits, targets, 5.0),
                               crit(logits, targets), rtol=1e-6, atol=0)


# -- the loss, the gradients and the step --------------------------------------------------

def test_loss_logits_and_gradients_match_jax(pair):
    """The loss (1e-5 relative), the (B, T) question logits (1e-5) and every
    gradient (1e-4): the frozen encoder's are zero on both sides."""
    jagent, tagent = pair[False]
    jb = _arrays(pair["jbatch"])
    fn = jax.jit(lambda p: jagent.loss_fn(pair["jrt"], p, jb, jax.random.PRNGKey(0),
                                          deterministic=False))
    (jloss, jlogits), jgrads = jax.value_and_grad(fn, has_aux=True)(pair["jstate"]["params"])
    jgrads = convert_agent_params(jax.tree_util.tree_map(np.asarray, jgrads), tagent)
    rng = tagent.init_state()["rng"]
    tloss, tlogits, tgrads = tagent.value_and_grads(
        pair["tparams"], lambda p: tagent.loss_fn(p, pair["tbatch"], rng))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=1e-5)
    for part in ("encoder", "decoder"):
        assert set(tgrads[part]) == set(jgrads[part])
        for name, g in tgrads[part].items():
            np.testing.assert_allclose(g.numpy(), jgrads[part][name].numpy(), atol=1e-4,
                                       rtol=0, err_msg=name)
    assert all(float(g.abs().max()) == 0.0 for g in tgrads["encoder"].values())
    assert float(tgrads["decoder"]["question_linear_1.weight"].abs().max()) > 1e-4


def test_only_finetune_classifier_step_matches_optax_multi_transform(pair):
    """One train step with only_finetune_classifier from the same parameters
    and the converted multi_transform state: the question head's new values
    within lr * 1e-2 of the JAX step's where |g| > 1e-5 (2 lr anywhere);
    every other parameter bit for bit as it was; Adam state for the head
    alone, its count 1."""
    jagent, tagent = pair[True]
    jstate = jagent.init_state()
    jstate["params"] = pair["jstate"]["params"]
    jstate["opt_state"] = jagent.optimizer.init(jstate["params"])
    state = tagent.init_state()
    state["params"] = pair["tparams"]
    state["opt_state"] = convert_opt_state(
        jax.tree_util.tree_map(np.asarray, jstate["opt_state"]), tagent.optimizer,
        state["params"])
    jnew, jl = jagent.train_step_fn()(jstate, _arrays(pair["jbatch"]))
    tnew, tl = tagent.train_step_fn()(state, pair["tbatch"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jp = convert_agent_params(jax.tree_util.tree_map(np.asarray, jnew["params"]), tagent)
    moved = 0
    for part in ("encoder", "decoder"):
        for name, p in tnew["params"][part].items():
            before = pair["tparams"][part][name]
            if "question_linear" not in name:
                # Not rewritten at all: the step leaves the very tensor.
                assert p is before and torch.equal(p, before), name
                continue
            delta = np.abs(p.numpy() - jp[part][name].numpy())
            assert delta.max() <= 2 * LR + 1e-6, name
            moved += int((p != before).sum())
    assert moved > 0
    inner = tnew["opt_state"]["inner_states"]
    assert inner["freeze"] == {} and inner["train"][1]["count"] == 1
    assert set(inner["train"][1]["mu"]) == {"decoder"}
    assert all("question_linear" in n for n in inner["train"][1]["mu"]["decoder"])


def test_multi_transform_clips_the_head_alone_like_optax():
    """Three steps of clip 40 + Adam on the "train" leaves and set_to_zero on
    the rest, with gradients whose norm over all leaves (~1e3) is far above
    the head's (~80): the port's updates equal optax.multi_transform's
    (1e-6), and its moments the converted optax state's (1e-5 relative,
    1e-6 absolute: the clip factor's fp32 rounding)."""
    rng = np.random.default_rng(0)
    shapes = {"encoder": {"a.weight": (4, 3)},
              "decoder": {"question_linear_0.weight": (2, 5), "question_linear_0.bias": (2,),
                          "lstm.wi": (8, 3)}}
    tp = {p: {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for n, s in leaves.items()} for p, leaves in shapes.items()}

    def flax_tree(t):
        return {"encoder": {"params": {"a": {"kernel": t["encoder"]["a.weight"].T}}},
                "decoder": {"params": {
                    "question_linear_0": {"kernel": t["decoder"]["question_linear_0.weight"].T,
                                          "bias": t["decoder"]["question_linear_0.bias"]},
                    "lstm": {"wi": t["decoder"]["lstm.wi"]}}}}

    def labels(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: ("train" if any("question_linear" in str(k) for k in path)
                             else "freeze"), params)

    jopt = optax.multi_transform({"train": optax.chain(optax.clip_by_global_norm(40.0),
                                                       optax.adam(1e-3)),
                                  "freeze": optax.set_to_zero()}, labels)
    topt_ = topt.multi_transform({"train": topt.agent_optimizer(1e-3),
                                  "freeze": topt.set_to_zero()}, question_head_labels)
    jparams = jax.tree_util.tree_map(jnp.asarray, flax_tree({p: {n: v.numpy() for n, v in
                                                                  d.items()} for p, d in
                                                              tp.items()}))
    jstate, tstate = jopt.init(jparams), topt_.init(tp)
    for step in range(3):
        scale = {"a.weight": 500.0, "lstm.wi": 300.0}
        tg = {p: {n: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                      * scale.get(n, 30.0))
                  for n, s in leaves.items()} for p, leaves in shapes.items()}
        jg = jax.tree_util.tree_map(jnp.asarray, flax_tree(
            {p: {n: v.numpy() for n, v in d.items()} for p, d in tg.items()}))
        jup, jstate = jopt.update(jg, jstate, jparams)
        tup, tstate = topt_.update(tg, tstate, tp)
        want = flax_to_state_dict_like(jax.tree_util.tree_map(np.asarray, jup))
        for p, leaves in tup.items():
            for n, u in leaves.items():
                if "question_linear" not in n:
                    # set_to_zero's update is None, which apply_updates skips.
                    assert u is None and not want[p][n].any(), n
                    continue
                np.testing.assert_allclose(u.numpy(), want[p][n], atol=1e-6, err_msg=n)
    conv = convert_opt_state(jax.tree_util.tree_map(np.asarray, jstate), topt_, tp)
    assert conv["inner_states"]["train"][1]["count"] == tstate["inner_states"]["train"][1][
        "count"] == 3
    for moment in ("mu", "nu"):
        for n, v in tstate["inner_states"]["train"][1][moment]["decoder"].items():
            np.testing.assert_allclose(
                v.numpy(), conv["inner_states"]["train"][1][moment]["decoder"][n].numpy(),
                rtol=1e-5, atol=1e-6, err_msg=n)


def flax_to_state_dict_like(tree):
    """The tiny flax tree of the multi_transform test as port names."""
    d = tree["decoder"]["params"]
    return {"encoder": {"a.weight": tree["encoder"]["params"]["a"]["kernel"].T},
            "decoder": {"question_linear_0.weight": d["question_linear_0"]["kernel"].T,
                        "question_linear_0.bias": d["question_linear_0"]["bias"],
                        "lstm.wi": d["lstm"]["wi"]}}


def test_evaluate_matches_jax(pair):
    """evaluate over three prepared batches: every metric equal, the loss
    within 1e-5."""
    jagent, tagent = pair[False]
    jbatches = [jagent.prepare_batch(pair["jinst"][i:i + 4]) for i in range(0, 12, 4)]
    tbatches = [tagent.prepare_batch(pair["tinst"][i:i + 4]) for i in range(0, 12, 4)]
    want = jagent.evaluate(pair["jstate"]["params"], jbatches)
    got = tagent.evaluate(pair["tparams"], tbatches)
    assert set(got) == set(want)
    np.testing.assert_allclose(got.pop("loss"), want.pop("loss"), rtol=1e-5)
    assert got == want


def test_binary_classification_metrics_match_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 200):
        y, p = rng.integers(0, 2, n), rng.integers(0, 2, n)
        assert binary_classification_metrics(y, p) == jmetrics(y, p)
    assert binary_classification_metrics([1, 1], [1, 1]) == jmetrics([1, 1], [1, 1])


def test_image_bert_for_action_prediction_matches_jax():
    """The candidate scorer over the pooled [CLS] output (tests/test_env.py's
    configuration, text only): logits within 1e-5."""
    cfg = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=32, type_vocab_size=4,
               img_feature_dim=20, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:] = 0
    cands = rng.normal(size=(2, 5, 24)).astype(np.float32)
    jmodel = JImageBert(JBert(**cfg), candidate_dim=24)
    jparams = jax.jit(lambda r: jmodel.init(r, ids, cands))(jax.random.PRNGKey(0))
    want = jmodel.apply(jparams, ids, cands, attention_mask=mask)
    tmodel = ImageBertForActionPrediction(TBert(**cfg), candidate_dim=24, image=False)
    tmodel.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams),
                                              tmodel))
    got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(cands),
                 attention_mask=torch.from_numpy(mask))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


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
            encoder_hidden_size=16, rnn_dim=24, num_iterations=3, logging_steps=1,
            saving_steps=3, per_gpu_train_batch_size=2, per_gpu_eval_batch_size=4,
            path_type="planner_path", use_bfloat16=False, drop_out=0.0, dropout=0.0,
            learning_rate=LR, only_finetune_classifier=False)


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_trainer_matches_the_jax_trainer(tmp_path, tiny_bert):
    """Three iterations of both trainers (the whole agent trains) from the
    JAX trainer's initial state: the logged losses within 1e-4 + 1e-4 |ref|,
    and the val metrics of the last checkpoint equal (loss 1e-4)."""
    jcfg = JConfig(**BASE, output_dir=str(tmp_path / "jax"), mesh_dp=1)
    jtr = JTrainer(jcfg, jws.Workspace.synthetic_workspace(jcfg))
    tcfg = TConfig(**BASE, output_dir=str(tmp_path / "torch"))
    ttr = ClassifierTrainer(tcfg, tws.Workspace.synthetic_workspace(tcfg, device="cpu"),
                            device="cpu")
    jstate = jtr.init_state()
    host = jax.tree_util.tree_map(np.asarray, {"params": jstate["params"],
                                               "opt_state": jstate["opt_state"]})
    tstate = ttr.init_state()
    tstate["params"] = convert_agent_params(host["params"], ttr.agent)
    tstate["opt_state"] = convert_opt_state(host["opt_state"], ttr.agent.optimizer,
                                            tstate["params"])
    ttr.train(state=tstate)
    jtr.train(state=jstate)
    tl = {int(float(r["step"])): float(r["loss"]) for r in _csv(tmp_path / "torch/train.csv")}
    jl = {int(float(r["step"])): float(r["loss"]) for r in _csv(tmp_path / "jax/train.csv")}
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    for it in tl:
        assert abs(tl[it] - jl[it]) <= 1e-4 + 1e-4 * abs(jl[it]), (it, tl[it], jl[it])
    assert ttr.ckpt.steps() == [3]


def test_run_classifier_starts_from_a_viewpoint_run_of_the_port(tmp_path, tiny_bert):
    """run viewpoint (1 iteration), then run classifier with
    classifier/classifier.json from its output: the encoder and the shared
    decoder layers start from the viewpoint checkpoint and, with
    only_finetune_classifier, stay bit for bit after 3 steps while the
    question head moves; val writes finite metrics.  classifier_val.json
    (0 iterations) then validates the classifier's checkpoint."""
    small = ["--debug", "--no_use_bfloat16", "--drop_out", "0", "--dropout", "0",
             "--logging_steps", "1", "--max_seq_length", "64", "--lstm_img_feature_dim",
             "48", "--rnn_dim", "24", "--encoder_hidden_size", "16",
             "--per_gpu_eval_batch_size", "4"]
    vp, cl = str(tmp_path / "vp"), str(tmp_path / "cl")
    trun.main(["viewpoint", "--config",
               os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
               *small, "--num_iterations", "1", "--eval_iters", "1", "--output_dir", vp],
              device="cpu")
    nav = CheckpointManager(vp).restore_raw(1)
    cfg = TConfig.from_json(os.path.join(REPO, "run_configs/classifier/classifier.json"))
    cfg = TConfig(**{**cfg.__dict__, "debug": True, "use_bfloat16": False, "drop_out": 0.0,
                     "dropout": 0.0, "max_seq_length": 64, "lstm_img_feature_dim": 48,
                     "rnn_dim": 24, "encoder_hidden_size": 16, "model_name_or_path": vp,
                     "output_dir": cl})
    trainer = ClassifierTrainer(cfg, tws.Workspace.synthetic_workspace(cfg, device="cpu"),
                                device="cpu")
    start = trainer.init_state()["params"]
    fresh = trainer.agent.init_params()
    for name, t in start["encoder"].items():
        assert torch.equal(t, nav["encoder"][name]), name
    for name, t in start["decoder"].items():
        assert torch.equal(t, nav["decoder"][name] if "question_linear" not in name
                           else fresh["decoder"][name]), name

    trun.main(["classifier", "--config",
               os.path.join(REPO, "run_configs/classifier/classifier.json"), *small,
               "--num_iterations", "3", "--saving_steps", "3", "--model_name_or_path", vp,
               "--output_dir", cl], device="cpu")
    after = CheckpointManager(cl).restore_raw(3)
    for part in ("encoder", "decoder"):
        for name, t in after[part].items():
            if "question_linear" in name:
                assert not torch.equal(t, start[part][name]), name
            else:
                assert torch.equal(t, start[part][name]), name
    rows = _csv(os.path.join(cl, "val.csv"))
    assert {int(float(r["step"])) for r in rows} == {3}
    values = {k: float(v) for r in rows for k, v in r.items() if k != "step" and v}
    assert len(values) == 14 and np.isfinite(list(values.values())).all()

    trun.main(["classifier", "--config",
               os.path.join(REPO, "run_configs/classifier/classifier_val.json"), *small,
               "--model_name_or_path", vp, "--output_dir", cl], device="cpu")
    assert CheckpointManager(cl).steps() == [3]
    rows = _csv(os.path.join(cl, "val.csv"))
    assert {int(float(r["step"])) for r in rows} == {3}
    assert {k: float(v) for r in rows for k, v in r.items() if k != "step" and v} == values


def test_a_viewpoint_run_at_another_length_is_refused_like_jax(tmp_path):
    """The classifier configs keep max_seq_length 512, the viewpoint configs
    set 768: a position table of another length is refused, by the port
    when it loads the checkpoint, by the JAX package when its encoder first
    applies it."""
    from flax.errors import ScopeParamShapeError

    from visitron_torch.models import OscarEncoder as TEncoder
    from visitron_torch.models.layers import init_module_params
    from visitron_tpu.models import OscarEncoder as JEncoder

    tiny = dict(vocab_size=50, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                intermediate_size=64, type_vocab_size=4)
    nav = {"encoder": init_module_params(TEncoder(TBert(**tiny, max_position_embeddings=24),
                                                  hidden_size=16, decoder_hidden_size=24),
                                         torch.Generator().manual_seed(0)),
           "decoder": {}}
    CheckpointManager(str(tmp_path / "vp")).save(1, nav)
    cfg = TConfig(debug=True, lstm_img_feature_dim=8, img_feature_dim=8, rnn_dim=24,
                  encoder_hidden_size=16, model_name_or_path=str(tmp_path / "vp"),
                  output_dir=str(tmp_path / "cl"))
    ws = tws.Workspace.synthetic_workspace(cfg, device="cpu")
    ws.bert_config = TBert(**tiny, max_position_embeddings=16)
    trainer = ClassifierTrainer(cfg, ws, device="cpu")
    with pytest.raises(ValueError, match="position_embeddings"):
        trainer.init_state()
    ids, lens = jnp.ones((1, 8), jnp.int32), jnp.array([8])
    short = JEncoder(JBert(**tiny, max_position_embeddings=16), hidden_size=16,
                     decoder_hidden_size=24)
    long = JEncoder(JBert(**tiny, max_position_embeddings=24), hidden_size=16,
                    decoder_hidden_size=24)
    with pytest.raises(ScopeParamShapeError, match="position_embeddings"):
        short.apply(long.init(jax.random.PRNGKey(0), ids, lens), ids, lens)
