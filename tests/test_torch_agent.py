"""The port's serving path as a whole against the JAX package: the host-side
copies (world, features, task JSON, dialogs, candidate tables) give the same
data, the runtime tables agree, and ``ViewpointAgent.test(feedback="argmax")``
gives the same trajectories with ``submit`` False and True, with the JAX
parameters carried across by visitron_torch.convert.  Both run on the CPU in
fp32 (the port with device="cpu", i.e. its plain twins)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch.convert import convert_agent_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.models import BertConfig as JConfig
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

SEQ = 128
EP_LEN = 10
COUNTS = {"train": 3, "val_seen": 2, "val_unseen": 10}
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, max_position_embeddings=SEQ, type_vocab_size=4)
AGENT = dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
             aemb=8)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The same world, data, runtime and agent on both sides."""
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")), counts=COUNTS)
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")), counts=COUNTS)
    jtable = jd.SceneFeatureTable.pack(jw.graphs, jw.scene_features(), vfov=60)
    ttable = td.SceneFeatureTable.pack(tw.graphs, tw.scene_features(), vfov=60)
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    assert vocab == td.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)],
                                             vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jinst = jd.build_nav_instances(jroot, ["val_unseen"], jtok, max_seq_length=SEQ)
    tinst = td.build_nav_instances(troot, ["val_unseen"], ttok, max_seq_length=SEQ)
    jrt = ja.NavRuntime.build(jw.graphs, jtable)
    trt = ta.NavRuntime.build(tw.graphs, ttable, device="cpu")
    jagent = ja.ViewpointAgent(JConfig(vocab_size=len(jtok), **SMALL), jrt, **AGENT,
                               max_seq_length=SEQ)
    tagent = ta.ViewpointAgent(TConfig(vocab_size=len(ttok), **SMALL), trt, **AGENT,
                               device="cpu")
    jparams = jagent.init_state()["params"]
    tparams = convert_agent_params(jax.tree_util.tree_map(np.asarray, jparams), tagent)
    return {"jw": jw, "tw": tw, "jroot": jroot, "troot": troot, "jtable": jtable,
            "ttable": ttable, "jinst": jinst, "tinst": tinst, "jrt": jrt, "trt": trt,
            "jagent": jagent, "tagent": tagent, "jparams": jparams, "tparams": tparams}


def test_world_graphs_features_and_task_json_identical(pair):
    jw, tw = pair["jw"], pair["tw"]
    for scan in jw.graphs:
        jg, tg = jw.graphs[scan], tw.graphs[scan]
        assert jg.viewpoints == tg.viewpoints
        for f in ("positions", "adjacency", "dist", "next_hop"):
            np.testing.assert_array_equal(getattr(jg, f), getattr(tg, f))
    np.testing.assert_array_equal(pair["jtable"].table, pair["ttable"].table)
    assert pair["jtable"].row_index == pair["ttable"].row_index
    for rel in ("NDH/data/val_unseen.json", "NDH/data/train.json", "CVDN/data/val_seen.json",
                "R2R/data/R2R_train.json", "RxR/data/rxr_train_guide.jsonl"):
        with open(os.path.join(pair["jroot"], rel), "rb") as a, \
                open(os.path.join(pair["troot"], rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_dialog_instances_identical(pair):
    assert len(pair["jinst"]) == len(pair["tinst"]) == COUNTS["val_unseen"]
    for a, b in zip(pair["jinst"], pair["tinst"]):
        assert (a.inst_idx, a.scan, a.length, a.trusted_path) == \
            (b.inst_idx, b.scan, b.length, b.trusted_path)
        np.testing.assert_array_equal(a.token_ids, b.token_ids)
        np.testing.assert_array_equal(a.segment_ids, b.segment_ids)


def test_runtime_tables_identical(pair):
    jrt, trt = pair["jrt"], pair["trt"]
    assert jrt.max_candidates == trt.max_candidates
    for f in ("count_h", "nbr_h", "point_h", "nav_idx_h", "heading_h", "elev_h"):
        np.testing.assert_array_equal(getattr(jrt, f), getattr(trt, f), err_msg=f)
    for f in ("feats", "count", "nbr", "point", "heading", "elev", "pano_af", "view_af"):
        np.testing.assert_array_equal(np.asarray(getattr(jrt, f)),
                                      getattr(trt, f).numpy(), err_msg=f)
    jb = next(JBatcher(pair["jinst"], jrt, batch_size=4).eval_batches())
    tb = next(ta.NavEpisodeBatcher(pair["tinst"], trt, batch_size=4).eval_batches())
    for k in ("ids", "segs", "lengths", "start_rows", "start_views", "goal_rows",
              "scans", "inst_idx"):
        np.testing.assert_array_equal(np.asarray(jb[k]), np.asarray(tb[k]), err_msg=k)


def _paths(results):
    return {k: [(vp, float(h), float(e)) for vp, h, e in v] for k, v in results.items()}


@pytest.mark.parametrize("submit", [False, True])
def test_argmax_test_rollout_matches_jax(pair, submit):
    jres = pair["jagent"].test(pair["jparams"], JBatcher(pair["jinst"], pair["jrt"],
                                                         batch_size=4).eval_batches(),
                               feedback="argmax", submit=submit)
    tres = pair["tagent"].test(pair["tparams"], ta.NavEpisodeBatcher(
        pair["tinst"], pair["trt"], batch_size=4).eval_batches(),
        feedback="argmax", submit=submit)
    assert set(tres) == set(jres) == {it.inst_idx for it in pair["tinst"]}
    assert _paths(tres) == _paths(jres)
    assert max(len(p) for p in tres.values()) > 2  # some episodes move


def test_per_step_logits_match_jax(pair):
    """The first batch's masked logits at every step of the device rollout,
    against the JAX single-step function driven along the same transitions."""
    jagent, jrt, jparams = pair["jagent"], pair["jrt"], pair["jparams"]
    batch = jagent.trim_batch(next(JBatcher(pair["jinst"], jrt, batch_size=4).eval_batches()))
    ctx, h, c = jagent._encode_fn(True)(
        jparams["encoder"], jnp.asarray(batch["ids"]), jnp.asarray(batch["segs"]),
        jnp.asarray(batch["lengths"]), jax.random.PRNGKey(0))
    ctx_mask = jnp.asarray(np.arange(batch["ids"].shape[1])[None]
                           >= batch["lengths"][:, None])
    step = jagent._student_step_fn("argmax", True)
    rows = batch["start_rows"].astype(np.int32)
    views = batch["start_views"].astype(np.int32)
    ended = np.zeros(len(rows), bool)
    k1 = jrt.max_candidates + 1
    jlogits = []
    for _ in range(EP_LEN):
        a, h, c, logit = step(jrt, jparams["decoder"], h, c, ctx, ctx_mask,
                              jnp.asarray(rows), jnp.asarray(views),
                              jnp.zeros((len(rows), k1), bool),
                              jnp.zeros((len(rows), k1), bool), jax.random.PRNGKey(0))
        jlogits.append(np.asarray(logit))
        a = np.asarray(a)
        stop = a >= jrt.count_h[rows]
        moved = ~ended & ~stop
        safe = np.minimum(a, jrt.max_candidates - 1)
        rows, views = (np.where(moved, jrt.nbr_h[rows, safe], rows),
                       np.where(moved, jrt.point_h[rows, safe], views))
        ended |= stop
    tagent = pair["tagent"]
    with torch.inference_mode():
        trows, _, _, tlogits = tagent.device_rollout(pair["tparams"], tagent.trim_batch(
            next(ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], batch_size=4)
                 .eval_batches())))
    np.testing.assert_array_equal(trows[:, -1].numpy(), rows)
    np.testing.assert_allclose(tlogits.numpy(), np.stack(jlogits, 1), atol=1e-4, rtol=0)


def test_init_params_covers_every_parameter_and_is_seeded(pair):
    tagent = pair["tagent"]
    p1, p2 = tagent.init_params(5), tagent.init_params(5)
    for part, module in (("encoder", tagent.encoder), ("decoder", tagent.decoder)):
        assert set(p1[part]) == {n for n, _ in module.named_parameters()}
        for name, t in p1[part].items():
            assert torch.equal(t, p2[part][name]), name
    # flax initialiser scales: BERT normal(0.02), LSTM U(+-1/sqrt(H)).
    qkv = p1["encoder"]["bert.bert.encoder.layer_0.attention.qkv.weight"]
    assert abs(qkv.std().item() - 0.02) < 0.002
    wh = p1["encoder"]["lstm.fwd.wh"]
    assert wh.abs().max().item() <= 1.0 / np.sqrt(wh.shape[1])
    results = tagent.test(p1, ta.NavEpisodeBatcher(pair["tinst"], pair["trt"],
                                                   batch_size=4).eval_batches())
    assert len(results) == COUNTS["val_unseen"]


def test_write_results(pair, tmp_path):
    tagent = pair["tagent"]
    tagent.test(pair["tparams"], ta.NavEpisodeBatcher(pair["tinst"], pair["trt"],
                                                      batch_size=4).eval_batches())
    out = tmp_path / "preds.json"
    tagent.write_results(str(out))
    import json

    got = json.loads(out.read_text())
    assert {r["inst_idx"] for r in got} == set(tagent.results)
