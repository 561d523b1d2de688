"""The port's data parallelism over two processes on the CPU (gloo), against
the JAX package's dp=2 mesh and against the port's own one-process step.

Each fixture starts two ranks of ``tests/torch_dist_worker.py`` (a gloo group
through ``file://`` under the test's directory, so parallel test workers
share no port), runs a list of cases in them and joins them within 120 s:

  * pretraining: two fp32 steps with dropout off from converted JAX
    parameters, plain / ``zero1`` / ``fsdp``, against JAX
    ``PretrainTrainer(mesh=make_mesh(dp=2))`` at ``test_torch_pretrain``'s
    tolerances; ZeRO-1 and FSDP hold about half the optimizer state (and
    FSDP half the parameters) on a rank;
  * the viewpoint teacher-forced step, plain and ``zero1``, on a batch whose
    two shards have different active counts, against the JAX dp=2 step (a
    mean of the two shards' mean losses misses that tolerance);
  * the turn-based and classifier dp steps against the port's one-process
    step on the whole batch;
  * the stop consensus: rank 1 takes a SIGTERM at step 3, both ranks stop at
    the ``sync_every`` boundary 4;
  * the CLI: ``run viewpoint --debug --zero1`` (rank 0 writes the
    checkpoints; a run resumed at iteration 2 ends where an uninterrupted one
    does, bit for bit), ``run pretrain --debug --fsdp``, ``run turn_based``
    and ``run classifier``; a checkpoint written at dp 2 resumes in one
    process.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch import run as trun
from visitron_torch.agents.classifier import ClassifierAgent
from visitron_torch.agents.turn_based import TurnBasedAgent
from visitron_torch.convert import convert_agent_params, convert_pretrain_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu import models as jm
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.parallel import make_mesh
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS
from visitron_tpu.train.pretrain import PretrainTrainer as JTrainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
JOIN_S = 120
PRE = dict(vocab_size=101, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, type_vocab_size=4, img_feature_dim=24,
           detector_classes=11, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=128, fused_packed_max_seq=128)
NAV = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, max_position_embeddings=128, type_vocab_size=4,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)
LR = 5e-5
EP_LEN = 8
STRATEGIES = ("plain", "zero1", "fsdp")


def start_ranks(work: str, cases: list, world: int = 2):
    """Start ``world`` worker processes on ``cases`` ((name, inputs) pairs,
    run in order); :func:`join_ranks` collects them."""
    os.makedirs(work, exist_ok=True)
    torch.save(cases, os.path.join(work, "inputs.pt"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, work, str(r), str(world)],
                                          env=env, stdout=log, stderr=subprocess.STDOUT,
                                          cwd=REPO))
    return work, cases, procs


def join_ranks(started) -> dict:
    """{case name: [rank 0's output, rank 1's, ...]}, each rank joined within
    ``JOIN_S`` seconds (killed past it)."""
    work, cases, procs = started
    try:
        for p in procs:
            p.wait(timeout=JOIN_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                pytest.fail(f"rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
    return {name: [torch.load(os.path.join(work, f"{name}_{r}.pt"), weights_only=False)
                   for r in range(len(procs))] for name, _ in cases}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pretrain_batch(seed, b=4, s_text=128, s_img=128):
    """test_torch_pretrain's batch at 4 rows: the two shards hold different
    label counts (next_action: one valid row, then two)."""
    rng = np.random.default_rng(seed)
    s = s_text + s_img
    mask = np.ones((b, s), np.int32)
    mask[1, s_text - 20:s_text] = 0
    mask[1, s - 10:] = 0
    labels = np.where(rng.random((b, s)) < 0.3, rng.integers(0, 101, (b, s)), -1)
    labels[:, s_text:] = -1
    tokens = np.where(rng.random((b, s)) < 0.2, rng.integers(0, 11, (b, s)), -1)
    tokens[:, s_text:] = -1
    return {
        "input_ids": rng.integers(0, 101, (b, s_text)).astype(np.int32),
        "token_type_ids": rng.integers(0, 4, (b, s_text)).astype(np.int32),
        "attention_mask": mask, "labels": labels.astype(np.int32),
        "token_labels": tokens.astype(np.int32),
        "img_feats": rng.standard_normal((b, s_img, 24)).astype(np.float32),
        "img_location_embeddings": rng.standard_normal((b, s_img, 128)).astype(np.float32),
        "next_action": np.array([rng.integers(0, 36), -1, 3, 3], np.int32)}


def _check_update(got, start, want, grads, lr, n_min=0.9):
    """An Adam update against another: within 3 lr everywhere, 1e-2 lr where
    every gradient exceeds 1e-4 (and moved there)."""
    n_big = n_moved = 0
    for name, p in got.items():
        upd, jupd = (p - start[name]).numpy(), (want[name] - start[name]).numpy()
        big = np.min([g[name].abs().numpy() for g in grads], axis=0) > 1e-4
        diff = np.abs(upd - jupd)
        assert diff.max() <= 3 * lr, name
        assert (diff[big] <= 1e-2 * lr).all(), name
        n_big += int(big.sum())
        n_moved += int((upd[big] != 0).sum())
    assert n_moved > n_min * n_big > 0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nav(tmp_path_factory):
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")))
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")))
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    feats = tw.scene_features()
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, feats, vfov=60), device="cpu")
    return {"world": {"kw": WORLD, "feats": feats}, "jinst": jd.build_nav_instances(jroot, ["train"], jtok, max_seq_length=128),
            "tinst": td.build_nav_instances(troot, ["train"], ttok, max_seq_length=128),
            "cinst": td.build_classifier_instances(troot, ["train"], ttok,
                                                   max_seq_length=128),
            "jrt": jrt, "trt": trt, "vocab": len(ttok)}


def _nav_agent_kw(lr):
    return dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
                aemb=8, dropout=0.0, learning_rate=lr)


@pytest.fixture(scope="module")
def steps(nav, tmp_path_factory):
    """The JAX dp=2 references, the port's one-process references, and the
    two ranks' results of every step case (the ranks run while the
    references are computed)."""
    cases, later = [], []
    nav_bert = {**NAV, "vocab_size": nav["vocab"]}
    # Pretraining: the JAX trainers' initial parameters, converted.
    jcfg, tcfg = jm.BertConfig(**PRE), TConfig(**PRE)
    batches = [_pretrain_batch(seed) for seed in (2, 3)]
    trainer = TTrainer(tcfg, device="cpu", total_steps=100, learning_rate=LR)
    for strategy in STRATEGIES:
        jtrainer = JTrainer(jcfg, mesh=make_mesh(dp=2), total_steps=100, learning_rate=LR,
                            zero1=strategy == "zero1", fsdp=strategy == "fsdp")
        jstate = jtrainer.init_state(batches[0])
        p0 = convert_pretrain_params(_np(jstate["params"]), trainer.model)
        later.append((f"pretrain_{strategy}", jtrainer, jstate, p0))
        cases.append((f"pretrain_{strategy}", {
            "case": "pretrain", "bert": PRE, "params": p0, "batches": batches, "lr": LR,
            "zero1": strategy == "zero1", "fsdp": strategy == "fsdp"}))
    # The viewpoint step: a batch whose two shards differ in active counts.
    tagent = ta.ViewpointAgent(TConfig(**nav_bert), nav["trt"], **_nav_agent_kw(LR),
                               device="cpu")
    jbatch = next(JBatcher(nav["jinst"], nav["jrt"], batch_size=4, seed=3)
                  .train_batches(1, EP_LEN))
    tbatch = tagent.trim_batch(next(ta.NavEpisodeBatcher(nav["tinst"], nav["trt"],
                                                         batch_size=4, seed=3)
                                    .train_batches(1, EP_LEN)))
    active = tbatch["active"].astype(np.float32)
    assert (active[:2].sum(0) != active[2:].sum(0)).any()
    for zero1 in (False, True):
        jagent = ja.ViewpointAgent(jm.BertConfig(**nav_bert), nav["jrt"],
                                   **_nav_agent_kw(LR), max_seq_length=128,
                                   mesh=make_mesh(dp=2), zero1=zero1)
        jstate = jagent.init_state()
        tparams = convert_agent_params(_np(jstate["params"]), tagent)
        name = "viewpoint_zero1" if zero1 else "viewpoint"
        later.append((name, jagent, jstate, tparams))
        cases.append((name, {"case": "viewpoint", "bert": nav_bert, "agent": _nav_agent_kw(LR),
                             "world": nav["world"], "params": tparams, "batch": tbatch,
                             "zero1": zero1}))
    # Turn-based and classifier: the port's one-process step on the whole batch.
    tkw, ckw = (dict(_nav_agent_kw(lr), episode_len=12) for lr in (1e-4, 1e-3))
    tb = TurnBasedAgent(TConfig(**nav_bert), nav["trt"], **tkw, device="cpu")
    batcher = ta.NavEpisodeBatcher(nav["tinst"], nav["trt"], batch_size=4, seed=4)
    tbb = tb.trim_batch(batcher.with_turn_teacher(next(batcher.train_batches(1)), 12))
    tb_state = tb.init_state()
    cases.append(("turn_based", {"case": "turn_based", "bert": nav_bert, "agent": tkw,
                                 "world": nav["world"], "params": tb_state["params"],
                                 "batch": tbb}))
    cl = ClassifierAgent(TConfig(**nav_bert), nav["trt"], **ckw, device="cpu")
    items = nav["cinst"][:4]
    cl_state = cl.init_state()
    cases.append(("classifier", {"case": "classifier", "bert": nav_bert, "agent": ckw,
                                 "world": nav["world"], "params": cl_state["params"],
                                 "items": items}))
    cases.append(("consensus", {"case": "consensus", "sync_every": 4}))
    started = start_ranks(str(tmp_path_factory.mktemp("steps")), cases)

    ref = {}
    for name, jobj, jstate, start in later:
        if name.startswith("pretrain"):
            jbundles = []
            for b in batches:
                jstate, bundle = jobj.step_fn()(jstate, b)
                jbundles.append({k: float(v) for k, v in _np(bundle).items()})
            ref[name] = {"start": start, "bundles": jbundles,
                         "params": convert_pretrain_params(_np(jstate["params"]),
                                                           trainer.model),
                         "grads": [trainer.loss_and_grads(start, trainer.to_device(b),
                                                          None)[1] for b in batches]}
            continue
        jnew, jloss = jobj.train_step_fn()(
            jstate, {k: np.asarray(v) for k, v in jbatch.items() if not isinstance(v, list)})
        _, _, grads = tagent.value_and_grads(start, lambda p: (
            tagent.episode_loss(p, tbatch), None))
        halves = [tagent.episode_loss(start, {k: v[s] for k, v in tbatch.items()})
                  for s in (slice(0, 2), slice(2, 4))]
        ref[name] = {"loss": float(jloss), "start": start, "grads": grads,
                     "params": convert_agent_params(_np(jnew["params"]), tagent),
                     "mean_of_means": float(sum(halves)) / 2}
    start = tb_state["params"]
    _, _, grads = tb.value_and_grads(start, lambda p: (tb.episode_loss(p, tbb), None))
    new, loss = tb.train_step_fn()(tb_state, tbb)
    ref["turn_based"] = {"loss": float(loss), "start": start, "params": new["params"],
                         "grads": grads}
    start, cb = cl_state["params"], cl.prepare_batch(items)
    labels = {"encoder": {k: "freeze" for k in start["encoder"]},
              "decoder": {k: "train" if "question_linear" in k else "freeze"
                          for k in start["decoder"]}}
    _, _, grads = cl.value_and_grads(start, lambda p: cl.loss_fn(p, cb), labels)
    new, loss = cl.train_step_fn()(cl_state, cb)
    ref["classifier"] = {"loss": float(loss), "start": start, "params": new["params"],
                         "grads": grads}
    return ref, join_ranks(started)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_pretraining_steps_match_the_jax_dp2_trainer(steps, strategy):
    ref, got = steps
    r = ref[f"pretrain_{strategy}"]
    ranks = got[f"pretrain_{strategy}"]
    for rank in ranks:  # every rank logs the global bundle
        for i, bundle in enumerate(rank["bundles"]):
            for key, v in r["bundles"][i].items():
                np.testing.assert_allclose(bundle[key], v, rtol=1e-5,
                                           err_msg=f"step {i + 1} {key}")
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    _check_update(ranks[0]["params"], r["start"], r["params"], r["grads"], LR)
    full_opt = 2 * sum(t.numel() for t in r["start"].values())  # Adam's mu and nu
    full_params = sum(t.numel() for t in r["start"].values())
    if strategy == "plain":
        assert ranks[0]["opt_numel"] == full_opt
        assert ranks[0]["counts"]["all_gather"] == ranks[0]["counts"]["reduce_scatter"] == 0
    else:
        assert ranks[0]["opt_numel"] < 0.51 * full_opt
        assert ranks[0]["counts"]["all_gather"] > 0
    assert (ranks[0]["param_numel"] < 0.51 * full_params) == (strategy == "fsdp")
    assert (ranks[0]["counts"]["reduce_scatter"] > 0) == (strategy == "fsdp")


@pytest.mark.parametrize("zero1", [False, True], ids=["dp", "zero1"])
def test_viewpoint_step_with_unequal_shards_matches_the_jax_dp2_step(steps, zero1):
    ref, got = steps
    name = "viewpoint_zero1" if zero1 else "viewpoint"
    r, ranks = ref[name], got[name]
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], r["loss"], rtol=1e-5)
    # Normalising each shard by its own counts gives another loss.
    assert abs(r["mean_of_means"] - r["loss"]) > 1e-3 * abs(r["loss"])
    want = {f"{part}/{k}": v for part, sub in r["params"].items() for k, v in sub.items()}
    start = {f"{part}/{k}": v for part, sub in r["start"].items() for k, v in sub.items()}
    grads = {f"{part}/{k}": v for part, sub in r["grads"].items() for k, v in sub.items()}
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in want)
    for name_, p in ranks[0]["params"].items():
        delta = np.abs(p.numpy() - want[name_].numpy())
        big = np.abs(grads[name_].numpy()) > 1e-5
        assert delta.max() <= 2 * LR + 1e-6, name_
        assert (delta[big] <= LR * 1e-2 + 1e-6).all(), name_
        assert (np.abs(p.numpy() - start[name_].numpy())[big] > 0.5 * LR).all(), name_
    full = sum(t.numel() for t in start.values()) * 2
    assert (ranks[0]["opt_numel"] < 0.6 * full) == zero1


@pytest.mark.parametrize("kind", ["turn_based", "classifier"])
def test_dp_step_equals_the_one_process_step_on_the_whole_batch(steps, kind):
    ref, got = steps
    r, ranks = ref[kind], got[kind]
    lr = 1e-4 if kind == "turn_based" else 1e-3
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], r["loss"], rtol=1e-5)
    moved = 0
    for part, sub in r["params"].items():
        for k, want in sub.items():
            p = ranks[0]["params"][f"{part}/{k}"]
            assert torch.equal(p, ranks[1]["params"][f"{part}/{k}"])
            g = r["grads"][part][k]
            if g is None:  # frozen: untouched on every rank
                assert torch.equal(p, r["start"][part][k])
                continue
            delta = np.abs(p.numpy() - want.numpy())
            big = np.abs(g.numpy()) > 1e-5
            assert delta.max() <= 2 * lr + 1e-6, k
            assert (delta[big] <= lr * 1e-2 + 1e-6).all(), k
            moved += int(big.sum())
    assert moved > 0


def test_stop_consensus_stops_every_rank_at_the_same_boundary(steps):
    _, got = steps
    r0, r1 = got["consensus"]
    assert r0["fired"] is False and r1["fired"] is True
    assert r0["stopped"] == r1["stopped"] == 4
    assert r0["counts"]["all_gather_object"] == 1


# -- the CLI ---------------------------------------------------------------------------------

SMALL_CLI = ["--debug", "--no_use_bfloat16", "--drop_out", "0", "--dropout", "0",
             "--logging_steps", "1", "--max_seq_length", "64", "--per_gpu_eval_batch_size",
             "4", "--per_gpu_train_batch_size", "2"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    out = {k: os.path.join(root, k) for k in ("full", "resumed", "pretrain", "turn", "cls")}
    vp = ["viewpoint", "--config",
          os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
          *SMALL_CLI, "--zero1", "--saving_steps", "2", "--feedback_method", "teacher"]
    argvs = [vp + ["--num_iterations", "4", "--eval_iters", "4", "--output_dir", out["full"]],
             vp + ["--num_iterations", "2", "--eval_iters", "2",
                   "--output_dir", out["resumed"]],
             vp + ["--num_iterations", "4", "--eval_iters", "4", "--resume",
                   "--output_dir", out["resumed"]],
             ["pretrain", "--config",
              os.path.join(REPO, "run_configs/pretrain/pretrain_ndh_r2r.json"), *SMALL_CLI,
              "--fsdp", "--num_epochs", "1", "--per_gpu_train_batch_size", "8",
              "--max_img_seq_length", "16", "--no_add_r2r_data",
              "--output_dir", out["pretrain"]],
             ["turn_based", *SMALL_CLI, "--num_iterations", "2", "--saving_steps", "2",
              "--path_type", "planner_path", "--output_dir", out["turn"]],
             ["classifier", *SMALL_CLI, "--num_iterations", "2", "--saving_steps", "2",
              "--path_type", "planner_path", "--output_dir", out["cls"]]]
    cases = [(f"cli{i}", {"case": "cli", "argvs": [argv]}) for i, argv in enumerate(argvs)]
    return out, join_ranks(start_ranks(os.path.join(root, "work"), cases))


def test_cli_viewpoint_zero1_checkpoints_and_resumes_exactly(cli):
    out, got = cli
    for d in (out["full"], out["resumed"]):
        assert CheckpointManager(d).steps() == [2, 4]
        assert os.path.exists(os.path.join(d, "train.csv"))
        assert os.path.exists(os.path.join(d, "preds_val_seen_4.json"))
    a, b = CheckpointManager(out["full"]), CheckpointManager(out["resumed"])
    for name in ("params", "opt_state"):
        pa, pb = a.restore_raw(4, name), b.restore_raw(4, name)
        la = jax.tree_util.tree_leaves(pa)
        lb = jax.tree_util.tree_leaves(pb)
        assert len(la) == len(lb) > 10
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(la, lb)), name
    # ZeRO-1: the moments are gathered into the single-device layout.
    opt = a.restore_raw(4, "opt_state")
    params = a.restore_raw(4, "params")
    assert opt[1]["mu"]["encoder"].keys() == params["encoder"].keys()
    assert all(opt[1]["mu"][p][k].shape == v.shape for p in params
               for k, v in params[p].items())
    counts = got["cli0"][0]["counts"]
    assert counts["all_reduce_sum"] >= 4 and counts["all_gather"] >= 4


def test_cli_pretrain_fsdp_writes_the_single_device_layout(cli):
    out, got = cli
    steps = CheckpointManager(out["pretrain"]).steps()
    assert len(steps) == 1 and steps[0] > 0
    params = CheckpointManager(out["pretrain"]).restore_raw(steps[0])
    assert params["bert.encoder.layer_0.attention.qkv.weight"].shape == (96, 32)
    with open(os.path.join(out["pretrain"], "train.csv")) as f:
        header = f.readline()
    assert "ndh_val_seen/loss" in header
    assert got["cli3"][0]["counts"]["reduce_scatter"] >= steps[0]


@pytest.mark.parametrize("task", ["turn", "cls"])
def test_cli_turn_based_and_classifier_under_two_ranks(cli, task):
    out, _ = cli
    assert CheckpointManager(out[task]).steps() == [2]
    assert os.path.exists(os.path.join(out[task], "val.csv"))


def test_dp2_checkpoint_resumes_in_one_process(cli, monkeypatch):
    import visitron_torch.train.workspace as tws

    out, _ = cli

    def tiny(cfg, tokenizer):
        return TConfig(vocab_size=len(tokenizer), hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=64,
                       max_position_embeddings=max(cfg.max_seq_length, 512),
                       type_vocab_size=4, img_feature_dim=cfg.img_feature_dim,
                       detector_classes=cfg.detector_classes, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)

    monkeypatch.setattr(tws.Workspace, "_bert_config", staticmethod(tiny))
    trun.main(["viewpoint", "--config",
               os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
               *SMALL_CLI, "--per_gpu_train_batch_size", "4", "--num_iterations", "5",
               "--saving_steps", "5", "--resume", "--eval_iters", "5",
               "--output_dir", out["full"]], device="cpu")
    ckpt = CheckpointManager(out["full"])
    assert ckpt.steps() == [2, 4, 5]
    opt = ckpt.restore_raw(5, "opt_state")
    assert opt[1]["count"] == 5
