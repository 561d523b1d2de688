"""The port's GPipe pipeline parallelism (``--mesh_pp``,
visitron_torch/parallel/pipeline.py) on the CPU, against the JAX package's
``PipelinePretrainTrainer`` on tests/conftest.py's 8 virtual CPU devices
(tests/test_pipeline.py's configuration: 4 layers, hidden 32, fp32; the
dropouts at 0 here) and against the port's one-process trainer:

  * ``split_pretrain_params`` / ``merge_pretrain_params`` round-trip bit
    for bit, and the stacked layout and stage blocks equal the JAX split's
    after ``convert_pipeline_state``;
  * two gloo ranks of tests/torch_dist_worker.py at dp 1, pp 2, M 4: the
    deterministic bundle and every gradient (merged) against the JAX
    trainer's and the one-process ``PretrainTrainer``'s, then two AdamW
    steps against the JAX trainer's (bundles rtol 1e-5; updates within 3
    lr, 1e-2 lr where every gradient exceeds 1e-4, as
    tests/test_torch_multiprocess.py) and the Adam moments after the first
    step against the JAX trainer's, converted;
  * four gloo ranks at dp 2, pp 2: the same steps against the JAX trainer
    (the per-shard mean loss, the pp-summed ``rest`` gradients, the clip's
    norm);
  * dropout: each (microbatch, stage) and dp shard draws its own hidden
    masks and kernel seeds, and the kernels keep 1 - rate;
  * the microbatch rule of visitron_tpu/run.py:216-219 and the refusals;
  * ``run pretrain --debug --mesh_pp 2`` on the two ranks: checkpoints in
    the single-device layout that a one-process trainer loads, the
    optimizer state in the trainer's, ``--resume`` with the same
    ``--mesh_pp``.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from test_pipeline import _batch
from test_torch_multiprocess import (LR, REPO, SMALL_CLI, _check_update, _np, join_ranks,
                                     start_ranks)
from visitron_torch import parallel
from visitron_torch.config import RunConfig
from visitron_torch.convert import convert_pipeline_state, convert_pretrain_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models import bert as tbert
from visitron_torch.ops.attention import _head_keep_mask
from visitron_torch.parallel import Mesh
from visitron_torch.parallel.pipeline import (PipelinePretrainTrainer, _stage_apply,
                                              default_microbatches, merge_pretrain_params,
                                              split_pretrain_params, stage_block)
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.pretrain import pretrain_mesh
from visitron_tpu import models as jm
from visitron_tpu.parallel.pipeline import PipelinePretrainTrainer as JPipeline
from visitron_tpu.parallel.pipeline import make_pp_mesh
from visitron_tpu.parallel.pipeline import merge_pretrain_params as j_merge

CPU = torch.device("cpu")
PP = dict(vocab_size=97, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
          intermediate_size=64, max_position_embeddings=48, type_vocab_size=4,
          img_feature_dim=16, action_space=6, detector_classes=7,
          use_fused_attention=False, hidden_dropout_prob=0.0,
          attention_probs_dropout_prob=0.0)
MICRO = 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hand_mesh(dp: int, rank: int) -> Mesh:
    return Mesh(dp=dp, rank=rank, device=CPU, axis="pp", size=2)


def _port_states(jstate, dp: int) -> list:
    """Each rank's converted state of a JAX pipeline state (numpy), without
    its generators."""
    out = []
    for r in range(2 * dp):
        tr = PipelinePretrainTrainer(TConfig(**PP), _hand_mesh(dp, r),
                                     num_microbatches=MICRO, total_steps=100,
                                     learning_rate=LR, device="cpu")
        state = convert_pipeline_state(jstate, tr)
        out.append({"params": state["params"], "opt_state": state["opt_state"]})
    return out


def _jax_params(jtrainer, jstate) -> dict:
    """A JAX pipeline state's parameters in the port's single-device layout."""
    model = TTrainer(TConfig(**PP), device="cpu").model
    return convert_pretrain_params(_np(jtrainer.checkpoint_params(jstate)), model)


def _shard_grads(batch, params, dp: int) -> list:
    """The one-process gradients of each dp shard's rows (the masks of
    ``_check_update``)."""
    tr = TTrainer(TConfig(**PP), device="cpu")
    n = len(batch["input_ids"]) // dp
    return [tr.loss_and_grads(params, tr.to_device({k: v[i * n:(i + 1) * n]
                                                   for k, v in batch.items()}), None)[1]
            for i in range(dp)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the ranks' results: dp 1 (two ranks, with the
    CLI runs) and dp 2 (four ranks), started together."""
    jcfg = jm.BertConfig(**PP)
    refs, started, cli_out = {}, [], str(tmp_path_factory.mktemp("pp_cli") / "out")
    for dp in (1, 2):
        rng = np.random.default_rng(10 + dp)
        batches = [_batch(rng, batch=8 * dp) for _ in range(2)]
        jtr = JPipeline(jcfg, make_pp_mesh(dp=dp, pp=2), num_microbatches=MICRO,
                        learning_rate=LR, total_steps=100)
        jstate = jtr.init_state(batches[0])
        host = _np({"params": jstate["params"], "opt_state": jstate["opt_state"]})
        start = _jax_params(jtr, jstate)
        cases = [(f"pp_dp{dp}", {"case": "pipeline", "bert": PP, "lr": LR, "batches": batches,
                                 "microbatches": MICRO, "states": _port_states(host, dp),
                                 "mesh": ("pp", 2)})]
        if dp == 1:
            argv = ["pretrain", "--config",
                    os.path.join(REPO, "run_configs/pretrain/pretrain_ndh_r2r.json"),
                    *SMALL_CLI, "--mesh_pp", "2", "--per_gpu_train_batch_size", "4",
                    "--max_img_seq_length", "16", "--no_add_r2r_data", "--output_dir",
                    cli_out]
            cases.append(("cli_pp", {"case": "cli", "argvs": [
                argv + ["--num_epochs", "1"], argv + ["--num_epochs", "2", "--resume"]]}))
        started.append(start_ranks(str(tmp_path_factory.mktemp(f"pp{dp}")), cases,
                                   world=2 * dp))
        refs[dp] = {"jtr": jtr, "jstate": jstate, "batches": batches, "start": start}
    for dp, ref in refs.items():
        jtr, jstate, batches = ref["jtr"], ref["jstate"], ref["batches"]
        rest, stages = jtr.state_from_params(jtr.checkpoint_params(jstate))["params"].values()
        jb = {k: jax.numpy.asarray(v) for k, v in batches[0].items()}
        bundle, g_rest, g_stages = jax.jit(jtr._sharded_grad_fn(deterministic=True))(
            rest, stages, jb)
        ref["bundle"] = {k: float(v) for k, v in bundle.items()}
        ref["grads"] = convert_pretrain_params(_np(j_merge(g_rest, g_stages)),
                                               TTrainer(TConfig(**PP), device="cpu").model)
        ref["bundles"], step = [], jtr.step_fn()
        for i, b in enumerate(batches):
            jstate, out = step(jstate, b)
            ref["bundles"].append({k: float(v) for k, v in _np(out).items()})
            if i == 0:
                host = _np({"params": jstate["params"], "opt_state": jstate["opt_state"]})
                ref["opt"] = [s["opt_state"] for s in _port_states(host, dp)]
        ref["params"] = _jax_params(jtr, jstate)
        ref["shard_grads"] = [_shard_grads(b, ref["start"], dp) for b in batches]
    got = {}
    for s in started:
        got.update(join_ranks(s))
    return refs, got, cli_out


def test_split_merge_round_trip_and_the_jax_layout():
    tr = TTrainer(TConfig(**PP), device="cpu")
    params = tr.init_params()
    rest, stages = split_pretrain_params(params)
    assert not any(k.startswith("bert.encoder.") for k in rest)
    assert stages["attention.qkv.weight"].shape == (4, 96, 32)
    merged = merge_pretrain_params(rest, stages)
    assert merged.keys() == params.keys()
    assert all(torch.equal(merged[k], v) for k, v in params.items())
    # The JAX split of the same weights, carried across for each rank: its
    # contiguous block of the stacked layers, the replicated rest.
    batch = _batch(np.random.default_rng(0))
    jtr = JPipeline(jm.BertConfig(**PP), make_pp_mesh(dp=1, pp=2), num_microbatches=MICRO)
    jstate = jtr.init_state(batch)
    full = convert_pretrain_params(_np(jtr.checkpoint_params(jstate)), tr.model)
    want_rest, want_stages = split_pretrain_params(full)
    host = _np({"params": jstate["params"], "opt_state": jstate["opt_state"]})
    for r, state in enumerate(_port_states(host, 1)):
        got = state["params"]
        assert got["rest"].keys() == want_rest.keys()
        assert all(torch.equal(got["rest"][k], v) for k, v in want_rest.items())
        block = stage_block(want_stages, _hand_mesh(1, r))
        assert all(torch.equal(got["stages"][k], v[2 * r:2 * r + 2])
                   for k, v in want_stages.items())
        assert all(torch.equal(block[k], got["stages"][k]) for k in block)
        mu = state["opt_state"][1]["mu"]
        assert mu["stages"]["attention.qkv.weight"].shape == (2, 96, 32)


@pytest.mark.parametrize("dp", [1, 2])
def test_pipeline_steps_match_the_jax_pipeline_trainer(runs, dp):
    refs, got, _ = runs
    ref, ranks = refs[dp], got[f"pp_dp{dp}"]
    for rank in ranks:  # every rank holds the global bundle
        for key, v in ref["bundle"].items():
            np.testing.assert_allclose(rank["bundle"][key], v, rtol=1e-5, err_msg=key)
        for i, bundle in enumerate(rank["bundles"]):
            for key, v in ref["bundles"][i].items():
                np.testing.assert_allclose(bundle[key], v, rtol=1e-5,
                                           err_msg=f"step {i + 1} {key}")
        assert rank["block"]["attention.qkv.weight"] == (2, 96, 32)
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][name].numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    # Every rank gathers the same parameters; the update is the JAX one.
    assert all(torch.equal(r["params"][k], ranks[0]["params"][k])
               for r in ranks[1:] for k in ranks[0]["params"])
    grads = [{k: sum(g[k] for g in shards) / dp for k in shards[0]}
             for shards in ref["shard_grads"]]
    _check_update(ranks[0]["params"], ref["start"], ref["params"], grads, LR)
    # The Adam moments after the first step, against the JAX trainer's
    # carried across by convert_pipeline_state (each rank's block).
    adam = ranks[0]["opt"][1]
    for moment in ("mu", "nu"):
        want_rest = ref["opt"][0][1][moment]["rest"]
        for k, v in want_rest.items():
            np.testing.assert_allclose(adam[moment]["rest"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-9, err_msg=f"{moment} {k}")
        for k, v in adam[moment]["stages"].items():
            want = torch.cat([ref["opt"][r][1][moment]["stages"][k] for r in range(2)])
            np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=1e-4, atol=1e-9,
                                       err_msg=f"{moment} {k}")
    assert adam["count"] == 1
    counts = ranks[0]["counts"]
    # Per step, forward and backward: M sends from the first stage, M
    # receives of gradients; nothing staged through the host on the CPU.
    assert counts["send_next"] == counts["recv_next"] == 3 * MICRO
    assert counts["recv_prev"] == counts["send_prev"] == 0
    assert counts["p2p_host_staged"] == 0
    assert ranks[1]["counts"]["recv_prev"] == ranks[1]["counts"]["send_prev"] == 3 * MICRO


def test_pipeline_step_matches_the_one_process_trainer(runs):
    refs, got, _ = runs
    ref, rank = refs[1], got["pp_dp1"][0]
    tr = TTrainer(TConfig(**PP), device="cpu")
    bundle, grads = tr.loss_and_grads(ref["start"], tr.to_device(ref["batches"][0]), None)
    for key, v in bundle.items():
        np.testing.assert_allclose(rank["bundle"][key], float(v), rtol=1e-6, err_msg=key)
    for name, g in grads.items():
        np.testing.assert_allclose(rank["grads"][name].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_dropout_draws_per_microbatch_and_stage(monkeypatch):
    """At S 128 each layer's attention runs K1 (its CPU twin): every
    (microbatch, layer, stage, dp shard) gets its own kernel seed, the
    kernels keep 1 - rate, and the hidden-dropout generators differ by
    stage and dp shard; one stage block applied to one microbatch M times on
    each of four ranks gives 4 M different outputs."""
    cfg = TConfig(**{**PP, "hidden_size": 128, "num_attention_heads": 2,
                     "intermediate_size": 256, "max_position_embeddings": 128,
                     "use_fused_attention": True, "hidden_dropout_prob": 0.1,
                     "attention_probs_dropout_prob": 0.1})
    drawn = []
    real = tbert.fused_attention_packed

    def spy(q, k, v, bias, heads, seed, rate):
        drawn.append((seed, rate))
        return real(q, k, v, bias, heads, seed, rate)

    monkeypatch.setattr(tbert, "fused_attention_packed", spy)
    params = TTrainer(cfg, device="cpu").init_params()
    stages = stage_block(split_pretrain_params(params)[1], _hand_mesh(1, 0))
    x = torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(0))
    bias = torch.zeros(2, 128)
    outs, mask_seeds = [], set()
    for rank in range(4):
        tr = PipelinePretrainTrainer(cfg, _hand_mesh(2, rank), num_microbatches=MICRO,
                                     device="cpu")
        rng = tr.dropout_rng()
        assert rng.seed_offset == (rank // 2) * 1000003 + (rank % 2) * 7919
        mask_seeds.add(rng.masks.initial_seed())
        with torch.no_grad():
            outs += [_stage_apply(tr.stage, stages, x, bias, rng) for _ in range(MICRO)]
    assert len(mask_seeds) == 4
    flat = torch.stack(outs).flatten(1)
    assert torch.cdist(flat, flat).add(torch.eye(len(outs)) * 1e9).min() > 1e-3
    seeds = [s for s, _ in drawn]
    assert len(seeds) == 4 * MICRO * 2 and len(set(seeds)) == len(seeds)
    assert {rate for _, rate in drawn} == {0.1}
    keep = torch.stack([_head_keep_mask(s, 2, 2, 128, 0.1, "cpu") for s in seeds]).float()
    n = keep.numel()
    assert abs(float(keep.mean()) - 0.9) < 5 * (0.9 * 0.1 / n) ** 0.5


def test_microbatch_rule_and_refusals(tmp_path, monkeypatch):
    for pp in (2, 3, 4):
        for per_shard in range(1, 40):
            # visitron_tpu/run.py:216-219
            want = max(m for m in range(1, min(4 * pp, per_shard) + 1) if per_shard % m == 0)
            assert default_microbatches(pp, per_shard) == want
    cfg = TConfig(**PP)
    assert PipelinePretrainTrainer(cfg, _hand_mesh(1, 0)).num_microbatches == 8
    with pytest.raises(ValueError, match="4 layers not divisible by pp=3"):
        PipelinePretrainTrainer(cfg, Mesh(dp=1, rank=0, device=CPU, axis="pp", size=3))
    with pytest.raises(ValueError, match="needs a \\(dp, pp\\) mesh, got a tp axis"):
        PipelinePretrainTrainer(cfg, Mesh(dp=1, rank=0, device=CPU, axis="tp", size=2))
    with pytest.raises(TypeError, match="needs a parallel.Mesh"):
        PipelinePretrainTrainer(cfg, make_pp_mesh(dp=1, pp=2))
    with pytest.raises(ValueError, match="carries no tp, sp or cp mesh"):
        PipelinePretrainTrainer(cfg.replace(sp_mesh=Mesh(dp=1, rank=0, device=CPU,
                                                         axis="sp", size=2)), _hand_mesh(1, 0))
    tr = PipelinePretrainTrainer(cfg, _hand_mesh(1, 0), num_microbatches=4, device="cpu")
    batch = tr.to_device(_batch(np.random.default_rng(0), batch=6))
    with pytest.raises(ValueError, match="batch 6 not divisible by num_microbatches=4"):
        tr.loss_and_grads(tr.init_state()["params"], batch, None)
    # pp runs over ranks, on one host; it composes with dp alone.
    with pytest.raises(ValueError, match="--mesh_pp 2 needs 2 ranks"):
        pretrain_mesh(RunConfig(mesh_pp=2))
    with pytest.raises(ValueError, match="--zero1 applies to the standard pretrain"):
        RunConfig(mesh_pp=2, zero1=True)
    parallel.init_process_group("cpu", init_method=f"file://{tmp_path}/pg", rank=0,
                                world_size=1)
    try:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="--mesh_pp runs on one host"):
            pretrain_mesh(RunConfig(mesh_pp=2), "cpu")
    finally:
        parallel.destroy_process_group()


def test_cli_pretrain_mesh_pp_checkpoints_and_resumes(runs):
    _, got, out = runs
    ckpt = CheckpointManager(out)
    steps = ckpt.steps()
    assert len(steps) == 2 and steps[1] == 2 * steps[0] > 0
    # The parameters in the single-device layout: a one-process trainer of
    # the CLI's tiny BERT (tests/torch_dist_worker.py) loads them.
    params = ckpt.restore_raw(steps[-1])
    shape = {k: v.shape for k, v in params.items()}
    one = TTrainer(TConfig(vocab_size=shape["mlm_bias"][0], hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                           max_position_embeddings=shape[
                               "bert.embeddings.position_embeddings.weight"][0],
                           type_vocab_size=4,
                           img_feature_dim=shape["bert.img_embedding.weight"][1],
                           detector_classes=shape["token_head.weight"][0]), device="cpu")
    loaded = ckpt.restore(steps[-1], {"params": one.init_params()})["params"]
    assert all(torch.equal(loaded[k], v) for k, v in params.items())
    # The optimizer state in the trainer's layout, the stages gathered.
    mu = ckpt.restore_raw(steps[-1], "opt_state")[1]["mu"]
    assert set(mu) == {"rest", "stages"}
    assert mu["stages"]["attention.qkv.weight"].shape == (2, 96, 32)
    with open(os.path.join(out, "train.csv")) as f:
        rows = list(csv.DictReader(f))
    # Every rank ran the pipelined validation; rank 0 logged it.
    assert any(r.get("ndh_val_seen/loss") for r in rows)
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    assert losses and np.all(np.isfinite(losses))
    with open(os.path.join(out, "train.log")) as f:
        assert f"resumed from checkpoint-{steps[0]}" in f.read()
    counts = got["cli_pp"][0]["counts"]  # the resumed run's, rank 0
    assert counts["send_next"] >= steps[0] and counts["all_gather"] >= 1
