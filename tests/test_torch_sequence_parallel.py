"""The port's Ulysses sequence parallelism (``--mesh_sp``) on the CPU, against
the JAX package's (dp, sp) mesh on the 8 virtual CPU devices of
tests/conftest.py, and the multi-rank dry run.

  * ``config_for_mesh`` on an sp mesh (tests/test_sequence_parallel.py:
    39-56's cases, "sp must divide the heads" a ValueError);
  * on two gloo ranks of tests/torch_dist_worker.py at sp 2: two fp32
    pretraining steps (dropouts 0), plain and with ``zero1`` (which at dp
    1 shards nothing), against JAX ``PretrainTrainer`` on
    ``make_sp_mesh(dp=1, sp=2)`` at
    test_torch_multiprocess.py's tolerances (bundles rtol 1e-5, updates
    within 3 lr, 1e-2 lr where every gradient exceeds 1e-4), with the two
    all-to-alls a layer each way; the parameters stay replicated;
  * ``run pretrain --debug --mesh_sp 2`` and ``--mesh_cp 2`` on two gloo
    ranks (a joint sequence of 80 tokens: rank 1's block straddles the text
    and the regions): checkpoints in the single-device layout, finite
    losses, the validation sweep;
  * ``python -m visitron_torch.parallel.dryrun --ranks 4``: every arm's
    loss finite, the JAX dry run's line.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_multiprocess import (LR, PRE, REPO, SMALL_CLI, _check_update, _np,
                                     _pretrain_batch, join_ranks, start_ranks)
from visitron_torch.convert import convert_pretrain_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models import config_for_mesh as t_config_for_mesh
from visitron_torch.parallel import Mesh
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_tpu import models as jm
from visitron_tpu.parallel import make_sp_mesh
from visitron_tpu.train.pretrain import PretrainTrainer as JTrainer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sp_config_for_mesh():
    mesh = Mesh(dp=2, rank=5, device=CPU, axis="sp", size=4)
    cfg = TConfig(**{**PRE, "num_attention_heads": 4}, use_flash_attention=True)
    out = t_config_for_mesh(cfg, mesh)
    # The kernels stay on: a rank runs them on its H/sp heads.
    assert out.sp_mesh is mesh and out.tp_mesh is None
    assert out.use_fused_attention and out.use_flash_attention
    plain = t_config_for_mesh(cfg.replace(use_fused_attention=False,
                                          use_flash_attention=False), mesh)
    assert plain.sp_mesh is mesh and not plain.use_fused_attention
    with pytest.raises(ValueError, match="sp=4 must divide num_attention_heads=3"):
        t_config_for_mesh(cfg.replace(num_attention_heads=3), mesh)
    # sp=1 meshes and dp-only meshes never attach sp_mesh.
    assert t_config_for_mesh(cfg, Mesh(dp=8, rank=0, device=CPU)).sp_mesh is None
    assert t_config_for_mesh(cfg, Mesh(dp=8, rank=0, device=CPU, axis="sp", size=1)) is cfg


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    cases = []
    batches = [_pretrain_batch(seed) for seed in (2, 3)]
    plain = TTrainer(TConfig(**PRE), device="cpu", total_steps=100, learning_rate=LR)
    # One JAX reference serves both arms: at dp 1 ZeRO-1 shards nothing.
    jtr = JTrainer(jm.BertConfig(**PRE), mesh=make_sp_mesh(dp=1, sp=2), total_steps=100,
                   learning_rate=LR)
    jstate = jtr.init_state(batches[0])
    p0 = convert_pretrain_params(_np(jstate["params"]), plain.model)
    for zero1 in (False, True):
        cases.append(("sp_zero1" if zero1 else "sp", {
            "case": "pretrain", "bert": PRE, "params": p0, "batches": batches, "lr": LR,
            "zero1": zero1, "fsdp": False, "mesh": ("sp", 2)}))
    root = str(tmp_path_factory.mktemp("sp_cli"))
    out = {k: os.path.join(root, k) for k in ("sp", "cp")}
    for axis in ("sp", "cp"):
        argv = ["pretrain", "--config",
                os.path.join(REPO, "run_configs/pretrain/pretrain_ndh_r2r.json"), *SMALL_CLI,
                f"--mesh_{axis}", "2", "--num_epochs", "1", "--per_gpu_train_batch_size",
                "8", "--max_img_seq_length", "16", "--no_add_r2r_data",
                "--output_dir", out[axis]]
        cases.append((f"cli_{axis}", {"case": "cli", "argvs": [argv]}))
    started = start_ranks(str(tmp_path_factory.mktemp("sp_steps")), cases)
    jbundles = []
    for b in batches:
        jstate, bundle = jtr.step_fn()(jstate, b)
        jbundles.append({k: float(v) for k, v in _np(bundle).items()})
    ref = {"start": p0, "bundles": jbundles,
           "params": convert_pretrain_params(_np(jstate["params"]), plain.model),
           "grads": [plain.loss_and_grads(p0, plain.to_device(b), None)[1] for b in batches]}
    return {"sp": ref, "sp_zero1": ref}, join_ranks(started), out


@pytest.mark.parametrize("name", ["sp", "sp_zero1"])
def test_sp_pretraining_steps_match_the_jax_sp_trainer(sp, name):
    ref, got, _ = sp
    r, ranks = ref[name], got[name]
    for rank in ranks:  # every rank logs the global bundle
        for i, bundle in enumerate(rank["bundles"]):
            for key, v in r["bundles"][i].items():
                np.testing.assert_allclose(bundle[key], v, rtol=1e-5,
                                           err_msg=f"step {i + 1} {key}")
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    _check_update(ranks[0]["params"], r["start"], r["params"], r["grads"], LR)
    # The parameters stay replicated (sp checkpoints load anywhere).
    assert all(ranks[0]["shapes"][k] == v.shape for k, v in r["start"].items())
    counts = ranks[0]["counts"]
    # Two all-to-alls a layer forward, two backward, for two steps.
    assert counts["all_to_all"] == 2 * 4 * PRE["num_hidden_layers"]
    assert counts["ring_shift"] == 0 and counts["all_reduce_sum"] >= 4


@pytest.mark.parametrize("axis", ["sp", "cp"])
def test_cli_pretrain_mesh_sp_and_cp_on_two_ranks(sp, axis):
    _, got, out = sp
    ckpt = CheckpointManager(out[axis])
    steps = ckpt.steps()
    assert len(steps) == 1 and steps[0] > 0
    params = ckpt.restore_raw(steps[0])
    assert params["bert.encoder.layer_0.attention.qkv.weight"].shape == (96, 32)
    with open(os.path.join(out[axis], "train.csv")) as f:
        rows = list(csv.DictReader(f))
    assert "ndh_val_seen/loss" in rows[0]
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    assert losses and np.all(np.isfinite(losses))
    counts = got[f"cli_{axis}"][0]["counts"]
    key = "all_to_all" if axis == "sp" else "ring_shift"
    assert counts[key] >= 4 * steps[0]


def test_dryrun_runs_every_mesh_arm_on_four_ranks():
    """``--device cpu`` rehearses the arms on gloo CPU ranks; without it the
    dry run asks for one card a rank, and refuses where there are none."""
    cmd = [sys.executable, "-m", "visitron_torch.parallel.dryrun", "--ranks", "4"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=120, env=env)
    assert proc.returncode != 0 and "one rank per card" in proc.stderr, proc.stderr[-2000:]
    proc = subprocess.run(cmd + ["--device", "cpu", "--timeout", "240"], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun ok: 4 gloo ranks, tp(dp=2,tp=2) pretrain loss=")
    for arm in ("nav loss=", "sp+zero1(dp=2,sp=2)", "fsdp(dp=4)", "ring-cp(dp=2,cp=2)",
                "pipeline(dp=2,pp=2)"):
        assert arm in line
