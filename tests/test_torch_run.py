"""The port's run configuration and ``python -m visitron_torch.run`` on the
CPU: every ``run_configs/**/*.json`` and a list of command lines parse to
the same values as the JAX package's ``RunConfig``, with the same
overrides and the same validation errors; ``run.main`` drives
``viewpoint`` (train, checkpoints, val, ``--test_only``) and ``pretrain``
(a checkpoint per epoch, which ablation 3's fine-tune config starts from)
on the ``--debug`` world with the tiny BERT of the JAX package's own drive
tests (hidden 32, 2 layers, 4 heads) patched into ``Workspace._bert_config``,
and scale-only overrides (iterations, epochs, batch, sequence lengths, as
tests/test_run_config_drive.py does); unported options refuse.
"""

import csv
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import visitron_torch.train.workspace as tws
from visitron_torch import run as trun
from visitron_torch.config import RunConfig as TConfig
from visitron_torch.models import BertConfig as TBert
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_tpu.config import RunConfig as JConfig

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "run_configs", "**", "*.json"), recursive=True))
ARGVS = [
    [],
    ["--path_type", "planner_path", "--learning_rate", "1e-4", "--add_r2r_data",
     "--num_iterations", "7", "--eval_iters", "1", "2"],
    ["--no_use_bfloat16", "--feedback_method", "rl", "--temperature", "0.5",
     "--bf16_adam_moments", "--async_checkpoints"],
    ["--debug", "--resume", "--test_only", "--submit", "--no_add_ndh_data", "--add_rxr_data"],
    ["--mesh_dp", "1", "--rng_impl", "threefry2x32", "--length_sort_window", "0",
     "--scheduler", "constant", "--output_dir", "out/x"],
    ["--use_flash_attention", "--no_use_fused_attention", "--remat", "--seed", "3"],
]
INVALID = [
    {"path_type": "shortest"},
    {"feedback_method": "beam"},
    {"scheduler": "cosine"},
    {"rng_impl": "philox"},
    {"feature_extract_dtype": "float16"},
    {"aug_keep_fraction": 1.5},
    {"speaker_feat_dropout": 1.0},
    {"mesh_pp": 0},
    {"mesh_pp": 2, "mesh_tp": 2},
    {"mesh_sp": 2, "mesh_pp": 2},
    {"mesh_cp": 2, "mesh_sp": 2},
    {"zero1": True, "mesh_pp": 2},
    {"fsdp": True, "mesh_pp": 2},
]
# Scale-only overrides for the CPU: the JAX package's drive tests' sizes.
SMALL = ["--debug", "--no_use_bfloat16", "--drop_out", "0", "--dropout", "0",
         "--logging_steps", "1", "--max_seq_length", "64", "--per_gpu_eval_batch_size", "4"]


def _tiny(cfg, tokenizer):
    return TBert(vocab_size=len(tokenizer), hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=max(cfg.max_seq_length, 512), type_vocab_size=4,
                 img_feature_dim=cfg.img_feature_dim, detector_classes=cfg.detector_classes,
                 hidden_dropout_prob=cfg.drop_out, attention_probs_dropout_prob=cfg.drop_out)


@pytest.fixture()
def tiny_bert(monkeypatch):
    monkeypatch.setattr(tws.Workspace, "_bert_config", staticmethod(_tiny))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the run configuration ------------------------------------------------------------

def test_fields_and_defaults_match_jax():
    tf, jf = dataclasses.fields(TConfig), dataclasses.fields(JConfig)
    assert [(f.name, f.type) for f in tf] == [(f.name, f.type) for f in jf]
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())
    assert TConfig().episode_len == JConfig().episode_len == 40
    assert TConfig(path_type="planner_path").episode_len == 10
    assert TConfig().train_batch_size(1) == JConfig().train_batch_size(1) == 8


@pytest.mark.parametrize("path", CONFIGS)
def test_every_run_config_parses_like_jax(path, tmp_path):
    full = os.path.join(REPO, path)
    tcfg, jcfg = TConfig.from_json(full), JConfig.from_json(full)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    out = str(tmp_path / "cfg.json")
    tcfg.to_json(out)
    assert JConfig.from_json(out) == jcfg and TConfig.from_json(out) == tcfg


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a[:2]) or "defaults" for a in ARGVS])
def test_argv_and_overrides_parse_like_jax(argv):
    assert dataclasses.asdict(TConfig.from_args(argv)) == dataclasses.asdict(
        JConfig.from_args(argv))
    assert TConfig.cli_overrides(argv) == JConfig.cli_overrides(argv)


def test_config_file_with_overrides_matches_jax(monkeypatch):
    """``--config file`` plus explicit flags, through both packages' main:
    a flag present on the command line wins even at its default value."""
    from visitron_tpu import run as jrun

    seen = {}
    monkeypatch.setattr(jrun, "run_viewpoint", lambda cfg, **kw: seen.setdefault("jax", cfg))
    monkeypatch.setattr(trun, "run_viewpoint", lambda cfg, **kw: seen.setdefault("torch",
                                                                                 cfg))
    argv = ["viewpoint", "--config",
            os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
            "--num_iterations", "7", "--drop_out", "0.1", "--no_oscar_setting"]
    jrun.main(list(argv))
    trun.main(list(argv), device="cpu")
    assert dataclasses.asdict(seen["torch"]) == dataclasses.asdict(seen["jax"])
    assert seen["torch"].num_iterations == 7 and seen["torch"].drop_out == 0.1
    assert not seen["torch"].oscar_setting and seen["torch"].max_seq_length == 768


@pytest.mark.parametrize("bad", INVALID, ids=[",".join(b) for b in INVALID])
def test_validation_errors_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        JConfig(**bad)
    with pytest.raises(ValueError) as terr:
        TConfig(**bad)
    assert str(terr.value) == str(jerr.value)


# -- (j) the CLI ---------------------------------------------------------------------------

def _marked(out):
    return CheckpointManager(out).steps()


def test_run_viewpoint_trains_validates_and_submits(tmp_path, tiny_bert):
    out = str(tmp_path / "vp")
    cfg = os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json")
    trun.main(["viewpoint", "--config", cfg, *SMALL, "--num_iterations", "2",
               "--saving_steps", "1", "--eval_iters", "2", "--output_dir", out], device="cpu")
    names = set(os.listdir(out))
    assert {"train.csv", "val.csv", "checkpoint-1", "checkpoint-2",
            "preds_val_seen_2.json", "preds_val_unseen_2.json"} <= names
    assert _marked(out) == [1, 2]
    preds = json.load(open(os.path.join(out, "preds_val_seen_2.json")))
    assert preds and {"inst_idx", "trajectory"} <= set(preds[0])
    with open(os.path.join(out, "val.csv")) as f:
        header = f.readline()
    assert "val_seen/spl" in header and "val_unseen/loss" in header
    trun.main(["viewpoint", "--config", cfg, *SMALL, "--test_only", "--output_dir", out],
              device="cpu")
    sub = json.load(open(os.path.join(out, "submission_test.json")))
    assert len(sub) == 4
    for item in sub:  # submit mode: no viewpoint visited twice
        vps = [p[0] for p in item["trajectory"]]
        assert len(vps) == len(set(vps))


def test_run_pretrain_then_ablation_3_finetunes_from_it(tmp_path, tiny_bert, caplog):
    pre = str(tmp_path / "pre")
    trun.main(["pretrain", "--config",
               os.path.join(REPO, "run_configs/pretrain/pretrain_ndh_r2r.json"), *SMALL,
               "--num_epochs", "1", "--per_gpu_train_batch_size", "16",
               "--max_img_seq_length", "16", "--output_dir", pre], device="cpu")
    steps = _marked(pre)
    assert len(steps) == 1 and steps[0] > 0
    assert json.load(open(os.path.join(pre, f"checkpoint-{steps[0]}", "meta.json"))) == {
        "step": steps[0]}
    with open(os.path.join(pre, "train.csv")) as f:
        header = f.readline()
    assert "ndh_val_seen/loss" in header and "r2r_val_unseen/mask_loss" in header
    pretrained = CheckpointManager(pre).restore_raw(steps[0])
    fine = str(tmp_path / "fine")
    caplog.set_level("INFO", logger="visitron_torch")
    trun.main(["viewpoint", "--config",
               os.path.join(REPO, "run_configs/ablations/3_only_oscar_mlm-finetune_ndh.json"),
               *SMALL, "--num_iterations", "1", "--saving_steps", "1", "--eval_iters", "1",
               "--model_name_or_path", pre, "--output_dir", fine], device="cpu")
    assert "loaded pretraining checkpoint" in caplog.text
    enc = CheckpointManager(fine).restore_raw(1)["encoder"]
    shared = [n for n in enc if n.startswith("bert.bert.")
              and n[len("bert.bert."):] in {k[len("bert."):] for k in pretrained}]
    assert len(shared) > 20
    for name in shared:  # one Adam step of lr 5e-5 away from the pretrained weights
        delta = (enc[name] - pretrained["bert." + name[len("bert.bert."):]]).abs().max()
        assert float(delta) <= 2 * 5e-5 + 1e-7, name


def test_run_pretrain_resumes_from_its_checkpoint(tmp_path, tiny_bert):
    """A second epoch with --resume restores the first epoch's checkpoint
    (the optimizer's and the schedule's counts go on from it) and skips no
    batch of the new epoch.  As in the JAX package, the dynamic-masking
    stream is not saved: a resumed epoch masks other tokens than an
    uninterrupted run would."""
    pre = str(tmp_path / "pre")
    argv = ["pretrain", "--config",
            os.path.join(REPO, "run_configs/pretrain/pretrain_ndh_r2r.json"), *SMALL,
            "--per_gpu_train_batch_size", "16", "--max_img_seq_length", "16",
            "--no_add_r2r_data", "--output_dir", pre]
    trun.main(argv + ["--num_epochs", "1"], device="cpu")
    (n,) = _marked(pre)
    trun.main(argv + ["--num_epochs", "2", "--resume"], device="cpu")
    assert _marked(pre) == [n, 2 * n]
    opt = CheckpointManager(pre).restore_raw(2 * n, "opt_state")
    assert opt[1]["count"] == opt[-1]["count"] == 2 * n
    with open(os.path.join(pre, "train.csv")) as f:
        steps = sorted({int(float(r["step"])) for r in csv.DictReader(f)})
    assert steps == list(range(n + 1, 2 * n + 1))


class _Built(Exception):
    """Raised by a stand-in trainer: the run's schedule is fixed by then."""


@pytest.mark.parametrize("axis", ["tp", "sp", "cp", "pp"])
def test_run_pretrain_global_batch_matches_jax_on_every_mesh(axis, tmp_path, monkeypatch):
    """At ``--mesh_dp 1 --mesh_{axis} 2`` both packages' ``run pretrain``
    take the global batch per_gpu x every device (rank), so an epoch has
    as many steps: the trainers are stood in for, and the schedule's
    length (and the pipeline's microbatches) compared. The fine-tuning
    trainers' rows of that global batch follow the same rule."""
    import visitron_torch.parallel.pipeline as tpipe
    import visitron_torch.train.pretrain as tpre
    import visitron_tpu.parallel as jpar
    import visitron_tpu.train.pretrain as jpre
    from visitron_torch.parallel import Mesh
    from visitron_torch.train.finetune import per_host_batch_size
    from visitron_tpu import run as jrun

    seen = {}

    def stand_in(name):
        def build(*args, **kw):
            seen[name] = (kw["total_steps"], kw.get("num_microbatches"))
            raise _Built
        return build

    for mod, attr in ((jpre, "PretrainTrainer"), (jpar, "PipelinePretrainTrainer")):
        monkeypatch.setattr(mod, attr, stand_in("jax"))
    for mod, attr in ((tpre, "PretrainTrainer"), (tpipe, "PipelinePretrainTrainer")):
        monkeypatch.setattr(mod, attr, stand_in("torch"))
    mesh = Mesh(dp=1, rank=0, device=torch.device("cpu"), axis=axis, size=2)
    monkeypatch.setattr(tpre, "pretrain_mesh", lambda cfg, device=None: mesh)
    argv = ["pretrain", "--config",
            os.path.join(REPO, "run_configs/pretrain/pretrain_ndh_r2r.json"), *SMALL,
            "--num_epochs", "1", "--per_gpu_train_batch_size", "2", "--mesh_dp", "1",
            f"--mesh_{axis}", "2"]
    with pytest.raises(_Built):
        jrun.main(argv + ["--output_dir", str(tmp_path / "jax")])
    with pytest.raises(_Built):
        trun.main(argv + ["--output_dir", str(tmp_path / "torch")], device="cpu")
    assert seen["torch"] == seen["jax"]
    cfg = TConfig.from_args(argv[3:])
    assert per_host_batch_size(cfg, mesh) == cfg.train_batch_size(2) == 4


def test_ablation_chain_at_the_configs_lengths_refuses_like_jax(tmp_path):
    """The ablation fine-tunes set max_seq_length 768 (768 positions), the
    pretraining configs keep 512: the graft's shape rule refuses the
    position table in both packages."""
    import flax

    from visitron_torch.models.oscar_import import graft_pretrain_checkpoint_into_encoder
    from visitron_tpu.models.oscar_import import \
        graft_pretrain_checkpoint_into_encoder as jgraft
    from visitron_tpu.train.checkpoint import CheckpointManager as JCkpt

    pos = "embeddings.position_embeddings"
    CheckpointManager(str(tmp_path / "t")).save(1, {f"bert.{pos}.weight": torch.zeros(512, 8)})
    with pytest.raises(ValueError, match="position_embeddings"):
        graft_pretrain_checkpoint_into_encoder(
            {f"bert.bert.{pos}.weight": torch.zeros(768, 8)}, str(tmp_path / "t"))
    JCkpt(str(tmp_path / "j")).save(1, {"params": {"bert": flax.traverse_util.unflatten_dict(
        {tuple(pos.split(".")) + ("embedding",): np.zeros((512, 8), np.float32)})}})
    enc = {"params": {"bert": {"bert": flax.traverse_util.unflatten_dict(
        {tuple(pos.split(".")) + ("embedding",): np.zeros((768, 8), np.float32)})}}}
    with pytest.raises(AssertionError):
        jgraft(enc, str(tmp_path / "j"))


def test_debug_world_has_a_test_split_where_the_jax_one_has_none(tmp_path):
    """``viewpoint --debug --test_only`` rolls out the test split: the port's
    synthetic task data holds one, written after the others (which stay as
    the JAX package writes them); the JAX package's has none, so its
    --test_only fails there."""
    from visitron_torch.train.finetune import ViewpointTrainer
    from visitron_tpu.train.finetune import ViewpointTrainer as JTrainer
    from visitron_tpu.train.workspace import Workspace as JWorkspace

    kw = dict(debug=True, lstm_img_feature_dim=8, img_feature_dim=8, max_seq_length=64)
    tcfg = TConfig(output_dir=str(tmp_path / "t"), **kw)
    jcfg = JConfig(output_dir=str(tmp_path / "j"), mesh_dp=1, **kw)
    ttr = ViewpointTrainer(tcfg, tws.Workspace.synthetic_workspace(tcfg, device="cpu"),
                           device="cpu")
    jtr = JTrainer(jcfg, JWorkspace.synthetic_workspace(jcfg))
    assert len(ttr._instances(["test"])) == 4
    for split in ("train", "val_seen", "val_unseen"):
        assert [i.raw for i in ttr._instances([split])] == [
            i.raw for i in jtr._instances([split])]
    with pytest.raises(FileNotFoundError):
        jtr._instances(["test"])


def test_unported_options_and_unknown_tasks_refuse(tmp_path):
    # tp, sp, cp and pp need their ranks (a process group), and sp, cp and
    # pp are the pretrain task's.
    with pytest.raises(ValueError, match="--mesh_pp 2 needs 2 ranks"):
        trun.main(["pretrain", "--debug", "--output_dir", str(tmp_path),
                   "--mesh_pp", "2"], device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        trun.main(["viewpoint", "--debug", "--output_dir", str(tmp_path),
                   "--mesh_tp", "2"], device="cpu")
    for axis in ("sp", "cp", "pp"):
        with pytest.raises(SystemExit, match=f"--mesh_{axis} applies to the pretrain task"):
            trun.main(["viewpoint", "--debug", "--output_dir", str(tmp_path),
                       f"--mesh_{axis}", "2"], device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        trun.main(["pretrain", "--debug", "--mesh_dp", "2", "--output_dir", str(tmp_path)],
                  device="cpu")
    with pytest.raises(SystemExit, match="--fsdp applies to the pretrain task"):
        trun.main(["viewpoint", "--debug", "--fsdp"], device="cpu")
    with pytest.raises(SystemExit, match="unknown task"):
        trun.main(["navigate"], device="cpu")


def test_main_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["viewpoint", "--debug", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["pretrain", "--debug", "--output_dir", str(tmp_path)])
    from visitron_torch.train.finetune import ViewpointTrainer
    from visitron_torch.train.pretrain import pretrain_loop

    cfg = TConfig(debug=True, output_dir=str(tmp_path), lstm_img_feature_dim=8,
                  img_feature_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tws.Workspace.synthetic_workspace(cfg)
    ws = tws.Workspace.synthetic_workspace(cfg, device="cpu")
    for entry in (lambda: ViewpointTrainer(cfg, ws), lambda: pretrain_loop(cfg, ws)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
