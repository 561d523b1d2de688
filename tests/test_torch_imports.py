"""visitron_torch stands alone: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import visitron_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "visitron_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "visitron_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter with jax, flax, optax and visitron_tpu made
    unimportable (entries already loaded at start-up are blocked too)
    imports every module of the port and chip_smoke."""
    code = f"""
import importlib, pkgutil, sys
blocked = {BLOCKED!r}
for name in list(sys.modules):
    if name.split('.')[0] in blocked:
        sys.modules[name] = None
for name in blocked:
    sys.modules[name] = None
import visitron_torch
names = [m.name for m in pkgutil.walk_packages(visitron_torch.__path__, 'visitron_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
print(' '.join(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, names = res.stdout.strip().splitlines()[-2:]
    assert int(count) >= 30
    # The mesh modules: the ring attention, the (dp, tp|sp|cp|pp) mesh and
    # its collectives, the pipeline trainer, the multi-rank dry run, and the
    # timing harness.
    assert {"visitron_torch.ops.ring_attention", "visitron_torch.parallel.mesh",
            "visitron_torch.parallel.pipeline", "visitron_torch.parallel.dryrun",
            "visitron_torch.utils.benchmark"} <= set(names.split())


def test_sources_import_nothing_of_jax():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"


def test_package_lists_every_ported_module():
    names = {m.name for m in pkgutil.walk_packages(visitron_torch.__path__, "visitron_torch.")}
    for mod in ("geometry", "graph.nav_graph", "data.features", "data.candidates",
                "data.tokenization", "data.dialog", "data.datasets", "testing.synthetic",
                "ops.masking", "ops.layernorm", "ops.attention", "models.bert",
                "models.lstm", "models.encoder", "models.decoder", "agents.runtime",
                "agents.batcher", "agents.decoding", "agents.viewpoint", "convert",
                "_build", "ops.crossentropy", "models.pretrain", "train.optim",
                "train.pretrain", "data.pretrain_dataset", "pipelines",
                "pipelines.pretrain_datagen", "models.speaker", "evaluation",
                "evaluation.metrics", "config", "run", "train.logging",
                "train.preemption", "train.checkpoint", "train.workspace",
                "train.finetune", "models.oscar_import", "agents.turn_based",
                "agents.classifier", "models.classification", "data.classifier_dataset",
                "evaluation.classifier_metrics", "train.turn_based", "train.classifier",
                "agents.speaker", "sim", "sim.simulator", "sim.native", "data.env",
                "data.legacy_tokenizer", "utils", "utils.timer", "ops.detection",
                "models.resnet", "models.detector", "pipelines.rendering",
                "pipelines.scene_features", "pipelines.region_features",
                "pipelines.orientation", "parallel", "parallel.mesh",
                "parallel.pipeline", "utils.benchmark"):
        assert f"visitron_torch.{mod}" in names, mod


def test_entry_points_need_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from visitron_torch._device import resolve_device
    from visitron_torch.agents import NavRuntime, ViewpointAgent
    from visitron_torch.data import SceneFeatureTable
    from visitron_torch.models import BertConfig
    from visitron_torch.testing import SyntheticWorld

    world = SyntheticWorld(seed=1, num_scans=1, viewpoints_per_scan=6, scene_feat_dim=8)
    table = SceneFeatureTable.pack(world.graphs, world.scene_features())
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(device)
        with pytest.raises(RuntimeError):
            NavRuntime.build(world.graphs, table, device=device)
    rt = NavRuntime.build(world.graphs, table, device="cpu")
    cfg = BertConfig(vocab_size=10, hidden_size=128, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=64)
    with pytest.raises(RuntimeError):
        ViewpointAgent(cfg, rt, feature_dim=8)
    agent = ViewpointAgent(cfg, rt, feature_dim=8, device="cpu")
    assert agent.device.type == "cpu"
    from visitron_torch import run
    from visitron_torch.agents.classifier import ClassifierAgent
    from visitron_torch.agents.turn_based import TurnBasedAgent

    for cls in (TurnBasedAgent, ClassifierAgent):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(cfg, rt, feature_dim=8)
        assert cls(cfg, rt, feature_dim=8, device="cpu").device.type == "cpu"
    from visitron_torch.agents.speaker import SpeakerAgent

    speaker = dict(feature_dim=8, vocab_size=10, bos_id=1, eos_id=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeakerAgent(rt, **speaker)
    assert SpeakerAgent(rt, **speaker, device="cpu").device.type == "cpu"
    from visitron_torch.parallel import Mesh
    from visitron_torch.parallel.pipeline import PipelinePretrainTrainer
    from visitron_torch.utils.benchmark import time_fn

    for device, error in (("cuda", RuntimeError), ("cpu", None)):
        mesh = Mesh(dp=1, rank=0, device=torch.device(device), axis="pp", size=2)
        two = cfg.replace(num_hidden_layers=2)
        if error is None:
            assert PipelinePretrainTrainer(two, mesh).device.type == "cpu"
        else:
            with pytest.raises(error, match="device='cpu'"):
                PipelinePretrainTrainer(two, mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        time_fn(lambda: None)
    for task in ("turn_based", "classifier", "datagen", "speaker", "augment",
                 "extract_scene", "extract_regions"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run.main([task, "--debug", "--lstm_img_feature_dim", "8",
                      "--output_dir", os.path.join(tmp_path, task)])


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_decoding_refuses_unported_strategies():
    """Every strategy of the JAX package is ported; an unknown one, or
    teacher feedback without a target, is refused."""
    from visitron_torch.agents.decoding import FEEDBACK_OPTIONS, select_action

    logit = torch.tensor([[0.0, 2.0, 2.0, -1.0]])
    assert select_action("argmax", logit).tolist() == [1]  # first maximum
    target = torch.tensor([3])
    assert select_action("teacher", logit, target=target) is target
    g = torch.Generator().manual_seed(0)
    for feedback in set(FEEDBACK_OPTIONS) - {"teacher"}:
        assert 0 <= int(select_action(feedback, logit, g)) < 4, feedback
    with pytest.raises(ValueError):
        select_action("teacher", logit)
    with pytest.raises(ValueError):
        select_action("bogus", logit)
