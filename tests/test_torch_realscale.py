"""The deployment's world resident on the device (visitron_torch.testing.
realscale, tools/torch_realscale_smoke.py) against the JAX package on the CPU:

  * ``SceneFeatureTable.pack(dtype=torch.bfloat16)`` equals the JAX
    ``pack(dtype=ml_dtypes.bfloat16)`` bit for bit (uint16 views), with the
    same row index and scan offsets, ``row`` and ``get``; the numpy path and
    the fp32 tables of ``zeros`` and the TSV reader are unchanged;
  * ``NavRuntime.build`` from that table gives the JAX runtime's
    (``device_dtype=jnp.bfloat16``) feature bits and index tables, holding
    the bf16 table itself (no fp32 copy);
  * realscale.py at a small scale (2 scans x 12 viewpoints, 32-d, a tiny
    BERT): the instances and each shape's first batch equal those of the JAX
    tool's construction (tools/realscale_smoke.py:54-89, repeated here), key
    by key, and its run gives finite losses at both shapes.
"""

import ast
import os
import tempfile
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch.data.features import read_tsv_img_features, write_tsv_img_features
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.testing import realscale
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.data.datasets import build_nav_instances as j_build_nav_instances
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_scans=2, viewpoints_per_scan=12, scene_feat_dim=32)
TINY = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
            intermediate_size=128)
N_TRAIN = 16


def _bits(table) -> np.ndarray:
    if isinstance(table, torch.Tensor):
        return table.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(table).view(np.uint16)


@pytest.fixture(scope="module")
def tables():
    """The small world's features (fp32, the same on both sides) packed
    as bf16 by each package (the port's page-unlocked: no card here)."""
    jw, tw = JWorld(**realscale.WORLD | SMALL), TWorld(**realscale.WORLD | SMALL)
    jfeat, tfeat = jw.scene_features(), tw.scene_features()
    return {"jw": jw, "tw": tw, "tfeat": tfeat,
            "j": jd.SceneFeatureTable.pack(jw.graphs, jfeat, vfov=60,
                                           dtype=ml_dtypes.bfloat16),
            "t": td.SceneFeatureTable.pack(tw.graphs, tfeat, vfov=60, dtype=torch.bfloat16)}


def test_bf16_pack_matches_jax_bit_for_bit(tables):
    j, t = tables["j"], tables["t"]
    assert isinstance(t.table, torch.Tensor) and t.table.dtype == torch.bfloat16
    assert t.table.device.type == "cpu"
    assert t.table.is_pinned() == torch.cuda.is_available()
    assert tuple(t.table.shape) == j.table.shape == (24, 36, 32)
    assert t.table.nbytes == j.table.nbytes
    np.testing.assert_array_equal(_bits(t.table), _bits(j.table))
    assert t.row_index == j.row_index and t.scan_offsets == j.scan_offsets
    assert (t.image_w, t.image_h, t.vfov) == (j.image_w, j.image_h, j.vfov)
    for scan, g in tables["tw"].graphs.items():
        for vp in g.viewpoints[::5]:
            assert t.row(scan, vp) == j.row(scan, vp)
            np.testing.assert_array_equal(_bits(t.get(scan, vp)), _bits(j.get(scan, vp)))


def test_bf16_pack_rounds_to_nearest_even():
    """Ties, values past bf16's range and the smallest normals round as
    ml_dtypes rounds them (the JAX table's rule)."""
    vals = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.4e38, 1.1754944e-38,
                     2 ** -133, 65504.0, 0.1, -0.0], np.float32)
    world = TWorld(seed=0, num_scans=1, viewpoints_per_scan=2, scene_feat_dim=4)
    feats = {f"{s}_{vp}": np.resize(vals, (36, 4)).astype(np.float32)
             for s, g in world.graphs.items() for vp in g.viewpoints}
    got = td.SceneFeatureTable.pack(world.graphs, feats, dtype=torch.bfloat16)
    want = np.resize(vals, (36, 4)).astype(ml_dtypes.bfloat16)
    for r in range(got.table.shape[0]):
        np.testing.assert_array_equal(_bits(got.table[r]), want.view(np.uint16))


def test_numpy_pack_and_fp32_tables_unchanged(tables, tmp_path):
    """The numpy path (fp32, the default) equals the JAX package's; ``zeros``
    and the TSV reader still give fp32, and a TSV's read-only rows pack to
    bf16 with no warning."""
    tw, tfeat = tables["tw"], tables["tfeat"]
    t = td.SceneFeatureTable.pack(tw.graphs, tfeat, vfov=60)
    jw = JWorld(**realscale.WORLD | SMALL)  # a fresh world: its first features
    j = jd.SceneFeatureTable.pack(jw.graphs, jw.scene_features(), vfov=60)
    assert isinstance(t.table, np.ndarray) and t.table.dtype == np.float32
    z = td.SceneFeatureTable.zeros(tw.graphs, 8)
    assert isinstance(z.table, np.ndarray) and z.table.dtype == np.float32
    assert not z.table.any()
    path = str(tmp_path / "feats.tsv")
    write_tsv_img_features(path, tfeat)
    read = read_tsv_img_features(path, feature_size=32)["features"]
    assert all(v.dtype == np.float32 for v in read.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        packed = td.SceneFeatureTable.pack(tw.graphs, read, vfov=60, dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits(packed.table), _bits(tables["t"].table))
    assert t.row_index == j.row_index
    np.testing.assert_array_equal(t.table, np.asarray(j.table))


def test_runtime_places_the_bf16_table_as_jax(tables):
    jrt = ja.NavRuntime.build(tables["jw"].graphs, tables["j"], device_dtype=jnp.bfloat16)
    trt = ta.NavRuntime.build(tables["tw"].graphs, tables["t"],
                              device_dtype=torch.bfloat16, device="cpu")
    # No fp32 copy: the runtime holds the packed bf16 table itself.
    assert trt.feats.dtype == torch.bfloat16
    assert trt.feats.data_ptr() == tables["t"].table.data_ptr()
    assert trt.feat_table is tables["t"]
    np.testing.assert_array_equal(_bits(trt.feats), _bits(jrt.feats))
    for f in ("count_h", "nbr_h", "point_h", "nav_idx_h", "heading_h", "elev_h"):
        np.testing.assert_array_equal(getattr(jrt, f), getattr(trt, f), err_msg=f)
    for f in ("count", "nbr", "point"):
        assert getattr(trt, f).dtype == torch.int64, f
        np.testing.assert_array_equal(np.asarray(getattr(jrt, f)), getattr(trt, f).numpy())
    for f in ("heading", "elev"):
        assert getattr(trt, f).dtype == torch.float32, f
        np.testing.assert_array_equal(np.asarray(getattr(jrt, f)), getattr(trt, f).numpy())
    for f in ("pano_af", "view_af"):
        np.testing.assert_array_equal(_bits(getattr(trt, f)), _bits(getattr(jrt, f)))
    assert trt.row_to_id(23) == jrt.row_to_id(23)


@pytest.fixture(scope="module")
def small_world():
    return realscale.build_world(device="cpu", **SMALL)


def test_build_world_times_each_step(small_world):
    rw = small_world
    assert set(rw.seconds) == {"world", "pack", "candidate_tables", "placement"}
    assert all(s >= 0 for s in rw.seconds.values())
    assert rw.table.table.dtype == rw.runtime.feats.dtype == torch.bfloat16
    assert rw.runtime.device.type == "cpu"
    assert rw.table.table.nbytes == 24 * 36 * 32 * 2


def _jax_tool(shape):
    """tools/realscale_smoke.py:54-89 at the small scale: the world, its bf16
    table and runtime, the instances and one shape's first batch."""
    world = JWorld(**realscale.WORLD | SMALL)
    table = jd.SceneFeatureTable.pack(world.graphs, world.scene_features(), vfov=60,
                                      dtype=ml_dtypes.bfloat16)
    runtime = ja.NavRuntime.build(world.graphs, table, device_dtype=jnp.bfloat16)
    tok = jd.WordPieceTokenizer(jd.build_wordpiece_vocab(
        [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=realscale.VOCAB_SIZE))
    with tempfile.TemporaryDirectory() as d:
        root = world.write_task_data(d, counts={"train": N_TRAIN})
        instances = j_build_nav_instances(root, ["train"], tok, max_seq_length=realscale.SEQ)
    path_type, episode_len = shape
    batcher = JBatcher(instances, runtime, batch_size=realscale.BATCH, path_type=path_type)
    return table, instances, next(batcher.train_batches(1, episode_len=episode_len))


@pytest.mark.parametrize("shape", realscale.SHAPES, ids=lambda s: f"{s[0]}-T{s[1]}")
def test_instances_and_first_batch_match_the_jax_tool(shape):
    # A fresh world: the module's world has drawn its task data already.
    rw = realscale.build_world(device="cpu", **SMALL)
    inst, tok = realscale.instances(rw, n=N_TRAIN)
    jtable, jinst, jbatch = _jax_tool(shape)
    np.testing.assert_array_equal(_bits(rw.table.table), _bits(jtable.table))
    assert len(inst) == len(jinst) == N_TRAIN
    for a, b in zip(inst, jinst):
        assert (a.inst_idx, a.scan, a.length) == (b.inst_idx, b.scan, b.length)
        assert a.raw == b.raw
        np.testing.assert_array_equal(a.token_ids, b.token_ids)
        np.testing.assert_array_equal(a.segment_ids, b.segment_ids)
    tbatch = realscale.first_batch(rw, inst, *shape)
    assert set(tbatch) == set(jbatch)
    for k, v in jbatch.items():
        if isinstance(v, list):
            assert tbatch[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(tbatch[k]), np.asarray(v), err_msg=k)
    assert tbatch["ids"].shape[0] == realscale.BATCH


def test_run_gives_finite_losses_at_both_shapes():
    """The tool's run at the small scale on the CPU (a tiny BERT): two finite
    losses at each shape, the table's bytes, and its log lines."""
    lines = []
    out = realscale.run(device="cpu", log=lines.append, agent=dict(
        bert=TINY, rnn_dim=32, encoder_hidden_size=32, aemb=8), **SMALL)
    assert out["viewpoints"] == 24 and out["table_bytes"] == 24 * 36 * 32 * 2
    assert [r["shape"] for r in out["shapes"]] == [
        f"T={t} {p} batch={realscale.BATCH}" for p, t in realscale.SHAPES]
    for r in out["shapes"]:
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    assert lines[0].startswith("world built: 24 viewpoints") and lines[-1] == "realscale smoke ok"
    assert out["host_peak_rss_gib"] > 0


def _arguments(path):
    """Each ``add_argument`` call's options and keywords (help text aside)."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            out.append(([ast.literal_eval(a) for a in node.args],
                        {k.arg: ast.unparse(k.value) for k in node.keywords
                         if k.arg != "help"}))
    return out


@pytest.mark.parametrize("jax_tool,torch_tool", [
    ("tools/realscale_smoke.py", "tools/torch_realscale_smoke.py"),
    ("tools/synthetic_e2e.py", "tools/torch_synthetic_e2e.py")])
def test_tools_take_the_jax_tools_arguments(jax_tool, torch_tool):
    assert _arguments(torch_tool) == _arguments(jax_tool)
