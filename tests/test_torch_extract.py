"""The offline feature extractors and their CLI tasks against the JAX
package, on the CPU: ``SceneFeatureExtractor.extract_all`` on carried-over
ResNet-50 weights in images and faces modes; ``RegionFeatureExtractor``
with the ``StubDetector`` (images mode: the records equal the JAX
package's, since both render with the same numpy code; faces mode: the
render on the device held to the JAX package's within 1e-6) and with the
port's Faster R-CNN (faces mode against images mode); then ``run
extract_scene`` and ``run extract_regions --debug`` on a two-viewpoint world
of skybox JPEGs (tests/test_rendering.py's)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import convert
from visitron_torch import run as trun
from visitron_torch.data.features import RegionFeatureStore, read_tsv_img_features
from visitron_torch.graph import load_nav_graphs
from visitron_torch.models.detector import BottomUpDetector
from visitron_torch.models.resnet import ResNet
from visitron_torch.pipelines import region_features as treg
from visitron_torch.pipelines import rendering as trend
from visitron_torch.pipelines import scene_features as tscene
from visitron_tpu.pipelines import region_features as jreg
from visitron_tpu.pipelines import rendering as jrend
from visitron_tpu.pipelines import scene_features as jscene


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One scan of two viewpoints: connectivity and 16 px skybox JPEGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("world")
    conn = root / "conn"
    conn.mkdir()
    entries = [
        {"image_id": "vpA", "pose": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
         "included": True, "unobstructed": [False, True], "height": 1.5},
        {"image_id": "vpB", "pose": [1, 0, 0, 2.0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
         "included": True, "unobstructed": [True, False], "height": 1.5},
    ]
    (conn / "sc1_connectivity.json").write_text(json.dumps(entries))
    rng = np.random.default_rng(0)
    sky = root / "mp" / "sc1" / "matterport_skybox_images"
    sky.mkdir(parents=True)
    for vp in ("vpA", "vpB"):
        for i in range(6):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                str(sky / f"{vp}_skybox{i}_sami.jpg"))
    return {"root": root, "conn": str(conn), "mp": str(root / "mp"),
            "graphs": load_nav_graphs(str(conn), ["sc1"])}


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.sqrt(np.mean(b ** 2)) + 1e-8))


def test_scene_extractor_matches_jax_in_both_modes(world):
    """Two viewpoints, 3 a forward (one flush, padded by a zero panorama),
    32 px views, fp32."""
    jex = jscene.SceneFeatureExtractor.random_init(
        depth=50, image_hw=(32, 32), image_w=32, image_h=32, vfov=60, dtype=jnp.float32,
        viewpoints_per_batch=3)
    state = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jex.params),
                                       ResNet(50))
    tex = tscene.SceneFeatureExtractor(state=state, depth=50, image_w=32, image_h=32,
                                       vfov=60, dtype=torch.float32, viewpoints_per_batch=3,
                                       device="cpu")
    trr = trend.SkyboxRenderer(world["mp"], image_w=32, image_h=32, vfov=60)
    jrr = jrend.SkyboxRenderer(world["mp"], image_w=32, image_h=32, vfov=60)
    graphs = world["graphs"]
    for mode, tprov, jprov in (("images", trr, jrr), ("faces", trr.load_faces, jrr.load_faces)):
        got = tex.extract_all(graphs, tprov, provider=mode)
        want = jex.extract_all(graphs, jprov, provider=mode)
        assert got.keys() == want.keys() == {"sc1_vpA", "sc1_vpB"}
        for k in got:
            assert got[k].shape == (36, 2048) and got[k].dtype == np.float32
            assert _rel(got[k], want[k]) < 1e-4, (mode, k)
    one = tex.extract_viewpoint(trr("sc1", "vpA"))
    assert _rel(one, got["sc1_vpA"]) < 1e-4
    with pytest.raises(ValueError, match="36 views"):
        tex.extract_viewpoint(np.zeros((35, 32, 32, 3), np.float32))


def _vocab(det):
    return (["__background__"] + [f"c{i}" for i in range(det.num_classes - 1)],
            ["__no_attribute__"] + [f"a{i}" for i in range(det.num_attributes - 1)])


def test_region_extractor_with_the_stub_matches_jax(world):
    """Images mode: both packages render with the same numpy code, so the
    stub's content-seeded records, and the whole store, are equal.  Faces
    mode: the stub's seed follows every ulp of the render, so the render on
    the device is held to the JAX package's within 1e-6, and the store to
    its layout."""
    classes, attrs = _vocab(treg.StubDetector())
    tr = treg.RegionFeatureExtractor(treg.StubDetector(), classes, attrs, image_w=60,
                                     image_h=60, vfov=80, device="cpu")
    jr = jreg.RegionFeatureExtractor(jreg.StubDetector(), classes, attrs, image_w=60,
                                     image_h=60, vfov=80)
    trr = trend.SkyboxRenderer(world["mp"], image_w=60, image_h=60, vfov=80)
    jrr = jrend.SkyboxRenderer(world["mp"], image_w=60, image_h=60, vfov=80)
    got = tr.extract_all(world["graphs"], trr)
    want = jr.extract_all(world["graphs"], jrr)
    assert got.keys == want.keys and len(got) == 72
    for k in got.keys:
        np.testing.assert_array_equal(got[k], want[k])
        assert got.get_region_tokens(k) == want.get_region_tokens(k)
    faces = trr.load_faces("sc1", "vpA")
    dev = tr.render(faces)
    assert dev.shape == (36, 60, 60, 3) and dev.dtype == torch.float32
    np.testing.assert_allclose(dev.numpy(), np.asarray(jr._render_fn(16)(jnp.asarray(faces))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(dev.numpy(), trr("sc1", "vpA"), atol=1e-6, rtol=0)
    by_faces = tr.extract_all(world["graphs"], trr.load_faces, provider="faces")
    assert by_faces.keys == got.keys
    for k in by_faces.keys:
        assert by_faces[k].shape[1] == 2054
        assert len(by_faces.get_region_tokens(k)) == by_faces[k].shape[0]


def test_region_extractor_with_the_detector_faces_equal_images(world):
    """The port's Faster R-CNN (random, depth 50, 64 px views of one
    viewpoint) in faces mode (rendered on the device, passed to
    detect_batch as tensors) against images mode (numpy render): the same
    boxes and tokens, features within 1e-4 of their scale."""
    det = BottomUpDetector.random_init(num_classes=12, num_attributes=7, num_rois=8,
                                       pre_nms_top_n=64, seed=3, device="cpu")
    classes, attrs = _vocab(det)
    ex = treg.RegionFeatureExtractor(det, classes, attrs, image_w=64, image_h=64, vfov=80)
    rr = trend.SkyboxRenderer(world["mp"], image_w=64, image_h=64, vfov=80)
    one = {"sc1": types.SimpleNamespace(viewpoints=["vpA"], num_viewpoints=1)}
    by_images = ex.extract_all(one, rr)
    by_faces = ex.extract_all(one, rr.load_faces, provider="faces")
    assert by_faces.keys == by_images.keys and len(by_faces) == 36
    for k in by_faces.keys:
        a, b = by_faces[k], by_images[k]
        assert a.shape == b.shape and a.shape[1] == 2054
        np.testing.assert_allclose(a, b, atol=1e-4 * float(np.abs(b).max()), rtol=1e-4)
        assert by_faces.get_region_tokens(k) == by_images.get_region_tokens(k)


def test_run_extract_scene_and_regions(world, tmp_path):
    out = tmp_path / "out"
    args = ["--debug", "--connectivity_dir", world["conn"], "--matterport_dir", world["mp"],
            "--output_dir", str(out), "--img_feature_file", str(out / "scene.tsv"),
            "--region_feature_prefix", str(out / "regions")]
    out.mkdir()
    trun.main(["extract_scene", *args], device="cpu")
    tsv = read_tsv_img_features(str(out / "scene.tsv"), 2048)
    assert {k: v.shape for k, v in tsv["features"].items()} == {
        "sc1_vpA": (36, 2048), "sc1_vpB": (36, 2048)}
    assert (tsv["image_w"], tsv["image_h"], tsv["vfov"]) == (64, 48, 60)
    assert all(np.isfinite(v).all() for v in tsv["features"].values())
    trun.main(["extract_regions", *args], device="cpu")
    store = RegionFeatureStore.from_pickle(str(out / "regions"))
    assert len(store) == 72 and (store.image_w, store.vfov) == (60, 80)
    for k in store.keys:
        assert store[k].shape[1] == 2048 + 6
        assert len(store.get_region_tokens(k)) == store[k].shape[0]
    assert treg.verify_region_store(str(out / "regions"))["feature_dim"] == 2054
    with pytest.raises(SystemExit, match="--detector_weights"):
        trun.main(["extract_regions", *args[1:]], device="cpu")


def test_extractors_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for make in (lambda: tscene.SceneFeatureExtractor.random_init(depth=50),
                 lambda: BottomUpDetector.random_init(),
                 lambda: treg.RegionFeatureExtractor(treg.StubDetector(), [], [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert tscene.SceneFeatureExtractor.random_init(
        depth=50, device="cpu").device.type == "cpu"
