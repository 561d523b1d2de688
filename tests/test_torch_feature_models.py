"""The offline feature pipelines' building blocks against the JAX package:
the port's copies of the numpy modules (ops/detection, the orientation
appender, the numpy parts of rendering, the TSV writer) equal the JAX
package's exactly; ``CubemapLUT.render_torch`` matches ``render_jax`` and
``render_np``; the ResNet on carried-over weights.  fp32 on the CPU unless
stated.  The detector is in tests/test_torch_detector.py."""

import base64

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import convert
from visitron_torch.data import features as tfeat
from visitron_torch.models import resnet as tres
from visitron_torch.ops import detection as tops
from visitron_torch.pipelines import orientation as torient
from visitron_torch.pipelines import rendering as trend
from visitron_tpu.data import features as jfeat
from visitron_tpu.models import resnet as jres
from visitron_tpu.ops import detection as jops
from visitron_tpu.pipelines import orientation as jorient
from visitron_tpu.pipelines import rendering as jrend


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the numpy copies ----------------------------------------------------------------

def _record(rng, n=16, classes=6, attrs=4, dim=8):
    boxes = rng.uniform(0, 300, (n, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 120, (n, 2)).astype(np.float32)
    return {"boxes": boxes,
            "cls_prob": rng.dirichlet(np.ones(classes), n).astype(np.float32),
            "attr_prob": rng.dirichlet(np.ones(attrs), n).astype(np.float32),
            "features": rng.standard_normal((n, dim)).astype(np.float32)}


def test_detection_ops_equal_the_jax_copies():
    rng = np.random.default_rng(0)
    rec = _record(rng, n=40)
    for thresh in (0.3, 0.7):
        _equal(tops.nms(rec["boxes"], rec["cls_prob"][:, 1], thresh),
               jops.nms(rec["boxes"], rec["cls_prob"][:, 1], thresh))
    for conf in (0.0, 0.4, 0.99):
        _equal(tops.select_boxes(rec["boxes"], rec["cls_prob"], conf_thresh=conf),
               jops.select_boxes(rec["boxes"], rec["cls_prob"], conf_thresh=conf))
    _equal(tops.box_orientation(rec["boxes"], 1.3, -0.4, 600, 600, 80),
           jops.box_orientation(rec["boxes"], 1.3, -0.4, 600, 600, 80))
    t, j = dict(rec), dict(rec)
    t["featureHeading"], t["featureElevation"] = tops.box_orientation(
        rec["boxes"], 0.5, 0.0, 600, 600, 80)
    j["featureHeading"], j["featureElevation"] = t["featureHeading"], t["featureElevation"]
    _equal(tops.dedup_boxes(t, 10), jops.dedup_boxes(j, 10))
    classes = ["__background__"] + [f"c{i}" for i in range(5)]
    attrs = ["__no_attribute__"] + [f"a{i}" for i in range(3)]
    assert (tops.region_tokens(rec["cls_prob"], rec["attr_prob"], classes, attrs)
            == jops.region_tokens(rec["cls_prob"], rec["attr_prob"], classes, attrs))
    _equal(tops.append_orientation(rec["features"], rec["boxes"], 600, 600),
           jops.append_orientation(rec["features"], rec["boxes"], 600, 600))


def test_orientation_and_tsv_writers_equal_the_jax_copies(tmp_path):
    rng = np.random.default_rng(1)
    items = []
    for i in range(3):
        rec = _record(rng, n=4 + i, dim=2048)
        items.append({"scanId": "s1", "viewpointId": f"v{i}", "image_w": 600,
                      "image_h": 600, "vfov": 80, "featureViewIndex": str(i),
                      "region_tokens": [f"t{k}" for k in range(4 + i)], **rec})
    for mod, name in ((torient, "t"), (jorient, "j")):
        mod.write_bottomup_tsv(str(tmp_path / f"{name}.tsv"), items)
        assert mod.convert_tsv_to_oriented_pickle(
            str(tmp_path / f"{name}.tsv"), str(tmp_path / f"{name}.pkl")) == 3
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    assert (tmp_path / "t.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()
    _equal(torient.read_bottomup_tsv(str(tmp_path / "t.tsv")),
           jorient.read_bottomup_tsv(str(tmp_path / "j.tsv")))
    feats = {f"scan{i}_vp{i}": rng.standard_normal((36, 2048)).astype(np.float32)
             for i in range(3)}
    tfeat.write_tsv_img_features(str(tmp_path / "t_scene.tsv"), feats, 64, 48, 60)
    jfeat.write_tsv_img_features(str(tmp_path / "j_scene.tsv"), feats, 64, 48, 60)
    assert (tmp_path / "t_scene.tsv").read_bytes() == (tmp_path / "j_scene.tsv").read_bytes()
    back = tfeat.read_tsv_img_features(str(tmp_path / "t_scene.tsv"))
    _equal(back["features"], feats)
    row = (tmp_path / "t_scene.tsv").read_text().splitlines()[0].split("\t")
    assert row[:5] == ["scan0", "vp0", "64", "48", "60"]
    assert base64.b64decode(row[5]) == feats["scan0_vp0"].tobytes()


def _rays(w=20, h=16):
    return np.stack([trend.view_ray_grid(hd * np.pi / 6, e * np.pi / 6, w, h, np.radians(60))
                     for hd in range(12) for e in (-1, 0, 1)])


def test_rendering_numpy_parts_equal_the_jax_copies(tmp_path):
    from PIL import Image

    rays = _rays()
    _equal(rays, np.stack([jrend.view_ray_grid(hd * np.pi / 6, e * np.pi / 6, 20, 16,
                                               np.radians(60))
                           for hd in range(12) for e in (-1, 0, 1)]))
    _equal(trend._face_uv(rays), jrend._face_uv(rays))
    color = lambda d: np.stack([0.5 + 0.4 * d[..., i] for i in range(3)], -1)  # noqa: E731
    _equal(trend.rasterize_cubemap(color, 24), jrend.rasterize_cubemap(color, 24))
    faces = np.random.default_rng(2).integers(0, 255, (6, 24, 24, 3), dtype=np.uint8)
    _equal(trend.sample_cubemap(faces, rays), jrend.sample_cubemap(faces, rays))
    tl, jl = trend.CubemapLUT(rays, 24), jrend.CubemapLUT(rays, 24)
    _equal((tl.idx00, tl.fx, tl.fy), (jl.idx00, jl.fx, jl.fy))
    _equal(tl.render_np(faces), jl.render_np(faces))
    assert trend.FACES == jrend.FACES and trend.SKYBOX_FACE_INDEX == jrend.SKYBOX_FACE_INDEX
    d = tmp_path / "sc" / "matterport_skybox_images"
    d.mkdir(parents=True)
    for i in range(6):
        Image.fromarray(faces[i]).save(str(d / f"vp_skybox{i}_sami.jpg"))
    tr = trend.SkyboxRenderer(str(tmp_path), image_w=32, image_h=24, vfov=60)
    jr = jrend.SkyboxRenderer(str(tmp_path), image_w=32, image_h=24, vfov=60)
    _equal(tr.load_faces("sc", "vp"), jr.load_faces("sc", "vp"))
    _equal(tr("sc", "vp"), jr("sc", "vp"))


def test_render_torch_matches_render_jax_and_render_np():
    rays = _rays()
    faces = np.random.default_rng(3).integers(0, 255, (6, 32, 32, 3), dtype=np.uint8)
    tl, jl = trend.CubemapLUT(rays, 32), jrend.CubemapLUT(rays, 32)
    got = tl.render_torch(torch.from_numpy(faces))
    assert got.dtype == torch.float32 and got.shape == (*rays.shape[:-1], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.render_jax(jnp.asarray(faces))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), tl.render_np(faces) / 255.0, atol=1e-6, rtol=0)
    two = np.stack([faces, faces[::-1]])
    got2 = tl.render_torch(torch.from_numpy(two))
    assert got2.shape == (2, *rays.shape[:-1], 3)
    np.testing.assert_allclose(got2.numpy(), np.asarray(jl.render_jax(jnp.asarray(two))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got2[0].numpy(), got.numpy())
    bf = tl.render_torch(torch.from_numpy(faces), dtype=torch.bfloat16)
    jbf = np.asarray(jl.render_jax(jnp.asarray(faces), dtype=jnp.bfloat16).astype(jnp.float32))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), jbf, atol=8e-3, rtol=0)


# -- the ResNet ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet50():
    x = np.random.default_rng(4).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    jm = jres.ResNet(50)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return x, jm, _np_tree(jp)


def test_resnet_matches_flax(resnet50):
    x, jm, jp = resnet50
    jpool, jstages = jm.apply(jp, jnp.asarray(x), return_stages=True)
    model = tres.ResNet(50)
    model.load_state_dict(convert.flax_to_state_dict(jp, model))
    with torch.inference_mode():
        pool, stages = model(torch.from_numpy(x), return_stages=True)
    assert pool.shape == (2, 2048) and pool.dtype == torch.float32
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jpool).max()))
    for got, want in zip(stages, jstages):
        want = np.asarray(want)
        got = got.permute(0, 2, 3, 1).numpy()  # NCHW -> the flax NHWC
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    bf = tres.ResNet(50, torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.inference_mode():
        pb = bf(torch.from_numpy(x))
    assert pb.dtype == torch.float32
    drift = float((pb - pool).norm() / pool.norm())
    assert drift < 0.05, drift  # bf16 tracks fp32


def test_resnet_loads_a_torchvision_state_dict(resnet50):
    """A torchvision-layout state dict (with ``fc.*`` and BatchNorm's
    ``num_batches_tracked``) loads with ``load_state_dict``, and the port's
    names are torchvision's."""
    _, _, jp = resnet50
    model = tres.ResNet(50)
    state = convert.flax_to_state_dict(jp, model)
    for name in [k for k in state if k.endswith("running_var")]:
        state[name.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    state["fc.weight"], state["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    assert {"layer1.0.downsample.0.weight", "layer4.2.bn3.running_mean",
            "conv1.weight"} <= set(state)
    fresh = tres.ResNet(50)
    tres.convert_torchvision_resnet(state, fresh)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, state[k], atol=0, rtol=0)
