"""The port's bottom-up Faster R-CNN (visitron_torch/models/detector.py)
against the JAX package's, at tests/test_detector_torch_parity.py's sizes
(depth 50, 12 classes, 7 attributes, 6 ROIs, pre-NMS 64, 64 px; also 128
px, where every ROI is live), from one random caffe-layout dump loaded by
both packages' ``from_caffe_dump``; ``nms_fixed`` (with an input where every
box is suppressed), ``roi_align`` (exact on a linear field) and
``detect_batch`` against per-image calls.  fp32 on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import convert
from visitron_torch.models import detector as tdet
from visitron_torch.models import resnet as tres
from visitron_tpu.models import detector as jdet

DEPTH, C_CLS, C_ATTR, NUM_ROIS, PRE_NMS, IMG = 50, 12, 7, 6, 64, 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _make_caffe_dump(rng: np.random.Generator) -> dict:
    """Random weights in the caffe dump layout (tests/test_detector_torch_parity.py's)."""
    s: dict = {}

    def conv(name, cout, cin, k):
        s[name + ".weight"] = rng.normal(
            0, 1.0 / np.sqrt(cin * k * k), (cout, cin, k, k)).astype(np.float32)

    def bn(cname, c):
        s[f"bn{cname}.mean"] = rng.normal(0, 0.05, c).astype(np.float32)
        s[f"bn{cname}.var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        s[f"scale{cname}.weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        s[f"scale{cname}.bias"] = rng.normal(0, 0.05, c).astype(np.float32)

    def dense(name, cout, cin):
        s[name + ".weight"] = rng.normal(0, 1.0 / np.sqrt(cin), (cout, cin)).astype(np.float32)
        s[name + ".bias"] = rng.normal(0, 0.02, cout).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("_conv1", 64)
    names = tdet._caffe_stage_names(DEPTH)
    inplanes = 64
    for si, n in enumerate(tres.STAGE_BLOCKS[DEPTH]):
        width = 64 * 2 ** si
        for bi in range(n):
            cn = names[(si, bi)].removeprefix("res")
            conv(f"res{cn}_branch2a", width, inplanes if bi == 0 else width * 4, 1)
            bn(f"{cn}_branch2a", width)
            conv(f"res{cn}_branch2b", width, width, 3)
            bn(f"{cn}_branch2b", width)
            conv(f"res{cn}_branch2c", width * 4, width, 1)
            bn(f"{cn}_branch2c", width * 4)
            if bi == 0:
                conv(f"res{cn}_branch1", width * 4, inplanes, 1)
                bn(f"{cn}_branch1", width * 4)
        inplanes = width * 4
    conv("rpn_conv/3x3", 512, 1024, 3)
    s["rpn_conv/3x3.bias"] = rng.normal(0, 0.02, 512).astype(np.float32)
    conv("rpn_cls_score", 24, 512, 1)
    s["rpn_cls_score.bias"] = rng.normal(0, 0.02, 24).astype(np.float32)
    conv("rpn_bbox_pred", 48, 512, 1)
    s["rpn_bbox_pred.bias"] = rng.normal(0, 0.1, 48).astype(np.float32)
    dense("cls_score", C_CLS, 2048)
    dense("bbox_pred", 4 * C_CLS, 2048)
    s["cls_embedding.weight"] = rng.normal(0, 0.1, (C_CLS, 256)).astype(np.float32)
    dense("fc_attr", 512, 2048 + 256)
    dense("attr_score", C_ATTR, 512)
    return s


@pytest.fixture(scope="module")
def detectors():
    dump = _make_caffe_dump(np.random.default_rng(11))
    kw = dict(depth=DEPTH, num_classes=C_CLS, num_attributes=C_ATTR, num_rois=NUM_ROIS,
              pre_nms_top_n=PRE_NMS)
    # 64 and 128 px views: at 64 px most proposals fall under the 16 px
    # minimum, at 128 px all 6 ROIs are live.
    rng = np.random.default_rng(7)
    images = {side: rng.uniform(0, 1, (3, side, side, 3)).astype(np.float32)
              for side in (IMG, 2 * IMG)}
    return (jdet.BottomUpDetector.from_caffe_dump(dump, **kw),
            tdet.BottomUpDetector.from_caffe_dump(dump, device="cpu", **kw), images)


def test_caffe_dump_converts_like_the_jax_package(detectors):
    """The port's convert_caffe_bottomup of the dump equals the JAX
    package's flax tree carried across by visitron_torch.convert."""
    jd, td, _ = detectors
    via_flax = convert.flax_to_state_dict(_np_tree(jd.params), td.model)
    assert set(via_flax) == set(td.model.state_dict())
    for k, v in td.model.state_dict().items():
        torch.testing.assert_close(v, via_flax[k], atol=0, rtol=0)


@pytest.mark.parametrize("side", [IMG, 2 * IMG])
def test_detector_matches_flax(detectors, side):
    jd, td, images = detectors
    imgs = images[side]
    want = _np_tree(jax.vmap(jd.model.apply, in_axes=(None, 0))(jd.params, jnp.asarray(imgs)))
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in td.model(torch.from_numpy(imgs)).items()}
    live = want["scores"] > np.finfo(np.float32).min / 2
    assert live.any(axis=1).all()
    np.testing.assert_array_equal(got["scores"] > np.finfo(np.float32).min / 2, live)
    # The kept proposals: the same boxes, in the same order.
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["scores"][live], want["scores"][live], atol=1e-6, rtol=1e-5)
    for k in ("cls_prob", "attr_prob"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    for k in ("features", "bbox_deltas"):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale, rtol=1e-4)
    # detect_batch against the JAX package's, after _strip_padding.
    for t, j in zip(td.detect_batch(imgs), jd.detect_batch(imgs)):
        assert t.keys() == j.keys()
        np.testing.assert_allclose(t["boxes"], j["boxes"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(t["cls_prob"], j["cls_prob"], atol=1e-5, rtol=0)


def test_detect_batch_equals_per_image_calls(detectors):
    _, td, images = detectors
    imgs = images[2 * IMG]
    batch = td.detect_batch(imgs)
    for i, img in enumerate(imgs):
        one = td(img)
        assert one.keys() == batch[i].keys()
        np.testing.assert_array_equal(one["boxes"], batch[i]["boxes"])
        for k in ("cls_prob", "attr_prob", "features"):
            np.testing.assert_allclose(one[k], batch[i][k], atol=1e-4, rtol=1e-4)


def test_nms_fixed_matches_flax():
    rng = np.random.default_rng(8)
    n = 200
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (n, 2)).astype(np.float32)], 1)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::7] = np.finfo(np.float32).min  # filtered (sentinel) rows
    for thresh, max_out in ((0.7, 50), (0.3, 120)):
        ji, js = jdet.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out)
        ti, ts = tdet.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                                max_out)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # Batched: each row as alone.
    bb = np.stack([boxes, boxes[::-1].copy()])
    ss = np.stack([scores, scores[::-1].copy()])
    ti, ts = tdet.nms_fixed(torch.from_numpy(bb), torch.from_numpy(ss), 0.5, 60)
    for r in range(2):
        ji, js = jdet.nms_fixed(jnp.asarray(bb[r]), jnp.asarray(ss[r]), 0.5, 60)
        np.testing.assert_array_equal(ti[r].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts[r].numpy(), np.asarray(js))
    # Every box suppressed by the first: the other picks repeat index 0 with
    # the sentinel score, as in the JAX package.
    same = np.tile(np.array([[10, 10, 50, 50]], np.float32), (8, 1))
    sc = np.linspace(0.9, 0.2, 8).astype(np.float32)
    ji, js = jdet.nms_fixed(jnp.asarray(same), jnp.asarray(sc), 0.7, 5)
    ti, ts = tdet.nms_fixed(torch.from_numpy(same), torch.from_numpy(sc), 0.7, 5)
    assert ti.tolist() == np.asarray(ji).tolist() == [0, 0, 0, 0, 0]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0] == sc[0] and (ts[1:] == np.finfo(np.float32).min).all()


def test_roi_align_is_exact_on_a_linear_field():
    """On f(y, x, c) = a*x + b*y + c the bilinear sample at a bin centre is
    the field's value there (inside the clip), and it matches the JAX
    package's roi_align."""
    h, w, c = 12, 16, 3
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    feat = np.stack([0.5 * xs + 2.0 * ys + k for k in range(c)], -1).astype(np.float32)
    boxes = np.array([[16, 16, 100, 80], [0, 0, 200, 150], [40.5, 33.2, 41.0, 33.9]],
                     np.float32)
    out = tdet.roi_align(torch.from_numpy(feat)[None], torch.from_numpy(boxes)[None], 7)[0]
    want = np.asarray(jdet.roi_align(jnp.asarray(feat), jnp.asarray(boxes), 7))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    grid = (np.arange(7) + 0.5) / 7
    for r, (x1, y1, x2, y2) in enumerate(boxes / 16):
        bx = np.clip(x1 + grid * max(x2 - x1, 1e-3), 0, w - 1.000001)
        by = np.clip(y1 + grid * max(y2 - y1, 1e-3), 0, h - 1.000001)
        exact = np.stack([0.5 * bx[None, :] + 2.0 * by[:, None] + k for k in range(c)], -1)
        np.testing.assert_allclose(out[r].numpy(), exact, atol=1e-4, rtol=0)


def test_anchors_equal_the_jax_copies():
    _equal(tdet.generate_anchors(), jdet.generate_anchors())
    _equal(tdet.shifted_anchors(5, 7), jdet.shifted_anchors(5, 7))
    assert tdet._caffe_stage_names(101) == jdet._caffe_stage_names(101)
    assert math.isclose(tdet.BBOX_XFORM_CLIP, jdet.BBOX_XFORM_CLIP)
