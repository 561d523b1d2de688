"""Bottom-up-attention Faster R-CNN (ResNet-C4) for region features
(visitron_tpu/models/detector.py).

Replaces the reference's external Caffe detector
(scripts/precompute_bottom-up_features.py:33-41: Faster R-CNN ResNet-101
trained on Visual Genome, 1601 object classes, 401 attributes; detection at
:177-231), with the JAX package's static shapes, over a batch of images:

  * ResNet conv1..conv4 backbone (stride 16), shared with models/resnet.py;
  * RPN: 3x3/512 conv + 2A objectness + 4A deltas over A=12 anchors
    (scales 4, 8, 16, 32 x ratios 0.5, 1, 2: the VG config), always fp32;
  * proposal selection: the top ``pre_nms_top_n`` by objectness (ties in
    index order, as ``lax.top_k``), greedy NMS at 0.7 with a fixed number of
    picks, ``num_rois`` kept (padded by sentinel-score rows);
  * per-ROI head: bilinear ROI-align 14x14 on C4 (one sample a bin), the
    conv5 stage, a global pool -> 2048-d pool5 features;
  * heads: 1601-way softmax, the class-conditioned attribute branch (class
    embedding 256 ++ pool5 -> fc 512 -> 401-way softmax), and the per-class
    box regression (unused for extraction), as in the Caffe net.

As in the reference extraction (:212: ``cls_boxes = rois[:, 1:5]``), the
returned boxes are the RPN proposals, not regressed boxes.

The greedy NMS runs on the card for every image of a batch at once, one
pick a step, with no read-back: ``nms_fixed``'s loop issues a fixed number
of small launches and never synchronises.

Weights: ``convert_caffe_bottomup`` maps a {caffe_layer: array} dump of the
published VG .caffemodel onto this module's state dict;
``BottomUpDetector.random_init`` gives a runnable randomly initialised
detector for tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visitron_torch._device import resolve_device
from visitron_torch.models.resnet import (STAGE_BLOCKS, Conv, FrozenBatchNorm,
                                          conv_precision, make_stage, random_state,
                                          register_imagenet_stats, stem, to_nchw)

VG_CLASSES = 1601
VG_ATTRIBUTES = 401
ANCHOR_SCALES = (4, 8, 16, 32)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
FEAT_STRIDE = 16
RPN_PRE_NMS_TOP_N = 6000
RPN_NMS_THRESH = 0.7
RPN_MIN_SIZE = 16.0
NEG = float(np.finfo(np.float32).min)  # the score of a suppressed or padding row


def generate_anchors(base_size: int = 16, ratios=ANCHOR_RATIOS,
                     scales=ANCHOR_SCALES) -> np.ndarray:
    """Base anchor windows, exact py-faster-rcnn ``generate_anchors`` math
    (integer-rounded ratio enumeration)."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float64)

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, x, y):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([x - 0.5 * (ws - 1), y - 0.5 * (hs - 1),
                          x + 0.5 * (ws - 1), y + 0.5 * (hs - 1)])

    w, h, x, y = whctrs(base)
    size_ratios = (w * h) / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios))
    ratio_anchors = mkanchors(ws, hs, x, y)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, x, y = whctrs(ratio_anchors[i])
        ws = w * np.asarray(scales, np.float64)
        hs = h * np.asarray(scales, np.float64)
        out.append(mkanchors(ws, hs, x, y))
    return np.vstack(out).astype(np.float32)


def shifted_anchors(fh: int, fw: int, stride: int = FEAT_STRIDE,
                    ratios=ANCHOR_RATIOS, scales=ANCHOR_SCALES) -> np.ndarray:
    """All anchors of an (fh, fw) feature map: (fh*fw*A, 4), A-fastest order
    (matches the (H, W, A*4) conv output reshape)."""
    base = generate_anchors(ratios=ratios, scales=scales)  # (A, 4)
    sx = np.arange(fw, dtype=np.float32) * stride
    sy = np.arange(fh, dtype=np.float32) * stride
    shift = np.stack(np.broadcast_arrays(
        sx[None, :], sy[:, None], sx[None, :], sy[:, None]), axis=-1)  # (fh, fw, 4)
    anchors = shift[:, :, None, :] + base[None, None, :, :]
    return anchors.reshape(-1, 4)


# py-faster-rcnn BBOX_XFORM_CLIP: cap dw/dh so exp() cannot overflow.
BBOX_XFORM_CLIP = float(np.log(1000.0 / 16.0))


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """bbox_transform_inv: (..., N, 4) anchors + (..., N, 4) (dx, dy, dw, dh)
    -> boxes."""
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(torch.clamp(deltas[..., 2], max=BBOX_XFORM_CLIP)) * w
    ph = torch.exp(torch.clamp(deltas[..., 3], max=BBOX_XFORM_CLIP)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, width - 1),
                        boxes[..., 1].clamp(0, height - 1),
                        boxes[..., 2].clamp(0, width - 1),
                        boxes[..., 3].clamp(0, height - 1)], dim=-1)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int):
    """Greedy NMS with static shapes over (B, N, 4) boxes and (B, N) scores
    (or one image's (N, 4) / (N,)): returns (B, max_out) indices in
    descending score order and their scores.  When fewer boxes survive, the
    remaining picks take the first of the suppressed rows (``argmax`` returns
    the first maximum) with the sentinel score, so shapes stay fixed.

    Each of the ``max_out`` picks computes the picked box's IOU row on the
    fly (never the (N, N) matrix) and suppresses the rows above the
    threshold, for every image at once; nothing is read back to the host."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    live = scores.float().clone()
    picks, kept = [], []
    for _ in range(max_out):
        i = torch.argmax(live, dim=-1, keepdim=True)  # (B, 1)
        picks.append(i)
        kept.append(torch.gather(live, 1, i))
        bi = torch.gather(boxes, 1, i[..., None].expand(-1, -1, 4))  # (B, 1, 4)
        xx1 = torch.maximum(x1, bi[..., 0])
        yy1 = torch.maximum(y1, bi[..., 1])
        xx2 = torch.minimum(x2, bi[..., 2])
        yy2 = torch.minimum(y2, bi[..., 3])
        inter = (xx2 - xx1 + 1).clamp(min=0.0) * (yy2 - yy1 + 1).clamp(min=0.0)
        iou = inter / (area + torch.gather(area, 1, i) - inter)
        live = live.masked_fill(iou > iou_thresh, NEG).scatter(1, i, NEG)
    kept_idx, kept_scores = torch.cat(picks, dim=1), torch.cat(kept, dim=1)
    return (kept_idx[0], kept_scores[0]) if single else (kept_idx, kept_scores)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int,
              stride: float = FEAT_STRIDE) -> torch.Tensor:
    """Bilinear ROI align, one sample a bin (its centre): feat (B, H, W, C),
    boxes (B, N, 4) in image coordinates -> (B, N, out, out, C)."""
    b, h, w, c = feat.shape
    n = boxes.shape[1]
    x1, y1, x2, y2 = (boxes[..., i] / stride for i in range(4))
    bw = torch.clamp(x2 - x1, min=1e-3)
    bh = torch.clamp(y2 - y1, min=1e-3)
    grid = (torch.arange(out_size, dtype=torch.float32, device=feat.device) + 0.5) / out_size
    xs = torch.clamp(x1[..., None] + grid * bw[..., None], 0.0, w - 1.000001)  # (B, N, out)
    ys = torch.clamp(y1[..., None] + grid * bh[..., None], 0.0, h - 1.000001)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[:, :, None, :, None]  # (B, N, 1, out, 1)
    fy = (ys - y0)[:, :, :, None, None]  # (B, N, out, 1, 1)
    x0 = torch.clamp(x0.long(), max=w - 2)
    y0 = torch.clamp(y0.long(), max=h - 2)
    base = (torch.arange(b, device=feat.device) * (h * w))[:, None, None, None]
    flat = feat.reshape(b * h * w, c)

    def gather(yi, xi):
        idx = base + yi[:, :, :, None] * w + xi[:, :, None, :]  # (B, N, out, out)
        return flat.index_select(0, idx.reshape(-1)).reshape(b, n, out_size, out_size, c)

    out = gather(y0, x0) * (1 - fx) * (1 - fy)
    out += gather(y0, x0 + 1) * fx * (1 - fy)
    out += gather(y0 + 1, x0) * (1 - fx) * fy
    out += gather(y0 + 1, x0 + 1) * fx * fy
    return out


# Caffe bottom-up-attention preprocessing: BGR, 0-255 pixel means.
CAFFE_PIXEL_MEANS = np.array([102.9801, 115.9465, 122.7717], np.float32)


class ConvBody(nn.Module):
    """ResNet conv1..conv4 (the C4 feature map, stride 16) with
    models/resnet.py's layer names.

    ``caffe_preproc``: the published VG weights were trained on BGR images
    minus per-channel pixel means (no std); torch-style weights use [0,1]-RGB
    ImageNet normalisation.  ``caffe_v1``: caffe's stride placement and
    pool1 alignment.  ``dtype``: the convolutions' compute dtype; the
    feature map comes back in fp32, so the RPN and box numerics do not
    depend on it."""

    def __init__(self, depth: int = 101, caffe_preproc: bool = False,
                 caffe_v1: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.caffe_preproc, self.caffe_v1, self.dtype = caffe_preproc, caffe_v1, dtype
        register_imagenet_stats(self)
        self.register_buffer("caffe_means", torch.tensor(CAFFE_PIXEL_MEANS),
                             persistent=False)
        self.conv1 = Conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, width = 64, 64
        for si, n in enumerate(STAGE_BLOCKS[depth][:3]):
            setattr(self, f"layer{si + 1}",
                    make_stage(inplanes, width, n, 2 if si > 0 else 1, caffe_v1))
            inplanes, width = width * 4, width * 2

    def forward(self, images):
        """(B, H, W, 3) in [0, 1] -> (B, 1024, H/16, W/16) fp32 (NCHW,
        channels-last)."""
        x = images.float()
        if self.caffe_preproc:
            x = x.flip(-1) * 255.0 - self.caffe_means
        else:
            x = (x - self.imagenet_mean) / self.imagenet_std
        with conv_precision(self.dtype):
            x = stem(to_nchw(x, self.dtype), self.conv1, self.bn1, self.caffe_v1)
            x = self.layer3(self.layer2(self.layer1(x)))
        return x.float()


class Conv5Head(nn.Module):
    """The ResNet conv5 stage per ROI (14x14 -> 7x7 -> global pool 2048)."""

    def __init__(self, depth: int = 101, caffe_v1: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layer4 = make_stage(1024, 512, STAGE_BLOCKS[depth][3], 2, caffe_v1)

    def forward(self, rois):
        """(R, 1024, 14, 14) fp32 -> (R, 2048) fp32 pool5 features (the mean
        taken in fp32)."""
        with conv_precision(self.dtype):
            x = self.layer4(rois.to(self.dtype))
        return x.float().mean(dim=(2, 3))


class RPN(nn.Module):
    def __init__(self, num_anchors: int = len(ANCHOR_SCALES) * len(ANCHOR_RATIOS)):
        super().__init__()
        self.rpn_conv = Conv(1024, 512, 3, bias=True)
        self.rpn_cls = Conv(512, 2 * num_anchors, 1, bias=True)
        self.rpn_bbox = Conv(512, 4 * num_anchors, 1, bias=True)

    def forward(self, feat):
        with conv_precision(torch.float32):
            x = F.relu(self.rpn_conv(feat))
            return self.rpn_cls(x), self.rpn_bbox(x)


class FasterRCNN(nn.Module):
    """Detection over a batch of images, ``num_rois`` regions each.

    ``dtype``: the backbone's and conv5 head's compute dtype; the RPN,
    proposals, NMS, box decoding and the class / attribute heads are fp32."""

    def __init__(self, depth: int = 101, num_classes: int = VG_CLASSES,
                 num_attributes: int = VG_ATTRIBUTES, num_rois: int = 300,
                 pre_nms_top_n: int = RPN_PRE_NMS_TOP_N,
                 nms_thresh: float = RPN_NMS_THRESH, roi_size: int = 14,
                 cls_emb_dim: int = 256, attr_hidden: int = 512,
                 anchor_scales: tuple = ANCHOR_SCALES,
                 anchor_ratios: tuple = ANCHOR_RATIOS, caffe_preproc: bool = False,
                 caffe_v1: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.num_attributes = num_classes, num_attributes
        self.num_rois, self.pre_nms_top_n = num_rois, pre_nms_top_n
        self.nms_thresh, self.roi_size = nms_thresh, roi_size
        self.anchor_scales, self.anchor_ratios = anchor_scales, anchor_ratios
        self.num_anchors = len(anchor_scales) * len(anchor_ratios)
        self.body = ConvBody(depth, caffe_preproc, caffe_v1, dtype)
        self.rpn = RPN(self.num_anchors)
        self.head = Conv5Head(depth, caffe_v1, dtype)
        self.cls_score = nn.Linear(2048, num_classes)
        self.bbox_pred = nn.Linear(2048, num_classes * 4)
        self.cls_embedding = nn.Embedding(num_classes, cls_emb_dim)
        self.fc_attr = nn.Linear(2048 + cls_emb_dim, attr_hidden)
        self.attr_score = nn.Linear(attr_hidden, num_attributes)
        self._anchors: dict = {}

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        key = (fh, fw, torch.device(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(shifted_anchors(
                fh, fw, FEAT_STRIDE, self.anchor_ratios, self.anchor_scales)).to(device)
        return self._anchors[key]

    def proposals(self, feat: torch.Tensor, height: int, width: int):
        """RPN over the C4 map -> the top ``pre_nms_top_n`` (B, K, 4) boxes
        and (B, K) objectness scores (tiny proposals at the sentinel)."""
        b, _, fh, fw = feat.shape
        a = self.num_anchors
        logits, deltas = self.rpn(feat)
        # NHWC (fh, fw, 2A) read as (fh*fw*A, 2): the channel is a*2 + c.
        logits = logits.permute(0, 2, 3, 1).reshape(b, fh * fw * a, 2)
        obj = torch.softmax(logits, dim=-1)[..., 1]
        deltas = deltas.permute(0, 2, 3, 1).reshape(b, fh * fw * a, 4)
        boxes = clip_boxes(decode_boxes(self.anchors(fh, fw, feat.device), deltas),
                           height, width)
        ws = boxes[..., 2] - boxes[..., 0] + 1
        hs = boxes[..., 3] - boxes[..., 1] + 1
        obj = obj.masked_fill((ws < RPN_MIN_SIZE) | (hs < RPN_MIN_SIZE), NEG)
        k = min(self.pre_nms_top_n, obj.shape[1])
        top_scores, top_idx = torch.sort(obj, dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        return torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)), top_scores

    def forward(self, images):
        """images (B, H, W, 3) float in [0, 1] -> dict of (B, num_rois, ...)
        boxes, scores, cls_prob, attr_prob, features, bbox_deltas."""
        b, h, w = images.shape[:3]
        feat = self.body(images)
        top_boxes, top_scores = self.proposals(feat, h, w)
        keep, scores = nms_fixed(top_boxes, top_scores, self.nms_thresh, self.num_rois)
        boxes = torch.gather(top_boxes, 1, keep[..., None].expand(-1, -1, 4))
        rois = roi_align(feat.permute(0, 2, 3, 1), boxes, self.roi_size)
        rois = rois.reshape(b * self.num_rois, self.roi_size, self.roi_size, -1)
        pooled = self.head(rois.permute(0, 3, 1, 2))  # (B*R, 2048)
        cls_prob = torch.softmax(self.cls_score(pooled), dim=-1)
        bbox_deltas = self.bbox_pred(pooled)
        emb = self.cls_embedding(torch.argmax(cls_prob, dim=-1))
        attr_h = F.relu(self.fc_attr(torch.cat([pooled, emb], dim=-1)))
        attr_prob = torch.softmax(self.attr_score(attr_h), dim=-1)
        per = lambda t: t.reshape(b, self.num_rois, -1)  # noqa: E731
        return {"boxes": boxes, "scores": scores, "cls_prob": per(cls_prob),
                "attr_prob": per(attr_prob), "features": per(pooled),
                "bbox_deltas": per(bbox_deltas)}


class BottomUpDetector:
    """RegionDetector-protocol wrapper: a FasterRCNN on the card with numpy
    I/O; plugs into pipelines.region_features.RegionFeatureExtractor in place
    of its StubDetector."""

    feature_dim = 2048

    def __init__(self, model: FasterRCNN, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_classes = model.num_classes
        self.num_attributes = model.num_attributes

    @classmethod
    def random_init(cls, num_classes: int = 32, num_attributes: int = 8,
                    depth: int = 50, num_rois: int = 16, pre_nms_top_n: int = 256,
                    seed: int = 0, device=None):
        """A randomly initialised detector from ``seed`` (models/resnet.py:
        random_state)."""
        model = FasterRCNN(depth=depth, num_classes=num_classes,
                           num_attributes=num_attributes, num_rois=num_rois,
                           pre_nms_top_n=pre_nms_top_n)
        model.load_state_dict(random_state(model, seed))
        return cls(model, device)

    @classmethod
    def from_caffe_dump(cls, state: dict, depth: int = 101, device=None, **kw):
        """The detector of a {caffe blob: array} weight dump, with caffe's
        preprocessing and stride placement unless ``kw`` says otherwise."""
        kw.setdefault("caffe_preproc", True)
        kw.setdefault("caffe_v1", True)
        model = FasterRCNN(depth=depth, **kw)
        model.load_state_dict(convert_caffe_bottomup(state, depth))
        return cls(model, device)

    @staticmethod
    def _strip_padding(out: dict) -> dict:
        # Fixed-shape padding rows carry sentinel scores; drop them on the
        # host so the post-processing sees only real proposals.
        live = out["scores"] > np.finfo(np.float32).min / 2
        return {"boxes": out["boxes"][live], "cls_prob": out["cls_prob"][live],
                "attr_prob": out["attr_prob"][live],
                "features": out["features"][live]}

    def __call__(self, image) -> dict:
        return self.detect_batch(image[None])[0]

    def detect_batch(self, images) -> list[dict]:
        """(N, H, W, 3) images (numpy, or a tensor already on the card) -> N
        per-image result dicts from one forward and one read-back."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            out = self.model(x)
        # The box regression is not read back: extraction keeps the proposals.
        out = {k: out[k].cpu().numpy()
               for k in ("boxes", "scores", "cls_prob", "attr_prob", "features")}
        return [self._strip_padding({k: v[i] for k, v in out.items()})
                for i in range(x.shape[0])]


def _caffe_stage_names(depth: int):
    """Caffe res-layer name per (stage, block): res2a/res2b/..., res4b22 etc."""
    names = {}
    letters = "abcdefghijklmnopqrstuvwxyz"
    for si, n in enumerate(STAGE_BLOCKS[depth]):
        stage = si + 2
        for bi in range(n):
            if n <= 3 or bi == 0:
                name = f"res{stage}{letters[bi]}"
            else:
                name = f"res{stage}b{bi}"
            names[(si, bi)] = name
    return names


def convert_caffe_bottomup(state: dict, depth: int = 101) -> dict:
    """{caffe_blob: array} -> the state dict of ``FasterRCNN(depth)``.

    Expects the standard dump layout: for every conv layer L, ``L.weight``
    (OIHW, as torch keeps it); BatchNorm folded as ``bn<L>.{mean,var}`` +
    ``scale<L>.{weight,bias}``; fully-connected ``{cls_score,bbox_pred,
    fc_attr,attr_score}.{weight,bias}`` (torch-style (out, in));
    ``cls_embedding.weight``; RPN convs ``rpn_conv/3x3`` / ``rpn_cls_score`` /
    ``rpn_bbox_pred`` with biases."""
    g = lambda k: torch.as_tensor(np.asarray(state[k], np.float32))  # noqa: E731
    out: dict = {}

    def bn(prefix, cname):
        out[prefix + "weight"] = g(f"scale{cname}.weight")
        out[prefix + "bias"] = g(f"scale{cname}.bias")
        out[prefix + "running_mean"] = g(f"bn{cname}.mean")
        out[prefix + "running_var"] = g(f"bn{cname}.var")

    names = _caffe_stage_names(depth)

    def block(prefix, si, bi):
        cn = names[(si, bi)].removeprefix("res")
        for i, branch in enumerate("abc"):
            out[f"{prefix}conv{i + 1}.weight"] = g(f"res{cn}_branch2{branch}.weight")
            bn(f"{prefix}bn{i + 1}.", f"{cn}_branch2{branch}")
        if bi == 0:
            out[f"{prefix}downsample.0.weight"] = g(f"res{cn}_branch1.weight")
            bn(f"{prefix}downsample.1.", f"{cn}_branch1")

    out["body.conv1.weight"] = g("conv1.weight")
    bn("body.bn1.", "_conv1")
    for si, n in enumerate(STAGE_BLOCKS[depth]):
        for bi in range(n):
            block(f"head.layer4.{bi}." if si == 3 else f"body.layer{si + 1}.{bi}.", si, bi)
    for ours, theirs in (("rpn_conv", "rpn_conv/3x3"), ("rpn_cls", "rpn_cls_score"),
                         ("rpn_bbox", "rpn_bbox_pred")):
        out[f"rpn.{ours}.weight"] = g(theirs + ".weight")
        out[f"rpn.{ours}.bias"] = g(theirs + ".bias")
    for name in ("cls_score", "bbox_pred", "fc_attr", "attr_score"):
        out[name + ".weight"] = g(name + ".weight")
        out[name + ".bias"] = g(name + ".bias")
    out["cls_embedding.weight"] = g("cls_embedding.weight")
    return out
