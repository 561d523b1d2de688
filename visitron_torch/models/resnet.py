"""Eval-mode ResNet backbones (50/101/152) for feature extraction
(visitron_tpu/models/resnet.py).

Replaces torchvision's ResNet-152 in the scene-feature pipeline
(scripts/precompute_resnet_img_features.py:117-131) and serves as the
detection backbone.  Inference only: BatchNorm uses its stored statistics,
folded at call time, as the reference uses the model (``model.eval()``).

The modules carry torchvision's names (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``, ...) and BatchNorm buffers (``weight``, ``bias``,
``running_mean``, ``running_var``), so a torchvision state dict loads with
``load_state_dict`` (torchvision itself is not needed).

Convolutions run NCHW in the ``channels_last`` memory format (cuDNN's fast
layout on the card); inputs arrive as (B, H, W, 3) images, whose NCHW view
is already channels-last.  ``dtype`` is the compute dtype: parameters stay
fp32 and are cast per call (flax ``Conv(dtype=...)``).  In fp32 the
convolutions run without TF32 (``conv_precision``), so they match
torchvision and caffe, as the JAX package's fp32 mode does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@contextlib.contextmanager
def conv_precision(dtype: torch.dtype):
    """fp32: cuDNN convolutions without TF32 inside this scope (the previous
    flags come back after it); other dtypes: no change."""
    if dtype != torch.float32:
        yield
        return
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics (inference only).

    The folded scale and shift are derived in fp32 from the fp32 statistics,
    then cast to the activations' dtype, so bf16 loses only the final
    multiply-add's precision.  torchvision's ``num_batches_tracked`` is
    accepted and dropped when a state dict loads."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        inv = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Conv(nn.Conv2d):
    """A bias-free (by default) square convolution with symmetric k // 2
    padding, computed in the input's dtype from fp32 weights."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block.

    ``caffe_v1``: the original (Kaiming/caffe, and hence bottom-up-attention
    VG) ResNet puts the stride on the first 1x1 conv; torchvision's "v1.5"
    puts it on the 3x3.  The published caffe weights only reproduce under v1
    stride placement."""

    def __init__(self, inplanes: int, width: int, stride: int = 1,
                 downsample: bool = False, caffe_v1: bool = False):
        super().__init__()
        s1, s2 = (stride, 1) if caffe_v1 else (1, stride)
        self.conv1 = Conv(inplanes, width, 1, s1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv(width, width, 3, s2)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv(width, width * 4, 1)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.downsample = (nn.Sequential(Conv(inplanes, width * 4, 1, stride),
                                         FrozenBatchNorm(width * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


def make_stage(inplanes: int, width: int, blocks: int, first_stride: int,
               caffe_v1: bool = False) -> nn.Sequential:
    """One ResNet stage (torchvision's ``layerN``): a downsampling block,
    then ``blocks - 1`` identity blocks."""
    return nn.Sequential(*(Bottleneck(inplanes if bi == 0 else width * 4, width,
                                      first_stride if bi == 0 else 1, bi == 0, caffe_v1)
                           for bi in range(blocks)))


def stem(x, conv1, bn1, caffe_pool: bool = False):
    """conv1 (7x7/2) -> BN -> relu -> pool1 (3x3/2).  torchvision pads the
    pool by 1 on each side; caffe's ceil-mode pool1 has its windows anchored
    at pixel 0 with one implicit pad row and column at the bottom and right
    (same output size, other alignment)."""
    x = F.relu(bn1(conv1(x)))
    if caffe_pool:
        return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
    return F.max_pool2d(x, 3, 2, padding=1)


def register_imagenet_stats(module: nn.Module) -> None:
    """ImageNet's mean and std as buffers of ``module`` (``imagenet_mean`` /
    ``imagenet_std``), left out of its state dict."""
    module.register_buffer("imagenet_mean", torch.tensor(IMAGENET_MEAN), persistent=False)
    module.register_buffer("imagenet_std", torch.tensor(IMAGENET_STD), persistent=False)


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) fp32 -> NCHW in ``dtype``, channels-last in memory."""
    return x.to(dtype).permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """torchvision-layout ResNet-50/101/152 without its classifier.

    ``forward(images)``: (B, H, W, 3) float in [0, 1], ImageNet-normalised
    inside; returns pooled (B, 2048) fp32 features (the mean over the last
    stage taken in fp32), and with ``return_stages`` also the stage outputs
    c2..c5 (NCHW, channels-last, in ``dtype``)."""

    def __init__(self, depth: int = 152, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        register_imagenet_stats(self)
        self.conv1 = Conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, width = 64, 64
        for si, n in enumerate(STAGE_BLOCKS[depth]):
            setattr(self, f"layer{si + 1}",
                    make_stage(inplanes, width, n, 2 if si > 0 else 1))
            inplanes, width = width * 4, width * 2

    def forward(self, images, return_stages: bool = False):
        with conv_precision(self.dtype):
            x = (images.float() - self.imagenet_mean) / self.imagenet_std
            x = stem(to_nchw(x, self.dtype), self.conv1, self.bn1)
            stages = []
            for si in range(4):
                x = getattr(self, f"layer{si + 1}")(x)
                stages.append(x)
        pooled = stages[-1].float().mean(dim=(2, 3))
        return (pooled, stages) if return_stages else pooled


def random_state(model: nn.Module, seed: int) -> dict:
    """A random state dict for ``model`` drawn from ``seed`` with flax's
    initial distributions (not its streams): lecun-normal kernels (and
    embeddings over their width), zero biases, identity BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in model.state_dict().items():
        if t.dim() >= 2:
            fan_in = t.shape[1] if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                                              nn.Embedding) else t[0].numel()
            state[name] = torch.randn(t.shape, generator=g) / fan_in ** 0.5
        elif name.endswith("bias"):
            state[name] = torch.zeros_like(t)
        else:  # BatchNorm's scale and statistics: the identity
            state[name] = t.clone()
    return state


def convert_torchvision_resnet(state: dict, model: ResNet) -> None:
    """Load a torchvision ResNet state dict (tensors or numpy arrays) into
    ``model``; its classifier (``fc.*``) has no counterpart and is left out."""
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()
                           if not k.startswith("fc.")})
