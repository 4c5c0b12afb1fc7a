"""ResNet-50 visual trunk (torchvision v1.5 topology).

The counterpart of medvill_tpu/models/resnet.py.  The public functions keep
the JAX layout -- ``ResNet50Trunk`` takes NHWC images and returns the NHWC
[B, M, M, 2048] fiber map, ``fibers`` flattens it to [B, M*M, C] -- while the
convolutions run NCHW inside.  Parameters sit under the reference's
``nn.Sequential(list(resnet50.children())[:-2])`` indices (models/image.py:
46-52): ``model.0`` conv1, ``model.1`` bn1, ``model.4..7`` layer1..4.

- The TPU's space-to-depth stem (medvill_tpu resnet.py:25-64) is a layout
  trick with the same math; the port runs the plain 7x7/s2 conv on the same
  weights.
- BatchNorm (eps 1e-5) runs in f32 on the compute-dtype conv output, like
  flax ``BatchNorm(dtype=...)``.  In eval mode (``train=False``, serving) it
  uses the running statistics.  In train mode (``train=True``, pretraining
  with ``train_cnn``) it follows flax ``BatchNorm(use_running_average=False,
  momentum=0.9)`` (medvill_tpu/models/resnet.py:79-82,142-144), not torch's
  training-mode ``batch_norm``: it normalizes with the batch statistics,
  ``var = mean(x^2) - mean(x)^2`` clipped at 0 (flax ``_compute_stats``),
  and updates the running statistics in place with that *biased* variance,
  ``r = 0.9 r + 0.1 batch``.  This holds even when the trunk is frozen: a
  frozen trunk gets no gradient, but its statistics still move.
- Convolutions run in ``dtype`` (bf16 when serving); the caller decides
  whether cuDNN may use TF32 for f32 convolutions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from medvill_torch.data.images import IMAGENET_MEAN, IMAGENET_STD


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


BN_MOMENTUM = 0.9  # flax convention: running = 0.9 running + 0.1 batch


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype,
        train: bool = False) -> torch.Tensor:
    if not train:
        return F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                            bn.weight, bn.bias, False, 0.0, bn.eps).to(dtype)
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
    shape = (1, -1, 1, 1)
    y = ((xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + bn.eps)
         * bn.weight.view(shape) + bn.bias.view(shape))
    return y.to(dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, torchvision v1.5) -> 1x1, 4x expansion."""

    def __init__(self, in_ch: int, width: int, stride: int, downsample: bool):
        super().__init__()
        out_ch = width * 4
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
            nn.BatchNorm2d(out_ch)) if downsample else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        y = torch.relu(_bn(self.bn1, _conv(self.conv1, x, dtype), dtype,
                           train))
        y = torch.relu(_bn(self.bn2, _conv(self.conv2, y, dtype), dtype,
                           train))
        y = _bn(self.bn3, _conv(self.conv3, y, dtype), dtype, train)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = _bn(bn, _conv(conv, x, dtype), dtype, train)
        return torch.relu(y + residual.to(y.dtype))


def device_normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> to_float + ImageNet normalize in f32, on the device
    (medvill_tpu resnet.py:105-119); float inputs pass through."""
    if x.dtype != torch.uint8:
        return x
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x.float() / 255.0 - mean) / std


class ResNet50Trunk(nn.Module):
    """conv1..layer4 (no avgpool/fc): NHWC images -> [B, M, M, 2048]."""

    stage_sizes = (3, 4, 6, 3)

    def __init__(self, dtype: torch.dtype = torch.bfloat16, width: int = 64):
        super().__init__()
        self.dtype = dtype
        stages, in_ch = [], width
        for stage, n_blocks in enumerate(self.stage_sizes):
            w = width * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(in_ch, w, stride, block == 0))
                in_ch = w * 4
            stages.append(nn.Sequential(*blocks))
        self.out_channels = in_ch
        self.model = nn.Sequential(
            nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False),
            nn.BatchNorm2d(width), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1), *stages)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``train`` selects BatchNorm on batch statistics with running
        statistics updated (see the module docstring)."""
        dt = self.dtype
        x = device_normalize(x).permute(0, 3, 1, 2)
        conv1, bn1, _, _, *stages = self.model
        x = torch.relu(_bn(bn1, _conv(conv1, x, dt), dt, train))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in stages:
            for block in stage:
                x = block(x, dt, train)
        return x.permute(0, 2, 3, 1)


def fibers(feature_map: torch.Tensor) -> torch.Tensor:
    """[B, M, M, C] -> [B, M*M, C] row-major (torch ``flatten(2)
    .transpose(1, 2)`` on the NCHW map; reference models/image.py:57-58)."""
    B, H, W, C = feature_map.shape
    return feature_map.reshape(B, H * W, C)

