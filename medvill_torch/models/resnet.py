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
- BatchNorm (eps 1e-5) runs in f32 on the compute-dtype conv output (f64
  on an f64 one), like flax ``BatchNorm(dtype=...)``, and returns the
  compute dtype.  In eval mode (``train=False``, serving) it uses the
  running statistics.  In train mode (``train=True``, pretraining with
  ``train_cnn``) it follows flax ``BatchNorm(use_running_average=False,
  momentum=0.9)`` (medvill_tpu/models/resnet.py:79-82,142-144): it
  normalizes with the batch statistics and the biased variance, and
  updates the running statistics in place with that *biased* variance,
  ``r = 0.9 r + 0.1 batch`` (torch's own update would take the unbiased
  one).  This holds even when the trunk is frozen: a frozen trunk gets no
  gradient, but its statistics still move.  The train-mode op is one
  ``torch.native_batch_norm`` per BatchNorm with no running buffers given:
  autograd saves the compute-dtype conv output and the per-channel f32
  mean and inverse std, nothing else, so a trained trunk keeps the bf16
  conv, ReLU and block outputs (and the max-pool indices) and no f32
  copy of any activation.  Under data parallelism the batch statistics
  are the global batch's (``parallel.sync_batch_norm``, which keeps the
  same).
- Convolutions run in ``dtype`` (bf16 when serving); the caller decides
  whether cuDNN may use TF32 for f32 convolutions.
- ``fibers`` flattens the map; ``pooled_fibers`` and ``half_pooled_fibers``
  are the classification model's pool encoders (torch adaptive pooling,
  medvill_tpu/models/resnet.py:173-227).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from medvill_torch import parallel
from medvill_torch.data.images import IMAGENET_MEAN, IMAGENET_STD


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding)


BN_MOMENTUM = 0.9  # flax convention: running = 0.9 running + 0.1 batch


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype,
        train: bool = False) -> torch.Tensor:
    if not train:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps).to(dtype)
    # one pass over x: the batch statistics (f32, f64 on f64 input) and the
    # output in x's dtype; autograd keeps only x, mean and invstd.  No
    # running buffers go in: torch would move them with the unbiased
    # variance, flax moves them with the biased one, recovered here from
    # invstd = (var + eps)^-1/2.
    w, b = bn.weight, bn.bias
    if x.dtype == torch.float64:
        w, b = w.double(), b.double()
    if parallel.data_parallel():
        # the statistics of the global batch (medvill_tpu/models/resnet.py:
        # 79-82 under GSPMD), summed over the data group
        y, mean, invstd = parallel.sync_batch_norm(x, w, b, bn.eps)
    else:
        y, mean, invstd = torch.native_batch_norm(x, w, b, None, None, True,
                                                  0.0, bn.eps)
    with torch.no_grad():
        var = invstd.pow(-2).sub_(bn.eps).clamp_(min=0.0)
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
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
    mean, std = _imagenet_stats(x.device)
    return (x.float() / 255.0 - mean) / std


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """The normalization constants on ``device``, copied there once (no
    host-to-device copy inside a captured step)."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


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



# torch AdaptiveAvgPool2d target shapes per num_image_embeds
# (reference: mmbt/models/image.py:30-39)
POOL_SHAPES = {1: (1, 1), 2: (2, 1), 3: (3, 1), 5: (5, 1), 7: (7, 1),
               4: (2, 2), 6: (3, 2), 8: (4, 2), 9: (3, 3)}


def adaptive_pool(fmap: torch.Tensor, out_hw, mode: str = "avg"
                  ) -> torch.Tensor:
    """torch's adaptive pooling on an NHWC map: output cell i of an H -> oh
    reduction spans rows [floor(i * H / oh), ceil((i + 1) * H / oh)).
    [B, H, W, C] -> [B, oh, ow, C]."""
    if mode not in ("avg", "max"):
        raise ValueError(f"pool type {mode!r}: avg or max")
    pool = F.adaptive_avg_pool2d if mode == "avg" else F.adaptive_max_pool2d
    return pool(fmap.permute(0, 3, 1, 2), tuple(out_hw)).permute(0, 2, 3, 1)


def pooled_fibers(fmap: torch.Tensor, num_image_embeds: int,
                  pool_type: str = "avg") -> torch.Tensor:
    """The 1-9-embed pool encoder: the trunk map pooled to the reference's
    per-N shape, flattened row-major to [B, N, C] (reference:
    mmbt/models/image.py:16-56)."""
    if num_image_embeds not in POOL_SHAPES:
        raise ValueError(
            f"pool encoder defined for num_image_embeds in "
            f"{sorted(POOL_SHAPES)}, got {num_image_embeds}")
    out = adaptive_pool(fmap, POOL_SHAPES[num_image_embeds], pool_type)
    B, oh, ow, C = out.shape
    return out.reshape(B, oh * ow, C)


def half_pooled_fibers(fmap: torch.Tensor,
                       pool_type: str = "avg") -> torch.Tensor:
    """ImageEncoder_pool: the [B, M, M, C] map pooled to (M // 2, M // 2)
    and flattened (reference: models/image.py:71-93)."""
    B, H, W, C = fmap.shape
    out = adaptive_pool(fmap, (H // 2, W // 2), pool_type)
    return out.reshape(B, (H // 2) * (W // 2), C)
