"""Operations and bytes, from shapes and mask specs only.

- ``attention_bounds``: the least time of one forward (K1) and one
  backward (K2) attention call over a batch: the larger of the bytes over
  HBM's rate and the operations over bf16's dense tensor-core rate.  The
  work is the cells the masks leave visible (``pairs``: visible cells x
  heads x head_dim, a multiply-add's unit) and the key rows some query
  sees: K1 reads q, k, v and writes o and the row log-sum-exp; K2 reads q,
  k, v, o, dO and the log-sum-exp and writes dq, dk, dv (as measured alone
  in ``chip_smoke.py``'s ``_attn_times``).
- ``ln_bounds``: one dropout-add-LayerNorm forward (K3: reads x, res,
  gamma, beta, writes y) and backward (K4: reads x, res, dy, gamma, writes
  dx, dres, dgamma, dbeta) over ``rows`` x ``h`` bf16 rows (``_ln_times``).
- ``model_flops``: the operations a training micro-step needs, counting
  each multiply-add as 2: the frozen ResNet-50 trunk's forward once; the
  image projection, the encoder and the heads forward and backward (3 x
  the forward).  The encoder counts the positions that some query sees (a
  position no query sees cannot change the loss) and, in attention, the
  visible cells of those rows; the MLM head counts the labeled positions,
  the ITM head and pooler one row per sample.  Nothing recomputed is
  counted, and nothing depends on which kernel does the work.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import masks

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
STAGES = (3, 4, 6, 3)


def _bound(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / BF16_FLOPS_PER_S)


def visible(family: str, spec: np.ndarray, L: int,
            img_block: int) -> np.ndarray:
    return masks.visible(family, torch.as_tensor(np.asarray(spec)), L,
                         img_block).numpy()


def attention_bounds(vis: np.ndarray, heads: int, head_dim: int,
                     dtype_bytes: int = 2) -> tuple:
    """(K1 seconds, K2 seconds) of one call over the batch whose [B, L, L]
    visibility is ``vis``."""
    B, L, _ = vis.shape
    row = heads * head_dim * dtype_bytes
    pairs = float(vis.sum()) * heads * head_dim
    full = B * L * row
    seen = float(vis.any(axis=1).sum()) * row
    lse = B * heads * L * 4
    return (_bound(2 * full + 2 * seen + lse, 4 * pairs),
            _bound(6 * full + 2 * seen + lse, 10 * pairs))


def ln_bounds(rows: int, h: int) -> tuple:
    """(K3 seconds, K4 seconds) of one call over bf16 [rows, h]."""
    return (_bound(3 * rows * h * 2 + 2 * h * 4, 10 * rows * h),
            _bound(5 * rows * h * 2 + 3 * h * 4, 20 * rows * h))


def resnet50_forward_flops(img_size: int, width: int = 64) -> float:
    """One image through conv1..layer4 (convolutions only)."""
    s = img_size // 2
    flops = 2.0 * width * 3 * 49 * s * s
    s //= 2  # max-pool
    in_ch = width
    for stage, n in enumerate(STAGES):
        w = width * 2 ** stage
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            out = s // stride
            flops += 2.0 * w * in_ch * s * s          # 1x1
            flops += 2.0 * w * w * 9 * out * out       # 3x3, strided
            flops += 2.0 * 4 * w * w * out * out       # 1x1
            if b == 0:
                flops += 2.0 * 4 * w * in_ch * out * out
            in_ch, s = 4 * w, out
    return flops


def model_flops(batch: dict, dims: dict, family: str, img_block: int,
                vis: np.ndarray) -> float:
    """One micro-step over ``batch`` (see the module docstring)."""
    H, I = dims["hidden_size"], dims["intermediate_size"]
    V, layers = dims["vocab_size"], dims["num_hidden_layers"]
    B = vis.shape[0]
    seen = vis.any(axis=1)                       # [B, L] keys some row sees
    positions = float(seen.sum())
    cells = float((vis & seen[:, :, None]).sum())
    per_token = 2.0 * (4 * H * H + 2 * H * I) * layers
    attention = 4.0 * cells * H * layers          # QK and PV, all heads
    enc = 3.0 * (positions * per_token + attention)
    image = 3.0 * 2.0 * B * dims["num_image_embeds"] * dims[
        "img_hidden_size"] * H
    trunk = B * resnet50_forward_flops(dims["img_size"])
    head = 3.0 * 2.0 * (H * H + H * V)
    if family == "pretrain":
        labeled = float((np.asarray(batch["txt_labels"]) != -100).sum())
        heads = labeled * head + B * 3.0 * 2.0 * (H * H + 2 * H)
    else:
        heads = float(np.asarray(batch["masked_weights"]).sum()) * head
    return trunk + image + enc + heads
