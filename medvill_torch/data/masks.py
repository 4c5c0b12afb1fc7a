"""Attention-mask specs and their dense realizations (a torch copy of
medvill_tpu/data/masks.py).

Each pretraining sample carries a 2-int spec ``(variant, txt_len)``
instead of an ``[L, L]`` mask.  ``visible`` is the one statement of the
policy: ``dense_mask_from_spec`` and ``seq2seq_spec_dense`` realize it on
the device, the attention kernels' plain versions (ops/flash_attention.py)
build their bias from it, and the CUDA kernels compute the same visibility
per element (``Spec::visible`` in ops/csrc/flash_attention.cu).  The
reference's quirks are kept:

- S2S builds the causal tril over the *padded* text block
  (dataset_origin.py:122,144-148);
- NONCROSS fills whole I/T blocks with ones, i.e. no padding mask
  (dataset_origin.py:163-167);
- ATTN1D's 1-D mask broadcasts over rows, which equals FULL densely
  (dataset_origin.py:170-172);
- ``txt_len`` counts the valid text positions including the trailing
  [SEP].

Pretrain layout: ``[CLS] img(N) [SEP] txt(seq_len) [SEP+pad]``,
``L = seq_len + N + 3``; the image block spans columns ``[0, N+2)``.
The finetune layout (``seq2seq_spec_dense``) follows sc/data_loader.py:
395-412 with ``txt_len`` carrying n_tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from medvill_torch.config import MaskVariant

NEG_BIAS = -10000.0  # reference: cxrbert_origin.py:83, sc/.../model.py:819


class Seq2seqMaskMode:
    """The finetune mask modes (medvill_tpu masks.py:170-173)."""

    S2S = "s2s"
    BAR = "bar"
    BI = "bi"


# finetune mask modes and their spec ids (medvill_tpu masks.py:242-243)
SEQ2SEQ_VARIANT_IDS = {Seq2seqMaskMode.BI: 0, Seq2seqMaskMode.S2S: 1,
                       Seq2seqMaskMode.BAR: 2}

# mask families: pretrain (FULL/S2S/BAR/NONCROSS/ATTN1D over
# ``[CLS] img(N) [SEP] txt``) and seq2seq (finetune bi/s2s/bar, ``txt_len``
# carrying n_tokens)
FAMILY_PRETRAIN = 0
FAMILY_SEQ2SEQ = 1


@dataclasses.dataclass(frozen=True)
class MaskGeometry:
    """Static geometry of the joint sequence.  ``extra_text_cls`` covers the
    NONCROSS ("disturbing") layout, which inserts a text-CLS after [SEP]."""

    num_image_embeds: int
    seq_len: int  # max text tokens (excl. the trailing [SEP])
    extra_text_cls: bool = False

    @property
    def img_block(self) -> int:
        """CLS + image embeds + SEP."""
        return self.num_image_embeds + 2

    @property
    def total_len(self) -> int:
        return self.seq_len + self.num_image_embeds + 3 + (
            1 if self.extra_text_cls else 0)


def make_spec(variant, txt_len: int) -> np.ndarray:
    """Host-side per-sample spec: int32[2] = (variant, txt_len)."""
    return np.array([int(variant), int(txt_len)], dtype=np.int32)


def _iotas(L: int, device):
    r = torch.arange(L, device=device).view(1, L, 1)
    c = torch.arange(L, device=device).view(1, 1, L)
    return r, c


def visible(family: int, variant: torch.Tensor, txt_len: torch.Tensor,
            r: torch.Tensor, c: torch.Tensor, img_block: int) -> torch.Tensor:
    """Boolean visibility of (query row r, key column c) for broadcastable
    per-sample ``variant``/``txt_len``; ``img_block`` is CLS + image embeds
    + SEP (medvill_tpu flash_attention.py:51-83)."""
    I2 = img_block
    if family == FAMILY_PRETRAIN:
        full = (c < I2) | (c - I2 < txt_len)
        s2s = (c < I2) | ((r >= I2) & (c >= I2) & (c <= r))
        bar = s2s | (r < I2)
        noncross = ((r < I2) & (c < I2)) | ((r >= I2) & (c >= I2))
        return torch.where(variant == int(MaskVariant.S2S), s2s,
               torch.where(variant == int(MaskVariant.BAR), bar,
               torch.where(variant == int(MaskVariant.NONCROSS), noncross,
                           full)))  # FULL and ATTN1D share dense semantics
    if family == FAMILY_SEQ2SEQ:
        n = txt_len
        causal = (r >= I2) & (r < n) & (c >= I2) & (c <= r)
        s2s = (c < I2) | causal
        bar = s2s | (r < I2)
        return torch.where(variant == 1, s2s,
                           torch.where(variant == 2, bar, c < n))
    raise ValueError(f"unknown mask family {family}")


def tile_skippable(family: int, variant: int, txt_len: int, img_block: int,
                   l_real: int, L: int, r0: int, c0: int,
                   tile: int = 64) -> bool:
    """Whether the attention kernels skip the (query rows [r0, r0+tile),
    key columns [c0, c0+tile)) pair of one sample: ``visible`` (and ``c <
    l_real``) holds for none of its cells below L, and every row of the
    query tile sees some column, so each skipped cell's weight is exactly 0
    (``Spec::skip`` in ops/csrc/flash_attention.cu, its twin).  A closed
    form: each region of ``visible`` is a rectangle or the triangle c <= r.
    """
    I2, lr = img_block, min(l_real, L)
    r_lo, r_hi = r0, min(r0 + tile, L) - 1
    c_lo, c_hi = c0, min(c0 + tile, L, lr) - 1
    # every row has a visible column: column 0, or I2 for NONCROSS text rows
    if lr < 1:
        return False
    if family == FAMILY_PRETRAIN:
        rows_see = ((r_hi < I2 or lr > I2)
                    if variant == int(MaskVariant.NONCROSS) else I2 >= 1)
    else:
        rows_see = I2 >= 1 if variant in (1, 2) else txt_len >= 1
    if not rows_see:
        return False
    if c_hi < c_lo:
        return True
    img_cols, img_rows, cc = c_lo < I2, r_lo < I2, max(c_lo, I2)
    if family == FAMILY_PRETRAIN:
        if variant == int(MaskVariant.NONCROSS):
            any_vis = (img_rows and img_cols) or (r_hi >= I2 and c_hi >= I2)
        elif variant in (int(MaskVariant.S2S), int(MaskVariant.BAR)):
            causal = r_hi >= I2 and cc <= c_hi and cc <= r_hi
            any_vis = img_cols or causal or (
                variant == int(MaskVariant.BAR) and img_rows)
        else:  # FULL, ATTN1D
            any_vis = c_lo < max(I2, I2 + txt_len)
    elif variant in (1, 2):  # seq2seq s2s, bar
        rr_lo, rr_hi = max(r_lo, I2), min(r_hi, txt_len - 1)
        causal = rr_lo <= rr_hi and cc <= c_hi and cc <= rr_hi
        any_vis = img_cols or causal or (variant == 2 and img_rows)
    else:  # seq2seq bi
        any_vis = c_lo < txt_len
    return not any_vis


def tile_skip_grid(family: int, spec: torch.Tensor, img_block: int,
                   l_real: int, L: int, tile: int = 64) -> torch.Tensor:
    """[B, n, n] bool (query tile, key tile), n = ceil(L / tile):
    ``tile_skippable`` for every pair of each sample of a [B, 2] int spec
    (variant, txt_len)."""
    n = -(-L // tile)
    return torch.tensor([[[tile_skippable(family, variant, txt, img_block,
                                          l_real, L, i * tile, j * tile, tile)
                           for j in range(n)] for i in range(n)]
                         for variant, txt in spec.tolist()], dtype=torch.bool)


def dense_mask_from_spec(spec: torch.Tensor,
                         geom: MaskGeometry) -> torch.Tensor:
    """[B, 2] int spec -> [B, L, L] int32 dense mask (1 = visible)."""
    r, c = _iotas(geom.total_len, spec.device)
    return visible(FAMILY_PRETRAIN, spec[:, 0].view(-1, 1, 1),
                   spec[:, 1].view(-1, 1, 1), r, c,
                   geom.img_block).to(torch.int32)


def bias_from_spec(spec: torch.Tensor, geom: MaskGeometry,
                   dtype=torch.float32) -> torch.Tensor:
    """[B, 2] spec -> [B, 1, L, L] additive bias ``(1 - m) * -10000``."""
    m = dense_mask_from_spec(spec, geom)
    return ((1.0 - m.to(dtype)) * NEG_BIAS)[:, None]


def seq2seq_spec_dense(variant_id: torch.Tensor, n_tokens: torch.Tensor,
                       len_vis_input: int, max_len: int) -> torch.Tensor:
    """Finetune masks from per-sample specs: variant_id [B] (0 bi, 1 s2s,
    2 bar), n_tokens [B] -> [B, L, L] int32."""
    r, c = _iotas(max_len, variant_id.device)
    return visible(FAMILY_SEQ2SEQ, variant_id.view(-1, 1, 1),
                   n_tokens.view(-1, 1, 1), r, c,
                   len_vis_input + 2).to(torch.int32)


def reference_dense_mask(variant, txt_len: int,
                         geom: MaskGeometry) -> np.ndarray:
    """The reference construction (data/dataset_origin.py:140-177) in
    numpy, literally: the golden oracle for ``dense_mask_from_spec``."""
    L = geom.total_len
    I2 = geom.img_block
    variant = MaskVariant(int(variant))

    attn_1d = np.zeros(L, dtype=np.int64)
    attn_1d[:I2] = 1
    attn_1d[I2:I2 + txt_len] = 1
    if variant in (MaskVariant.FULL, MaskVariant.ATTN1D):
        return np.broadcast_to(attn_1d, (L, L)).copy()
    if variant in (MaskVariant.S2S, MaskVariant.BAR):
        m = np.zeros((L, L), dtype=np.int64)
        m[:, :I2] = 1
        # tril over the padded text block (dataset_origin.py:122,144-148)
        m[I2:, I2:] = np.tril(np.ones((L - I2, L - I2), dtype=np.int64))
        if variant == MaskVariant.BAR:
            m[:I2, :] = 1
        return m
    if variant == MaskVariant.NONCROSS:
        m = np.zeros((L, L), dtype=np.int64)
        m[:I2, :I2] = 1
        m[I2:, I2:] = 1
        return m
    raise ValueError(variant)
