"""Which key each query sees, from a sample's ``(variant, txt_len)`` spec.

Written from MedViLL's dataset code (``data/dataset_origin.py:140-177``
for pretraining, ``sc/data_loader.py:395-412`` for report generation),
whose quirks are part of the semantics:

- pretraining lays out ``[CLS] img(N) [SEP] txt(seq_len) [SEP+pad]``; the
  image block is the first ``N + 2`` positions; ``txt_len`` counts the
  valid text positions with the trailing [SEP];
- S2S: every row sees the image block, text rows see the text block
  causally, padding included (the tril is built over the padded block);
  BAR is S2S plus image rows that see every column; NONCROSS is
  block-diagonal with no padding mask; FULL and ATTN1D see the image block
  and the valid text;
- report generation carries ``n_tokens`` (the real positions, image
  segment included) in ``txt_len``: s2s rows below ``n_tokens`` in the
  text see the image segment and the text causally; padding rows see only
  the image segment; bi sees every real position; bar adds image rows
  that see everything.
"""
from __future__ import annotations

import torch

PRETRAIN_VARIANTS = {"FULL": 0, "S2S": 1, "BAR": 2, "NONCROSS": 3,
                     "ATTN1D": 4}
SEQ2SEQ_VARIANTS = {"bi": 0, "s2s": 1, "bar": 2}


def visible(family: str, spec: torch.Tensor, L: int,
            img_block: int) -> torch.Tensor:
    """[B, L, L] bool: row r (query) sees column c (key)."""
    variant = spec[:, 0].long().view(-1, 1, 1)
    n = spec[:, 1].long().view(-1, 1, 1)
    r = torch.arange(L, device=spec.device).view(1, L, 1)
    c = torch.arange(L, device=spec.device).view(1, 1, L)
    img_col, img_row = c < img_block, r < img_block
    if family == "pretrain":
        text_causal = (r >= img_block) & (c >= img_block) & (c <= r)
        s2s = img_col | text_causal
        out = img_col | (c - img_block < n)  # FULL, ATTN1D
        out = torch.where(variant == PRETRAIN_VARIANTS["S2S"], s2s, out)
        out = torch.where(variant == PRETRAIN_VARIANTS["BAR"],
                          s2s | img_row, out)
        noncross = (img_row & img_col) | (~img_row & ~img_col)
        return torch.where(variant == PRETRAIN_VARIANTS["NONCROSS"],
                           noncross, out)
    if family == "seq2seq":
        causal = (r >= img_block) & (r < n) & (c >= img_block) & (c <= r)
        s2s = img_col | causal
        out = torch.where(variant == SEQ2SEQ_VARIANTS["s2s"], s2s, c < n)
        return torch.where(variant == SEQ2SEQ_VARIANTS["bar"], s2s | img_row,
                           out)
    raise ValueError(f"unknown mask family {family!r}")


def additive_bias(family: str, spec: torch.Tensor, L: int,
                  img_block: int) -> torch.Tensor:
    """[B, 1, L, L] float32: 0 where visible, -10000 elsewhere (the
    reference's ``(1 - mask) * -10000``)."""
    vis = visible(family, spec, L, img_block)
    return torch.where(vis, 0.0, -10000.0).unsqueeze(1)
