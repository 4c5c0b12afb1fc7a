"""The yardstick's counts against hand counts at small shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import flops
from benchmark.reference import models
from benchmark.reference.precision import Products


class _Counting(Products):
    def __init__(self):
        super().__init__("f32")
        self.macs = 0

    def conv2d(self, x, w, stride, padding):
        y = super().conv2d(x, w, stride, padding)
        self.macs += y.numel() * w[0].numel()
        return y


@pytest.mark.parametrize("size", [64, 224])
def test_resnet50_flops_match_the_convolutions_run(size):
    spec = models.load("vlp").param_spec({"hidden_size": 8, "vocab_size": 8,
                                     "max_position_embeddings": 8,
                                     "type_vocab_size": 2,
                                     "img_hidden_size": 2048,
                                     "num_hidden_layers": 0,
                                     "intermediate_size": 8})
    P = {n: (torch.ones(s) if d == "ones" else torch.zeros(s) if
             d == "zeros" else torch.randn(s) * 0.01)
         for n, s, d in spec if n.startswith("img_encoder")}
    prod = _Counting()
    image = torch.zeros(1, size, size, 3, dtype=torch.uint8)
    with torch.no_grad():
        models.trunk_fibers(P, "img_encoder.model.", image, prod)
    assert flops.resnet50_forward_flops(size) == 2.0 * prod.macs
    if size == 224:   # torchvision's ResNet-50 without its fc: ~4.09 GMACs
        assert abs(prod.macs / 4.087e9 - 1) < 0.01


def test_bar_visible_cells():
    """BAR over [CLS] img(180) [SEP] txt(253) [SEP]: image rows see all 436
    columns, text rows the image block and the text causally."""
    L, I2 = 436, 182
    for txt_len in (2, 91, 254):
        vis = flops.visible("pretrain", np.array([[2, txt_len]]), L, I2)
        want = I2 * L + sum(I2 + j + 1 for j in range(L - I2))
        assert vis.sum() == want == 157965


@pytest.mark.parametrize("n", [259, 300, 512])
def test_s2s_visible_cells(n):
    """s2s over 256 fibers, L 512: every row sees the 258 image-segment
    columns, the n - 258 real text rows also the text causally."""
    L, I2 = 512, 258
    vis = flops.visible("seq2seq", np.array([[1, n]]), L, I2)
    assert vis.sum() == L * I2 + sum(range(1, n - I2 + 1))
    seen = vis.any(axis=1)
    assert seen.sum() == n


def test_attention_and_ln_bounds_by_hand():
    vis = np.ones((1, 4, 4), bool)
    k1, k2 = flops.attention_bounds(vis, heads=1, head_dim=64)
    row, full = 128, 4 * 128
    lse = 16
    assert k1 == max((2 * full + 2 * full + lse) / 3.35e12,
                     4 * 16 * 64 / 989e12)
    assert k2 == max((6 * full + 2 * full + lse) / 3.35e12,
                     10 * 16 * 64 / 989e12)
    k3, k4 = flops.ln_bounds(10, 8)
    assert k3 == (3 * 10 * 8 * 2 + 2 * 8 * 4) / 3.35e12
    assert k4 == (5 * 10 * 8 * 2 + 3 * 8 * 4) / 3.35e12


def test_model_flops_by_hand():
    dims = {"hidden_size": 4, "intermediate_size": 8, "vocab_size": 10,
            "num_hidden_layers": 2, "num_image_embeds": 1,
            "img_hidden_size": 3, "img_size": 32}
    vis = flops.visible("seq2seq", np.array([[1, 5]]), 6, 3)
    batch = {"masked_weights": np.array([[1.0, 1.0, 0.0]])}
    got = flops.model_flops(batch, dims, "seq2seq", 3, vis)
    positions = 5                           # column 5 is padding
    cells = int(vis[0, :5].sum())           # rows that some query sees
    enc = 3 * (positions * 2 * (4 * 16 + 2 * 4 * 8) * 2
               + 4 * cells * 4 * 2)
    want = (flops.resnet50_forward_flops(32) + 3 * 2 * 1 * 3 * 4 + enc
            + 2 * 3 * 2 * (16 + 40))
    assert got == pytest.approx(want, rel=1e-12)
