"""The plain reference against the port's CPU path, its masks and its
dropout hash against hand counts."""
from __future__ import annotations

import pytest
import torch

from benchmark.reference import dropout, masks
from benchmark.tests import tiny


@pytest.mark.parametrize("name", ["pretrain-r50-bar", "finetune-r50-s2s"])
def test_reference_follows_the_port_on_the_cpu(name):
    """At float32 on the CPU (the port's plain kernel versions) the
    reference gives the program's losses, first moments and changes to
    rounding, dropout masks included: the comparison reads arithmetic, not
    randomness."""
    result, lines = tiny.run(tiny.cell(name))
    assert result["correct"], lines
    for number, c in result["check"].items():
        assert c["value"] < 1e-5, (number, c)
    assert result["attempted"] > 0 and result["failed"] == 0


def test_masks_by_hand():
    # pretraining, image block 3 (CLS, 1 fiber, SEP), 3 text positions
    spec = torch.tensor([[masks.PRETRAIN_VARIANTS["BAR"], 2]])
    v = masks.visible("pretrain", spec, 6, 3)[0].int().tolist()
    assert v == [[1] * 6] * 3 + [[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 0],
                                 [1, 1, 1, 1, 1, 1]]
    spec = torch.tensor([[masks.PRETRAIN_VARIANTS["FULL"], 2]])
    assert masks.visible("pretrain", spec, 6, 3)[0].int().tolist() == \
        [[1, 1, 1, 1, 1, 0]] * 6
    # report generation, image segment 3, 5 real positions of 6
    spec = torch.tensor([[masks.SEQ2SEQ_VARIANTS["s2s"], 5]])
    v = masks.visible("seq2seq", spec, 6, 3)[0].int().tolist()
    assert v == [[1, 1, 1, 0, 0, 0]] * 3 + [[1, 1, 1, 1, 0, 0],
                                            [1, 1, 1, 1, 1, 0],
                                            [1, 1, 1, 0, 0, 0]]


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_dropout_hash_against_python_integers():
    idx = torch.tensor([0, 1, 2, 12345, 2 ** 32 - 1], dtype=torch.int64)
    assert dropout.fmix32(idx).tolist() == [_fmix32(i) for i in idx.tolist()]
    keep = dropout.hashed_keep(7, (3, 5), 0.1, "cpu")
    want = [_fmix32(i ^ 7) >= int(0.1 * 2 ** 32) for i in range(15)]
    assert keep.flatten().tolist() == want


def test_host_draws_in_order():
    g = torch.Generator().manual_seed(5)
    pix, seed = dropout.host_draws(g, 16, 4)
    g2 = torch.Generator().manual_seed(5)
    perm = torch.randperm(16, generator=g2)
    assert pix.tolist() == sorted(perm[:4].tolist())
    assert seed == int(torch.randint(0, 2 ** 31, (), generator=g2))
