"""medvill_torch.ops.fused_ln: the plain version against the JAX Pallas
kernel (interpret mode on the CPU, as tests/test_fused_ln.py runs it), the
dropout keep-mask hash, and the wrapper's routing and input checks.  The
CUDA kernel itself is held against its plain version on the card, in
tests/test_torch_port_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch.ops import fused_ln as tfl
from medvill_tpu.ops.fused_ln import TILE_R
from medvill_tpu.ops.fused_ln import fused_dropout_add_ln as jax_fused

# both compute f32 row statistics of the same sums; only the summation
# order differs
TOL = 2e-5


def _inputs(shape, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    x = rng.standard_normal(shape).astype(dtype)
    res = rng.standard_normal(shape).astype(dtype)
    gamma = rng.standard_normal(h).astype(np.float32)
    beta = rng.standard_normal(h).astype(np.float32)
    return x, res, gamma, beta


@pytest.mark.parametrize("shape", [(70, 256), (1, TILE_R + 13, 128),
                                   (2, 3, 768)],
                         ids=["2d", "3d-ragged-rows", "3d-h768"])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_plain_matches_jax_rate0(shape, eps):
    x, res, gamma, beta = _inputs(shape)
    want = jax_fused(jnp.asarray(x), jnp.asarray(res), jnp.asarray(gamma),
                     jnp.asarray(beta), rate=0.0, eps=eps, seed=jnp.int32(0))
    got = tfl.fused_dropout_add_ln_plain(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(gamma),
        torch.from_numpy(beta), rate=0.0, eps=eps, seed=0)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _fmix32_py(h: int) -> int:
    """murmur3's 32-bit finaliser on Python ints (the independent oracle
    for the int64 tensor version)."""
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 - 1])
def test_keep_mask_hash_matches_python_oracle(seed):
    rows, h, rate = 3, 40, 0.3
    got = tfl.keep_mask(seed, rows, h, rate).numpy()
    thresh = int(rate * 2 ** 32)
    want = np.array([[_fmix32_py((seed & 0xFFFFFFFF) ^ (r * h + c)) >= thresh
                      for c in range(h)] for r in range(rows)])
    np.testing.assert_array_equal(got, want)


def test_keep_mask_deterministic_and_seed_dependent():
    a = tfl.keep_mask(11, 64, 768, 0.1)
    b = tfl.keep_mask(11, 64, 768, 0.1)
    c = tfl.keep_mask(12, 64, 768, 0.1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert tfl.keep_mask(11, 64, 768, 0.0).all()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction(rate):
    keep = tfl.keep_mask(3, 512, 768, rate)
    assert abs(keep.float().mean().item() - (1.0 - rate)) < 0.01


def test_plain_dropout_is_the_masked_layer_norm():
    x, res, gamma, beta = _inputs((32, 128), seed=4)
    rate, eps, seed = 0.25, 1e-5, 5
    got = tfl.fused_dropout_add_ln_plain(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(gamma),
        torch.from_numpy(beta), rate=rate, eps=eps, seed=seed).numpy()
    keep = tfl.keep_mask(seed, 32, 128, rate).numpy()
    s = np.where(keep, x * np.float32(1.0 / (1.0 - rate)), 0.0) + res
    mean = s.mean(-1, keepdims=True)
    var = ((s - mean) ** 2).mean(-1, keepdims=True)
    want = (s - mean) / np.sqrt(var + eps) * gamma + beta
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_wrapper_routes_cpu_tensors_to_plain_without_counting():
    x, res, gamma, beta = (torch.from_numpy(a)
                           for a in _inputs((2, 5, 64), seed=1))
    before = tfl.fused_dropout_add_ln.launches
    got = tfl.fused_dropout_add_ln(x, res, gamma, beta, rate=0.2, eps=1e-5,
                                   seed=3)
    want = tfl.fused_dropout_add_ln_plain(x, res, gamma, beta, rate=0.2,
                                          eps=1e-5, seed=3)
    assert torch.equal(got, want)
    assert tfl.fused_dropout_add_ln.launches == before


@pytest.mark.parametrize("bad", ["h-not-vector", "h-too-wide", "res-dtype",
                                 "gamma-bf16", "non-contiguous", "f16",
                                 "rate-1"])
def test_kernel_input_checks(bad):
    h = 768
    x = torch.zeros(4, h, dtype=torch.bfloat16)
    res = torch.zeros(4, h, dtype=torch.bfloat16)
    g, b = torch.ones(h), torch.zeros(h)
    if bad == "h-not-vector":
        x, res = x[:, :764].contiguous(), res[:, :764].contiguous()
        g, b = g[:764], b[:764]
    elif bad == "h-too-wide":
        x, res = torch.zeros(4, 2048, dtype=torch.bfloat16), \
            torch.zeros(4, 2048, dtype=torch.bfloat16)
        g, b = torch.ones(2048), torch.zeros(2048)
    elif bad == "res-dtype":
        res = res.float()
    elif bad == "gamma-bf16":
        g = g.bfloat16()
    elif bad == "non-contiguous":
        x = torch.zeros(h, 4, dtype=torch.bfloat16).t()
    elif bad == "f16":
        x, res = x.half(), res.half()
    if bad == "rate-1":
        with pytest.raises(ValueError):
            tfl._threshold(1.0)
        return
    with pytest.raises((TypeError, ValueError)):
        tfl._check(x, res, g, b)
