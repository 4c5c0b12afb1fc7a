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
    before = tfl.fused_ln_fwd.launches
    got = tfl.fused_dropout_add_ln(x, res, gamma, beta, rate=0.2, eps=1e-5,
                                   seed=3)
    want = tfl.fused_dropout_add_ln_plain(x, res, gamma, beta, rate=0.2,
                                          eps=1e-5, seed=3)
    assert torch.equal(got, want)
    assert tfl.fused_ln_fwd.launches == before


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


@pytest.mark.parametrize("shape", [(70, 256), (2, 3, 768)],
                         ids=["2d", "3d-h768"])
def test_plain_backward_matches_jax_vjp_rate0(shape):
    """K4's plain version against jax.vjp of the Pallas kernel's custom
    VJP (interpret mode), the backward TPU kernel itself."""
    import jax

    x, res, gamma, beta = _inputs(shape, seed=2)
    dy = np.random.default_rng(3).standard_normal(shape).astype(np.float32)

    def f(x, res, gamma, beta):
        return jax_fused(x, res, gamma, beta, rate=0.0, eps=1e-12,
                         seed=jnp.int32(0))

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, res, gamma, beta)))
    want = vjp(jnp.asarray(dy))
    got = tfl.fused_dropout_add_ln_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(gamma),
        torch.from_numpy(dy), rate=0.0, eps=1e-12, seed=0)
    # dgamma/dbeta sum over rows: tolerance scaled by the row count
    rows = x.size // x.shape[-1]
    tols = [TOL, TOL, TOL * rows, TOL * rows]
    for g, w, tol in zip(got, want, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_autograd_runs_the_plain_backward(rate):
    """fused_dropout_add_ln is differentiable in x, res, gamma and beta, and
    its backward (the recompute of K4) equals autograd through the plain
    forward with the same keep mask."""
    x, res, gamma, beta = (torch.from_numpy(a).requires_grad_()
                           for a in _inputs((3, 7, 128), seed=6))
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 7, 128)).astype(np.float32))
    kw = dict(rate=rate, eps=1e-5, seed=21)
    y = tfl.fused_dropout_add_ln(x, res, gamma, beta, **kw)
    got = torch.autograd.grad(y, (x, res, gamma, beta), dy)
    leaves = [t.detach().clone().requires_grad_() for t in (x, res, gamma,
                                                            beta)]
    want = torch.autograd.grad(
        tfl.fused_dropout_add_ln_plain(*leaves, **kw), leaves, dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    if rate:
        keep = tfl.keep_mask(21, 21, 128, rate).reshape(3, 7, 128)
        assert torch.equal(got[0] == 0, ~keep)


def test_backward_routes_cpu_tensors_to_plain_without_counting():
    x, res, gamma, _ = (torch.from_numpy(a)
                        for a in _inputs((5, 64), seed=8))
    before = tfl.fused_ln_bwd.launches
    got = tfl.fused_ln_bwd(x, res, gamma, x, rate=0.2, eps=1e-5, seed=3)
    want = tfl.fused_dropout_add_ln_bwd_plain(x, res, gamma, x, rate=0.2,
                                              eps=1e-5, seed=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfl.fused_ln_bwd.launches == before


K4_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__6b1f0c2e_11_fus\
ed_ln_cu_6b1f0c2e19fused_ln_bwd_kernelI13__nv_bfloat16Li3EEEvPKT_S5_PKfS5_\
PS3_S8_PfS9_Pjiiiiijjff' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__6b1f0c2e_11_fused
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__6b1f0c2e_11_fus\
ed_ln_cu_6b1f0c2e19fused_ln_bwd_kernelIfLi8EEEvPKT_S3_PKfS3_PS1_S6_PfS7_Pj\
iiiiijjff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 140 registers, used 1 barriers, 1 bytes smem
"""


def test_ptxas_report_names_each_k4_instantiation():
    """build.ptxas_report keeps an integer template argument (K4's chunks
    a lane holds) in the kernel's name, so K4's instantiations are
    reported, and checked for spills, one by one."""
    from medvill_torch.ops import build

    assert build.ptxas_report(K4_PTXAS_LOG) == {
        "fused_ln_bwd_kernel<3>[bf16]": {"spill_stores": 0, "spill_loads": 0,
                                         "registers": 96, "static_smem": 1},
        "fused_ln_bwd_kernel<8>[f32]": {"spill_stores": 0, "spill_loads": 0,
                                        "registers": 140, "static_smem": 1}}
