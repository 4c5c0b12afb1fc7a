"""medvill_torch.ops.flash_attention: the plain versions of K1 and K2
against the JAX Pallas kernels (interpret mode on the CPU, as
tests/test_flash_attention.py runs them) under every mask variant, the
recompute backward against autograd with dropout on, the attention-dropout
keep-mask hash, and the wrapper's routing and input checks.  The CUDA
kernels are held against these plain versions on the card, in
tests/test_torch_port_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch.data import masks as tmasks
from medvill_torch.ops import flash_attention as tfa
from medvill_torch.ops.attention import mha_reference as t_mha
from medvill_tpu.core.config import MaskVariant
from medvill_tpu.data.masks import MaskGeometry
from medvill_tpu.ops import flash_attention as jfa

GEOM = MaskGeometry(num_image_embeds=4, seq_len=7)
B, HEADS, D = 2, 2, 8
L = GEOM.total_len
# f32 on both sides; the online and the whole-row softmax differ only in
# summation order
FWD_TOL = 1e-5
# gradients sum ~L products of O(1) terms, in different orders
GRAD_TOL = 1e-4


def _qkv(seed, shape=(B, L, HEADS, D)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _specs(family, variant):
    if family == tfa.FAMILY_PRETRAIN:
        return np.array([[int(variant), t] for t in (3, 8)], np.int32)
    vis = GEOM.num_image_embeds
    vid = tmasks.SEQ2SEQ_VARIANT_IDS[variant]
    return np.array([[vid, n] for n in (vis + 3, vis + 6)], np.int32)


CASES = ([(tfa.FAMILY_PRETRAIN, v) for v in MaskVariant]
         + [(tfa.FAMILY_SEQ2SEQ, m) for m in ("bi", "s2s", "bar")])
IDS = [f"pretrain-{v.name}" for v in MaskVariant] + [
    f"seq2seq-{m}" for m in ("bi", "s2s", "bar")]


@pytest.mark.parametrize("family,variant", CASES, ids=IDS)
def test_plain_forward_matches_jax_kernel(family, variant):
    q, k, v = _qkv(0)
    spec = _specs(family, variant)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(spec), img_block=GEOM.img_block,
                         l_real=L, family=family)
    got, lse = tfa.attn_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(spec), img_block=GEOM.img_block, l_real=L,
        family=family, rate=0.0, seed=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert lse.shape == (B, HEADS, L) and torch.isfinite(lse).all()


@pytest.mark.parametrize("variant", [MaskVariant.BAR, MaskVariant.NONCROSS,
                                     MaskVariant.S2S], ids=lambda v: v.name)
def test_recompute_backward_matches_jax_custom_vjp(variant):
    q, k, v = _qkv(2)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    spec = _specs(tfa.FAMILY_PRETRAIN, variant)

    def f(q, k, v):
        return jfa.flash_mha(q, k, v, jnp.asarray(spec),
                             img_block=GEOM.img_block, l_real=L)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    kw = dict(img_block=GEOM.img_block, l_real=L,
              family=tfa.FAMILY_PRETRAIN, rate=0.0, seed=0)
    tq, tk, tv, tspec = (torch.from_numpy(a) for a in (q, k, v, spec))
    o, lse = tfa.attn_fwd_plain(tq, tk, tv, tspec, **kw)
    got = tfa.attn_bwd_plain(tq, tk, tv, o, torch.from_numpy(do), lse, tspec,
                             **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("family,variant",
                         [(tfa.FAMILY_PRETRAIN, MaskVariant.BAR),
                          (tfa.FAMILY_SEQ2SEQ, "s2s")],
                         ids=["pretrain-BAR", "seq2seq-s2s"])
def test_recompute_backward_matches_autograd_with_dropout(family, variant):
    """Rate 0.1: the recompute backward regenerates the forward's keep mask
    (same seed), so it equals autograd through the plain forward."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(4))
    spec = torch.from_numpy(_specs(family, variant))
    kw = dict(img_block=GEOM.img_block, l_real=L, family=family, rate=0.1,
              seed=77)
    o, lse = tfa.attn_fwd_plain(q, k, v, spec, **kw)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = tfa.attn_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(),
                             do, lse.detach(), spec, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_flash_mha_autograd_runs_the_recompute_backward():
    """flash_mha's backward (attn_bwd) equals autograd through the plain
    forward, with dropout on."""
    spec = torch.from_numpy(_specs(tfa.FAMILY_PRETRAIN, MaskVariant.BAR))
    leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(6)]
    kw = dict(img_block=GEOM.img_block, l_real=L, dropout_rate=0.2, seed=9,
              deterministic=False)
    (tfa.flash_mha(*leaves, spec, **kw) ** 2).sum().backward()
    clones = [t.detach().clone().requires_grad_() for t in leaves]
    o, _ = tfa.attn_fwd_plain(*clones, spec, img_block=GEOM.img_block,
                              l_real=L, family=tfa.FAMILY_PRETRAIN,
                              rate=0.2, seed=9)
    (o ** 2).sum().backward()
    for a, b in zip(leaves, clones):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_plain_forward_equals_dense_bias_attention():
    """At rate 0 the spec path equals mha_reference on bias_from_spec."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8))
    spec = torch.from_numpy(_specs(tfa.FAMILY_PRETRAIN, MaskVariant.S2S))
    geom = tmasks.MaskGeometry(GEOM.num_image_embeds, GEOM.seq_len)
    want = t_mha(q, k, v, tmasks.bias_from_spec(spec, geom))
    got = tfa.flash_mha(q, k, v, spec, img_block=GEOM.img_block, l_real=L)
    torch.testing.assert_close(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _fmix32_py(h: int) -> int:
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def test_keep_mask_hash_matches_python_oracle():
    b_, heads, l_, rate, seed = 2, 3, 5, 0.3, 12345
    got = tfa.keep_mask(seed, b_, heads, l_, rate).numpy()
    thresh = int(rate * 2 ** 32)
    want = np.array([[[[_fmix32_py(seed ^ (((b * heads + h) * l_ + r) * l_
                                           + c)) >= thresh
                        for c in range(l_)] for r in range(l_)]
                      for h in range(heads)] for b in range(b_)])
    np.testing.assert_array_equal(got, want)


def test_dropout_keep_fraction_and_effect():
    keep = tfa.keep_mask(3, 4, 12, 64, 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    q, k, v = (torch.from_numpy(a) for a in _qkv(9))
    spec = torch.from_numpy(_specs(tfa.FAMILY_PRETRAIN, MaskVariant.FULL))
    kw = dict(img_block=GEOM.img_block, l_real=L)
    det = tfa.flash_mha(q, k, v, spec, **kw)
    drop = tfa.flash_mha(q, k, v, spec, dropout_rate=0.3, seed=1,
                         deterministic=False, **kw)
    assert torch.isfinite(drop).all() and not torch.allclose(drop, det)
    # deterministic=True ignores the rate
    same = tfa.flash_mha(q, k, v, spec, dropout_rate=0.3, seed=1, **kw)
    assert torch.equal(same, det)


def test_wrapper_routes_cpu_tensors_to_plain_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(10))
    spec = torch.from_numpy(_specs(tfa.FAMILY_PRETRAIN, MaskVariant.BAR))
    kw = dict(img_block=GEOM.img_block, l_real=L,
              family=tfa.FAMILY_PRETRAIN, rate=0.1, seed=4)
    before = (tfa.attn_fwd.launches, tfa.attn_bwd.launches)
    o, lse = tfa.attn_fwd(q, k, v, spec, **kw)
    want_o, want_lse = tfa.attn_fwd_plain(q, k, v, spec, **kw)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    tfa.attn_bwd(q, k, v, o, o, lse, spec, **kw)
    assert (tfa.attn_fwd.launches, tfa.attn_bwd.launches) == before


@pytest.mark.parametrize("bad", ["head-dim", "dtype-f16", "k-dtype",
                                 "non-contiguous", "spec-int64",
                                 "spec-shape", "too-long"])
def test_kernel_input_checks(bad):
    shape = (2, 9, 3, tfa.HEAD_DIM)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k, v = q.clone(), q.clone()
    spec = torch.zeros(2, 2, dtype=torch.int32)
    if bad == "head-dim":
        q = k = v = torch.zeros(2, 9, 3, 32, dtype=torch.bfloat16)
    elif bad == "dtype-f16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "k-dtype":
        k = k.float()
    elif bad == "non-contiguous":
        v = torch.zeros(2, 3, 9, tfa.HEAD_DIM,
                        dtype=torch.bfloat16).transpose(1, 2)
    elif bad == "spec-int64":
        spec = spec.long()
    elif bad == "spec-shape":
        spec = torch.zeros(3, 2, dtype=torch.int32)
    elif bad == "too-long":
        q = k = v = torch.zeros(1, tfa._MAX_L + 1, 1, tfa.HEAD_DIM,
                                dtype=torch.bfloat16)
        spec = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        tfa._check(spec, q, k, v)


def test_mha_reference_dropout_uses_the_generator():
    from medvill_torch.ops.dropout import DropoutRNG

    q, k, v = (torch.from_numpy(a) for a in _qkv(11))
    kw = dict(dropout_rate=0.5, deterministic=False)
    a = t_mha(q, k, v, None, rng=DropoutRNG(1, "cpu"), **kw)
    b = t_mha(q, k, v, None, rng=DropoutRNG(1, "cpu"), **kw)
    c = t_mha(q, k, v, None, rng=DropoutRNG(2, "cpu"), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(t_mha(q, k, v, None, dropout_rate=0.5),
                       t_mha(q, k, v, None))
    with pytest.raises(ValueError):
        t_mha(q, k, v, None, **kw)
