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
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

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


SKIP_CASES = ([(tfa.FAMILY_PRETRAIN, int(v)) for v in MaskVariant]
              + [(tfa.FAMILY_SEQ2SEQ, m) for m in range(3)])
SKIP_IDS = [f"pretrain-{v.name}" for v in MaskVariant] + [
    f"seq2seq-{m}" for m in ("bi", "s2s", "bar")]


@pytest.mark.parametrize("L", [37, 64, 65, 436, 512])
@pytest.mark.parametrize("family,variant", SKIP_CASES, ids=SKIP_IDS)
def test_tile_skip_predicate_matches_dense_mask(family, variant, L):
    """masks.tile_skippable against visible() over every (query tile, key
    tile) pair at the kernel's tile size: a pair it marks is masked in
    every cell and each of its rows sees some column (so a skipped cell
    weighs exactly 0), and every such pair is marked (exact for
    img_block >= 1)."""
    T = tfa.TILE
    idx = torch.arange(L)
    r, c = idx.view(L, 1), idx.view(1, L)
    for I2 in sorted({1, 22, 64, min(182, L - 1)}):
        if family == tfa.FAMILY_PRETRAIN:  # txt_len: text rows valid
            txts = {0, 1, T - I2, T - I2 + 1, L - I2 - 1, L - I2}
        else:  # n_tokens
            txts = {0, 1, I2, I2 + 1, T, T + 1, L}
        for txt in sorted(t for t in txts if t >= 0):
            for l_real in (L, max(1, L - 40)):
                vis = tmasks.visible(family, torch.tensor(variant),
                                     torch.tensor(txt), r, c, I2) & (c < l_real)
                for r0 in range(0, L, T):
                    rows = vis[r0:r0 + T]
                    rows_see = bool(rows.any(1).all())
                    for c0 in range(0, L, T):
                        masked = not bool(rows[:, c0:c0 + T].any())
                        got = tmasks.tile_skippable(family, variant, txt, I2,
                                                    l_real, L, r0, c0, T)
                        assert got == (masked and rows_see), (
                            I2, txt, l_real, r0, c0)


def test_tile_skip_pairs_at_the_training_shape():
    """BAR, L = 436, img_block 182, 64-row tiles: exactly the 6 of 49 pairs
    above the causal text diagonal, whatever txt_len."""
    L, I2, T = 436, 182, tfa.TILE
    for txt in (1, 100, L - I2):
        got = [(r0 // T, c0 // T) for r0 in range(0, L, T)
               for c0 in range(0, L, T)
               if tmasks.tile_skippable(tfa.FAMILY_PRETRAIN,
                                        int(MaskVariant.BAR), txt, I2, L, L,
                                        r0, c0, T)]
        assert got == [(3, 4), (3, 5), (3, 6), (4, 5), (4, 6), (5, 6)]


def test_tile_skip_grid_is_the_predicate_per_pair():
    """masks.tile_skip_grid holds tile_skippable for every (sample, query
    tile, key tile): the 6 BAR pairs at the training shape, none for
    FULL."""
    L, I2, T = 436, 182, tfa.TILE
    spec = torch.tensor([[int(MaskVariant.BAR), 100],
                         [int(MaskVariant.FULL), L - I2]])
    grid = tmasks.tile_skip_grid(tfa.FAMILY_PRETRAIN, spec, I2, L, L, T)
    assert grid.shape == (2, 7, 7) and grid.dtype == torch.bool
    assert [tuple(p) for p in grid[0].nonzero().tolist()] == [
        (3, 4), (3, 5), (3, 6), (4, 5), (4, 6), (5, 6)]
    assert not grid[1].any()


def test_skipped_tiles_reads_no_skip_from_the_plain_versions():
    """On the CPU skipped_tiles runs the plain versions, which compute every
    pair, so no pair reads as skipped, though the predicate marks some
    (BAR, L = 150, image block 64)."""
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 150, 2, tfa.HEAD_DIM)).astype(np.float32)) for _ in range(4))
    spec = torch.tensor([[2, 1], [2, 86]], dtype=torch.int32)
    assert tmasks.tile_skip_grid(tfa.FAMILY_PRETRAIN, spec, 64, 150,
                                 150).any()
    read = tfa.skipped_tiles(q, k, v, do, spec, img_block=64, l_real=150,
                             family=tfa.FAMILY_PRETRAIN)
    assert sorted(read) == ["dkdv", "dq", "fwd"]
    for got in read.values():
        assert got.shape == (2, 2, 3, 3) and not got.any()


def test_bf16_tolerances_bound_a_bf16_rounding_of_p():
    """bf16_tolerances bounds what rounding P_drop and dS to bf16 between
    products does: the plain math with that rounding added stays within
    it (f32 inputs exactly representable in bf16, rate 0.1)."""
    rng = np.random.default_rng(12)
    shape = (2, 70, 2, tfa.HEAD_DIM)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16().float() for _ in range(4))
    spec = torch.tensor([[2, 20], [1, 40]], dtype=torch.int32)
    kw = dict(img_block=10, l_real=70, family=tfa.FAMILY_PRETRAIN, rate=0.1,
              seed=3)
    o, lse = tfa.attn_fwd_plain(q, k, v, spec, **kw)
    dq, dk, dv = tfa.attn_bwd_plain(q, k, v, o, do, lse, spec, **kw)
    plain = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    tol = tfa.bf16_tolerances(q, k, v, o, do, lse, spec, plain, **kw)
    p_drop, ds = tfa._bwd_terms(q, k, v, o, do, lse, spec, 10, 70,
                                tfa.FAMILY_PRETRAIN, 0.1, 3)
    p_drop, ds = p_drop.bfloat16().float(), ds.bfloat16().float()
    scale = 1.0 / np.sqrt(tfa.HEAD_DIM)
    rounded = {
        "o": torch.einsum("bhqk,bkhd->bqhd", p_drop, v),
        "dq": torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
        "dk": torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
        "dv": torch.einsum("bhqk,bqhd->bkhd", p_drop, do)}
    for name, got in rounded.items():
        err = (got.bfloat16().float() - plain[name].bfloat16().float()
               ).abs().max().item()
        assert 0 < err <= tol[name], (name, err, tol[name])


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


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__2aacc652_18_flash\
_attention_cu_ec2ed44718attn_fwd_tc_kernelEPK13__nv_bfloat16S2_S2_PKiPS0_PfNS\
_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__2aacc652_18_flash_at
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__2aacc652_18_flash\
_attention_cu_ec2ed44718attn_bwd_dq_kernelEPKfS1_S1_S1_S1_S1_PKiPfNS_4ArgsE' \
for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 160 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack \
size, 32768 bytes smem
"""


def test_ptxas_report_reads_each_kernel():
    """build.ptxas_report: registers, spills and static shared memory per
    entry function, named by kernel and element type."""
    from medvill_torch.ops import build

    assert build.ptxas_report(PTXAS_LOG) == {
        "attn_fwd_tc_kernel[bf16]": {"spill_stores": 0, "spill_loads": 0,
                                     "registers": 128, "static_smem": 0},
        "attn_bwd_dq_kernel[f32]": {"spill_stores": 8, "spill_loads": 160,
                                    "registers": 168, "static_smem": 32768}}
    assert build.ptxas_report("") == {}
