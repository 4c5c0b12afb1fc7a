"""medvill_torch on the card: the CUDA kernels (K1/K2 attention, K3/K4 fused
LN) against their plain versions, and a tiny model's decode on the card
(kernel path) against the CPU (plain path).  Every test here needs a CUDA device and nvcc and skips
elsewhere; the file imports neither jax nor medvill_tpu, so it also runs on
a GPU host without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from medvill_torch.config import BertConfig, ImageEncoderConfig
from medvill_torch.data import masks as tmasks
from medvill_torch.models import decoder
from medvill_torch.models.seq2seq import VLPForPreTraining, init_weights
from medvill_torch.ops import flash_attention as tfa
from medvill_torch.ops import fused_ln as tfl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the fused_ln kernel has "
                    "no CPU mode (chip_smoke.py runs it on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rows", [16, 2064])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_matches_plain(cuda_device, rows, dtype, rate):
    """f32: 1e-5 (summation order); bf16: one bf16 ulp of max|y|."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    x, res = (torch.randn(rows, 768, device=cuda_device,
                          generator=gen).to(dtype) for _ in range(2))
    gamma, beta = (torch.randn(768, device=cuda_device, generator=gen)
                   for _ in range(2))
    kw = dict(rate=rate, eps=1e-5, seed=9)
    before = tfl.fused_ln_fwd.launches
    got = tfl.fused_dropout_add_ln(x, res, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert tfl.fused_ln_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = tfl.fused_dropout_add_ln_plain(x, res, gamma, beta, **kw)
    tol = 1e-5 if dtype == torch.float32 else \
        2.0 ** -7 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_tiny_decode_card_matches_cpu(cuda_device):
    """f32 tiny VLP: fused kernel on the card vs plain LayerNorm on the CPU,
    token-exact ids and log-probs within 1e-4."""
    bert = dataclasses.replace(
        BertConfig.vlp(BertConfig.test_tiny(vocab_size=64)), fused_ln=True)
    image_cfg = ImageEncoderConfig(img_size=64, num_image_embeds=4,
                                   encoder="full-fiber")
    cpu_model = VLPForPreTraining(dataclasses.replace(bert, fused_ln=False),
                                  image_cfg, len_vis_input=4)
    init_weights(cpu_model, 0, initializer_range=0.5)
    card_model = VLPForPreTraining(bert, image_cfg, len_vis_input=4)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model = card_model.to(cuda_device).eval()
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    settings = decoder.DecodeSettings(max_txt_length=6, mask_word_id=4,
                                      eos_id=3)
    before = tfl.fused_ln_fwd.launches
    with torch.inference_mode():
        want_ids, want_lp, _ = decoder.greedy_decode(cpu_model.eval(), img,
                                                     settings, 2, 3)
        got_ids, got_lp, _ = decoder.greedy_decode(
            card_model, img.to(cuda_device), settings, 2, 3)
    assert tfl.fused_ln_fwd.launches - before == 2 * 2 * (1 + 6)
    assert torch.equal(got_ids.cpu(), want_ids)
    torch.testing.assert_close(got_lp.cpu(), want_lp, rtol=0, atol=1e-4)


def _bf16_tol(want: torch.Tensor) -> float:
    """One bf16 ulp of the largest magnitude: the LN kernels and their
    plain versions compute in f32 from the same inputs and round once."""
    return 2.0 ** -7 * want.float().abs().max().item()


def _ln_bwd_inputs(device, rows, h, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x, res, dy = (torch.randn(rows, h, device=device,
                              generator=gen).to(dtype) for _ in range(3))
    gamma, beta = (torch.randn(h, device=device, generator=gen)
                   for _ in range(2))
    return x, res, gamma, beta, dy


def _check_ln_backward(x, res, gamma, beta, dy, kw):
    """K4 once against its plain version and against autograd through the
    plain forward.  dx, dres: f32 1e-5 (1e-4 against autograd), bf16 one
    ulp; dgamma/dbeta sum over rows in another order: 1e-6 per row and at
    least 16 rows' worth (one row's dy * xhat reaches ~16, where the two
    sides' rstd, 1/sqrtf against rsqrt, differ by a few f32 ulps).  dx is
    zero where the forward dropped x."""
    rows, h = x.shape
    before = tfl.fused_ln_bwd.launches
    got = tfl.fused_ln_bwd(x, res, gamma, dy, **kw)
    torch.cuda.synchronize()
    assert tfl.fused_ln_bwd.launches == before + 1
    want = tfl.fused_dropout_add_ln_bwd_plain(x, res, gamma, dy, **kw)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, res, gamma, beta)]
    auto = torch.autograd.grad(
        tfl.fused_dropout_add_ln_plain(*leaves, **kw), leaves, dy)
    f32 = x.dtype == torch.float32
    for i, (g, w, a) in enumerate(zip(got, want, auto)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if i >= 2:
            tol = tol_auto = 1e-6 * max(rows, 16)
        else:
            tol = 1e-5 if f32 else _bf16_tol(w)
            tol_auto = 1e-4 if f32 else tol
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
        torch.testing.assert_close(g.float(), a.float(), rtol=0,
                                   atol=tol_auto)
    if kw["rate"] > 0:
        keep = tfl.keep_mask(kw["seed"], rows, h, kw["rate"], x.device)
        assert bool((got[0][~keep] == 0).all())


@pytest.mark.parametrize("rows", [1, 16, 2064, 15696, 15697])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ln_backward_kernel_matches_plain(cuda_device, rows, dtype, rate):
    """H = 768; rows from one to the training shape's 15696 and one more,
    which no block's share of K4's persistent grid divides."""
    _check_ln_backward(*_ln_bwd_inputs(cuda_device, rows, 768, dtype,
                                       rows + 1),
                       dict(rate=rate, eps=1e-12, seed=5))


@pytest.mark.parametrize("rows", [1, 16, 15697])
@pytest.mark.parametrize("h,dtype", [(32, torch.float32),
                                     (1024, torch.float32),
                                     (1024, torch.bfloat16),
                                     (256, torch.bfloat16)])
def test_ln_backward_kernel_at_other_widths(cuda_device, rows, h, dtype):
    """K4's other instantiations (chunks a lane holds): the f32 test width
    32, the widest row 1024, and 256 (one chunk a lane in bf16); rate
    0.1."""
    _check_ln_backward(*_ln_bwd_inputs(cuda_device, rows, h, dtype, h + rows),
                       dict(rate=0.1, eps=1e-12, seed=6))


def test_ln_backward_kernel_is_deterministic(cuda_device):
    """dgamma/dbeta are summed over K4's blocks in a fixed order, with no
    floating-point atomics: two calls agree bit for bit, and so do calls
    replayed from a CUDA graph (its tickets are left at zero)."""
    x, res, gamma, _, dy = _ln_bwd_inputs(cuda_device, 15696, 768,
                                          torch.bfloat16, 3)
    kw = dict(rate=0.1, eps=1e-12, seed=7)
    first, second = (tfl.fused_ln_bwd(x, res, gamma, dy, **kw)
                     for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfl.fused_ln_bwd(x, res, gamma, dy, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = tfl.fused_ln_bwd(x, res, gamma, dy, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b, c in zip(first, second, captured):
            assert torch.equal(a, b) and torch.equal(a, c)


def _attn_inputs(device, B, L, heads, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, L, heads, tfa.HEAD_DIM, device=device,
                        generator=gen).to(dtype) for _ in range(4)]


ATTN_CASES = ([(tfa.FAMILY_PRETRAIN, v) for v in range(5)]
              + [(tfa.FAMILY_SEQ2SEQ, v) for v in range(3)])


def _check_attention(q, k, v, do, spec, kw):
    """K1 and K2 once each against the plain versions.  f32: o 1e-5, lse
    and grads 1e-4 (summation order over L); bf16: the worst case of where
    the kernels round (tfa.bf16_tolerances), lse 1e-4."""
    before = (tfa.attn_fwd.launches, tfa.attn_bwd.launches)
    o, lse = tfa.attn_fwd(q, k, v, spec, **kw)
    grads = tfa.attn_bwd(q, k, v, o, do, lse, spec, **kw)
    torch.cuda.synchronize()
    assert (tfa.attn_fwd.launches, tfa.attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_o, want_lse = tfa.attn_fwd_plain(q, k, v, spec, **kw)
    want = dict(zip(("dq", "dk", "dv"),
                    tfa.attn_bwd_plain(q, k, v, o, do, lse, spec, **kw)))
    if q.dtype == torch.float32:
        tol = {"o": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
    else:
        tol = tfa.bf16_tolerances(q, k, v, o, do, lse, spec,
                                  {"o": want_o, **want}, **kw)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0,
                               atol=tol["o"])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    for name, g in zip(("dq", "dk", "dv"), grads):
        torch.testing.assert_close(g.float(), want[name].float(), rtol=0,
                                   atol=tol[name])


@pytest.mark.parametrize("family,variant", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_match_plain(cuda_device, family, variant, dtype,
                                       rate):
    """K1 (o, lse) and K2 (dq, dk, dv) against the plain versions at a
    ragged L (two full key tiles and a partial one)."""
    B, L, heads, img_block = 3, 150, 2, 22
    q, k, v, do = _attn_inputs(cuda_device, B, L, heads, dtype, variant + 7)
    spec = torch.tensor([[variant, t] for t in (5, 60, 200)],
                        dtype=torch.int32, device=cuda_device)
    _check_attention(q, k, v, do, spec, dict(
        img_block=img_block, l_real=L, family=family, rate=rate, seed=31))


@pytest.mark.parametrize("head_dim", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_take_narrow_heads(cuda_device, head_dim, dtype):
    """A head narrower than the kernels' 64 (test-tiny's 16) is padded to
    64 around the launch: K1 and K2 (one launch each) against the plain
    versions at that width, rate 0.1, BAR, a ragged L; the outputs keep
    the narrow shape."""
    B, L, heads, img_block = 3, 150, 2, 22
    gen = torch.Generator(device=cuda_device).manual_seed(head_dim)
    q, k, v, do = (torch.randn(B, L, heads, head_dim, device=cuda_device,
                               generator=gen).to(dtype) for _ in range(4))
    spec = torch.tensor([[2, t] for t in (5, 60, 128)], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(img_block=img_block, l_real=L, family=tfa.FAMILY_PRETRAIN,
              rate=0.1, seed=5)
    _check_attention(q, k, v, do, spec, kw)
    o, _ = tfa.attn_fwd(q, k, v, spec, **kw)
    assert o.shape == q.shape and o.is_contiguous()


@pytest.mark.parametrize("family,variant", ATTN_CASES)
@pytest.mark.parametrize("L", [1, 63, 64, 65, 150, 436])
@pytest.mark.parametrize("edge", ["inside", "on"])
def test_bf16_attention_kernels_at_tile_edges(cuda_device, family, variant,
                                              L, edge):
    """bf16, rate 0.1: L at and around the 64-row tile, the image block
    ending inside a tile or on a tile boundary, so the causal text block
    starts mid-tile or at a tile's first row (and whole pairs skip)."""
    img_block = (min(22, L) if edge == "inside" else min(64, L))
    if family == tfa.FAMILY_PRETRAIN:
        txts = (min(1, L - img_block), L - img_block)
    else:
        txts = (min(img_block + 1, L), L)
    spec = torch.tensor([[variant, t] for t in txts], dtype=torch.int32,
                        device=cuda_device)
    q, k, v, do = _attn_inputs(cuda_device, 2, L, 2, torch.bfloat16, L)
    _check_attention(q, k, v, do, spec, dict(
        img_block=img_block, l_real=L, family=family, rate=0.1, seed=L))


@pytest.mark.parametrize("family,variant", ATTN_CASES)
@pytest.mark.parametrize("edge", ["inside", "on"])
@pytest.mark.parametrize("l_real", [200, 130])
def test_bf16_kernels_skip_the_predicates_tile_pairs(cuda_device, family,
                                                     variant, edge, l_real):
    """The (query tile, key tile) pairs that K1 and both K2 tile kernels
    skip, read back by NaN probes (tfa.skipped_tiles), are exactly the
    pairs masks.tile_skippable marks: the CUDA Spec::skip against its
    twin.  L = 200 (four key tiles), the image block ending inside a tile
    or on its edge, l_real = L or short of the last key tile."""
    L = 200
    img_block = 22 if edge == "inside" else 64
    if family == tfa.FAMILY_PRETRAIN:
        txts = (1, L - img_block)
    else:
        txts = (img_block + 1, L)
    spec = torch.tensor([[variant, t] for t in txts], dtype=torch.int32,
                        device=cuda_device)
    q, k, v, do = _attn_inputs(cuda_device, 2, L, 2, torch.bfloat16, 3)
    kw = dict(img_block=img_block, l_real=l_real, family=family)
    want = tmasks.tile_skip_grid(family, spec, img_block, l_real, L,
                                 tfa.TILE)[:, None].to(cuda_device)
    for name, got in tfa.skipped_tiles(q, k, v, do, spec, **kw).items():
        assert torch.equal(got, want.expand_as(got)), name


def test_f32_kernels_skip_no_tile_pair(cuda_device):
    """The f32 kernels keep the first version's code, which computes every
    pair, also those the predicate marks (BAR, L = 200)."""
    L, img_block = 200, 64
    spec = torch.tensor([[2, 1], [2, L - img_block]], dtype=torch.int32,
                        device=cuda_device)
    assert tmasks.tile_skip_grid(tfa.FAMILY_PRETRAIN, spec, img_block, L,
                                 L).any()
    q, k, v, do = _attn_inputs(cuda_device, 2, L, 2, torch.float32, 4)
    read = tfa.skipped_tiles(q, k, v, do, spec, img_block=img_block,
                             l_real=L, family=tfa.FAMILY_PRETRAIN)
    assert not any(got.any() for got in read.values())


def test_bf16_attention_backward_is_deterministic(cuda_device):
    """K2 has one writer per output element: two calls agree bit for
    bit."""
    B, L, heads = 4, 436, 3
    q, k, v, do = _attn_inputs(cuda_device, B, L, heads, torch.bfloat16, 5)
    spec = torch.tensor([[2, t] for t in (1, 80, 200, 254)],
                        dtype=torch.int32, device=cuda_device)
    kw = dict(img_block=182, l_real=L, family=tfa.FAMILY_PRETRAIN, rate=0.1,
              seed=8)
    o, lse = tfa.attn_fwd(q, k, v, spec, **kw)
    first = tfa.attn_bwd(q, k, v, o, do, lse, spec, **kw)
    second = tfa.attn_bwd(q, k, v, o, do, lse, spec, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_dropout_mask_is_the_plain_mask(cuda_device, dtype):
    """With q = k = 0 every visible cell of a FULL row gets p = 1/L; with V
    one-hot over a window of 64 keys, O[r, d] > 0 iff key c0 + d was kept,
    so the kernel's keep mask reads back bit for bit."""
    B, L, heads, rate, seed = 2, 150, 3, 0.1, 1234
    q = torch.zeros(B, L, heads, tfa.HEAD_DIM, device=cuda_device,
                    dtype=dtype)
    spec = torch.tensor([[0, L]] * B, dtype=torch.int32, device=cuda_device)
    mask = tfa.keep_mask(seed, B, heads, L, rate, cuda_device)
    for c0 in range(0, L, tfa.HEAD_DIM):
        w = min(tfa.HEAD_DIM, L - c0)
        v = torch.zeros_like(q)
        v[:, c0:c0 + w, :, :w] = torch.eye(w, device=cuda_device,
                                           dtype=dtype)[:, None]
        o, _ = tfa.attn_fwd(q, q, v, spec, img_block=2, l_real=L,
                            family=tfa.FAMILY_PRETRAIN, rate=rate, seed=seed)
        got = (o[..., :w] > 0).permute(0, 2, 1, 3)  # [B, heads, r, d]
        assert torch.equal(got, mask[..., c0:c0 + w])


def test_flash_mha_training_step_on_card(cuda_device):
    """flash_mha forward + backward through autograd launch K1 once and K2
    once and agree with autograd through the plain forward (f32)."""
    q, k, v, _ = _attn_inputs(cuda_device, 2, 70, 2, torch.float32, 3)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    spec = torch.tensor([[2, 20], [1, 40]], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(img_block=10, l_real=70)
    before = (tfa.attn_fwd.launches, tfa.attn_bwd.launches)
    out = tfa.flash_mha(*leaves, spec, dropout_rate=0.1, seed=3,
                        deterministic=False, **kw)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    assert (tfa.attn_fwd.launches, tfa.attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    clones = [t.detach().clone().requires_grad_() for t in leaves]
    ref, _ = tfa.attn_fwd_plain(*clones, spec, family=tfa.FAMILY_PRETRAIN,
                                rate=0.1, seed=3, **kw)
    want = torch.autograd.grad((ref ** 2).sum(), clones)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


def _finetune_batch(device, cfg, seed):
    """Rows in the s2s, bi and bar modes (spec ids 1, 0, 2) with their
    n_tokens, 3 masked positions each (the last row's third padded)."""
    gen = torch.Generator().manual_seed(seed)
    B, L = 3, cfg.max_seq_length
    spec = torch.tensor([[1, 14], [0, 20], [2, 17]], dtype=torch.int32)
    pos = torch.tensor([[7, 9, 13], [6, 11, 19], [8, 16, 0]])
    batch = dict(
        image=torch.randint(0, 256, (B, 64, 64, 3), generator=gen,
                            dtype=torch.uint8),
        input_ids=torch.randint(5, 64, (B, L), generator=gen),
        segment_ids=torch.tensor([[4] * 6 + [5] * 18, [0] * 6 + [1] * 18,
                                  [0] * 6 + [1] * 18]),
        mask_spec=spec, masked_pos=pos,
        masked_ids=torch.randint(5, 64, (B, 3), generator=gen),
        masked_weights=torch.tensor([[1.0] * 3, [1.0] * 3, [1.0, 1.0, 0.0]]),
        task_idx=torch.tensor([3, 0, 3]))
    return {k: v.to(device) for k, v in batch.items()}


def test_finetune_step_kernels_match_plain_on_card(cuda_device, monkeypatch):
    """One report-generation micro-step in f32 (2 layers of 2 x 64 heads,
    24 positions, train-mode BatchNorm, dropout 0.1, label smoothing 0.1)
    through K1-K4 against the same step with the plain versions swapped in,
    from the same weights and seeds: 2 K1, 2 K2, 4 K3 and 4 K4 launches;
    the loss within 1e-4 relative and every gradient within 1e-3 of its
    tensor's largest entry (a key bias, whose exact gradient is 0, of its
    layer's key weights'), chip_smoke.py train-parity's f32 tolerances."""
    from medvill_torch.config import FinetuneConfig
    from medvill_torch.models import bert as bert_lib
    from medvill_torch.ops.dropout import DropoutRNG
    from medvill_torch.train import finetune as tft

    bert = dataclasses.replace(
        BertConfig.vlp(BertConfig(vocab_size=64, hidden_size=128,
                                  num_hidden_layers=2, num_attention_heads=2,
                                  intermediate_size=256,
                                  compute_dtype="float32")), fused_ln=True)
    cfg = FinetuneConfig(bert=bert, image=ImageEncoderConfig(
        img_size=64, num_image_embeds=4, encoder="full-fiber"),
        len_vis_input=4, max_seq_length=24, max_pred=3, img_size=64)
    model = tft.build_model(cfg)
    init_weights(model, 0, initializer_range=0.1)
    model.to(cuda_device)
    batch = _finetune_batch(cuda_device, cfg, 0)
    buffers = {k: v.clone() for k, v in model.named_buffers()}

    def plain_attention(q, k, v, bias, rng=None, deterministic=True):
        seed = rng.next_seed()
        return tfa.attn_fwd_plain(q, k, v, batch["mask_spec"], img_block=6,
                                  l_real=q.shape[1],
                                  family=tfa.FAMILY_SEQ2SEQ, rate=0.1,
                                  seed=seed)[0]

    out = {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(buffers[k])
        if path == "plain":
            monkeypatch.setattr(bert_lib, "fused_dropout_add_ln",
                                tfl.fused_dropout_add_ln_plain)
        before = (tfa.attn_fwd.launches, tfa.attn_bwd.launches,
                  tfl.fused_ln_fwd.launches, tfl.fused_ln_bwd.launches)
        loss, _ = tft.finetune_loss_and_metrics(
            model, batch, DropoutRNG(3, cuda_device), cfg,
            attention_fn=plain_attention if path == "plain" else None)
        loss.backward()
        after = (tfa.attn_fwd.launches, tfa.attn_bwd.launches,
                 tfl.fused_ln_fwd.launches, tfl.fused_ln_bwd.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [2, 2, 4, 4] if path == "kernel" else [0, 0, 0, 0])
        out[path] = (loss.item(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None})
    (k_loss, k_grads), (p_loss, p_grads) = out["kernel"], out["plain"]
    assert np.isfinite(k_loss)
    assert abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)
    assert k_grads.keys() == p_grads.keys()
    for name, w in p_grads.items():
        ref = (p_grads[name[:-len("bias")] + "weight"]
               if name.endswith("attention.self.key.bias") else w)
        torch.testing.assert_close(k_grads[name], w, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())


def test_bertadam_on_card_matches_cpu(cuda_device):
    """Three BertAdam updates (lr 1e-3, t_total 4, both decay groups, one
    tensor without a gradient) on the card and on the CPU from the same
    parameters and gradients: within 1e-6."""
    from medvill_torch.train.optim import BertAdam

    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(64, 32, generator=gen), torch.randn(32, generator=gen),
            torch.randn(16, 8, generator=gen)]
    grads = [[torch.randn(p.shape, generator=gen) * 3 for p in init[:2]]
             for _ in range(3)]
    result = []
    for device in ("cpu", cuda_device):
        params = [torch.nn.Parameter(p.clone().to(device)) for p in init]
        opt = BertAdam([{"params": params[:1] + params[2:],
                         "weight_decay": 0.01},
                        {"params": params[1:2], "weight_decay": 0.0}],
                       lr=1e-3, t_total=4, weight_decay=0.01)
        for step_grads in grads:
            for p, g in zip(params, step_grads):
                p.grad = g.to(device)
            opt.step()
            opt.zero_grad(set_to_none=True)
        result.append([p.detach().cpu() for p in params])
    for a, b in zip(*result):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_at_the_mmbt_call(cuda_device, dtype, rate):
    """K1 and K2 at the classification step's call: B = 56, L = 258 + 256 =
    514 (the last tile holds 2 rows), FULL, img_block 258, text lengths
    1..256 (the key tiles of the padding skipped in bf16), against the
    plain versions."""
    B, L, img_block = 56, 514, 258
    q, k, v, do = _attn_inputs(cuda_device, B, L, 12, dtype, 56)
    txt = torch.randint(1, L - img_block + 1, (B,),
                        generator=torch.Generator().manual_seed(56))
    spec = torch.stack([torch.zeros_like(txt), txt], 1).to(
        device=cuda_device, dtype=torch.int32)
    _check_attention(q, k, v, do, spec, dict(
        img_block=img_block, l_real=L, family=tfa.FAMILY_PRETRAIN,
        rate=rate, seed=5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_at_the_retrieval_call(cuda_device, dtype, rate):
    """K1 and K2 at the retrieval training call: 70 positives and 70
    negatives, B = 140 (the grid's z extent), L = 1 + 180 + 1 + 254 = 436
    (7 query tiles, the last of 52 rows), FULL, img_block 182, text lengths
    uniform in 1..254, against the plain versions; in bf16 the tile pairs
    skipped (read back) are the predicate's."""
    B, L, img_block = 140, 436, 182
    q, k, v, do = _attn_inputs(cuda_device, B, L, 12, dtype, 140)
    txt = torch.randint(1, L - img_block + 1, (B,),
                        generator=torch.Generator().manual_seed(140))
    spec = torch.stack([torch.zeros_like(txt), txt], 1).to(
        device=cuda_device, dtype=torch.int32)
    kw = dict(img_block=img_block, l_real=L, family=tfa.FAMILY_PRETRAIN)
    _check_attention(q, k, v, do, spec, dict(kw, rate=rate, seed=7))
    if dtype == torch.bfloat16:
        want = tmasks.tile_skip_grid(tfa.FAMILY_PRETRAIN, spec, img_block,
                                     L, L, tfa.TILE)[:, None].to(cuda_device)
        assert want.any()
        for name, got in tfa.skipped_tiles(q, k, v, do, spec, **kw).items():
            assert torch.equal(got, want.expand_as(got)), name


def test_retrieval_step_on_card(cuda_device):
    """One retrieval micro-step in f32 (a CXRBERT of 2 layers of 2 x 64
    heads, 4 image embeds, 12 text positions, the frozen trunk in train
    mode, dropout 0.1, 3 pairs) through K1/K2 against the same step with
    the plain attention swapped in, from the same weights and seeds: 2 K1
    and 2 K2 launches per micro-step and 2 K1 per scored batch; the loss
    within 1e-4 relative and every gradient within 1e-3 of its tensor's
    largest entry (a key bias of its layer's key weights')."""
    from medvill_torch.config import RetrievalConfig
    from medvill_torch.ops.dropout import DropoutRNG
    from medvill_torch.train import retrieve as tret

    bert = BertConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      compute_dtype="float32")
    cfg = RetrievalConfig(bert=bert, image=ImageEncoderConfig(
        img_size=64, num_image_embeds=4), seq_len=11, img_size=64)
    model = tret.build_model(cfg)
    init_weights(model, 0, initializer_range=0.1)
    model.to(cuda_device)
    gen = torch.Generator().manual_seed(2)
    B, T = 6, 12
    txt = torch.tensor([3, 12, 7, 1, 12, 5])
    batch = {k: v.to(cuda_device) for k, v in dict(
        cls_tok=torch.full((B, 1), 2), sep_tok=torch.full((B, 1), 3),
        input_txt=torch.randint(5, 64, (B, T), generator=gen),
        mask_spec=torch.stack([torch.zeros_like(txt), txt], 1).int(),
        segment=torch.ones(B, T, dtype=torch.long),
        image=torch.randint(0, 256, (B, 64, 64, 3), generator=gen,
                            dtype=torch.uint8),
        is_aligned=torch.tensor([1, 1, 1, 0, 0, 0])).items()}
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    pix = torch.arange(4, device=cuda_device)

    def plain_attention(q, k, v, bias, rng=None, deterministic=True):
        return tfa.attn_fwd_plain(q, k, v, batch["mask_spec"], img_block=6,
                                  l_real=q.shape[1],
                                  family=tfa.FAMILY_PRETRAIN, rate=0.1,
                                  seed=rng.next_seed())[0]

    def launches():
        return (tfa.attn_fwd.launches, tfa.attn_bwd.launches)

    out = {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(buffers[k])
        before = launches()
        loss, _ = tret.loss_and_metrics(
            model, batch, DropoutRNG(3, cuda_device), pix, cfg,
            attention_fn=plain_attention if path == "plain" else None)
        loss.backward()
        assert [a - b for a, b in zip(launches(), before)] == (
            [2, 2] if path == "kernel" else [0, 0])
        out[path] = (loss.item(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None})
    before = launches()
    scores = tret.make_score_step(cfg)(model, batch)
    assert [a - b for a, b in zip(launches(), before)] == [2, 0]
    assert scores.shape == (B,) and bool(((scores >= 0) & (scores <= 1))
                                         .all())
    (k_loss, k_grads), (p_loss, p_grads) = out["kernel"], out["plain"]
    assert np.isfinite(k_loss)
    assert abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)
    assert k_grads.keys() == p_grads.keys() and len(k_grads) == 2 * 16 + 11
    for name, w in p_grads.items():
        ref = (p_grads[name[:-len("bias")] + "weight"]
               if name.endswith("attention.self.key.bias") else w)
        torch.testing.assert_close(k_grads[name], w, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())


def test_mmbt_step_on_card(cuda_device, monkeypatch):
    """One classification micro-step in f32 (2 layers of 2 x 64 heads, 4
    image embeds and 12 text positions, the trunk trained with train-mode
    BatchNorm, dropout 0.1, weighted BCE) through K1-K4 against the same
    step with the plain versions swapped in, from the same weights and
    seeds: 2 K1, 2 K2, 4 K3 and 4 K4 launches per micro-step and 2 K1 per
    eval batch; the loss within 1e-4 relative and every gradient within
    1e-3 of its tensor's largest entry (a key bias of its layer's key
    weights'), chip_smoke.py train-parity's f32 tolerances."""
    from medvill_torch.config import ClassificationConfig
    from medvill_torch.models import bert as bert_lib
    from medvill_torch.models.mmbt import full_spec
    from medvill_torch.ops.dropout import DropoutRNG
    from medvill_torch.train import classify as tclf

    bert = BertConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      compute_dtype="float32", fused_ln=True)
    cfg = ClassificationConfig(
        bert=bert, image=ImageEncoderConfig(img_size=64, num_image_embeds=4,
                                            encoder="full-fiber"),
        num_image_embeds=4, max_seq_len=16, img_size=64,
        labels=("a", "b", "c"))
    model = tclf.build_model(cfg, 3)
    init_weights(model, 0, initializer_range=0.1)
    model.to(cuda_device)
    gen = torch.Generator().manual_seed(1)
    B, T = 3, 12
    batch = {k: v.to(cuda_device) for k, v in dict(
        input_txt=torch.randint(5, 64, (B, T), generator=gen),
        txt_len=torch.tensor([3, 12, 7]),
        segment=torch.ones(B, T, dtype=torch.long),
        image=torch.randint(0, 256, (B, 64, 64, 3), generator=gen,
                            dtype=torch.uint8),
        label=torch.tensor([[1.0, 0, 1], [0, 1, 0], [1, 1, 0]])).items()}
    pw = torch.tensor([2.0, 0.5, 1.0], device=cuda_device)
    buffers = {k: v.clone() for k, v in model.named_buffers()}

    def plain_attention(q, k, v, bias, rng=None, deterministic=True):
        return tfa.attn_fwd_plain(q, k, v, full_spec(batch["txt_len"]),
                                  img_block=6, l_real=q.shape[1],
                                  family=tfa.FAMILY_PRETRAIN, rate=0.1,
                                  seed=rng.next_seed())[0]

    def launches():
        return (tfa.attn_fwd.launches, tfa.attn_bwd.launches,
                tfl.fused_ln_fwd.launches, tfl.fused_ln_bwd.launches)

    out = {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(buffers[k])
        if path == "plain":
            monkeypatch.setattr(bert_lib, "fused_dropout_add_ln",
                                tfl.fused_dropout_add_ln_plain)
        before = launches()
        loss, _ = tclf.loss_and_logits(
            model, batch, DropoutRNG(3, cuda_device), cfg, pw, 2, 3,
            attention_fn=plain_attention if path == "plain" else None)
        loss.backward()
        assert [a - b for a, b in zip(launches(), before)] == (
            [2, 2, 4, 4] if path == "kernel" else [0, 0, 0, 0])
        out[path] = (loss.item(), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters()})
    monkeypatch.undo()
    before = launches()
    logits = tclf.make_eval_step(cfg, 2, 3)(model, batch)
    assert [a - b for a, b in zip(launches(), before)] == [2, 0, 4, 0]
    assert logits.shape == (3, 3) and bool(torch.isfinite(logits).all())
    (k_loss, k_grads), (p_loss, p_grads) = out["kernel"], out["plain"]
    assert np.isfinite(k_loss)
    assert abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)
    assert len(k_grads) == len(p_grads) > 159  # the trunk's 159 included
    for name, w in p_grads.items():
        ref = (p_grads[name[:-len("bias")] + "weight"]
               if name.endswith("attention.self.key.bias") else w)
        torch.testing.assert_close(k_grads[name], w, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())


def test_dispatch_loader_on_card(cuda_device):
    """The prefetching pipeline on the card: the batches come out in the
    loader's order, on the card, equal to the numpy ones, only the keys
    asked for; an early exit releases the producer."""
    import threading

    from medvill_torch.data.pretrain import dispatch_loader

    batches = [{"x": np.full((4, 3), i, np.int32),
                "y": np.arange(6, dtype=np.float32) * i} for i in range(6)]
    out = list(dispatch_loader(batches, cuda_device, keys=("x",)))
    assert len(out) == 6 and not any(g for _, g in out)
    for i, (b, _) in enumerate(out):
        assert set(b) == {"x"} and b["x"].device.type == "cuda"
        assert torch.equal(b["x"].cpu(), torch.from_numpy(batches[i]["x"]))
    groups = list(dispatch_loader(batches[:5], cuda_device, k=2))
    assert [g for _, g in groups] == [True, True, False]
    assert torch.equal(groups[1][0]["y"].cpu(), torch.from_numpy(
        np.stack([batches[2]["y"], batches[3]["y"]])))
    before = threading.active_count()
    it = iter(dispatch_loader(batches * 20, cuda_device))
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


# --- k micro-steps per dispatch: device seeds and CUDA graphs -----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_from_a_device_seed_equal_the_host_seed(cuda_device, dtype):
    """K1-K4 at rate 0.1 launched with the seed s as a host int and as a
    device word holding s - add with the call constant add: bit-identical
    outputs."""
    from medvill_torch.ops.dropout import GOLDEN, DeviceSeed

    s, add = 0x5EED1234, (7 * GOLDEN) & 0xFFFFFFFF
    base = np.array([(s - add) & 0xFFFFFFFF], np.uint32).view(np.int32)
    dev = DeviceSeed(torch.from_numpy(base).to(cuda_device), add)
    q, k, v, do = _attn_inputs(cuda_device, 2, 150, 12, dtype, 3)
    spec = torch.tensor([[0, 100], [2, 120]], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(img_block=6, l_real=150, family=tfa.FAMILY_PRETRAIN, rate=0.1)
    o1, lse1 = tfa.attn_fwd(q, k, v, spec, seed=s, **kw)
    o2, lse2 = tfa.attn_fwd(q, k, v, spec, seed=dev, **kw)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    for a, b in zip(tfa.attn_bwd(q, k, v, o1, do, lse1, spec, seed=s, **kw),
                    tfa.attn_bwd(q, k, v, o1, do, lse1, spec, seed=dev,
                                 **kw)):
        assert torch.equal(a, b)
    x, res, gamma, beta, dy = _ln_bwd_inputs(cuda_device, 2064, 768, dtype, 4)
    lk = dict(rate=0.1, eps=1e-5)
    assert torch.equal(tfl.fused_ln_fwd(x, res, gamma, beta, seed=s, **lk),
                       tfl.fused_ln_fwd(x, res, gamma, beta, seed=dev, **lk))
    for a, b in zip(tfl.fused_ln_bwd(x, res, gamma, dy, seed=s, **lk),
                    tfl.fused_ln_bwd(x, res, gamma, dy, seed=dev, **lk)):
        assert torch.equal(a, b)


def _tiny_finetune(rate):
    from medvill_torch.config import FinetuneConfig

    bert = dataclasses.replace(
        BertConfig.vlp(BertConfig(vocab_size=64, hidden_size=128,
                                  num_hidden_layers=2, num_attention_heads=2,
                                  intermediate_size=256,
                                  hidden_dropout_prob=rate,
                                  attention_probs_dropout_prob=rate,
                                  compute_dtype="float32")), fused_ln=True)
    return FinetuneConfig(bert=bert, image=ImageEncoderConfig(
        img_size=64, num_image_embeds=4, encoder="full-fiber"),
        len_vis_input=4, max_seq_length=24, max_pred=3, img_size=64)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_captured_finetune_micro_steps_equal_eager(cuda_device, rate):
    """A 2-layer report-generation model (fused_ln, f32): two dispatches of
    k = 3 (CUDA graphs: the first micro-step eager, then the captured one
    replayed) against 6 eager micro-steps from the same weights, batches
    and seeds: losses, parameters and BatchNorm statistics within 1e-5 of
    their scale (bit-identical expected), 2/2/4/4 K1-K4 launches per
    micro-step on both paths (replays counted)."""
    from medvill_torch.train import dispatch
    from medvill_torch.train import finetune as tft

    cfg = _tiny_finetune(rate)
    batches = [_finetune_batch(cuda_device, cfg, i) for i in range(6)]
    runs = {}
    for path in ("eager", "graphed"):
        state = tft.init_state(cfg, t_total=10, seed=0, device=cuda_device)
        gen = torch.Generator().manual_seed(1)
        before = [f.launches for f in dispatch.COUNTED]
        if path == "eager":
            step = tft.make_train_step(cfg)
            losses = torch.stack([step(state, b, gen)["loss"]
                                  for b in batches])
        else:
            multi = dispatch.MultiStep(tft.make_train_step(cfg), 3)
            losses = torch.cat([multi(state, {
                k: torch.stack([b[k] for b in batches[i:i + 3]])
                for k in batches[0]}, gen)["loss"] for i in (0, 3)])
        launches = [f.launches - b for f, b in zip(dispatch.COUNTED, before)]
        assert launches == [12, 12, 24, 24], (path, launches)
        assert state.step == 6 and state.tx.optimizer.opt_step == 6
        runs[path] = (losses, state.model.state_dict())
    (le, sde), (lg, sdg) = runs["eager"], runs["graphed"]
    torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
    for name, t in sde.items():
        if t.is_floating_point():
            torch.testing.assert_close(
                sdg[name], t, rtol=0, atol=1e-5 * t.abs().max().item(),
                msg=name)
    if rate > 0:
        assert len(set(lg.tolist())) == 6


def _tiny_pretrain():
    from medvill_torch.config import PretrainConfig

    bert = dataclasses.replace(
        BertConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=256,
                   hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                   compute_dtype="float32"), fused_ln=True)
    return PretrainConfig(seq_len=15, bert=bert, batch_size=2,
                          gradient_accumulation_steps=2, lr=1e-3,
                          image=ImageEncoderConfig(
                              img_size=128, num_image_embeds=4,
                              img_hidden_size=64, encoder="random-pixel"))


def _pretrain_batch(device, cfg, seed):
    """A BAR batch of ``cfg``'s shapes, its tokens and labels drawn from
    ``seed``."""
    from medvill_torch.config import MaskVariant

    rng = np.random.default_rng(seed)
    B, S, I = cfg.batch_size, cfg.seq_len + 1, cfg.image.num_image_embeds + 2
    lens = rng.integers(3, S + 1, B)
    ids = rng.integers(5, 64, (B, S)) * (np.arange(S) < lens[:, None])
    labels = np.where((rng.random((B, S)) < 0.3)
                      & (np.arange(S) < lens[:, None] - 1), ids, -100)
    batch = dict(
        cls_tok=np.full((B, 1), 2), input_txt=ids,
        txt_labels=np.concatenate([np.full((B, I), -100), labels], 1),
        mask_spec=np.stack([np.full(B, int(MaskVariant.BAR)), lens], 1),
        image=rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8),
        segment=np.ones((B, S)), is_aligned=rng.integers(0, 2, B),
        sep_tok=np.full((B, 1), 3))
    return {k: torch.from_numpy(np.asarray(v)).to(device).to(
        torch.uint8 if k == "image" else torch.int32)
        for k, v in batch.items()}


def test_graphed_pixel_draws_wait_for_their_copy(cuda_device, monkeypatch):
    """The random-pixel draws of a graphed dispatch reach the card on the
    stream that reads them: with every pinned copy held behind ~0.1 s of
    work on the stream that was current when it was queued, three
    dispatches of k = 2 (a 2-layer pretrain model, f32, 16 fibers, 4
    drawn) still equal six eager micro-steps from the same weights,
    batches and draws: losses, parameters and BatchNorm statistics within
    1e-5 of their scale (bit-identical expected)."""
    from medvill_torch.train import dispatch
    from medvill_torch.train import pretrain as tpre

    cfg = _tiny_pretrain()
    batches = [_pretrain_batch(cuda_device, cfg, i) for i in range(6)]
    runs = {}
    for path in ("eager", "graphed"):
        state = tpre.init_state(cfg, seed=0, device=cuda_device)
        gen = torch.Generator().manual_seed(1)
        if path == "eager":
            step = tpre.make_train_step(cfg)
            losses = torch.stack([step(state, b, gen)["loss"]
                                  for b in batches])
        else:
            pin = torch.Tensor.pin_memory

            def slow_pin(t, *a, **kw):
                torch.cuda._sleep(2 ** 27)
                return pin(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, "pin_memory", slow_pin)
            multi = dispatch.MultiStep(tpre.make_train_step(cfg), 2)
            losses = torch.cat([multi(state, {
                k: torch.stack([b[k] for b in batches[i:i + 2]])
                for k in batches[0]}, gen)["loss"] for i in (0, 2, 4)])
            monkeypatch.undo()
        torch.cuda.synchronize()
        runs[path] = (losses, state.model.state_dict())
    (le, sde), (lg, sdg) = runs["eager"], runs["graphed"]
    torch.testing.assert_close(lg, le, rtol=1e-5, atol=0)
    for name, t in sde.items():
        if t.is_floating_point():
            torch.testing.assert_close(
                sdg[name], t, rtol=0, atol=1e-5 * t.abs().max().item(),
                msg=name)


def test_graphs_refuse_cpu_tensors(cuda_device):
    """The graphed path takes CUDA tensors only: a CPU group there raises
    (a CPU dispatch runs eagerly instead)."""
    from medvill_torch.train import dispatch
    from medvill_torch.train import finetune as tft

    cfg = _tiny_finetune(0.0)
    state = tft.init_state(cfg, t_total=10, seed=0, device="cpu")
    group = {k: v.cpu()[None] for k, v in
             _finetune_batch(cuda_device, cfg, 0).items()}
    multi = dispatch.MultiStep(tft.make_train_step(cfg), 1)
    with pytest.raises((ValueError, RuntimeError)):
        multi._replayed(state, group, [multi.micro.draw(
            torch.Generator().manual_seed(0))], torch.device("cpu"))


def test_capturable_adamw_matches_the_adamw_formula(cuda_device):
    """The port's AdamW on CUDA parameters (capturable: its step count on
    the device) over 3 steps, lr 1e-3, weight decay 0.01, against optax's
    adamw written out in float64 numpy (bias-corrected moments, eps outside
    the square root, decay added to the update): within 1e-6."""
    from medvill_torch.train.optim import adamw

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(64, 32, generator=gen)
    grads = [torch.randn(64, 32, generator=gen) for _ in range(3)]
    p = torch.nn.Parameter(p0.clone().to(cuda_device))
    opt = adamw([p], 1e-3, weight_decay=0.01)
    assert opt.param_groups[0]["capturable"]
    for g in grads:
        p.grad = g.to(cuda_device)
        opt.step()
    assert opt.state[p]["step"].is_cuda
    w, m, v = p0.double().numpy(), 0.0, 0.0
    for t, g in enumerate(grads, 1):
        g = g.double().numpy()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        u = (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t)) + 1e-6)
        w = w - 1e-3 * (u + 0.01 * w)
    np.testing.assert_allclose(p.detach().cpu().double().numpy(), w,
                               rtol=0, atol=1e-6)


def _snapshot(state, gen) -> dict:
    """The training state as ``checkpoint.save_training_state`` stores it,
    through torch.save and torch.load(weights_only=True)."""
    import io

    buf = io.BytesIO()
    torch.save({"model": {k: v.detach().cpu() for k, v in
                          state.model.state_dict().items()},
                "tx": state.tx.state_dict(), "step": state.step,
                "generator": gen.get_state()}, buf)
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def _restore(state, gen, snap) -> None:
    state.model.load_state_dict(snap["model"])
    state.tx.load_state_dict(snap["tx"])
    state.step = snap["step"]
    gen.set_state(snap["generator"])


@pytest.mark.parametrize("kind", ["pretrain-adamw", "finetune-bertadam"])
def test_restored_state_then_graphed_dispatch_equals_uninterrupted(
        cuda_device, kind):
    """A 2-layer model (f32, fused_ln), accumulation 2, dispatches of k = 3
    (CUDA graphs): the state after the first dispatch (one micro-batch
    accumulated: capturable AdamW's device step, or BertAdam's moments,
    opt_step and device lr; the gradients summed so far) is saved and
    restored (a) into the same state whose graphs are captured, in place,
    and (b) into a fresh state and MultiStep; the second dispatch from each
    equals the uninterrupted one's losses, parameters and BatchNorm
    statistics within 1e-5 of their scale (bit-identical expected), and
    (a) keeps every optimizer and gradient tensor it had."""
    from medvill_torch.train import dispatch
    from medvill_torch.train import finetune as tft
    from medvill_torch.train import pretrain as tpre

    if kind.startswith("pretrain"):
        cfg = _tiny_pretrain()
        batches = [_pretrain_batch(cuda_device, cfg, i) for i in range(6)]

        def make():
            return (tpre.init_state(cfg, seed=0, device=cuda_device),
                    tpre.make_train_step(cfg))
    else:
        cfg = dataclasses.replace(_tiny_finetune(0.1),
                                  gradient_accumulation_steps=2)
        batches = [_finetune_batch(cuda_device, cfg, i) for i in range(6)]

        def make():
            return (tft.init_state(cfg, t_total=10, seed=0,
                                   device=cuda_device),
                    tft.make_train_step(cfg))
    groups = [{k: torch.stack([b[k] for b in batches[i:i + 3]])
               for k in batches[0]} for i in (0, 3)]

    def second(state, multi, gen):
        loss = multi(state, groups[1], gen)["loss"]
        torch.cuda.synchronize()
        return loss.clone(), {k: v.clone() for k, v in
                              state.model.state_dict().items()}

    state, step = make()
    multi, gen = dispatch.MultiStep(step, 3), torch.Generator().manual_seed(1)
    multi(state, groups[0], gen)
    assert state.tx.count == 1
    snap = _snapshot(state, gen)
    want = second(state, multi, gen)
    held = [t for s in state.tx.optimizer.state.values() for t in s.values()
            if torch.is_tensor(t)] + [p.grad for p in
                                      state.model.parameters()]
    _restore(state, gen, snap)
    assert all(a is b for a, b in zip(held, [
        t for s in state.tx.optimizer.state.values() for t in s.values()
        if torch.is_tensor(t)] + [p.grad for p in state.model.parameters()]))
    in_place = second(state, multi, gen)
    fresh, step = make()
    gen = torch.Generator()
    _restore(fresh, gen, snap)
    if kind.startswith("pretrain"):
        assert all(s["step"].is_cuda
                   for s in fresh.tx.optimizer.state.values())
    restored = second(fresh, dispatch.MultiStep(step, 3), gen)
    for got in (in_place, restored):
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
        for name, t in want[1].items():
            if t.is_floating_point():
                torch.testing.assert_close(
                    got[1][name], t, rtol=0,
                    atol=1e-5 * t.abs().max().item(), msg=name)


def test_cpu_written_optim_file_restores_on_card(cuda_device, tmp_path):
    """A 2-layer pretrain run on the CPU (accumulation 2, 3 micro-steps)
    saved with ``checkpoint.save_training_state``: the files restore into a
    model on the card (capturable AdamW's step on the device, moments and
    the accumulated gradients equal the CPU's), and 3 more micro-steps
    there follow the CPU run's: losses within 1e-4 relative, every tensor
    but the key biases within 1e-4 of its scale."""
    from medvill_torch import checkpoint as ckpt
    from medvill_torch.data.pretrain import BatchLoader
    from medvill_torch.train import pretrain as tpre

    cfg = _tiny_pretrain()
    cpu = torch.device("cpu")
    batches = [_pretrain_batch(cpu, cfg, i) for i in range(6)]
    state, step = (tpre.init_state(cfg, seed=0, device=cpu),
                   tpre.make_train_step(cfg))
    gen = torch.Generator().manual_seed(1)
    for b in batches[:3]:
        step(state, b, gen)
    ckpt.save_training_state(str(tmp_path), 0, state, gen,
                             BatchLoader([], 1), in_epoch=True)
    card = tpre.init_state(cfg, seed=5, device=cuda_device)
    card_gen = torch.Generator()
    ckpt.restore_training_state(str(tmp_path), 0, card, card_gen)
    assert card.tx.count == 1 and card.step == 3
    for p, q in zip(state.model.parameters(), card.model.parameters()):
        assert q.is_cuda and torch.equal(p.detach(), q.detach().cpu())
        if p.requires_grad:
            assert torch.equal(p.grad, q.grad.cpu())
            for k, v in state.tx.optimizer.state[p].items():
                w = card.tx.optimizer.state[q][k]
                assert w.is_cuda and torch.equal(v.float(), w.cpu())
    for b in batches[3:]:
        want = step(state, b, gen)["loss"]
        got = step(card, {k: v.to(cuda_device) for k, v in b.items()},
                   card_gen)["loss"]
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0)
    for name, t in state.model.state_dict().items():
        # a key bias's exact gradient is 0 (softmax ignores a shift shared
        # by a row): Adam moves it by about lr on either device's rounding
        if t.is_floating_point() and not name.endswith(
                "attention.self.key.bias"):
            torch.testing.assert_close(
                card.model.state_dict()[name].cpu(), t, rtol=0,
                atol=1e-4 * max(t.abs().max().item(), 1e-6), msg=name)


def test_captured_phases_add_up_and_tracing_changes_nothing(cuda_device,
                                                           monkeypatch):
    """Phase marks (medvill_torch/utils/tracing.py): a 2-layer pretrain
    model (fused_ln, f32, accumulation 2), six dispatches of k = 2 (the
    first eager, the second captures both graphs and replays each once,
    then one replay of each per dispatch), the last four under the
    profiler with a ring of 3 event sets (so each graph's sets are reused):
    the marks time image, forward, backward, update and tail, each
    positive, one of each per replay, adding up to the replays' time
    within 5%; losses and K1-K4 launch counts equal an untraced twin's bit
    for bit."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from medvill_torch.train import dispatch
    from medvill_torch.train import pretrain as tpre
    from medvill_torch.utils import tracing

    monkeypatch.setattr(tracing, "RING", 3)
    cfg = _tiny_pretrain()
    batches = [_pretrain_batch(cuda_device, cfg, i) for i in range(12)]
    groups = [{k: torch.stack([b[k] for b in batches[i:i + 2]])
               for k in batches[0]} for i in range(0, 12, 2)]
    runs = {}
    for traced in (False, True):
        state = tpre.init_state(cfg, seed=0, device=cuda_device)
        multi = dispatch.MultiStep(tpre.make_train_step(cfg), 2)
        gen = torch.Generator().manual_seed(1)
        before = [f.launches for f in dispatch.COUNTED]
        out = [multi(state, g, gen)["loss"] for g in groups[:2]]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) if traced \
                else contextlib.nullcontext():
            out += [multi(state, g, gen)["loss"] for g in groups[2:]]
            torch.cuda.synchronize()
            snap = tracing.snapshot()
        runs[traced] = (torch.cat(out).cpu(), [
            f.launches - b for f, b in zip(dispatch.COUNTED, before)])
    tracing.refresh()
    assert torch.equal(runs[False][0], runs[True][0])
    assert runs[False][1] == runs[True][1]
    phases = snap["phases"]
    assert set(phases) == {"image", "forward", "backward", "update", "tail",
                           "replay"}
    assert phases["replay"]["replays"] == 8
    assert phases["update"]["replays"] == phases["tail"]["replays"] == 4
    for name, p in phases.items():
        assert p["ms"] > 0, name
    parts = sum(p["ms"] for n, p in phases.items() if n != "replay")
    assert parts == pytest.approx(phases["replay"]["ms"], rel=0.05)
    assert snap["counters"] == {"dispatch.replays": 8}
