"""medvill_torch on the card: the fused LN CUDA kernel against its plain
version, and a tiny model's decode on the card (kernel path) against the
CPU (plain path).  Every test here needs a CUDA device and nvcc and skips
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
from medvill_torch.models import decoder
from medvill_torch.models.seq2seq import VLPForPreTraining, init_weights
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
    before = tfl.fused_dropout_add_ln.launches
    got = tfl.fused_dropout_add_ln(x, res, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert tfl.fused_dropout_add_ln.launches == before + 1
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
    before = tfl.fused_dropout_add_ln.launches
    with torch.inference_mode():
        want_ids, want_lp, _ = decoder.greedy_decode(cpu_model.eval(), img,
                                                     settings, 2, 3)
        got_ids, got_lp, _ = decoder.greedy_decode(
            card_model, img.to(cuda_device), settings, 2, 3)
    assert tfl.fused_dropout_add_ln.launches - before == 2 * 2 * (1 + 6)
    assert torch.equal(got_ids.cpu(), want_ids)
    torch.testing.assert_close(got_lp.cpu(), want_lp, rtol=0, atol=1e-4)
