"""The port's greedy decode against the JAX package's ``greedy_decode`` on a
tiny VLP model with the same weights: token-exact ids and log-probs within
1e-4 (f32 on both sides; the 2-layer stack, the ResNet trunk and the
vocabulary projection sum in different orders), in each
``window_positions`` mode, with the fused LN off and on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch.models import decoder as tdec
from medvill_tpu.models import decoder as jdec
from medvill_tpu.train import finetune as ft
from tests.torch_port_support import IMG, finetune_config, jax_vlp, torch_vlp

T = 5
CLS, SEP, MASK = 2, 3, 4
LOGP_TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    cfg = finetune_config()
    _, variables = jax_vlp(cfg, seed=0)
    img = np.random.default_rng(1).integers(0, 256, (3, IMG, IMG, 3),
                                            dtype=np.uint8)
    return variables, img


def _settings(mod, mode, **kw):
    return mod.DecodeSettings(max_txt_length=T, mask_word_id=MASK,
                              eos_id=SEP, window_positions=mode, **kw)


def _both(weights, fused_ln, mode, gt=None, teacher_forcing=False):
    variables, img = weights
    cfg = finetune_config(fused_ln=fused_ln)
    jmodel = ft.build_model(cfg)
    j_ids, j_logp, j_nll = jdec.greedy_decode(
        jmodel, variables, jnp.asarray(img), _settings(jdec, mode), CLS, SEP,
        gt_tokens=None if gt is None else jnp.asarray(gt),
        teacher_forcing=teacher_forcing)
    tmodel = torch_vlp(cfg, variables)
    with torch.inference_mode():
        t_ids, t_logp, t_nll = tdec.greedy_decode(
            tmodel, torch.from_numpy(img), _settings(tdec, mode), CLS, SEP,
            gt_tokens=None if gt is None else torch.from_numpy(gt),
            teacher_forcing=teacher_forcing)
    return ((np.asarray(j_ids), np.asarray(j_logp), np.asarray(j_nll)),
            (t_ids.numpy(), t_logp.numpy(), t_nll.numpy()))


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused-ln"])
@pytest.mark.parametrize("mode", ["reference", "train", "global"])
def test_greedy_decode_matches_jax(weights, fused_ln, mode):
    (j_ids, j_logp, _), (t_ids, t_logp, _) = _both(weights, fused_ln, mode)
    if mode != "global":
        # the fixture's weights must not collapse decode onto one token
        # (at positions vis+t the tiny model does, which is still a check)
        assert len(np.unique(j_ids)) > 2, j_ids
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_logp, j_logp, rtol=0, atol=LOGP_TOL)


def test_teacher_forced_gt_nll_matches_jax(weights):
    gt = np.random.default_rng(2).integers(5, 64, (3, T)).astype(np.int32)
    (j_ids, _, j_nll), (t_ids, _, t_nll) = _both(
        weights, False, "reference", gt=gt, teacher_forcing=True)
    np.testing.assert_array_equal(t_ids, j_ids)
    # random gt tokens sit ~20 nats down the softmax; f32 carries ~6
    # significant digits there, hence a relative term
    np.testing.assert_allclose(t_nll, j_nll, rtol=1e-5, atol=LOGP_TOL)


def test_sampling_with_generator(weights):
    """top_k=1 sampling is greedy; the same generator seed repeats the
    draw; sampling without a generator is refused."""
    variables, img = weights
    model = torch_vlp(finetune_config(), variables)
    image = torch.from_numpy(img)
    greedy = _settings(tdec, "reference")
    with torch.inference_mode():
        g_ids, _, _ = tdec.greedy_decode(model, image, greedy, CLS, SEP)
        top1 = _settings(tdec, "reference", sample_mode="sample", top_k=1)
        s_ids, _, _ = tdec.greedy_decode(
            model, image, top1, CLS, SEP,
            generator=torch.Generator().manual_seed(0))
        assert torch.equal(s_ids, g_ids)
        hot = _settings(tdec, "reference", sample_mode="sample",
                        temperature=5.0)
        a, _, _ = tdec.greedy_decode(model, image, hot, CLS, SEP,
                                     generator=torch.Generator().manual_seed(3))
        b, _, _ = tdec.greedy_decode(model, image, hot, CLS, SEP,
                                     generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="generator"):
            tdec.greedy_decode(model, image, hot, CLS, SEP)


@pytest.mark.parametrize("t", [0, 3])
def test_decode_masks_and_positions_match_jax(t):
    vis, L = 6, 12
    np.testing.assert_array_equal(
        tdec._window_bias(vis, t, L, "cpu").numpy(),
        np.asarray(jdec._window_bias(vis, t, L)))
    np.testing.assert_array_equal(
        tdec._prefill_bias(vis, L, "cpu").numpy(),
        np.asarray(jdec._prefill_bias(vis, L)))
    for mode in ("reference", "train", "global"):
        np.testing.assert_array_equal(
            tdec._window_positions(_settings(tdec, mode), vis, t, 2,
                                   "cpu").numpy(),
            np.asarray(jdec._window_positions(_settings(jdec, mode), vis,
                                              jnp.int32(t), 2)))
