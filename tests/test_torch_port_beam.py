"""The port's beam search against the JAX package's ``beam_search`` on a tiny
VLP model with the same weights (f32, fused LN off and on in the port):
token-exact ids; best scores within 1e-5 relative plus one step's log-prob
tolerance of the greedy parity test (the two models' log-probs differ by up
to ~9e-5 at a step of this fixture, tests/test_torch_port_decode.py), and
within 1e-5 relative of the port's own teacher-forced rescoring of the
chosen tokens, which isolates the search's arithmetic.  Also against the NumPy
transcription of the reference's search in tests/test_beam_oracle.py driven
by a probe on the port's own model, and its pieces against JAX's: the
n-gram forbid mask and the tie order of the top-K."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch.models import decoder as tdec
from medvill_tpu.models import decoder as jdec
from medvill_tpu.train import finetune as ft
from tests.test_beam_oracle import reference_beam_search
from tests.torch_port_support import (IMG, VOCAB, finetune_config, jax_vlp,
                                      torch_vlp)
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

T, K, B = 6, 3, 2
CLS, SEP, MASK = 2, 3, 4
SCORE_RTOL = 1e-5
LOGP_TOL = 1e-4   # tests/test_torch_port_decode.py, per step
NEG = -10000.0


@pytest.fixture(scope="module")
def weights():
    cfg = finetune_config()
    _, variables = jax_vlp(cfg, seed=0)
    img = np.random.default_rng(1).integers(0, 256, (B, IMG, IMG, 3),
                                            dtype=np.uint8)
    # an EOS the model emits mid-sequence, so beams finish early and the
    # finished-beam paths run (tests/test_beam_oracle.py::_pick_eos)
    ids, _, _ = jdec.greedy_decode(
        ft.build_model(cfg), variables, jnp.asarray(img),
        jdec.DecodeSettings(max_txt_length=T, mask_word_id=MASK, eos_id=-1),
        CLS, SEP)
    return variables, img, int(np.asarray(ids)[0, 2])


def _cases(eos: int) -> dict:
    return {
        "default": dict(),
        "ngram-ignore": dict(forbid_duplicate_ngrams=True, ngram_size=2,
                             forbid_ignore_ids=(eos, 7), eos_id=eos),
        "penalty-minlen": dict(length_penalty=0.7, min_len=2, eos_id=eos),
        "early-eos": dict(eos_id=eos),
    }


def _settings(mod, **kw):
    base = dict(max_txt_length=T, mask_word_id=MASK, eos_id=SEP,
                beam_size=K)
    base.update(kw)
    return mod.DecodeSettings(**base)


@pytest.fixture(scope="module")
def jax_beams(weights):
    """JAX beam_search once per settings case (its loop compiles once)."""
    variables, img, eos = weights
    model = ft.build_model(finetune_config())
    out = {}
    for name, kw in _cases(eos).items():
        ids, scores = jdec.beam_search(model, variables, jnp.asarray(img),
                                       _settings(jdec, **kw), CLS, SEP)
        out[name] = (np.asarray(ids), np.asarray(scores))
    return out


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused-ln"])
@pytest.mark.parametrize("case", ["default", "ngram-ignore",
                                  "penalty-minlen", "early-eos"])
def test_beam_search_matches_jax(weights, jax_beams, case, fused_ln):
    variables, img, eos = weights
    model = torch_vlp(finetune_config(fused_ln=fused_ln), variables)
    with torch.inference_mode():
        ids, scores = tdec.beam_search(model, torch.from_numpy(img),
                                       _settings(tdec, **_cases(eos)[case]),
                                       CLS, SEP)
    j_ids, j_scores = jax_beams[case]
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=SCORE_RTOL,
                               atol=LOGP_TOL)
    np.testing.assert_allclose(
        scores.numpy(), _rescore(model, img, _cases(eos)[case], ids),
        rtol=SCORE_RTOL)
    if case == "early-eos":
        # some row's answer is an EOS event before the last step
        hits = [np.flatnonzero(r == eos) for r in j_ids]
        assert any(len(h) and h[0] < T - 1 for h in hits), j_ids


def _rescore(model, img: np.ndarray, kw: dict, ids: torch.Tensor
             ) -> np.ndarray:
    """Each row's score recomputed from teacher-forced greedy decode of its
    tokens: the log-probs up to its first EOS (or all T) plus the additive
    length penalty for that many tokens."""
    settings = _settings(tdec, **kw)
    with torch.inference_mode():
        _, _, nll = tdec.greedy_decode(model, torch.from_numpy(img), settings,
                                       CLS, SEP, gt_tokens=ids,
                                       teacher_forcing=True)
    out = []
    for row, row_nll in zip(ids.numpy(), nll.numpy()):
        hits = np.flatnonzero(row == settings.eos_id)
        n = hits[0] + 1 if len(hits) else T
        out.append(-row_nll[:n].sum() + settings.length_penalty * n)
    return np.array(out, np.float32)


def _port_probe(model, img: torch.Tensor, settings, n_rows: int):
    """logp(committed [n_rows, t]) -> [n_rows, V] by re-encoding the whole
    text window at global positions each call (no cache reuse), as
    tests/test_beam_oracle.py::make_probe does on the JAX model."""
    vis = model.len_vis_input + 2
    L = vis + T + 1
    with torch.inference_mode():
        prefilled = tdec._prefill(
            model, img.repeat_interleave(n_rows // img.shape[0], 0),
            settings, CLS, SEP, L)

    def probe(committed: np.ndarray) -> np.ndarray:
        t = committed.shape[1]
        with torch.inference_mode():
            # the window writes its K/V into the caches: a fresh copy each
            caches = [(k.clone(), v.clone()) for k, v in prefilled]
            W = t + 1
            ids = torch.full((n_rows, W), settings.mask_word_id)
            ids[:, :t] = torch.from_numpy(committed.astype(np.int64))
            pos = (vis + torch.arange(W)).expand(n_rows, W)
            types = torch.full((n_rows, W), settings.txt_type_id)
            c = torch.arange(L).view(1, 1, 1, L)
            r = vis + torch.arange(W).view(1, 1, W, 1)
            bias = torch.where((c < vis) | (c <= r), 0.0, NEG)
            logits, _ = model.decode_step(ids, pos, types, caches, vis, bias)
            return torch.log_softmax(logits.float(), -1).double().numpy()

    return probe


@pytest.mark.parametrize("case", ["plain", "penalty_minlen", "ngram"])
def test_beam_search_matches_reference_transcription(weights, case):
    variables, img, eos = weights
    model = torch_vlp(finetune_config(), variables)
    # the oracle's probe re-encodes prefixes at 'global' positions
    kw = dict(eos_id=eos, window_positions="global")
    if case == "penalty_minlen":
        kw.update(length_penalty=0.7, min_len=2)
    if case == "ngram":
        kw.update(forbid_duplicate_ngrams=True, ngram_size=2,
                  length_penalty=0.3)
    settings = _settings(tdec, **kw)
    image = torch.from_numpy(img)
    with torch.inference_mode():
        ids, scores = tdec.beam_search(model, image, settings, CLS, SEP)
    want_seqs, want_scores = reference_beam_search(
        _port_probe(model, image, settings, B * K), B, VOCAB, settings)
    for b in range(B):
        seq = want_seqs[b]
        np.testing.assert_allclose(scores[b].item(), want_scores[b],
                                   rtol=1e-4)
        assert ids[b, :len(seq)].tolist() == seq, (case, b, ids[b], seq)
        assert (ids[b, len(seq):] == 0).all()


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("ignore", [(), (1,), (0, 3)],
                         ids=["none", "one", "two"])
def test_ngram_forbid_mask_matches_jax(n, ignore):
    rng = np.random.default_rng(n * 10 + len(ignore))
    out_ids = rng.integers(0, 4, (6, 10)).astype(np.int32)
    V = 8
    for t in range(11):
        # only [:, :t] is decoded; the rest holds zeros, as in the loop
        ids = out_ids.copy()
        ids[:, t:] = 0
        want = np.asarray(jdec._ngram_forbid_mask(jnp.asarray(ids), t, n, V,
                                                  ignore))
        got = tdec._ngram_forbid_mask(torch.from_numpy(ids).long(), t, n, V,
                                      ignore).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"t={t}")
        if t == 10 and not ignore:
            assert (want != 0).any()


def test_top_k_breaks_ties_by_lower_index_as_lax_top_k():
    rng = np.random.default_rng(0)
    # exact ties within and across beams: K * V flat scores from 4 values,
    # with the t == 0 filler on the later beams of one row
    flat = rng.integers(0, 4, (3, K * 16)).astype(np.float32) - 2.5
    flat[2, 16:] = -1e30
    for k in (1, K, 7):
        want_v, want_i = jax.lax.top_k(jnp.asarray(flat), k)
        got_v, got_i = tdec._top_k(torch.from_numpy(flat), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
