"""Autoregressive report generation: greedy, sampled and beam decode
(medvill_tpu/models/decoder.py).

The UniLM [MASK]-probe scheme with a true per-layer K/V cache: one prefill
of the image segment, then per text step t a 2-position window (the
previously committed token, a [MASK] probe) whose logits pick token t.  The
JAX package runs the steps as a ``lax.fori_loop`` and the layers as a scan or
unrolled program; here both are plain Python loops over eager ops (the
scan/unrolled split was a compile-time device with no counterpart).

``beam_search`` keeps the JAX scoring (reference model.py:1239-1487): a
-10000 penalty on every continuation of a beam whose last token was EOS,
EOS set to -10000 before ``min_len``, duplicate-ngram forbidding with an
ignore set, the additive length penalty, and the answer as the best over
every EOS event and the last frame's beams.  Its top-K is a stable sort,
so equal scores go to the lower flat index first, as ``lax.top_k`` does.

Decode-time geometry (sc/data_loader.py:476-528): token types 4 (image
segment) / 5 (text) under new_segment_ids; ``DecodeSettings.
window_positions`` picks the text-window position ids ('reference' is what
the reference decoder executes, see the JAX module for all three).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from medvill_torch.models.seq2seq import VLPForPreTraining

NEG = -10000.0


@dataclasses.dataclass(frozen=True)
class DecodeSettings:
    max_txt_length: int = 128
    mask_word_id: int = 103      # [MASK]
    eos_id: int = 102            # [SEP]
    beam_size: int = 1
    # ADDITIVE per-length bonus: score + length_penalty * n_tokens
    length_penalty: float = 0.0
    forbid_duplicate_ngrams: bool = False
    ngram_size: int = 3
    min_len: int = 0
    new_segment_ids: bool = True
    # vocab ids exempt from ngram forbidding (a tuple, for hashability)
    forbid_ignore_ids: tuple = ()
    # 'greedy' argmax | 'sample' multinomial over the filtered softmax
    sample_mode: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # 'reference' | 'train' | 'global' (see _window_positions)
    window_positions: str = "reference"

    @property
    def img_type_id(self) -> int:
        return 4 if self.new_segment_ids else 0

    @property
    def txt_type_id(self) -> int:
        return 5 if self.new_segment_ids else 1


def filter_sample_logits(logits: torch.Tensor, temperature: float = 1.0,
                         top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature / top-k / nucleus (top-p) filtering of ``[..., V]``
    logits before a categorical draw; defaults are the identity.  top_k
    keeps logits >= the k-th largest (ties at the cutoff survive); top_p
    keeps the smallest descending-probability prefix whose mass reaches
    ``top_p`` (at least one token).  Filtered tokens get -inf."""
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    V = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k and 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # keep sorted token i while the mass BEFORE it is < top_p
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        n_keep = keep.sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def _window_bias(vis: int, t: int, L: int, device) -> torch.Tensor:
    """[1, 1, 2, L] bias for the (committed, probe) window at text step t:
    row 0 (slot vis+t-1) sees cols < vis and text cols <= vis+t-1; row 1
    (the probe at slot vis+t) sees cols < vis and text cols <= vis+t."""
    c = torch.arange(L, device=device).view(1, 1, 1, L)
    r_end = (vis + t - 1 + torch.arange(2, device=device)).view(1, 1, 2, 1)
    visible = (c < vis) | (c <= r_end)
    return torch.where(visible, 0.0, NEG)


def _prefill_bias(vis: int, L: int, device) -> torch.Tensor:
    """[1, 1, vis, L]: image-segment rows attend image cols only (s2s
    decode mask, sc/data_loader.py:524)."""
    c = torch.arange(L, device=device).view(1, 1, 1, L)
    return torch.where(c < vis, 0.0, NEG).expand(1, 1, vis, L)


def _window_positions(settings: DecodeSettings, vis: int, t: int,
                      n_rows: int, device) -> torch.Tensor:
    """[n_rows, 2] position ids for the window at text step t.  The t == 0
    committed slot re-encodes [SEP] at its prefill position vis-1, so the
    cache overwrite is a no-op in every mode."""
    mode = settings.window_positions
    if mode == "reference":
        pos = (vis - 1, 0) if t == 0 else (0, 1)
    elif mode == "train":
        pos = (vis - 1 if t == 0 else t - 1, t)
    elif mode == "global":
        pos = (vis - 1 + t, vis + t)
    else:
        raise ValueError(f"window_positions: {mode!r}")
    return torch.tensor(pos, device=device).expand(n_rows, 2)


def _sep_last_ids(cls_id: int, sep_id: int, B: int, vis: int,
                  device) -> torch.Tensor:
    ids = torch.zeros(B, vis, dtype=torch.long, device=device)
    ids[:, 0] = cls_id
    ids[:, -1] = sep_id
    return ids


def _prefill(model: VLPForPreTraining, image: torch.Tensor,
             settings: DecodeSettings, cls_id: int, sep_id: int,
             L: int) -> list:
    """Per-layer K/V caches [B, L, heads, dim] with the image segment
    encoded at [0, vis)."""
    device = image.device
    B, vis = image.shape[0], model.len_vis_input + 2
    caches = model.init_kv_caches(B, L, device)
    seg_ids = _sep_last_ids(cls_id, sep_id, B, vis, device)
    seg_types = torch.full((B, vis), settings.img_type_id, dtype=torch.long,
                           device=device)
    model.decode_prefill(image, seg_ids, seg_types, caches,
                         _prefill_bias(vis, L, device))
    return caches


def _window_inputs(settings: DecodeSettings, vis: int, T: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every step's window positions and token types, [T, 2] each, in one
    host->device copy apiece: a copy from pageable host memory synchronises
    the stream, so one per step would stall the host on the device at
    every window."""
    positions = torch.cat([_window_positions(settings, vis, t, 1, "cpu")
                           for t in range(T)]).to(device)
    txt_type = settings.txt_type_id
    types = torch.tensor(
        [[settings.img_type_id if t == 0 else txt_type, txt_type]
         for t in range(T)]).to(device)
    return positions, types


def greedy_decode(model: VLPForPreTraining, image: torch.Tensor,
                  settings: DecodeSettings, cls_id: int, sep_id: int,
                  gt_tokens: Optional[torch.Tensor] = None,
                  teacher_forcing: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (output_ids [B, T] long, output_logprob [B, T] f32,
    gt_nll [B, T] f32).

    gt_nll is the per-position CE of ``gt_tokens`` (zeros without them).
    ``teacher_forcing`` commits the ground-truth token at each step instead
    of the chosen one.  With ``settings.sample_mode == 'sample'`` each step
    draws from the filtered softmax with ``generator`` (required, on the
    image's device); output_logprob still carries log p(token) under the
    unfiltered softmax.  No EOS freeze: every row decodes T tokens and the
    caller truncates at the first [SEP]."""
    do_sample = settings.sample_mode == "sample"
    if do_sample and generator is None:
        raise ValueError("sample_mode='sample' requires a generator")
    device = image.device
    vis = model.len_vis_input + 2
    T = settings.max_txt_length
    L = vis + T + 1
    B = image.shape[0]

    caches = _prefill(model, image, settings, cls_id, sep_id, L)
    if gt_tokens is None:
        gt_tokens = torch.zeros(B, T, dtype=torch.long, device=device)
    gt_tokens = gt_tokens.long()
    out_ids = torch.zeros(B, T, dtype=torch.long, device=device)
    out_logp = torch.zeros(B, T, device=device)
    gt_nll = torch.zeros(B, T, device=device)
    mask_col = torch.full((B,), settings.mask_word_id, dtype=torch.long,
                          device=device)
    # committed slot token: step 0 re-encodes the segment [SEP]
    committed = torch.full((B,), sep_id, dtype=torch.long, device=device)
    positions, types_all = _window_inputs(settings, vis, T, device)
    for t in range(T):
        window_ids = torch.stack([committed, mask_col], dim=1)
        pos = positions[t].expand(B, 2)
        types = types_all[t].expand(B, 2)
        logits, caches = model.decode_step(window_ids, pos, types, caches,
                                           vis - 1 + t,
                                           _window_bias(vis, t, L, device))
        logits = logits.float()
        logp = torch.log_softmax(logits, dim=-1)
        if do_sample:
            probs = torch.softmax(filter_sample_logits(
                logits, settings.temperature, settings.top_k,
                settings.top_p), dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        out_ids[:, t] = next_tok
        out_logp[:, t] = torch.gather(logp, 1, next_tok[:, None])[:, 0]
        gt_t = gt_tokens[:, t]
        gt_nll[:, t] = -torch.gather(logp, 1, gt_t[:, None])[:, 0]
        committed = gt_t if teacher_forcing else next_tok
    return out_ids, out_logp, gt_nll


def _top_k(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of each row, equal
    values in ascending index order, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties, and bf16 logits cast to
    f32 tie often)."""
    values, indices = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def _gather_beams(x: torch.Tensor, parent: torch.Tensor, B: int,
                  K: int) -> torch.Tensor:
    """Rows of ``x`` [B*K, ...] picked by the per-(B, K) parent beam."""
    flat = (torch.arange(B, device=x.device)[:, None] * K
            + parent).reshape(-1)
    return x.index_select(0, flat)


def _ngram_forbid_mask(out_ids: torch.Tensor, t: int, n: int, vocab: int,
                       ignore_ids: tuple = ()) -> torch.Tensor:
    """[BK, V] additive mask (-10000 where forbidden) for the tokens that
    would complete an n-gram already in ``out_ids[:, :t]`` (reference
    model.py:1387-1404, 1289-1290).  A row forbids nothing when one of its
    n-1 context tokens is in ``ignore_ids``, and ids in the set are never
    forbidden.  The forbidden next-tokens are scattered into zeros, where
    the JAX version sums a [BK, T, V] one-hot."""
    BK = out_ids.shape[0]
    forbid = torch.zeros(BK, vocab + 1, dtype=torch.bool,
                         device=out_ids.device)
    if t >= n:
        grams = out_ids[:, :t].unfold(1, n, 1)          # [BK, t-n+1, n]
        ctx = out_ids[:, t - n + 1:t]                    # [BK, n-1]
        match = (grams[..., :n - 1] == ctx[:, None, :]).all(-1)
        # unmatched grams write to the spare column V; every write stores
        # True, so the order of duplicate writes does not matter
        nxt = torch.where(match, grams[..., n - 1], vocab)
        forbid.scatter_(1, nxt, True)
        if ignore_ids:
            ign = torch.zeros(vocab, dtype=torch.bool, device=out_ids.device)
            ign[list(ignore_ids)] = True
            forbid[:, :vocab] &= ~ign[ctx].any(1, keepdim=True) & ~ign
    return torch.where(forbid[:, :vocab], NEG, 0.0)


def beam_search(model: VLPForPreTraining, image: torch.Tensor,
                settings: DecodeSettings, cls_id: int, sep_id: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (best_ids [B, T] long, best_scores [B] f32), as the JAX
    ``beam_search`` scores them (reference model.py:1239-1487):

    - a beam whose last token was EOS keeps expanding, each continuation
      carrying -10000 (no hard freeze);
    - while ``t < min_len`` the EOS log-prob is set to -10000;
    - an EOS event at step t scores ``cum_logp + length_penalty * (t+1)``;
    - at t == 0 the K beams are one, so only beam 0 is kept (-1e30, never
      -inf, for the others);
    - the answer is the best over every EOS event and the last frame's K
      beams, replaced only on a strict ``>``.

    The image segment is prefilled at batch B and its caches repeated to
    B*K rows (row b*K + k belongs to image b); each step gathers the caches
    and the partial sequences by parent beam, so no traceback is needed."""
    device = image.device
    vis = model.len_vis_input + 2
    T, K = settings.max_txt_length, settings.beam_size
    L = vis + T + 1
    B = image.shape[0]
    BK = B * K
    V = model.config.vocab_size
    eos = settings.eos_id
    NEG_INIT = -1e30  # "no candidate yet"; not -inf, to keep sums finite

    caches = [(k.repeat_interleave(K, 0), v.repeat_interleave(K, 0))
              for k, v in _prefill(model, image, settings, cls_id, sep_id,
                                   L)]
    positions, types_all = _window_inputs(settings, vis, T, device)
    penalty = torch.tensor(settings.length_penalty, device=device)
    rows = torch.arange(B, device=device)
    mask_col = torch.full((BK,), settings.mask_word_id, dtype=torch.long,
                          device=device)
    committed = torch.full((BK,), sep_id, dtype=torch.long, device=device)
    out_ids = torch.zeros(BK, T, dtype=torch.long, device=device)
    scores = torch.zeros(BK, device=device)
    last_eos = torch.zeros(BK, device=device)
    best_score = torch.full((B,), NEG_INIT, device=device)
    best_ids = torch.zeros(B, T, dtype=torch.long, device=device)
    for t in range(T):
        window_ids = torch.stack([committed, mask_col], dim=1)
        logits, caches = model.decode_step(
            window_ids, positions[t].expand(BK, 2),
            types_all[t].expand(BK, 2), caches, vis - 1 + t,
            _window_bias(vis, t, L, device))
        logp = torch.log_softmax(logits.float(), dim=-1)
        if settings.forbid_duplicate_ngrams:
            logp = logp + _ngram_forbid_mask(out_ids, t, settings.ngram_size,
                                             V, settings.forbid_ignore_ids)
        if t < settings.min_len:
            logp[:, eos] = NEG
        total = (scores.view(B, K, 1) + logp.view(B, K, V)
                 + (NEG * last_eos).view(B, K, 1))
        if t == 0:
            total[:, 1:] = NEG_INIT
        top_scores, top_idx = _top_k(total.view(B, K * V), K)
        parent = torch.div(top_idx, V, rounding_mode="floor")
        token = top_idx % V
        caches = [(_gather_beams(k, parent, B, K),
                   _gather_beams(v, parent, B, K)) for k, v in caches]
        out_ids = _gather_beams(out_ids, parent, B, K)
        committed = token.reshape(-1)
        out_ids[:, t] = committed
        ev_score = torch.where(token == eos, top_scores + penalty * (t + 1),
                               NEG_INIT)                       # [B, K]
        k_ev = torch.argmax(ev_score, dim=1)
        cand_score = ev_score[rows, k_ev]
        better = cand_score > best_score
        best_score = torch.where(better, cand_score, best_score)
        best_ids = torch.where(better[:, None],
                               out_ids.view(B, K, T)[rows, k_ev], best_ids)
        last_eos = (committed == eos).float()
        scores = top_scores.reshape(-1)
    fin = scores.view(B, K) + settings.length_penalty * float(T)
    k_fin = torch.argmax(fin, dim=1)
    fin_score = fin[rows, k_fin]
    better = fin_score > best_score
    best_score = torch.where(better, fin_score, best_score)
    best_ids = torch.where(better[:, None], out_ids.view(B, K, T)[rows, k_fin],
                           best_ids)
    return best_ids, best_score
