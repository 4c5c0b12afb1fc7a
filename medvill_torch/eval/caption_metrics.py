"""Native ROUGE-L and CIDEr-D caption metrics (a copy of
medvill_tpu/eval/caption_metrics.py).

The reference's ``language_eval`` (sc/lang_utils.py:12-60) reports Bleu_1-4,
METEOR, ROUGE_L and CIDEr via the external ``pycocoevalcap`` package, which
is not a dependency (and whose METEOR additionally needs a JVM).  BLEU is
covered natively in ``eval/bleu.py``; this module adds ROUGE-L (Lin 2004)
and CIDEr-D (Vedantam et al. 2015) implemented from the published
algorithms with coco-caption's exact conventions, so the fallback path of
``eval/lang_utils.py::language_eval`` reports the same keys with the same
semantics as the reference's eval stack.

Conventions reproduced on purpose (these define every published number):

* ROUGE-L: beta = 1.2; precision/recall are each maximised over the
  references independently before the F-measure.
* CIDEr-D: n = 1..4, sigma = 6.0; IDF document frequency is counted over
  the *reference* sets of the evaluation corpus itself (one document per
  image); per-ngram similarity clips the hypothesis TF-IDF at the
  reference's (``min(h, r) * r``); a Gaussian length penalty
  ``exp(-delta^2 / (2 sigma^2))`` multiplies every order, where ``delta``
  is the difference in *bigram* totals — coco-caption counts length from
  the ``n == 1`` index, i.e. bigrams, and published scores include that
  quirk; the per-image score is the ref-average of the n-average, x10.

Scores are corpus functions: ``(mean, per_image_list)`` like
coco-caption's ``compute_score``.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

ROUGE_BETA = 1.2
CIDER_N = 4
CIDER_SIGMA = 6.0


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Longest common subsequence length, O(len(a) * len(b)) rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(hypotheses: Sequence[Sequence[str]],
            references: Sequence[Sequence[Sequence[str]]],
            beta: float = ROUGE_BETA) -> Tuple[float, List[float]]:
    """Corpus ROUGE-L F-measure over tokenized hyps and per-image ref lists."""
    scores: List[float] = []
    for hyp, refs in zip(hypotheses, references):
        prec_max = 0.0
        rec_max = 0.0
        for ref in refs:
            lcs = _lcs_len(ref, hyp)
            if hyp:
                prec_max = max(prec_max, lcs / len(hyp))
            if ref:
                rec_max = max(rec_max, lcs / len(ref))
        if prec_max > 0 and rec_max > 0:
            scores.append(((1 + beta ** 2) * prec_max * rec_max)
                          / (rec_max + beta ** 2 * prec_max))
        else:
            scores.append(0.0)
    return (sum(scores) / len(scores) if scores else 0.0), scores


def _ngram_counts(tokens: Sequence[str], max_n: int) -> Counter:
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


def _tfidf_vec(counts: Counter, doc_freq: Dict[tuple, float],
               log_n_images: float, max_n: int):
    """Per-order TF-IDF vectors + L2 norms + bigram length (the coco-caption
    'length' quirk: it sums the n==1 *index*, i.e. bigram term freqs)."""
    vec = [defaultdict(float) for _ in range(max_n)]
    norm = [0.0] * max_n
    length = 0
    for ngram, tf in counts.items():
        idf = log_n_images - math.log(max(1.0, doc_freq.get(ngram, 0.0)))
        n = len(ngram) - 1
        vec[n][ngram] = tf * idf
        norm[n] += vec[n][ngram] ** 2
        if n == 1:
            length += tf
    return vec, [math.sqrt(x) for x in norm], length


def cider_d(hypotheses: Sequence[Sequence[str]],
            references: Sequence[Sequence[Sequence[str]]],
            max_n: int = CIDER_N,
            sigma: float = CIDER_SIGMA) -> Tuple[float, List[float]]:
    """Corpus CIDEr-D over tokenized hyps and per-image reference lists.

    IDF is computed from this corpus's references (one document per image),
    so a meaningful score needs >= 2 images — with a single image every
    reference ngram has df == N and all TF-IDF mass vanishes (coco-caption
    behaves identically).
    """
    assert len(hypotheses) == len(references)
    if not hypotheses:
        return 0.0, []
    doc_freq: Dict[tuple, float] = defaultdict(float)
    ref_counts = [[_ngram_counts(r, max_n) for r in refs]
                  for refs in references]
    for per_image in ref_counts:
        seen = set()
        for counts in per_image:
            seen.update(counts.keys())
        for ngram in seen:
            doc_freq[ngram] += 1.0
    log_n = math.log(float(len(references)))
    scores: List[float] = []
    for hyp, per_image in zip(hypotheses, ref_counts):
        h_vec, h_norm, h_len = _tfidf_vec(_ngram_counts(hyp, max_n),
                                          doc_freq, log_n, max_n)
        acc = [0.0] * max_n
        for r_counts in per_image:
            r_vec, r_norm, r_len = _tfidf_vec(r_counts, doc_freq, log_n,
                                              max_n)
            penalty = math.exp(-((h_len - r_len) ** 2)
                               / (2.0 * sigma ** 2))
            for n in range(max_n):
                dot = sum(min(w, r_vec[n][ngram]) * r_vec[n][ngram]
                          for ngram, w in h_vec[n].items()
                          if ngram in r_vec[n])
                if h_norm[n] != 0 and r_norm[n] != 0:
                    dot /= h_norm[n] * r_norm[n]
                acc[n] += dot * penalty
        score = (sum(acc) / max_n) / len(per_image) * 10.0
        scores.append(score)
    return sum(scores) / len(scores), scores
