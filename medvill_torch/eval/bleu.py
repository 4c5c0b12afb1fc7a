"""Corpus BLEU-1..4 + report CSV dumps (a copy of medvill_tpu/eval/bleu.py).

Equivalent of `language_eval_bleu` (reference: sc/bleu.py:16-64), which uses
nltk.corpus_bleu with weights (1,0,0,0) ... (0.25,0.25,0.25,0.25) over
whitespace-tokenized hypothesis/reference pairs and writes ``*_gt.csv`` /
``*.csv`` files consumed by the external CheXpert labeler.  nltk is not a
dependency, so corpus BLEU (with the standard brevity penalty and uniform-weight
geometric mean over modified n-gram precisions) is implemented natively —
numerically identical to nltk's default smoothing=None behavior.
"""
from __future__ import annotations

import csv
import math
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(references: Sequence[Sequence[Sequence[str]]],
                hypotheses: Sequence[Sequence[str]],
                max_n: int = 4) -> List[float]:
    """Returns [BLEU-1, BLEU-2, BLEU-3, BLEU-4] with uniform weights
    1/k over the first k orders (nltk corpus_bleu semantics: clipped
    modified precision aggregated over the corpus, multiplicative brevity
    penalty)."""
    clipped = [0] * (max_n + 1)
    totals = [0] * (max_n + 1)
    hyp_len = 0
    ref_len = 0
    for refs, hyp in zip(references, hypotheses):
        hyp_len += len(hyp)
        # closest reference length (ties -> shortest), nltk convention
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp, n)
            max_ref: Counter = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    if c > max_ref[ng]:
                        max_ref[ng] = c
            totals[n] += max(len(hyp) - n + 1, 0)
            clipped[n] += sum(min(c, max_ref[ng])
                              for ng, c in hyp_counts.items())
    bp = 1.0 if hyp_len > ref_len else (
        math.exp(1 - ref_len / hyp_len) if hyp_len > 0 else 0.0)
    bleus = []
    for k in range(1, max_n + 1):
        logsum = 0.0
        ok = True
        for n in range(1, k + 1):
            if clipped[n] == 0 or totals[n] == 0:
                ok = False
                break
            logsum += math.log(clipped[n] / totals[n]) / k
        bleus.append(bp * math.exp(logsum) if ok else 0.0)
    return bleus


def language_eval_bleu(predictions: Sequence[Dict[str, str]],
                       output_dir: str = "",
                       run_name: str = "eval") -> Dict[str, float]:
    """predictions: [{'image_id': ..., 'caption': hyp, 'gt_caption': ref}].
    Computes corpus BLEU-1..4 and (if output_dir) writes the hypothesis /
    reference CSVs the CheXpert labeler consumes
    (reference: sc/bleu.py:16-64)."""
    refs = [[p["gt_caption"].split()] for p in predictions]
    hyps = [p["caption"].split() for p in predictions]
    b1, b2, b3, b4 = corpus_bleu(refs, hyps)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"{run_name}_gt.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            for p in predictions:
                w.writerow([p["gt_caption"]])
        with open(os.path.join(output_dir, f"{run_name}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            for p in predictions:
                w.writerow([p["caption"]])
    return {"Bleu_1": b1, "Bleu_2": b2, "Bleu_3": b3, "Bleu_4": b4}
