"""Host-side stochastic data ops: MLM masking, ITM pair sampling and the
finetune pair truncation (a copy of the pretraining and finetune parts of
medvill_tpu/data/sampling.py).

These stay on the host with Python ``random`` to match the reference
semantics exactly (reference: data/dataset_origin.py:183-235), and draw the
same numbers as the JAX package's from the same ``random.Random`` state.
"""
from __future__ import annotations

import random
import re
from typing import List, Sequence, Tuple


def random_word(tokens: List[int], vocab_len: int, mask_id: int,
                rng: random.Random) -> Tuple[List[int], List[int]]:
    """BERT 15% masking with 80/10/10 split and >=1-mask guarantee
    (reference: data/dataset_origin.py:183-209).  Mutates and returns
    ``tokens``; labels are the original ids at masked slots, -100 elsewhere.
    """
    output_label: List[int] = []
    for i, token in enumerate(tokens):
        prob = rng.random()
        if prob < 0.15:
            prob /= 0.15
            if prob < 0.8:
                tokens[i] = mask_id
            elif prob < 0.9:
                tokens[i] = rng.randrange(vocab_len)
            # else: keep original token
            output_label.append(token)
        else:
            output_label.append(-100)
    if tokens and all(o == -100 for o in output_label):
        output_label[0] = tokens[0]
        tokens[0] = mask_id
    # empty `tokens` (e.g. a record whose text tokenizes to nothing) returns
    # ([], []) instead of IndexError-ing the loader; the reference would
    # crash here too (dataset_origin.py:205-207 indexes [0] unguarded)
    return tokens, output_label


_nonalnum = re.compile(r"[^\w]+", re.UNICODE)
# fuzzywuzzy's default force_ascii=True path (utils.asciidammit) deletes
# exactly the code points 128..255 before processing — characters above
# U+00FF (e.g. CJK) are NOT stripped and count as word chars under the
# unicode \w.  Reproduced exactly so labels_match == (token_sort_ratio ==
# 100) on any input, not just the ASCII CheXpert labels.
_latin1_delete = {i: None for i in range(128, 256)}


def _token_sort_key(s: str) -> str:
    """fuzzywuzzy full_process(force_ascii=True) + token sort: drop
    U+0080..U+00FF, replace non-word chars with spaces, lowercase, sort
    whitespace tokens, join."""
    s = str(s).translate(_latin1_delete)
    s = _nonalnum.sub(" ", s.lower()).strip()
    return " ".join(sorted(s.split()))


def labels_match(a: str, b: str) -> bool:
    """True iff fuzz.token_sort_ratio(a, b) == 100 — the reference's
    label-equality test for ITM negative sampling
    (reference: data/dataset_origin.py:225).  ratio==100 iff the processed
    token-sorted strings are equal."""
    return _token_sort_key(a) == _token_sort_key(b)


def random_pair_sampling(idx: int, data: Sequence[dict],
                         rng: random.Random) -> Tuple[str, str, int, float]:
    """50% aligned pair; else resample (<=300 tries) until the candidate's
    CheXpert label set differs -> label-conditioned negative
    (reference: data/dataset_origin.py:211-235).

    Returns (text, img_path, is_aligned, itm_prob).
    """
    d = data[idx]
    d_label, d_txt, d_img = d["label"], d["text"], d["img"]
    itm_prob = rng.random()
    if itm_prob > 0.5:
        return d_txt, d_img, 1, itm_prob
    for _ in range(300):
        cand = data[rng.randint(0, len(data) - 1)]
        if not labels_match(d_label, cand["label"]):
            return cand["text"], d_img, 0, itm_prob
    # reference returns None after 300 failures (falls off the loop); we
    # degrade to an aligned pair instead of crashing the collator
    return d_txt, d_img, 1, itm_prob


def truncate_txt(txt_tokens: List, max_seq_len: int) -> None:
    """Pop from the tail until it fits (reference:
    data/dataset_origin.py:17-22)."""
    while len(txt_tokens) > max_seq_len:
        txt_tokens.pop()


def truncate_tokens_pair(tokens_a: List, tokens_b: List, max_len: int,
                         max_len_a: int = 0, max_len_b: int = 0,
                         trunc_seg=None, always_truncate_tail: bool = False,
                         rng: random.Random = random
                         ) -> Tuple[List[int], List[int]]:
    """Pair truncation of the finetune pipeline (reference:
    sc/data_loader.py:24-59): trim a segment over its own cap first, else
    ``trunc_seg``, else the longer one; drop its head or its tail with
    probability 1/2 each (one ``rng.random()`` per token removed) unless
    ``always_truncate_tail``.  Mutates both lists; returns the (head, tail)
    counts removed from each."""
    num_truncated_a = [0, 0]
    num_truncated_b = [0, 0]
    while len(tokens_a) + len(tokens_b) > max_len:
        if max_len_a > 0 and len(tokens_a) > max_len_a:
            trunc, num = tokens_a, num_truncated_a
        elif max_len_b > 0 and len(tokens_b) > max_len_b:
            trunc, num = tokens_b, num_truncated_b
        elif trunc_seg:
            trunc, num = ((tokens_a, num_truncated_a) if trunc_seg == "a"
                          else (tokens_b, num_truncated_b))
        elif len(tokens_a) > len(tokens_b):
            trunc, num = tokens_a, num_truncated_a
        else:
            trunc, num = tokens_b, num_truncated_b
        if (not always_truncate_tail) and rng.random() < 0.5:
            del trunc[0]
            num[0] += 1
        else:
            trunc.pop()
            num[1] += 1
    return num_truncated_a, num_truncated_b
