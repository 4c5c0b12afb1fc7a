"""Optional COCO-caption evaluation wrapper (a copy of
medvill_tpu/eval/lang_utils.py).

Equivalent of ``language_eval`` (reference: sc/lang_utils.py:12-60), which
wraps the external ``pycocoevalcap`` package (unused by the reference's main
path).  The package is not a dependency; when importable we use it, else we
fall back to native metrics — corpus BLEU (``eval/bleu.py``), ROUGE-L and
CIDEr-D (``eval/caption_metrics.py``, coco-caption conventions), and
METEOR (``eval/meteor.py``, METEOR-1.5 exact+stem modules with documented
divergences) — so callers always get the reference's FULL metric key set
(sc/lang_utils.py:31-37: Bleu_1-4 / METEOR / ROUGE_L / CIDEr).
"""
from __future__ import annotations

from typing import Dict, List, Sequence


def language_eval(preds: Sequence[Dict], model_id: str = "",
                  split: str = "test") -> Dict[str, float]:
    """preds: [{'image_id': ..., 'caption': ..., 'gt_caption': ...}]."""
    try:
        from pycocoevalcap.bleu.bleu import Bleu
        from pycocoevalcap.cider.cider import Cider
        from pycocoevalcap.meteor.meteor import Meteor
        from pycocoevalcap.rouge.rouge import Rouge

        gts = {i: [p["gt_caption"]] for i, p in enumerate(preds)}
        res = {i: [p["caption"]] for i, p in enumerate(preds)}
        out: Dict[str, float] = {}
        bleu, _ = Bleu(4).compute_score(gts, res)
        for n, b in enumerate(bleu, 1):
            out[f"Bleu_{n}"] = float(b)
        for scorer, name in ((Meteor(), "METEOR"), (Rouge(), "ROUGE_L"),
                             (Cider(), "CIDEr")):
            score, _ = scorer.compute_score(gts, res)
            out[name] = float(score)
        return out
    except (ImportError, OSError):
        # OSError/FileNotFoundError too: Meteor() spawns a java subprocess,
        # so pycocoevalcap being importable does not guarantee it runs —
        # the native fallback must cover a missing JVM as well
        from medvill_torch.eval.bleu import language_eval_bleu
        from medvill_torch.eval.caption_metrics import cider_d, rouge_l
        from medvill_torch.eval.meteor import meteor_strings

        out = language_eval_bleu(list(preds))
        hyps = [p["caption"].split() for p in preds]
        refs = [[p["gt_caption"].split()] for p in preds]
        out["METEOR"] = meteor_strings([p["caption"] for p in preds],
                                       [[p["gt_caption"]] for p in preds])[0]
        out["ROUGE_L"] = rouge_l(hyps, refs)[0]
        out["CIDEr"] = cider_d(hyps, refs)[0]
        return out
