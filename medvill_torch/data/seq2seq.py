"""Finetune data pipeline for report generation (a copy of the train-time
part of medvill_tpu/data/seq2seq.py; reference: sc/data_loader.py:61-452).

- ``Img2TxtDataset`` reads JSONL records ``{"img": path, "text": report}``
  and picks the s2s or the bi preprocessor per example by a weighted choice
  (``s2s_prob``, ``bi_prob``);
- ``Seq2seqPreprocessor`` lays out ``[CLS] [UNK]*len_vis [SEP] text
  [SEP]``, masks ``n_pred = min(max_pred, max(1, round(len_b *
  mask_prob)))`` text positions (the final [SEP] force-masked with
  probability 1/2), pads to ``max_seq_length`` and ``max_pred``, and carries
  the 2-D mask as a ``(variant id, n_tokens)`` spec.

From the same records, tokenizer, config and seed the examples equal the
JAX package's byte for byte.  ``fetch(idx, load_image=False)`` is the
resume replay of ``BatchLoader.skip_next``: every draw, no image.
``Seq2seqDecodePreprocessor`` is the decode CLI's.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from medvill_torch.config import FinetuneConfig
from medvill_torch.data import images as image_lib
from medvill_torch.data.masks import SEQ2SEQ_VARIANT_IDS, Seq2seqMaskMode
from medvill_torch.data.sampling import truncate_tokens_pair


class Seq2seqPreprocessor:
    """One mode (s2s / bi / bar) of the train-time preprocessor
    (reference: Preprocess4Seq2seq, sc/data_loader.py:295-452).  Segment
    ids are 4/5 for s2s under ``new_segment_ids``, else 0/1; ``task_idx``
    is 3 for s2s and 0 otherwise."""

    def __init__(self, cfg: FinetuneConfig, tokenizer, mode: str,
                 bar: bool = False, rng: Optional[random.Random] = None):
        if mode not in (Seq2seqMaskMode.S2S, Seq2seqMaskMode.BI,
                        Seq2seqMaskMode.BAR):
            raise ValueError(f"unknown seq2seq mode {mode!r}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.mode = mode
        self.bar = bar
        self.rng = rng or random
        self.task_idx = 3 if mode == Seq2seqMaskMode.S2S else 0
        self.max_len = cfg.max_seq_length

    def __call__(self, tokens_b: List[str],
                 rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        v = self.tokenizer.vocab
        rng = rng or self.rng
        len_vis = cfg.len_vis_input
        tokens_a = ["[UNK]"] * len_vis
        tokens_b = list(tokens_b)
        truncate_tokens_pair(tokens_a, tokens_b, len_vis + cfg.max_len_b,
                             max_len_b=cfg.max_len_b,
                             trunc_seg=cfg.trunc_seg,
                             always_truncate_tail=cfg.always_truncate_tail,
                             rng=rng)
        tokens = ["[CLS]"] + tokens_a + ["[SEP]"] + tokens_b + ["[SEP]"]

        if cfg.new_segment_ids and self.mode == Seq2seqMaskMode.S2S:
            segment = [4] * (len(tokens_a) + 2) + [5] * (len(tokens_b) + 1)
        else:
            segment = [0] * (len(tokens_a) + 2) + [1] * (len(tokens_b) + 1)

        n_pred = min(cfg.max_pred, max(1, round(len(tokens_b)
                                                * cfg.mask_prob)))
        if cfg.task == "report_generation":
            cand_pos = [i for i, tk in enumerate(tokens)
                        if i >= len(tokens_a) + 2 and tk != "[CLS]"]
            rng.shuffle(cand_pos)
            if rng.random() > 0.5:  # 50% force-mask the final [SEP]
                masked_pos = cand_pos[:n_pred - 1] + [len(tokens) - 1]
            else:
                masked_pos = cand_pos[:n_pred]
            masked_tokens = [tokens[p] for p in masked_pos]
            for p in masked_pos:
                tokens[p] = "[MASK]"
        else:
            masked_pos, masked_tokens = [], []
        masked_weights = [1] * len(masked_tokens)

        input_ids = [v.get(t, v["[UNK]"]) for t in tokens]
        masked_ids = [v.get(t, v["[UNK]"]) for t in masked_tokens]

        n_tokens = len(input_ids)
        n_pad = self.max_len - n_tokens
        input_ids += [0] * n_pad
        segment += [0] * n_pad

        if cfg.max_pred > len(masked_ids):
            pad = cfg.max_pred - len(masked_ids)
            masked_ids += [0] * pad
            masked_pos += [0] * pad
            masked_weights += [0] * pad

        mode = Seq2seqMaskMode.BAR if self.bar else self.mode
        return dict(
            input_ids=np.array(input_ids, np.int32),
            segment_ids=np.array(segment, np.int32),
            mask_spec=np.array([SEQ2SEQ_VARIANT_IDS[mode], n_tokens],
                               np.int32),
            masked_ids=np.array(masked_ids, np.int32),
            masked_pos=np.array(masked_pos, np.int32),
            masked_weights=np.array(masked_weights, np.float32),
            task_idx=np.int32(self.task_idx),
        )


def pipelines(cfg: FinetuneConfig, tokenizer, rng: random.Random):
    """The (s2s or bar, bi) preprocessors and their choice weights
    (reference: finetune.py:263-283)."""
    return ([Seq2seqPreprocessor(cfg, tokenizer, Seq2seqMaskMode.S2S,
                                 bar=cfg.bar, rng=rng),
             Seq2seqPreprocessor(cfg, tokenizer, Seq2seqMaskMode.BI,
                                 rng=rng)],
            [cfg.s2s_prob, cfg.bi_prob])


class Img2TxtDataset:
    """Report-generation dataset: JSONL -> (image, preprocessed text)
    (reference: sc/data_loader.py:190-293, the report-generation branch).
    Images are decoded as grayscale to 3 channels and resized only when
    ``len_vis_input < 100`` (reference: data_loader.py:421-428)."""

    def __init__(self, data_path_or_records, tokenizer, cfg: FinetuneConfig,
                 seed: int = 0, image_loader=None):
        if isinstance(data_path_or_records, str):
            self.data_dir = os.path.dirname(data_path_or_records)
            with open(data_path_or_records) as f:
                self.data = [json.loads(line) for line in f]
        else:
            self.data_dir = ""
            self.data = list(data_path_or_records)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rng = random.Random(seed)
        self.image_loader = image_loader or self._default_image_loader
        self.pipelines, self.probs = pipelines(cfg, tokenizer, self.rng)

    def _default_image_loader(self, img_path: str) -> np.ndarray:
        return image_lib.load_image(
            os.path.join(self.data_dir, img_path), self.cfg.img_size,
            grayscale_to_rgb=True, do_resize=(self.cfg.len_vis_input < 100))

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.fetch(idx)

    def fetch(self, idx: int, rng: Optional[random.Random] = None,
              load_image: bool = True
              ) -> Optional[Dict[str, np.ndarray]]:
        """``__getitem__`` with an optional per-sample RNG (used by
        ``BatchLoader(workers>1)``); ``None`` draws from the shared
        sequential stream.  ``load_image=False`` makes the draws and
        returns None (``BatchLoader.skip_next``'s replay)."""
        rec = self.data[idx]
        tokens_b = self.tokenizer.tokenize(rec["text"])
        proc = (rng or self.rng).choices(self.pipelines,
                                         weights=self.probs)[0]
        out = proc(tokens_b, rng=rng)
        if not load_image:
            return None
        out["image"] = image_lib.as_wire_image(self.image_loader(rec["img"]))
        return out


class Seq2seqDecodePreprocessor:
    """Decode-time preprocessing (reference: Preprocess4Seq2seqDecoder,
    sc/data_loader.py:455-541): the image in the wire format and the
    ground-truth ids cut or zero-padded to ``max_txt_length``, for
    teacher forcing and ppl."""

    def __init__(self, cfg: FinetuneConfig, tokenizer,
                 max_txt_length: int = 128):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_txt_length = max_txt_length

    def __call__(self, img_path: str, original_text: str,
                 image_loader) -> Dict[str, np.ndarray]:
        gt_ids = self.tokenizer.convert_tokens_to_ids(
            self.tokenizer.tokenize(original_text))
        del gt_ids[self.max_txt_length:]
        gt_ids += [0] * (self.max_txt_length - len(gt_ids))
        return dict(
            image=image_lib.as_wire_image(image_loader(img_path)),
            gt_token=np.array(gt_ids, np.int32),
        )
