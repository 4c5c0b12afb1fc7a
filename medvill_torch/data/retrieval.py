"""Retrieval data pipeline (a copy of medvill_tpu/data/retrieval.py; from the
same records, tokenizer, config and seed its arrays equal the JAX package's
bit for bit: both draw from Python's ``random.Random``).

Equivalent of ``CXR_Retrieval_Dataset`` (reference:
Downstream_task/Retrieval/full_dset_retrieval.py:60-248):

- train mode: per example emit a (positive, negative) pair; the negative is
  label-conditioned — resample (<=300 tries) until the candidate's label set
  differs, then replace image or text with 50/50 probability
  (full_dset_retrieval.py:118-141);
- eval mode: candidate-pool JSONL with ``is_aligned`` labels, pool of
  ``eval_len_size`` candidates per query (full_dset_retrieval.py:145-162);
- per-sample processing: tokenize, truncate to seq_len, append [SEP], pad;
  attention is 1-D (FULL semantics) so the wire format is the usual
  ``(variant=FULL, txt_len)`` spec (full_dset_retrieval.py:173-229).
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from medvill_torch.config import MaskVariant, RetrievalConfig
from medvill_torch.data import images as image_lib
from medvill_torch.data.sampling import labels_match, truncate_txt


class CXRRetrievalDataset:
    def __init__(self, data_path_or_records, tokenizer, cfg: RetrievalConfig,
                 is_train: bool = True, label_conditioned: bool = True,
                 seed: int = 0, image_loader=None, cxr_bert: bool = True):
        if isinstance(data_path_or_records, str):
            self.data_dir = os.path.dirname(data_path_or_records)
            with open(data_path_or_records) as f:
                self.data = [json.loads(l) for l in f]
        else:
            self.data_dir = ""
            self.data = list(data_path_or_records)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.is_train = is_train
        self.label_conditioned = label_conditioned
        self.rng = random.Random(seed)
        self.vocab = tokenizer.vocab
        self.cxr_bert = cxr_bert
        self.image_loader = image_loader or self._default_image_loader

    def _default_image_loader(self, img_path: str) -> np.ndarray:
        # img_channel=1 sources are grayscale JPGs expanded to 3 channels
        # (reference full_dset_retrieval.py:174-176,239-241 transform split)
        return image_lib.load_image(
            os.path.join(self.data_dir, img_path), self.cfg.image.img_size,
            grayscale_to_rgb=(self.cfg.image.img_channel == 1),
            do_resize=False)

    def __len__(self) -> int:
        return len(self.data)

    def _process_cnn(self, txt: str, img_path: str) -> Dict[str, np.ndarray]:
        """Non-CXRBERT (CNN_BERT) branch: text-only BERT input
        ``[CLS] tokens [SEP] + pad`` with a 1-D mask, image handled by the
        global CNN encoder (full_dset_retrieval.py:231-248)."""
        v = self.vocab
        tokens = self.tokenizer.tokenize(txt)
        truncate_txt(tokens, self.cfg.seq_len)
        ids = ([v["[CLS]"]] + [v.get(w, v["[UNK]"]) for w in tokens]
               + [v["[SEP]"]])
        attn_len = len(ids)
        ids = ids + [v["[PAD]"]] * (self.cfg.seq_len + 2 - attn_len)
        return dict(
            input_txt=np.array(ids, np.int32),
            attn_len=np.int32(attn_len),
            segment=np.ones(self.cfg.seq_len + 2, np.int32),
            image=image_lib.as_wire_image(self.image_loader(img_path)),
        )

    def _process(self, txt: str, img_path: str) -> Dict[str, np.ndarray]:
        """(full_dset_retrieval.py:173-229, CXRBERT branch)."""
        if not self.cxr_bert:
            return self._process_cnn(txt, img_path)
        v = self.vocab
        tokens = self.tokenizer.tokenize(txt)
        truncate_txt(tokens, self.cfg.seq_len)
        ids = [v.get(w, v["[UNK]"]) for w in tokens] + [v["[SEP]"]]
        txt_len = len(ids)
        ids = ids + [v["[PAD]"]] * (self.cfg.seq_len + 1 - txt_len)
        return dict(
            cls_tok=np.array([v["[CLS]"]], np.int32),
            input_txt=np.array(ids, np.int32),
            mask_spec=np.array([int(MaskVariant.FULL), txt_len], np.int32),
            segment=np.ones(self.cfg.seq_len + 1, np.int32),
            image=image_lib.as_wire_image(self.image_loader(img_path)),
            sep_tok=np.array([v["[SEP]"]], np.int32),
        )

    def _random_other(self, idx: int, rng: random.Random):
        """(full_dset_retrieval.py:164-170: uniform over all-but-idx)."""
        if len(self.data) < 2:
            # the reference crashes here too (random.choice([]) IndexError,
            # full_dset_retrieval.py:165-166); fail with a message
            raise ValueError("retrieval training needs >= 2 records to "
                             "sample a negative pair")
        j = rng.randrange(len(self.data) - 1)
        if j >= idx:
            j += 1
        d = self.data[j]
        return d["label"], d["text"], d["img"]

    def __getitem__(self, idx: int):
        return self.fetch(idx)

    def fetch(self, idx: int, rng: Optional[random.Random] = None):
        """``__getitem__`` with an optional per-sample RNG override (see
        ``BatchLoader(workers>1)``)."""
        rng = rng or self.rng
        d = self.data[idx]
        if self.is_train:
            d_label, d_txt, d_img = d["label"], d["text"], d["img"]
            neg_txt, neg_img = d_txt, d_img
            if self.label_conditioned:
                for _ in range(300):
                    r_label, r_txt, r_img = self._random_other(idx, rng)
                    if not labels_match(d_label, r_label):
                        if rng.random() > 0.5:
                            neg_img, neg_txt = r_img, d_txt
                        else:
                            neg_img, neg_txt = d_img, r_txt
                        break
                else:
                    # all 300 tries shared the anchor's label (the reference
                    # hits UnboundLocalError here, full_dset_retrieval.py:
                    # 119-128); degrade to a same-label DIFFERENT record as
                    # a hard negative rather than emitting the positive pair
                    # itself labeled is_aligned=0
                    if rng.random() > 0.5:
                        neg_img, neg_txt = r_img, d_txt
                    else:
                        neg_img, neg_txt = d_img, r_txt
            else:
                r_label, r_txt, r_img = self._random_other(idx, rng)
                if rng.random() > 0.5:
                    neg_img, neg_txt = r_img, d_txt
                else:
                    neg_img, neg_txt = d_img, r_txt
            pos = self._process(d_txt, d_img)
            neg = self._process(neg_txt, neg_img)
            pos["is_aligned"] = np.int32(1)
            neg["is_aligned"] = np.int32(0)
            return idx, pos, neg
        # eval-pool rows use the reference's published key spelling "txt"
        # (full_dset_retrieval.py:147 example row); accept both
        txt = d.get("text", d.get("txt"))
        if txt is None:
            raise ValueError(
                "retrieval eval rows need a 'text' or 'txt' key; got keys "
                f"{sorted(d)}")
        sample = self._process(txt, d["img"])
        if "is_aligned" not in d:
            raise ValueError(
                "retrieval eval rows must carry 'is_aligned': eval pools "
                "are pre-built candidate lists of eval_len_size entries per "
                "query (reference full_dset_retrieval.py:145-162); got keys "
                f"{sorted(d)}")
        sample["is_aligned"] = np.int32(d["is_aligned"][0]
                                        if isinstance(d["is_aligned"], list)
                                        else d["is_aligned"])
        sample["index"] = np.int32(idx)
        return sample


def collate_pairs(samples) -> Dict[str, np.ndarray]:
    """Concatenate positives then negatives along batch — the reference's
    ``cat(pos, neg)`` (full_dset_retrieval.py:357-380)."""
    pos = [p for _, p, _ in samples]
    neg = [n for _, _, n in samples]
    out = {}
    for k in pos[0]:
        out[k] = np.stack([s[k] for s in pos] + [s[k] for s in neg])
    return out


def synthetic_retrieval_records(n: int, n_labels: int = 4, seed: int = 0,
                                eval_pool: Optional[int] = None) -> List[dict]:
    rng = random.Random(seed)
    words = [f"word{i}" for i in range(50)]
    recs = []
    for i in range(n):
        rec = dict(id=str(i), label=f"label{rng.randrange(n_labels)}",
                   text=" ".join(rng.choices(words, k=rng.randint(5, 20))),
                   img=f"img{i}.jpg")
        if eval_pool is not None:
            rec["is_aligned"] = [1 if i % eval_pool == 0 else 0]
        recs.append(rec)
    return recs
