"""VQA-RAD data (a copy of medvill_tpu/data/vqa.py; reference: the VQA
branch of sc/data_loader.py:61-293).

- ``load_vqa_entries`` reads ``{split}set.json``,
  ``cache/{split}_target.pkl`` (soft answer targets) and
  ``imgid2idx.json`` under a dataroot, with the organ filter (all / chest /
  head / abd);
- ``preprocess_question`` strips the "? -yes/no" / "? -open" markers,
  commas, question marks and periods, and writes "x ray" as "x-ray";
- ``soft_target`` scatters an answer's scores into a dense target;
- ``VQADataset`` runs each question through the s2s/bi preprocessors (no
  masking in vqa mode) and adds ``ans_target``, ``ans_type`` (CLOSED 0,
  OPEN 1) and ``organ`` (CHEST/HEAD/ABD 0/1/2).

From the same entries, tokenizer, config and seed the examples equal the
JAX package's byte for byte.
"""
from __future__ import annotations

import json
import os
import pickle
import random
from typing import Dict, List, Optional

import numpy as np

from medvill_torch.config import FinetuneConfig
from medvill_torch.data import images as image_lib
from medvill_torch.data.seq2seq import pipelines

ANS_TYPE = {"CLOSED": 0, "OPEN": 1}
ORGAN = {"CHEST": 0, "HEAD": 1, "ABD": 2}


def preprocess_question(text: str) -> str:
    """(reference: sc/data_loader.py:135-143)."""
    s = text.lower()
    for marker in ("? -yes/no", "? -open", "? - open"):
        s = s.replace(marker, "")
    return (s.replace(",", "").replace("?", "").replace("'s", " 's")
            .replace("...", "").replace("x ray", "x-ray").replace(".", ""))


def load_vqa_entries(dataroot: str, split: str, organ_filter: str = "all"
                     ) -> List[dict]:
    """(reference: sc/data_loader.py:166-188).  The pickle is the dataset's
    own cache file, as the reference reads it.  Raises if the questions and
    the answer targets disagree on their qids."""
    with open(os.path.join(dataroot, split + "set.json")) as f:
        samples = sorted(json.load(f), key=lambda x: x["qid"])
    with open(os.path.join(dataroot, "cache", f"{split}_target.pkl"),
              "rb") as f:
        answers = sorted(pickle.load(f), key=lambda x: x["qid"])
    with open(os.path.join(dataroot, "imgid2idx.json")) as f:
        img_id2idx = json.load(f)
    if len(samples) != len(answers) or any(
            s["qid"] != a["qid"] for s, a in zip(samples, answers)):
        raise ValueError(
            f"{split}set.json and cache/{split}_target.pkl disagree on "
            "qids: answers would be paired with the wrong questions")
    entries = []
    for sample, answer in zip(samples, answers):
        organ = str(sample.get("image_organ", "")).strip()
        if organ_filter != "all" and organ.upper() != organ_filter.upper():
            continue
        entries.append(dict(
            qid=sample["qid"], image_name=sample["image_name"],
            image=img_id2idx.get(sample["image_name"]),
            question=sample["question"], answer=answer,
            answer_type=sample["answer_type"], image_organ=organ))
    return entries


def soft_target(answer: Optional[dict], num_answers: int) -> np.ndarray:
    """Scatter answer scores into a dense soft target
    (reference: data_loader.py:267-273)."""
    target = np.zeros(num_answers, np.float32)
    if answer:
        labels = answer.get("labels")
        scores = answer.get("scores")
        if labels is not None and len(labels):
            target[np.asarray(labels, int)] = np.asarray(scores, np.float32)
    return target


class VQADataset:
    """VQA-RAD examples through the s2s/bi preprocessors: the text segment
    is the question, nothing is masked."""

    def __init__(self, cfg: FinetuneConfig, tokenizer,
                 entries_or_dataroot, split: str = "train",
                 image_root: str = "", seed: int = 0, image_loader=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rng = random.Random(seed)
        if isinstance(entries_or_dataroot, str):
            organ = cfg.vqa_organs[0] if len(cfg.vqa_organs) == 1 else "all"
            self.entries = load_vqa_entries(entries_or_dataroot, split,
                                            organ)
        else:
            self.entries = list(entries_or_dataroot)
        self.image_root = image_root
        self.image_loader = image_loader or self._default_image_loader
        self.pipelines, self.probs = pipelines(cfg, tokenizer, self.rng)

    def _default_image_loader(self, image_name: str) -> np.ndarray:
        return image_lib.load_image(
            os.path.join(self.image_root, image_name), self.cfg.img_size,
            grayscale_to_rgb=True, do_resize=(self.cfg.len_vis_input < 100))

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.fetch(idx)

    def fetch(self, idx: int, rng: Optional[random.Random] = None,
              load_image: bool = True
              ) -> Optional[Dict[str, np.ndarray]]:
        """``__getitem__`` with an optional per-sample RNG (see
        ``BatchLoader(workers>1)``); ``load_image=False`` makes the draws
        and returns None (``BatchLoader.skip_next``'s replay)."""
        e = self.entries[idx]
        q_tokens = self.tokenizer.tokenize(
            preprocess_question(e["question"]))
        proc = (rng or self.rng).choices(self.pipelines,
                                         weights=self.probs)[0]
        out = proc(q_tokens, rng=rng)
        if not load_image:
            return None
        out["image"] = image_lib.as_wire_image(
            self.image_loader(e["image_name"]))
        out["ans_target"] = soft_target(e.get("answer"),
                                        self.cfg.vqa_num_answers)
        out["ans_type"] = np.int32(
            ANS_TYPE.get(str(e["answer_type"]).strip().upper(), 0))
        out["organ"] = np.int32(
            ORGAN.get(str(e["image_organ"]).strip().upper(), 0))
        return out


def synthetic_vqa_entries(n: int, num_answers: int = 458, seed: int = 0
                          ) -> List[dict]:
    """Synthetic entries shaped like ``load_vqa_entries``' for tests and
    smoke runs (images ``img{i}.jpg``)."""
    rng = random.Random(seed)
    words = [f"word{i}" for i in range(30)]
    entries = []
    for i in range(n):
        labels = rng.sample(range(num_answers), rng.randint(1, 2))
        entries.append(dict(
            qid=i, image_name=f"img{i}.jpg", image=i,
            question=" ".join(rng.choices(words, k=rng.randint(3, 10)))
            + "? -yes/no",
            answer=dict(labels=labels, scores=[1.0] * len(labels)),
            answer_type=rng.choice(["CLOSED", "OPEN"]),
            image_organ="CHEST"))
    return entries
