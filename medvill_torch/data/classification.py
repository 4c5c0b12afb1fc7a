"""Classification (MMBT) data pipeline (a copy of
medvill_tpu/data/classification.py; reference:
Downstream_task/Classification/mmbt/data/dataset.py, data/helpers.py):

- label scan: ``get_labels_and_frequencies`` counts comma-split CheXpert
  labels with empty -> "'Others'" (helpers.py:32-45);
- ``pos_weights``: the BCE pos_weight (N - freq) / freq per class;
- per example: the text window ``tokens[:max - 1] + [SEP]`` (the mmbt
  layout drops the leading [SEP]; segments are 1, dataset.py:36-83);
- ``drop_img_percent`` applied once under ``numpy_seed(0)``
  (dataset.py:22-25);
- a missing image -> a constant gray 128 placeholder (dataset.py:75);
- ``task_type`` "multilabel": a multi-hot label with "'Others'" for an
  empty one (dataset.py:56-64); "classification": the class index.

Every batch is padded to ``max_seq_len - num_image_embeds`` text
positions with ``txt_len`` carrying the valid ones, as in the JAX package
(the reference collates to the batch's longest text).
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medvill_torch.data import images as image_lib
from medvill_torch.utils.seed import numpy_seed


def get_labels_and_frequencies(path_or_records) -> Tuple[List[str], Counter]:
    if isinstance(path_or_records, str):
        with open(path_or_records) as f:
            data_labels = [json.loads(line)["label"] for line in f]
    else:
        data_labels = [r["label"] for r in path_or_records]
    label_freqs: Counter = Counter()
    for label_row in data_labels:
        rows = ["'Others'"] if label_row == "" else label_row.split(", ")
        label_freqs.update(rows)
    return list(label_freqs.keys()), label_freqs


def pos_weights(label_freqs: Counter, labels: Sequence[str],
                train_len: int) -> np.ndarray:
    """BCE pos_weight = (N - freq) / freq per class (reference:
    mmbt/main.py:93-104 label_weights)."""
    freqs = np.array([label_freqs[l] for l in labels], dtype=np.float64)
    return ((train_len - freqs) / freqs).astype(np.float32)


class ClassificationDataset:
    def __init__(self, data_path_or_records, tokenizer, labels: Sequence[str],
                 max_seq_len: int, num_image_embeds: int, img_size: int,
                 drop_img_percent: float = 0.0, openi: bool = False,
                 image_loader=None, task_type: str = "multilabel"):
        # task_type: "multilabel" emits a multi-hot target (reference
        # dataset.py:56-66); "classification" emits the single-label class
        # index (reference dataset.py:62-64 LongTensor path)
        assert task_type in ("multilabel", "classification")
        self.task_type = task_type
        if isinstance(data_path_or_records, str):
            self.data_dir = os.path.dirname(data_path_or_records)
            with open(data_path_or_records) as f:
                self.data = [json.loads(l) for l in f]
        else:
            self.data_dir = ""
            self.data = [dict(r) for r in data_path_or_records]
        self.tokenizer = tokenizer
        self.labels = list(labels)
        self.n_classes = len(self.labels)
        self.max_seq_len = max_seq_len - num_image_embeds
        self.img_size = img_size
        self.openi = openi
        self.image_loader = image_loader or self._default_image_loader
        if drop_img_percent > 0:
            with numpy_seed(0):
                for row in self.data:
                    if np.random.random() < drop_img_percent:
                        row["img"] = None

    def _default_image_loader(self, img_path: Optional[str]) -> np.ndarray:
        if not img_path:
            gray = np.full((self.img_size, self.img_size, 3), 128, np.uint8)
            return gray  # uint8 wire format; device_normalize handles it
        return image_lib.load_image(
            os.path.join(self.data_dir, img_path), self.img_size,
            grayscale_to_rgb=self.openi, do_resize=False)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.data[index]
        vocab = self.tokenizer.vocab
        unk = vocab["[UNK]"]
        # [SEP] start token for mmbt; window max_seq_len - 1
        tokens = self.tokenizer.tokenize(row["text"])[: self.max_seq_len - 1]
        sentence = tokens + ["[SEP]"]  # leading [SEP] dropped (dataset.py:80)
        ids = [vocab.get(w, unk) for w in sentence]
        txt_len = len(ids)
        ids = ids + [vocab["[PAD]"]] * (self.max_seq_len - txt_len)
        segment = [1] * self.max_seq_len  # text segment shifted to 1

        if self.task_type == "multilabel":
            label = np.zeros(self.n_classes, np.float32)
            lab = row["label"] if row["label"] != "" else "'Others'"
            for tgt in lab.split(", "):
                label[self.labels.index(tgt)] = 1.0
        else:
            # single-label class index (reference dataset.py:62-64; no
            # ''->Others fill in this branch)
            label = np.int32(self.labels.index(row["label"]))

        image = self.image_loader(row.get("img"))
        return dict(
            input_txt=np.array(ids, np.int32),
            txt_len=np.int32(txt_len),
            segment=np.array(segment, np.int32),
            image=image_lib.as_wire_image(image),
            label=label,
        )


def synthetic_clf_records(n: int, labels: Sequence[str], seed: int = 0
                          ) -> List[dict]:
    import random

    rng = random.Random(seed)
    words = [f"word{i}" for i in range(50)]
    recs = []
    for i in range(n):
        k = rng.randint(1, 3)
        lab = ", ".join(sorted(rng.sample(list(labels), k)))
        recs.append(dict(id=str(i), text=" ".join(
            rng.choices(words, k=rng.randint(5, 30))), label=lab,
            img=f"img{i}.jpg"))
    return recs
