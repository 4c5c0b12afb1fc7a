"""Pretraining data pipeline: JSONL -> numpy batches of (ids, labels, spec)
(a copy of medvill_tpu/data/pretrain.py without its multi-host sharding),
with its mid-epoch resume (``BatchLoader.skip_next``), and the training
CLIs' input pipeline,
``dispatch_loader``: a ``PrefetchLoader`` that builds, groups
(``grouped_batches``, for k micro-steps per dispatch) and places the next
batches on the device on a background thread while the step runs.

Each example carries a 2-int mask spec ``(variant, txt_len)`` instead of an
``[L, L]`` mask (data/masks.py).  JSONL schema (reference:
dataset_origin.py:211-216): ``{"id", "split", "label", "text", "img"}``.
From the same records, tokenizer, config and seed the batches equal the JAX
package's bit for bit.
"""
from __future__ import annotations

import inspect
import json
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from medvill_torch.config import MaskVariant, PretrainConfig
from medvill_torch.data import images as image_lib
from medvill_torch.data.sampling import (random_pair_sampling, random_word,
                                         truncate_txt)


class CXRPretrainDataset:
    """Per-example processing; indexable like the torch Dataset."""

    def __init__(self, data_path_or_records, tokenizer, cfg: PretrainConfig,
                 seed: int = 0, image_loader=None):
        if isinstance(data_path_or_records, str):
            self.data_dir = os.path.dirname(data_path_or_records)
            with open(data_path_or_records) as f:
                self.data = [json.loads(line) for line in f]
        else:
            self.data_dir = ""
            self.data = list(data_path_or_records)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.seq_len = cfg.seq_len
        self.num_image_embeds = cfg.image.num_image_embeds
        self.vocab = tokenizer.vocab
        self.vocab_len = len(self.vocab)
        self.rng = random.Random(seed)
        self.image_loader = image_loader or self._default_image_loader
        self.static_variant = cfg.resolve_variant()  # None => Mixed

    def _default_image_loader(self, img_path: str) -> np.ndarray:
        return image_lib.load_image(
            os.path.join(self.data_dir, img_path), self.cfg.image.img_size,
            channels=self.cfg.image.img_channel,
            # the 512 path skips the resize, as the reference does
            # (helper.py:19-27): dataset images are already 512
            do_resize=(self.cfg.image.img_size == 224))

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.fetch(idx)

    def fetch(self, idx: int, rng: Optional[random.Random] = None,
              load_image: bool = True
              ) -> Optional[Dict[str, np.ndarray]]:
        """Like ``__getitem__`` with an optional per-sample RNG (used by
        ``BatchLoader(workers>1)``); ``None`` draws from the shared
        sequential stream.  ``load_image=False`` (``BatchLoader.skip_next``'s
        replay) makes every draw of a real fetch, loads no image and
        returns None."""
        rng = rng or self.rng
        origin_txt, img_path, is_aligned, _ = random_pair_sampling(
            idx, self.data, rng)
        encoded = self.tokenizer.tokenize_to_ids(origin_txt)
        truncate_txt(encoded, self.seq_len)
        input_ids, txt_labels = random_word(encoded, self.vocab_len,
                                            self.vocab["[MASK]"], rng)

        # [SEP] + label layout (reference: dataset_origin.py:104-126; the
        # disturbing layout adds a leading -100 for the extra text-CLS)
        input_ids = input_ids + [self.vocab["[SEP]"]]
        if self.cfg.disturbing_mask:
            txt_labels_t = [-100] + txt_labels + [-100]
        else:
            txt_labels_t = txt_labels + [-100]
        txt_labels_i = [-100] * (self.num_image_embeds + 2)

        txt_len = len(input_ids)  # valid text positions incl. [SEP]
        n_pad = self.seq_len - txt_len + 1
        input_ids = input_ids + [self.vocab["[PAD]"]] * n_pad
        txt_labels_t = txt_labels_t + [-100] * n_pad
        segment = [1] * (self.seq_len + 1)  # reference: dataset_origin.py:129

        if self.static_variant is None:
            # Mixed: per-sample weighted choice (dataset_origin.py:152-156)
            variant = (MaskVariant.FULL
                       if rng.random() < self.cfg.bi_prob else MaskVariant.S2S)
        else:
            variant = self.static_variant
        if not load_image:  # every draw is made: the image takes none
            return None

        return dict(
            cls_tok=np.array([self.vocab["[CLS]"]], np.int32),
            input_txt=np.array(input_ids, np.int32),
            txt_labels=np.array(txt_labels_i + txt_labels_t, np.int32),
            mask_spec=np.array([int(variant), txt_len], np.int32),
            image=image_lib.as_wire_image(self.image_loader(img_path)),
            segment=np.array(segment, np.int32),
            is_aligned=np.int32(is_aligned),
            sep_tok=np.array([self.vocab["[SEP]"]], np.int32),
        )


def collate(samples: Sequence[Dict[str, np.ndarray]]
            ) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Epoch iterator with shuffling (reference: DataLoader,
    main_origin.py:52-54).  ``drop_last`` (default) keeps every batch the
    same shape.  ``workers > 1`` fetches each batch's samples on a thread
    pool, each sample with an RNG derived from (seed, epoch, index), so an
    epoch is the same for any worker count; ``workers == 1`` draws from the
    dataset's shared sequential stream.  The shuffle order is numpy's
    ``default_rng(seed + epoch)``, as in the JAX package.  ``close`` stops
    the thread pool.

    ``skip_next(n)`` skips the first n batches of the next iteration only
    (mid-epoch resume, medvill_tpu/data/pretrain.py:191-209): the order is
    a pure function of (seed, epoch), so the rest equal an uninterrupted
    epoch's tail; with ``workers > 1`` so do their samples (their RNG is
    (seed, epoch, index)); with ``workers == 1`` the skipped samples' draws
    are replayed from the shared stream through ``fetch(idx,
    load_image=False)`` (a dataset without that keyword is skipped by
    position only).  ``state(in_epoch)`` is where the loader stands, for a
    resume: with ``in_epoch`` the epoch of the latest iteration and its
    shared stream's (``dataset.rng``) state at that iteration's start (a
    run stopped inside that epoch; the prefetch may have read on), else the
    next epoch and the stream's state now (a run between epochs).
    ``load_state`` puts it back, so a resumed run replays the stream from
    where the interrupted one stood (the JAX package restarts it from the
    seed), and ``resume_at(epoch, batches_done)`` sets the skip (an epoch
    begun and not finished before it runs as a skipped iteration)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, workers: int = 1, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.workers = workers
        self.drop_last = drop_last
        self._pool: Optional[ThreadPoolExecutor] = None
        self._skip = 0
        self._at_start = {"epoch": 0, "stream": None}

    def skip_next(self, n_batches: int) -> None:
        self._skip = int(n_batches)

    def _stream(self) -> Optional[random.Random]:
        stream = getattr(self.dataset, "rng", None)
        return stream if isinstance(stream, random.Random) else None

    def state(self, in_epoch: bool) -> dict:
        if in_epoch:
            return dict(self._at_start)
        stream = self._stream()
        return {"epoch": self.epoch,
                "stream": None if stream is None else stream.getstate()}

    def load_state(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        stream = self._stream()
        if state["stream"] is not None and stream is not None:
            stream.setstate(state["stream"])

    def resume_at(self, epoch: int, batches_done: int) -> tuple:
        """Makes the next iteration continue ``epoch`` after its first
        ``batches_done`` batches, or the next epoch where they are all of
        them; returns that (epoch, batches skipped)."""
        if batches_done >= len(self):
            epoch, batches_done = epoch + 1, 0
        while self.epoch < epoch:  # epochs begun, not finished: replayed
            self.skip_next(len(self))
            for _ in self:
                pass
        self.skip_next(batches_done)
        return epoch, batches_done

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _fetch(self, idxs) -> List[Dict[str, np.ndarray]]:
        if self.workers <= 1:
            return [self.dataset[int(j)] for j in idxs]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.workers)
        fetch = getattr(self.dataset, "fetch", None)
        if fetch is None:
            return list(self._pool.map(lambda j: self.dataset[int(j)], idxs))
        epoch = self.epoch
        return list(self._pool.map(
            lambda j: fetch(int(j), random.Random(
                f"{self.seed}/{epoch}/{int(j)}")), idxs))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        stream = self._stream()
        self._at_start = {"epoch": self.epoch, "stream": None if stream is None
                          else stream.getstate()}
        # advanced before the fetches, as in the JAX package, so the
        # per-sample RNGs of epoch e are keyed by e + 1 there too
        self.epoch += 1
        B = self.batch_size
        start, self._skip = self._skip, 0
        fetch = getattr(self.dataset, "fetch", None)
        if start and self.workers <= 1 and fetch is not None and \
                "load_image" in inspect.signature(fetch).parameters:
            for j in order[:start * B]:
                fetch(int(j), load_image=False)
        for i in range(start, len(self)):
            yield collate(self._fetch(order[i * B:(i + 1) * B]))


class PrefetchLoader:
    """Wraps a batch iterable with a background thread and a queue of
    ``depth`` batches, so host preprocessing (image decode, tokenization,
    masking) and, through ``place_fn``, the copy to the device overlap the
    running step (medvill_tpu/data/pretrain.py:303-387; the reference's
    ``DataLoader(num_workers=...)``).  The batches come out in the wrapped
    iterable's order, an exception of the producer is raised on the
    consumer's side, and a consumer that stops early (break, an exception,
    early stopping) releases the producer and drops the queued batches."""

    def __init__(self, loader, depth: int = 2, place_fn=None):
        self.loader = loader
        self.depth = depth
        self.place_fn = place_fn

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            # a plain q.put would block forever once the consumer is gone
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.loader:
                    # a put racing the consumer's drain can land in the
                    # freed slot: check before fetching and placing more
                    if stop.is_set():
                        return
                    if self.place_fn is not None:
                        batch = self.place_fn(batch)
                    if not put(batch):
                        return
            except BaseException as e:  # raised on the consumer's side
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()

        def drain():
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

        try:
            while True:
                item = q.get()
                if item is end:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # on GeneratorExit too: release the producer, then drop what it
            # queued (and what one racing put added) so no placed batch
            # outlives the abandonment
            stop.set()
            drain()
            t.join(timeout=2.0)
            drain()


def _select(batch: dict, keys: Optional[Sequence[str]]) -> dict:
    return batch if keys is None else {k: batch[k] for k in keys
                                       if k in batch}


def grouped_batches(loader, k: int):
    """Groups of k host batches stacked into ``([k, B, ...] arrays, True)``
    for a k-micro-steps-per-dispatch step; the (at most k - 1) tail batches
    of an epoch come out alone as ``([B, ...], False)``, so a short epoch
    (fewer than k batches) and an epoch's tail still train, through the
    single-step path (medvill_tpu/data/pretrain.py:265-281)."""
    buf = []
    for b in loader:
        buf.append(b)
        if len(buf) == k:
            yield {key: np.stack([x[key] for x in buf]) for key in buf[0]}, \
                True
            buf = []
    for b in buf:
        yield b, False


class _CudaPrefetch:
    """``dispatch_loader`` on a CUDA device: the producer copies each batch
    (or group) into pinned host memory and from there to the device on a
    side stream (``non_blocking``: a copy from pageable memory would
    synchronize); the consumer's stream waits on that copy's event before
    the batch is handed out, and each tensor is ``record_stream``-ed to the
    consumer's stream so the allocator does not reuse it while the step
    reads it."""

    def __init__(self, items, device: torch.device):
        self.items, self.device = items, device

    def __iter__(self):
        copy_stream = torch.cuda.Stream(self.device)

        def place(item):
            batch, is_group = item
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(copy_stream):
                out = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .pin_memory().to(self.device, non_blocking=True)
                       for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(copy_stream)
            return out, is_group, done

        it = iter(PrefetchLoader(self.items, place_fn=place))
        try:
            for out, is_group, done in it:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for t in out.values():
                    t.record_stream(stream)
                yield out, is_group
        finally:
            it.close()


def dispatch_loader(loader, device, keys: Optional[Sequence[str]] = None,
                    k: int = 1):
    """The training CLIs' input pipeline (medvill_tpu/data/pretrain.py:284):
    iterates ``loader``'s numpy batches (only ``keys``, when given) on a
    background thread and yields ``(batch, is_group)`` with the tensors on
    ``device``, up to two ahead of the consumer, in the loader's order.
    With ``k > 1`` a batch is a group of k stacked ``[k, B, ...]`` in one
    pinned copy per key (``grouped_batches``, ``is_group`` True) or one of
    an epoch's tail batches (``is_group`` False); with k = 1 every batch
    comes alone."""
    device = torch.device(device)
    selected = (_select(b, keys) for b in loader)
    items = (grouped_batches(selected, k) if k > 1
             else ((b, False) for b in selected))
    if device.type == "cuda":
        return _CudaPrefetch(items, device)
    return PrefetchLoader(items, place_fn=lambda item: (
        {n: torch.as_tensor(v).to(device) for n, v in item[0].items()},
        item[1]))


def synthetic_records(n: int, rng: Optional[random.Random] = None,
                      n_labels: int = 5, words: Optional[List[str]] = None
                      ) -> List[dict]:
    """Synthetic JSONL-shaped records for tests and smoke runs."""
    rng = rng or random.Random(0)
    words = words or [f"word{i}" for i in range(50)]
    recs = []
    for i in range(n):
        text = " ".join(rng.choices(words, k=rng.randint(5, 30)))
        recs.append(dict(id=str(i), split="train",
                         label=f"label{rng.randrange(n_labels)}",
                         text=text, img=f"img{i}.jpg"))
    return recs
