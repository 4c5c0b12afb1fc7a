"""Shared helpers for the CLI entry points (copies of medvill_tpu/cli's).

The entry points, each ``python -m medvill_torch.cli.<name>``:
``serve_main``, ``pretrain_main``, ``finetune_main``, ``decode_main``,
``classification_main`` and ``retrieval_main``.
"""
import logging

from medvill_torch.data.native_tokenizer import NativeBertTokenizer
from medvill_torch.data.tokenization import BertTokenizer


def make_tokenizer(vocab_file: str, remap_unused: bool = False):
    """The native-backed tokenizer (``data/native_tokenizer.py``) where its
    library builds and loads, else, with a warning, the Python tokenizer:
    the same ids either way (medvill_tpu/cli/pretrain_main.py:38-48).  The
    pretrain, finetune, classification and retrieval CLIs build theirs
    here, with JAX's ``remap_unused``: False, True, False, False."""
    tokenizer = NativeBertTokenizer(vocab_file, remap_unused=remap_unused)
    if tokenizer.native_available:
        return tokenizer
    logging.getLogger("medvill_torch").warning(
        "the native wordpiece library did not build or load (g++ -> "
        "medvill_torch/ops/_build/): tokenizing in Python, the same ids, "
        "slower")
    return BertTokenizer.from_vocab_file(vocab_file,
                                         remap_unused=remap_unused)


def window_positions(mode: str, model_path, logger=None) -> str:
    """``--decode_positions``, with ``auto`` resolved from the checkpoint's
    provenance, as the JAX decode and serve CLIs resolve it
    (medvill_tpu/cli/decode_main.py:201-215): a torch checkpoint finetuned
    by the reference decodes every window at positions 0/1 as the
    reference decoder does ("reference"); one finetuned by this port
    (``checkpoint.trained_here``: the JAX CLIs' orbax case) and the random
    init (no ``model_path``) take the train forward's layout ("train")."""
    if mode != "auto":
        return mode
    from medvill_torch.checkpoint import trained_here

    kind = ("random-init" if model_path is None
            else "medvill_torch" if trained_here(model_path) else "torch")
    mode = "reference" if kind == "torch" else "train"
    if logger is not None:
        logger.info("decode_positions auto -> %s (checkpoint kind: %s)",
                    mode, kind)
    return mode


def str2bool(v):
    """Canonical truthy-string parser shared by every CLI."""
    return str(v).lower() in ("1", "true", "yes")


def collect_metrics(agg: dict, metrics: dict, is_group: bool) -> None:
    """Appends a step's device metrics to ``agg`` (name -> list of
    per-micro-step tensors); a dispatch's metrics are stacked [k]."""
    for k, v in metrics.items():
        agg.setdefault(k, []).extend(v.unbind(0) if is_group else (v,))


def sampling_kwargs(args, beam_size: int) -> dict:
    """Validated DecodeSettings kwargs for --do_sample/--temperature/
    --top_k/--top_p, shared by the decode and serve CLIs and checked at
    startup so a bad value fails before the first request.  Raises
    ValueError on out-of-range values, on sampling knobs given without
    --do_sample, and on --do_sample with beam search."""
    do_sample, temperature, top_k, top_p = (
        args.do_sample, args.temperature, args.top_k, args.top_p)
    if do_sample and beam_size > 1:
        # the reference samples only in its non-beam loop (model.py:1213)
        raise ValueError("--do_sample requires --beam_size 1 "
                         "(sampling is a greedy-loop mode, model.py:1213)")
    if not do_sample and (temperature != 1.0 or top_k != 0 or top_p != 1.0):
        raise ValueError(
            "--temperature/--top_k/--top_p require --do_sample")
    if temperature <= 0.0:
        raise ValueError(f"--temperature must be > 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"--top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"--top_p must be in (0, 1], got {top_p}")
    return dict(sample_mode="sample" if do_sample else "greedy",
                temperature=temperature, top_k=top_k, top_p=top_p)
