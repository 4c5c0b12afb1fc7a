"""Shared helpers for the CLI entry points (copies of medvill_tpu/cli's).

The entry points, each ``python -m medvill_torch.cli.<name>``:
``serve_main``, ``pretrain_main``, ``finetune_main``, ``decode_main``,
``classification_main`` and ``retrieval_main``.
"""


def str2bool(v):
    """Canonical truthy-string parser shared by every CLI."""
    return str(v).lower() in ("1", "true", "yes")


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
