"""Shared helpers for the CLI entry points (copies of medvill_tpu/cli's)."""


def str2bool(v):
    """Canonical truthy-string parser shared by every CLI."""
    return str(v).lower() in ("1", "true", "yes")


def sampling_kwargs(args) -> dict:
    """Validated DecodeSettings kwargs for --do_sample/--temperature/
    --top_k/--top_p, checked at startup so a bad value fails before the
    first request.  Raises ValueError on out-of-range values and on
    sampling knobs given without --do_sample."""
    do_sample, temperature, top_k, top_p = (
        args.do_sample, args.temperature, args.top_k, args.top_p)
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
