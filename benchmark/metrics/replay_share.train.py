"""The share of the traced window's micro-steps that replayed a CUDA
graph, in %: the port's counters ``dispatch.replays`` over it and
``dispatch.eager_steps``."""
from benchmark import program_trace


def read(ctx):
    replays = program_trace.counter("dispatch.replays")
    total = replays + program_trace.counter("dispatch.eager_steps")
    return replays / total * 100.0 if total else None
