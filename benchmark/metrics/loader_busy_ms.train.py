"""The loader thread's milliseconds per group it placed on the device in
the traced window: its ``loader.fetch`` (the upstream batches, stacked),
``loader.pin`` and ``loader.h2d`` spans (the port's tracing,
``program_trace``)."""
from benchmark import program_trace


def read(ctx):
    return program_trace.loader_ms_per_group()
