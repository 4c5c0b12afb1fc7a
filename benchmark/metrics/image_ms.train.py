"""Device milliseconds per micro-step in the image encoder: the graphed
micro-step's phase from its ``start`` mark to the ``image`` mark after the
encoder (the port's tracing, ``program_trace``)."""
from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms("image")
