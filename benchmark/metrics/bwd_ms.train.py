"""Device milliseconds per micro-step in the backward pass: the graphed
micro-step's ``backward`` phase (the port's tracing, ``program_trace``)."""
from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms("backward")
