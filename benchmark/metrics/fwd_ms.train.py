"""Device milliseconds per micro-step from the image encoder's end to the
loss: the graphed micro-step's ``forward`` phase (the port's tracing,
``program_trace``)."""
from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms("forward")
