"""Device milliseconds per optimizer update: the ``update`` phase of the
graph that applies it, from the backward pass's end to the micro-step's
(the gradients' division, the optimizer's step, their clearing and the
metrics' sum; the port's tracing, ``program_trace``)."""
from benchmark import program_trace


def read(ctx):
    return program_trace.phase_ms("update")
