"""Device milliseconds per micro-step outside every graph replay: the
traced window less the replays' ``start``-to-``end`` time (the port's
tracing, ``program_trace``), over the window's micro-steps.  The idle
share less this is the idle time inside the replays."""
from benchmark import program_trace


def read(ctx):
    got = program_trace.phase("replay")
    if not got or not ctx.micro_steps or ctx.window_s <= 0:
        return None
    return (ctx.window_s * 1e3 - got["ms"]) / ctx.micro_steps
