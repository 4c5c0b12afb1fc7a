"""The share of the traced window in which no operation ran on the
device, in %."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return (1.0 - ctx.busy_s / ctx.window_s) * 100.0
