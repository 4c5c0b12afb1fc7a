"""Device milliseconds per optimizer update in the optimizer's kernels
(multi-tensor and Adam kernels, ``kernels.KINDS``)."""


def read(ctx):
    s = ctx.op_seconds("optimizer")
    return s / ctx.updates * 1e3 if s > 0 and ctx.updates else None
