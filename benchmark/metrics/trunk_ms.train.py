"""Device milliseconds per micro-step in the image trunk's convolution and
BatchNorm kernels (``kernels.KINDS``)."""


def read(ctx):
    s = ctx.op_seconds("convolution", "batch_norm")
    return s / ctx.micro_steps * 1e3 if s > 0 and ctx.micro_steps else None
