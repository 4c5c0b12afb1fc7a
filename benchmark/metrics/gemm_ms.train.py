"""Device milliseconds per micro-step in GEMM kernels (``kernels.KINDS``):
the encoder's and the heads' products."""


def read(ctx):
    s = ctx.op_seconds("gemm")
    return s / ctx.micro_steps * 1e3 if s > 0 and ctx.micro_steps else None
