"""K2's share of its roofline, in %: the least time of the window's calls
of the attention kernel K2 (forward K1, backward K2; `flops.attention_bounds`),
summed over the micro-steps from their batches' shapes and mask specs,
over the device time of K2's kernels in the window.  None where no K2
kernel ran."""


def read(ctx):
    s = ctx.op_seconds("K2")
    return ctx.bounds["K2"] / s * 100.0 if s > 0 else None
