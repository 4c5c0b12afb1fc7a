"""K1's share of its roofline, in %: the least time of the window's calls
of the attention kernel K1 (forward K1, backward K2; `flops.attention_bounds`),
summed over the micro-steps from their batches' shapes and mask specs,
over the device time of K1's kernels in the window.  None where no K1
kernel ran."""


def read(ctx):
    s = ctx.op_seconds("K1")
    return ctx.bounds["K1"] / s * 100.0 if s > 0 else None
