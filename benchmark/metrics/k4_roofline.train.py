"""K4's share of its roofline, in %: the least time of the window's calls
of the dropout-add-LayerNorm kernel K4 (forward K3, backward K4; `flops.ln_bounds`),
summed over the micro-steps from their batches' shapes and mask specs,
over the device time of K4's kernels in the window.  None where no K4
kernel ran."""


def read(ctx):
    s = ctx.op_seconds("K4")
    return ctx.bounds["K4"] / s * 100.0 if s > 0 else None
