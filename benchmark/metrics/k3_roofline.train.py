"""K3's share of its roofline, in %: the least time of the window's calls
of the dropout-add-LayerNorm kernel K3 (forward K3, backward K4; `flops.ln_bounds`),
summed over the micro-steps from their batches' shapes and mask specs,
over the device time of K3's kernels in the window.  None where no K3
kernel ran."""


def read(ctx):
    s = ctx.op_seconds("K3")
    return ctx.bounds["K3"] / s * 100.0 if s > 0 else None
