"""The whole training step's share of the device's dense bf16 peak, in %:
the model FLOPs of the traced window's micro-steps (``flops.model_flops``:
what the model needs, whichever kernels do it) over the window's wall time
and 989 TFLOP/s (H100 SXM)."""


def read(ctx):
    if not ctx.micro_steps or ctx.window_s <= 0:
        return None
    return ctx.flops / ctx.window_s / ctx.peak_flops * 100.0
