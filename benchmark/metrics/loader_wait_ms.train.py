"""Host milliseconds per dispatch that the window's loop waited on
``next()`` of ``dispatch_loader`` (the benchmark's ``loader_wait`` span):
the input pipeline's pinned copies and side-stream prefetch, as far as
they hold the step back."""


def read(ctx):
    waits = ctx.span_seconds("loader_wait")
    return sum(waits) / len(waits) * 1e3 if waits else None
