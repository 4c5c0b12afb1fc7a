"""Host milliseconds per dispatch inside the ``MultiStep`` call (the
benchmark's ``dispatch`` span), less the time the host spent inside the
CUDA runtime calls that wait for the device: graph launches, where a
replay waits for the previous replay of its graph to finish, and
synchronizations.  What is left is the host's own cost of a dispatch: the
draws, the copies into the static buffers, the pinned allocations and the
eager kernels' launches.  The enqueue cost of a graph launch goes out
with its wait."""

WAITS = ("cudaGraphLaunch", "cuGraphLaunch", "cudaStreamSynchronize",
         "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def read(ctx):
    spans = ctx.span_seconds("dispatch")
    if not spans:
        return None
    waits = sum(s for calls in ctx.runtime_seconds("dispatch")
                for name, s in calls.items() if name in WAITS)
    return (sum(spans) - waits) / len(spans) * 1e3
