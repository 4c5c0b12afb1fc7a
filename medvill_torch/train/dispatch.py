"""k training micro-steps per dispatch: the port's counterpart of
medvill_tpu/train/optim.py:233-265 ``scan_micro_steps``.

JAX runs k micro-steps in one jit dispatch (``lax.scan`` over a ``[k, B,
...]`` batch) so that the host's cost per dispatch is paid once per k.
PyTorch launches each operation from the host, so the port's counterpart
is a CUDA graph: ``MultiStep`` captures the training micro-step of a step
factory (forward, backward and, where the accumulation applies, the
gradient division, the optimizer update and the in-place clearing of the
gradients) over static device buffers and replays it once per micro-step
of a k-batch group.

- ``MicroStep`` is a step factory's micro-step in the form both paths run:
  ``draw`` takes what the host draws for it from the run's generator (the
  random-pixel indices, then the dropout seed, in the order the eager step
  always drew them), ``body`` is the device work a graph captures.  Called
  as ``step(state, batch, generator)`` it is the eager micro-step.  Its
  dropout randomness is one ``DropoutRNG`` per run and device: the kernels
  K1-K4 read their seeds from a device word that ``reseed`` rewrites before
  every micro-step, eager or replayed, and the plain dropouts draw from one
  persistent device generator that every graph registers.  So k = 1 and
  k > 1 draw the same masks in the same order.
- ``MultiStep(micro, k)(state, group, generator)`` takes a group
  ``[k, B, ...]`` (``data.pretrain.dispatch_loader(..., k=k)``) and returns
  the metrics stacked ``[k]`` on the device, as JAX's scan does.  On a CUDA
  device it keeps two graphs: the micro-step that only accumulates and the
  one that also applies the update; the host's ``Accumulate.count`` picks
  which one a micro-step replays, so any k and any accumulation work.  The
  first micro-step of each kind runs eagerly, on the stream the graphs are
  captured on: it makes the gradients, the optimizer's state and the
  kernels' scratch that the capture then reads in place.  A graph is
  captured again only where JAX compiles a new step: for a new batch shape
  or a new set of trainable parameters (a classification freeze phase),
  and each step factory (a drop-worst ratio) has its own.  Before each
  replay the host copies the micro-batch and the pixel draw into the
  static buffers, rewrites the seed word and the generator's seed, and
  (for an update) BertAdam's lr scalar; after it, it advances its counters
  and adds the graph's kernel launches to their counts (recorded at
  capture, where the wrappers counted launches that did not happen).  A
  capture or a replay that fails raises: there is no fall back to eager
  steps.  Once a state has been graphed its gradients are zeroed in place
  (``Accumulate.keep_grads``) for good, eager steps included, so the
  ``.grad`` buffers keep the addresses the graphs captured.
- A state restored from a checkpoint (``Accumulate.load_state_dict``) is
  copied into the tensors that exist, the ``.grad`` buffers and the
  optimizer's moments and step among them, so graphs captured before the
  restore read the restored values; in a fresh process the first
  micro-step of each kind still runs eagerly and makes them.  A resumed
  run at k > 1 equals the run that never stopped at the same k.
- On the CPU a ``MultiStep`` runs the k micro-steps eagerly, one after
  another.
- Tracing (``utils/tracing.py``, live while a profiler runs): each call
  refreshes the switch and opens the span ``dispatch`` (carrying the loader
  group it takes), with ``dispatch.draw``, ``dispatch.eager`` (a
  micro-step run eagerly), ``dispatch.capture``, ``dispatch.stage`` (the
  pixel draws' copy, the copies into the static buffers, the reseed and
  the optimizer's host work), ``dispatch.launch`` (``tracing.replay``,
  which gives the replay's phase marks events of their own, and the
  replay) and ``dispatch.collect`` inside; it counts ``dispatch.replays``
  and ``dispatch.eager_steps``.
  ``MicroStep.body`` marks the phases ``start``, ``forward`` (after the
  loss), ``backward`` and ``end`` (after the update and the metrics' sum);
  the models mark ``image`` after their image encoder.  A graph keeps the
  marks it captured (``tracing.bind``: it is captured with ``keep_graph``
  and instantiated at once, as it would be otherwise).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from medvill_torch import parallel
from medvill_torch.ops import bert_adam
from medvill_torch.ops import flash_attention as fa
from medvill_torch.ops import fused_ln
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.utils import tracing

Metrics = Dict[str, torch.Tensor]
# (model, batch, rng, pixel_indices) -> (loss, metrics)
LossFn = Callable[..., Tuple[torch.Tensor, Metrics]]

# the kernel wrappers whose launches a graph replays
COUNTED = (fa.attn_fwd, fa.attn_bwd, fused_ln.fused_ln_fwd,
           fused_ln.fused_ln_bwd, bert_adam.bert_adam)


def _device_of(batch: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(batch.values())).device


class MicroStep:
    """One training micro-step (see the module docstring).  ``loss_fn``
    computes the training loss and its device metrics; ``pixel_draw``, when
    given, draws the step's pixel indices (a CPU tensor) from the host
    generator."""

    def __init__(self, loss_fn: LossFn,
                 pixel_draw: Optional[Callable[[torch.Generator],
                                               torch.Tensor]] = None):
        self.loss_fn = loss_fn
        self.pixel_draw = pixel_draw
        self._rngs: Dict[torch.device, DropoutRNG] = {}

    def rng(self, device: torch.device) -> DropoutRNG:
        """The run's dropout randomness on ``device``."""
        if device not in self._rngs:
            self._rngs[device] = DropoutRNG(0, device)
        return self._rngs[device]

    def draw(self, generator: torch.Generator
             ) -> Tuple[Optional[torch.Tensor], int]:
        """(pixel indices or None, dropout seed) of one micro-step: every
        rank draws the same, and the seed folds in the data rank
        (``parallel.rank_seed``)."""
        pix = self.pixel_draw(generator) if self.pixel_draw else None
        return pix, parallel.rank_seed(
            int(torch.randint(0, 2 ** 31, (), generator=generator)))

    def body(self, state, batch, rng: DropoutRNG,
             pix: Optional[torch.Tensor], apply: bool) -> Metrics:
        """The device work of one micro-step: what a graph captures.  Under
        data parallelism the loss is this rank's share of the global
        batch's, and the update and the metrics are the global batch's:
        the gradients are summed over the data group when the update
        applies (``Accumulate.apply_device``), the metrics here."""
        tracing.mark("start")
        loss, metrics = self.loss_fn(state.model, batch, rng, pix)
        tracing.mark("forward")
        loss.backward()
        tracing.mark("backward")
        if apply:
            state.tx.apply_device()
        out = parallel.sum_metrics({k: v.detach() for k, v in
                                    metrics.items()})
        tracing.mark("end")
        return out

    def run(self, state, batch, pix: Optional[torch.Tensor],
            seed: int) -> Metrics:
        """One eager micro-step from its draws."""
        device = _device_of(batch)
        rng = self.rng(device)
        rng.reseed(seed)
        if pix is not None:
            pix = pix.to(device)
        apply = state.tx.applies_next()
        if apply:
            state.tx.prepare()
        metrics = self.body(state, batch, rng, pix, apply)
        state.tx.finish(apply)
        state.step += 1
        return metrics

    def __call__(self, state, batch, generator: torch.Generator) -> Metrics:
        return self.run(state, batch, *self.draw(generator))


class _Graph:
    def __init__(self, graph, batch, pix, out, launches, marks):
        self.graph, self.batch, self.pix = graph, batch, pix
        self.out, self.launches, self.marks = out, launches, marks


class MultiStep:
    """k micro-steps of ``micro`` per call (see the module docstring)."""

    def __init__(self, micro: MicroStep, k: int):
        if k < 1:
            raise ValueError(f"steps per dispatch must be >= 1, got {k}")
        self.micro, self.k = micro, int(k)
        self._graphs: Dict[str, _Graph] = {}
        self._warm: set = set()
        self._key = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    def __call__(self, state, group, generator: torch.Generator) -> Metrics:
        tracing.refresh()
        with tracing.span("dispatch"):
            return self._dispatch(state, group, generator)

    def _dispatch(self, state, group, generator: torch.Generator
                  ) -> Metrics:
        device = _device_of(group)
        with tracing.span("dispatch.draw"):
            draws = [self.micro.draw(generator) for _ in range(self.k)]
        if device.type == "cpu":
            out = []
            for i in range(self.k):
                with tracing.span("dispatch.eager"):
                    out.append(self.micro.run(
                        state, {n: t[i] for n, t in group.items()},
                        *draws[i]))
            tracing.count("dispatch.eager_steps", self.k)
            return {n: torch.stack([m[n] for m in out]) for n in out[0]}
        if device.type != "cuda":
            raise ValueError(f"steps per dispatch: no graphs on {device}")
        return self._replayed(state, group, draws, device)

    def _replayed(self, state, group, draws, device) -> Metrics:
        tx = state.tx
        tx.keep_grads = True
        key = (id(state),
               tuple((n, tuple(t.shape), t.dtype) for n, t in group.items()),
               tuple(p.requires_grad for p in state.model.parameters()))
        if key != self._key:
            self._graphs, self._warm, self._pool = {}, set(), None
            self._key = key
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side, cur = self._stream, torch.cuda.current_stream(device)
        side.wait_stream(cur)
        for t in group.values():
            t.record_stream(side)
        rng = self.micro.rng(device)
        out: List[Metrics] = []
        with torch.cuda.stream(side):
            # the pixel draws are copied on the stream that reads them
            pix_all = None
            if draws[0][0] is not None:
                with tracing.span("dispatch.stage"):
                    pix_all = torch.stack([p for p, _ in draws]) \
                        .pin_memory().to(device, non_blocking=True)
            for i, (_, seed) in enumerate(draws):
                batch = {n: t[i] for n, t in group.items()}
                pix = None if pix_all is None else pix_all[i]
                apply = tx.applies_next()
                kind = "apply" if apply else "accumulate"
                if kind not in self._warm:
                    with tracing.span("dispatch.eager"):
                        out.append(self.micro.run(state, batch, pix, seed))
                    tracing.count("dispatch.eager_steps")
                    self._warm.add(kind)
                    continue
                g = self._graphs.get(kind)
                if g is None:
                    with tracing.span("dispatch.capture"):
                        g = self._graphs[kind] = self._capture(
                            state, batch, pix, seed, apply, rng)
                with tracing.span("dispatch.stage"):
                    for n, t in g.batch.items():
                        t.copy_(batch[n])
                    if g.pix is not None:
                        g.pix.copy_(pix)
                    rng.reseed(seed)
                    if apply:
                        tx.prepare()
                with tracing.span("dispatch.launch"):
                    tracing.replay(g.marks, apply)
                    g.graph.replay()
                tracing.count("dispatch.replays")
                with tracing.span("dispatch.collect"):
                    tx.finish(apply)
                    state.step += 1
                    for fn, n in zip(COUNTED, g.launches):
                        fn.launches += n
                    out.append({n: t.clone() for n, t in g.out.items()})
        with tracing.span("dispatch.collect"):
            cur.wait_stream(side)
            for m in out:
                for t in m.values():
                    t.record_stream(cur)
            return {n: torch.stack([m[n] for m in out]) for n in out[0]}

    def _capture(self, state, batch, pix, seed: int, apply: bool,
                 rng: DropoutRNG) -> _Graph:
        static_batch = {n: t.clone() for n, t in batch.items()}
        static_pix = None if pix is None else pix.clone()
        rng.reseed(seed)
        # kept, so that the phase marks' nodes can be found (tracing.bind)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(rng.generator)
        before = [fn.launches for fn in COUNTED]
        # thread_local: the loader's thread goes on copying the next
        # batches on its own stream while this thread captures
        with tracing.capture() as marks, \
                torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                 capture_error_mode="thread_local"):
            out = self.micro.body(state, static_batch, rng, static_pix,
                                  apply)
        graph.instantiate()
        tracing.bind(marks, graph)
        launches = []
        for fn, b in zip(COUNTED, before):
            launches.append(fn.launches - b)
            fn.launches = b  # the capture launched nothing
        self._pool = graph.pool()
        return _Graph(graph, static_batch, static_pix, out, launches, marks)

