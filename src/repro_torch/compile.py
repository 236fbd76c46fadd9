"""Program registry for serving: one captured CUDA graph per key.

The port's counterpart of the reference's ``repro/compile.py``.  There,
the serving engine reaches one ahead-of-time compiled XLA program per
``(kind, bucket[, component])`` through a shared ``ProgramRegistry``.  On
CUDA the counterpart of such a program is a captured CUDA graph
(``torch.cuda.CUDAGraph``): the query's whole launch sequence, recorded
once on static input buffers and replayed with no Python and no host-side
launch cost.

  * :meth:`ProgramRegistry.capture` is the counterpart of ``aot``: it
    returns the :class:`GraphProgram` (on a CUDA model) or
    :class:`EagerProgram` (on a CPU model) cached under ``(anchor, key)``.
    The device decides which: there is no capture on the CPU, and no
    failure is caught to choose.  A failed capture on the card raises.
  * Keys are ``(anchor, key)``: ``anchor`` is the model, held weakly, so a
    dead model releases its programs (and its graphs' memory pool); ``key``
    is a hashable tuple such as ``(kind, bucket[, component])``.
  * Each anchor has one CUDA graph memory pool, shared by all its graphs:
    a graph's intermediates are free again when its capture ends, so a
    later capture may place its own intermediates, or its static output,
    in the same blocks.  Replaying one graph can therefore overwrite
    another graph's static output, so a graph's output is valid only until
    any program of the same model replays.  :meth:`GraphProgram.__call__`
    hands back a copy made right after its replay (on the same stream),
    so what a caller holds stays valid whatever replays next.
  * Capture counts and seconds, and cache hits, are tracked per registry
    (``stats``) and through ``repro_torch.obs`` (:func:`obs.compile_event`,
    :func:`obs.cache_event`, kind ``"graph"`` or ``"eager"``); the capture
    span is ``compile.graph``.

A graph replays the weights it read at capture by address.  So a
:class:`GraphProgram` checks, on every call, that every tensor the model
reads (:func:`read_tensors`: parameters and buffers, a mixture's stacked
tensors included) still has the ``data_ptr`` it had at capture; if one
moved, it recaptures and counts a compile.  This is the counterpart of
the reference passing the params as a program argument: an in-place
``copy_`` (training's M-step) needs no recapture, a replaced tensor does.

A replay runs no Python, so the kernel ops' launch counters
(``kernels.dispatch.KernelOp.launches``) count the wrappers' calls only:
the warm-up run and the capture of each program, and nothing a replay
launches.  What a replay launches on the device is measured, not
inferred: ``chip_smoke.py`` profiles one replay of each program and holds
its kernels against an eager call's.

The reference's second path, ``jit`` (training steps), has no counterpart
here yet: training-step graphs are later work (ROADMAP, Queue 1 item 3).
:data:`REGISTRY` is the process-wide default; passing an explicit
registry isolates its statistics (benchmarks, tests).
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, Union

import torch

from repro_torch import obs

QueryFn = Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor]
# capture(run, device, pool) -> (replay, static output): records ``run()``
CaptureFn = Callable[[Callable[[], torch.Tensor], torch.device, Any],
                     Tuple[Callable[[], None], torch.Tensor]]


def read_tensors(model) -> List[torch.Tensor]:
    """Every tensor a query of ``model`` reads in place: its parameters
    and buffers, and those of its shared structure (``model.component``,
    which a mixture holds outside its submodules)."""
    mods = [model]
    comp = getattr(model, "component", None)
    if isinstance(comp, torch.nn.Module):
        mods.append(comp)
    out: List[torch.Tensor] = []
    for m in mods:
        out += list(m.parameters())
        out += list(m.buffers())
    return out


def _pointers(model) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in read_tensors(model))


def capture_cuda_graph(run: Callable[[], torch.Tensor], device: torch.device,
                       pool) -> Tuple[Callable[[], None], torch.Tensor]:
    """Capture ``run()`` into a CUDA graph on a side stream, allocating in
    the memory pool ``pool``; returns (replay, static output).  The caller
    has warmed ``run`` up already (first-use caches filled outside the
    capture)."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    torch.cuda.synchronize(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = run()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph.replay, out


class EagerProgram:
    """A CPU model's program: the query function itself, run eagerly."""

    kind = "eager"

    def __init__(self, anchor, key: Hashable, fn: QueryFn):
        self.key = key
        self._anchor = weakref.ref(anchor)
        self._fn = fn

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._fn(_alive(self._anchor), batch)


def _alive(ref):
    anchor = ref()
    if anchor is None:
        raise ReferenceError("the program's model no longer exists")
    return anchor


class GraphProgram:
    """One captured CUDA graph: static input buffers shaped like the
    example batch, the graph, and its static output."""

    kind = "graph"

    def __init__(self, registry: "ProgramRegistry", anchor, key: Hashable,
                 fn: QueryFn, example_batch: Dict[str, torch.Tensor]):
        self.key = key
        self._registry = registry
        self._anchor = weakref.ref(anchor)
        self._fn = fn
        # allocated outside any capture and outside inference mode, so the
        # buffers are normal tensors that every call writes in place
        with torch.inference_mode(False):
            self._static = {k: torch.empty(v.shape, dtype=v.dtype,
                                           device=v.device).copy_(v)
                            for k, v in example_batch.items()}
        self.device = next(iter(self._static.values())).device
        self.replays = 0
        self.capture_s = self._capture(anchor)

    def _warm_up(self, run: Callable[[], torch.Tensor]) -> None:
        """One real run before the capture, on a side stream on the card
        (as ``torch.cuda.graphs`` asks): it fills the caches that allocate
        on first use (kernel libraries, packed gather tables, function
        attributes), so none of them is filled inside the capture."""
        if self.device.type != "cuda":
            run()
            return
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            run()
        torch.cuda.current_stream(self.device).wait_stream(stream)

    def _capture(self, anchor) -> float:
        fn, static = self._fn, self._static

        def run():
            return fn(anchor, static)

        self._replay = self._out = None  # the old graph goes first
        with obs.timed("compile.graph", key=repr(self.key)) as t:
            self._warm_up(run)
            capture = self._registry.capture_fn or capture_cuda_graph
            self._replay, self._out = capture(
                run, self.device, self._registry.pool(anchor, self.device))
        self._pointers = _pointers(anchor)
        return t.seconds

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Copy ``batch`` into the static buffers, recapture if a tensor
        the model reads has moved, replay, and return a copy of the static
        output (which the next replay of any program of the model may
        overwrite)."""
        anchor = _alive(self._anchor)
        for k, buf in self._static.items():
            src = batch[k]
            if tuple(src.shape) != tuple(buf.shape) or src.dtype != buf.dtype:
                raise ValueError(
                    f"program {self.key!r}: batch field {k!r} is "
                    f"{src.dtype} {tuple(src.shape)}, captured as "
                    f"{buf.dtype} {tuple(buf.shape)}")
            buf.copy_(src)
        if _pointers(anchor) != self._pointers:
            self._registry._count_compile(self.kind, self.key,
                                          self._capture(anchor))
        self._replay()
        self.replays += 1
        return self._out.clone()


Program = Union[GraphProgram, EagerProgram]


class ProgramRegistry:
    """One cache of programs, keyed ``(anchor, key)``.

    ``capture_fn`` replaces :func:`capture_cuda_graph` as the way a graph
    is recorded, and makes programs graphs on any device: the seam a test
    uses to exercise the graph bookkeeping on the CPU.  By default a CUDA
    model's programs are graphs and a CPU model's eager.
    """

    def __init__(self, capture_fn: Optional[CaptureFn] = None):
        self.capture_fn = capture_fn
        self.clear()

    # ------------------------------------------------------------- inspection
    def table(self, anchor) -> Dict[Hashable, Program]:
        """The (mutable) key -> program table anchored to ``anchor``, in
        capture order."""
        tab = self._tables.get(anchor)
        if tab is None:
            tab = {}
            self._tables[anchor] = tab
        return tab

    def num_programs(self, anchor=None) -> int:
        if anchor is not None:
            return len(self._tables.get(anchor, ()))
        return sum(len(t) for t in self._tables.values())

    def clear(self) -> None:
        self._tables: "weakref.WeakKeyDictionary[Any, Dict]" = (
            weakref.WeakKeyDictionary())
        self._pools: "weakref.WeakKeyDictionary[Any, Any]" = (
            weakref.WeakKeyDictionary())
        self.stats = {"compiles": 0, "compile_s": 0.0, "hits": 0}

    def pool(self, anchor, device: torch.device):
        """``anchor``'s CUDA graph memory pool (made on first use; None off
        the card)."""
        if device.type != "cuda":
            return None
        handle = self._pools.get(anchor)
        if handle is None:
            handle = torch.cuda.graph_pool_handle()
            self._pools[anchor] = handle
        return handle

    def pool_bytes(self, anchor) -> int:
        """Bytes the card holds in ``anchor``'s graph memory pool (0
        without one), from the caching allocator's snapshot."""
        handle = self._pools.get(anchor)
        if handle is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(handle))

    # ---------------------------------------------------------------- capture
    def capture(self, anchor, key: Hashable, fn: QueryFn,
                example_batch: Dict[str, torch.Tensor]) -> Program:
        """The program of ``fn(anchor, batch)`` for batches shaped like
        ``example_batch`` (a dict of tensors on the model's device), cached
        under ``(anchor, key)``.  ``fn`` takes the model as an argument so
        that the program holds it weakly."""
        table = self.table(anchor)
        prog = table.get(key)
        if prog is not None:
            self.stats["hits"] += 1
            obs.cache_event(prog.kind, hit=True)
            return prog
        device = next(iter(example_batch.values())).device
        if self.capture_fn is None and device.type != "cuda":
            prog = EagerProgram(anchor, key, fn)
            seconds = 0.0
        else:
            prog = GraphProgram(self, anchor, key, fn, example_batch)
            seconds = prog.capture_s
        self._count_compile(prog.kind, key, seconds)
        table[key] = prog
        return prog

    def _count_compile(self, kind: str, key: Hashable, seconds: float) -> None:
        self.stats["compiles"] += 1
        self.stats["compile_s"] += seconds
        obs.compile_event(kind, key, seconds)


# The process-wide default registry: serving engines and the direct path
# share it unless a caller passes its own (benchmarks and tests that count
# compiles).
REGISTRY = ProgramRegistry()
