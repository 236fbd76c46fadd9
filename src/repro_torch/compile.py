"""Program registry for serving and training: captured CUDA graphs.

The port's counterpart of the reference's ``repro/compile.py``.  There,
the serving engine reaches one ahead-of-time compiled XLA program per
``(kind, bucket[, component])`` through a shared ``ProgramRegistry``, and
training reaches one jitted, donated-buffer EM step per (model, config).
On CUDA the counterpart of such a program is a captured CUDA graph
(``torch.cuda.CUDAGraph``): the whole launch sequence, recorded once on
static input buffers and replayed with no Python and no host-side launch
cost.

  * :meth:`ProgramRegistry.capture` is the counterpart of ``aot``: it
    returns the :class:`GraphProgram` (on a CUDA model) or
    :class:`EagerProgram` (on a CPU model) cached under ``(anchor, key)``.
    The device decides which: there is no capture on the CPU, and no
    failure is caught to choose.  A failed capture on the card raises.
  * :meth:`ProgramRegistry.jit` is the counterpart of ``jit``: it returns
    the training step program (:class:`StepProgram` on a CUDA model,
    :class:`EagerStepProgram` on a CPU model) cached under ``(anchor,
    key)``, so two ``make_em_step`` calls with the same (model, config)
    return the same callable.  A step program captures its graphs lazily,
    once per input shape, as ``jax.jit`` compiles once per shape.  The step
    (:class:`StagedStep`) writes the model's parameters in place; see
    :class:`StepProgram` for how it is captured.
  * Keys are ``(anchor, key)``: ``anchor`` is the model, held weakly, so a
    dead model releases its programs (and its graphs' memory pool); ``key``
    is a hashable tuple such as ``(kind, bucket[, component])``.
  * An anchor's serving programs share one CUDA graph memory pool: a
    graph's intermediates are free again when its capture ends, so a
    later capture may place its own intermediates, or its static output,
    in the same blocks.  Replaying one graph can therefore overwrite
    another graph's static output, so a graph's output is valid only until
    any program of the same model replays.  :meth:`GraphProgram.__call__`
    hands back a copy made right after its replay (on the same stream),
    so what a caller holds stays valid whatever replays next.
  * Each captured step shape (:class:`StepGraphs`) has a pool of its own,
    made for that capture and dropped with it: when a step program, or
    one of its shapes, goes, the card gets its memory back.  A recapture
    takes a fresh pool, so no capture ever reuses a released pool.
  * Capture counts and seconds, and cache hits, are tracked per registry
    (``stats``) and through ``repro_torch.obs`` (:func:`obs.compile_event`,
    :func:`obs.cache_event`, kind ``"graph"`` or ``"eager"``); the capture
    span is ``compile.graph``.
  * Each capture of a program runs under a capture observer
    (``repro_torch.obs.capture``): the program's spans put its graph's
    nodes down to layers, published as ``compile.graph.nodes{program,
    span}`` and a layer map.  The program label comes from its key
    (:func:`query_label`, :func:`step_label`: ``query.joint_ll.64``,
    ``em_step``, and ``em_step.body`` for a staged step's body graph).
    Each replay adds one to ``compile.graph.replays{program}``, a counter
    taken at capture.  A serving program on the card also times each
    replay on the device between one reused pair of CUDA events
    (:meth:`GraphProgram.replay_seconds`, read after the caller's own
    synchronisation).

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

:data:`REGISTRY` is the process-wide default; passing an explicit
registry isolates its statistics (benchmarks, tests).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, Union

import torch

from repro_torch import obs
from repro_torch import tree as tree_lib

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


def query_label(key: Hashable) -> str:
    """A serving program's stable label for the capture counters:
    ``query`` and its key's strings and ints, dot-joined (``("joint_ll",
    64, None)`` is ``query.joint_ll.64``)."""
    keys = key if isinstance(key, tuple) else (key,)
    return ".".join(["query"] + [str(k) for k in keys
                                 if isinstance(k, str) or type(k) is int])


def step_label(key: Hashable) -> str:
    """A step program's stable label: its key's first entry
    (``("em_step", "stochastic", 1, ...)`` is ``em_step``)."""
    return str(key[0] if isinstance(key, tuple) else key)


def cuda_node_counter(device: torch.device) -> Callable[[], int]:
    """The capture observer's node count on the card: the driver's count
    of the graph the current stream captures into (called inside the
    capture, where the capture stream is current)."""
    from repro_torch.kernels import graph_census

    stream = torch.cuda.current_stream(device).cuda_stream
    return lambda: graph_census.count_nodes(stream)


def capture_cuda_graph(run: Callable[[], torch.Tensor], device: torch.device,
                       pool) -> Tuple[Callable[[], None], torch.Tensor]:
    """Capture ``run()`` into a CUDA graph on a side stream, allocating in
    the memory pool ``pool``; returns (replay, static output).  The caller
    has warmed ``run`` up already (first-use caches filled outside the
    capture)."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    torch.cuda.synchronize(device)
    # cuBLAS keeps a workspace a stream, made on first use and cached for
    # the process: cleared before, the capture makes its own in ``pool``
    # (never one another pool or the eager cache owns); cleared after, it
    # is free in the pool like any intermediate, instead of pinning a
    # segment of the pool once the pool's graphs are gone
    torch._C._cuda_clearCublasWorkspaces()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            out = run()
        finally:
            graph.capture_end()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph.replay, out


def new_pool(device: torch.device):
    """A fresh CUDA graph memory pool handle on the card (None elsewhere,
    where only an injected capture function records)."""
    if device.type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


def _hold_pool(handle, device: torch.device):
    """A one-node graph captured into the serving pool ``handle``, kept as
    long as the registry uses the handle.  PyTorch frees a pool's record
    once every graph captured into it is gone, and a later capture into the
    same handle then fails (its host allocator asserts on the released
    pool).  The serving pool needs the hold: a serving program that
    recaptures alone in the pool, or one made after a model's others were
    dropped, captures into the same handle.  Step graphs need none: each
    capture takes a fresh pool.  Returns what keeps the graph alive."""
    buf = torch.zeros(1, device=device)
    replay, _ = capture_cuda_graph(lambda: buf.add_(0.0), device, handle)
    return replay, buf


class EagerProgram:
    """A CPU model's program: the query function itself, run eagerly."""

    kind = "eager"

    def __init__(self, anchor, key: Hashable, fn: QueryFn):
        self.key = key
        self._anchor = weakref.ref(anchor)
        self._fn = fn

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._fn(_alive(self._anchor), batch)


def _warm_up(device: torch.device, run: Callable[[], Any]) -> Any:
    """``run()`` for real before a capture, on a side stream on the card
    (as ``torch.cuda.graphs`` asks), directly on the CPU: it fills the
    caches that allocate on first use (kernel libraries, packed gather
    tables, function attributes), so none of them is filled inside the
    capture.  Returns what ``run`` returns."""
    if device.type != "cuda":
        return run()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out = run()
    torch.cuda.current_stream(device).wait_stream(stream)
    return out


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
        self.label = query_label(key)
        self._replays = obs.METRICS.counter("compile.graph.replays",
                                            program=self.label)
        # one reused pair of timing events around each replay, on the card
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if self.device.type == "cuda" else None)
        self.capture_s = self._capture(anchor)

    def _capture(self, anchor) -> float:
        fn, static = self._fn, self._static

        def run():
            return fn(anchor, static)

        self._replay = self._out = None  # the old graph goes first
        with obs.timed("compile.graph", key=repr(self.key)) as t:
            _warm_up(self.device, run)
            capture = self._registry.capture_fn or capture_cuda_graph
            self._replay, self._out = capture(
                self._registry.observed(self.label, run, self.device),
                self.device, self._registry.pool(anchor, self.device))
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
        if self._events is None:
            self._replay()
        else:
            self._events[0].record()
            self._replay()
            self._events[1].record()
        self.replays += 1
        self._replays.inc()
        return self._out.clone()

    def replay_seconds(self) -> Optional[float]:
        """Device seconds of the last replay, between its timing events
        (None off the card).  Read it only once the caller has waited for
        the replay's output (a copy to the host): it synchronises
        nothing."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1]) / 1e3


@dataclasses.dataclass(frozen=True)
class StagedStep:
    """A training step in the stages :meth:`ProgramRegistry.jit` captures.

    The step writes its model's parameters in place and returns output
    tensors (a mean LL, a health vector).  With ``num_microbatches`` n:

      * n == 1 and no ``reduce``: ``finish(model, None, x)`` is the whole
        step on batch x;
      * otherwise (staged): ``start(model)`` makes the accumulators (a tree
        of tensors, set to zero before every step), ``body(model, acc,
        xb)`` writes one microbatch's E-step statistics into them in place
        (once a microbatch, in order), ``reduce(model, acc)`` (if given)
        combines them with other ranks' in place, and ``finish(model, acc,
        x)`` runs the rest of the step (M-step, blend, writes) on the whole
        batch x.

    ``gather(model)`` (if given) runs after ``finish``: it completes the
    parameters from other ranks' blocks.  ``reduce`` and ``gather`` hold
    the collectives, so a step program runs them eagerly between its
    captured graphs, never inside one.  ``finish`` returns a tuple of
    tensors; ``result`` maps (copies of) them to what a call of the step
    returns.
    """

    finish: Callable[[Any, Any, torch.Tensor], Tuple[torch.Tensor, ...]]
    num_microbatches: int = 1
    start: Optional[Callable[[Any], Any]] = None
    body: Optional[Callable[[Any, Any, torch.Tensor], None]] = None
    result: Callable[[Tuple[torch.Tensor, ...]], Any] = tuple
    reduce: Optional[Callable[[Any, Any], None]] = None
    gather: Optional[Callable[[Any], None]] = None

    @property
    def staged(self) -> bool:
        """Whether the statistics run as ``body`` stages apart from
        ``finish``."""
        return self.num_microbatches > 1 or self.reduce is not None

    def microbatch_rows(self, x: torch.Tensor) -> int:
        n, b = self.num_microbatches, x.shape[0]
        if b % n:
            raise ValueError(
                f"batch {b} not divisible into {n} microbatches")
        return b // n

    def run_eager(self, anchor, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The step op by op: the microbatches' bodies in order, ``reduce``,
        ``finish``, ``gather``."""
        if not self.staged:
            return tuple(self.finish(anchor, None, x))
        rows = self.microbatch_rows(x)
        acc = self.start(anchor)
        for xb in x.split(rows):
            self.body(anchor, acc, xb)
        if self.reduce is not None:
            self.reduce(anchor, acc)
        out = tuple(self.finish(anchor, acc, x))
        if self.gather is not None:
            self.gather(anchor)
        return out


class EagerStepProgram:
    """A CPU model's step program: the step run op by op."""

    kind = "eager"

    def __init__(self, anchor, key: Hashable, fn: StagedStep):
        self.key = key
        self._anchor = weakref.ref(anchor)
        self._fn = fn

    def __call__(self, x: torch.Tensor):
        return self._fn.result(self._fn.run_eager(_alive(self._anchor), x))


@dataclasses.dataclass
class StepGraphs:
    """One input shape's captured step: the static batch ``x`` (and
    microbatch ``xb``), the accumulators (tree and leaves), the static
    outputs, the replays of the body graph (staged steps) and of the finish
    graph, the pointers of the tensors the model read at capture, the
    memory pool both graphs were captured into (released with them), and
    the two graphs' ``compile.graph.replays`` counters."""

    pool: Any
    x: torch.Tensor
    xb: Optional[torch.Tensor]
    acc: Any
    acc_leaves: List[torch.Tensor]
    outs: List[torch.Tensor]
    body: Optional[Callable[[], None]]
    finish: Callable[[], None]
    pointers: Tuple[int, ...]
    capture_s: float
    body_replays: Optional[obs.Counter]
    finish_replays: obs.Counter


class StepProgram:
    """A training step as captured CUDA graphs, one set per input shape.

    On the first call with a batch of a new shape the program

      1. copies the batch into a static buffer and makes the accumulators
         and a microbatch buffer, all outside any capture (so they live
         outside the graph pool, for the program's life);
      2. warms up: runs one microbatch body (staged steps) and ``finish``
         for real on a side stream, after snapshotting every parameter of
         the model, and copies the snapshot back afterwards -- the step
         writes the M-step into the parameters, so without this the warm-up
         would advance the model and the first call would be two steps;
      3. captures the body graph (staged steps), which writes into the
         accumulators, and the finish graph, which writes the parameters and
         copies the outputs into static buffers (a capture executes
         nothing).

    A call copies the batch in, sets the accumulators to zero, replays the
    body once a microbatch (each after copying its rows into the microbatch
    buffer, in order, so the sums are the eager loop's bit for bit), runs
    ``reduce``, replays the finish graph, runs ``gather`` and hands back
    copies of the outputs.  The collectives stay out of the graphs: gloo
    cannot be captured, and NCCL inside a captured graph is a hazard
    (a replay's collective must line up with every other rank's).  As for
    :class:`GraphProgram`, a tensor the model reads that has moved (a
    replaced parameter) makes that shape recapture; an in-place write
    (``load_params``, a restored checkpoint) does not.  Each capture
    allocates in a pool of its own (:func:`new_pool`), which goes when its
    :class:`StepGraphs` go: a recapture drops the old graphs first and
    takes a fresh pool.
    """

    kind = "graph"

    def __init__(self, registry: "ProgramRegistry", anchor, key: Hashable,
                 fn: StagedStep):
        self.key = key
        self._registry = registry
        self._anchor = weakref.ref(anchor)
        self._fn = fn
        self.graphs: Dict[Tuple, StepGraphs] = {}

    def _capture(self, anchor, x: torch.Tensor) -> StepGraphs:
        fn = self._fn
        staged = fn.staged
        rows = fn.microbatch_rows(x)
        device = x.device
        xs = torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
        xb = acc = None
        acc_leaves: List[torch.Tensor] = []
        if staged:
            xb = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                             device=device)
            acc = fn.start(anchor)
            acc_leaves = tree_lib.flatten(acc)[1]
        capture = self._registry.capture_fn or capture_cuda_graph
        observed = self._registry.observed
        label = step_label(self.key)
        pool = new_pool(device)
        written = [p.detach() for p in anchor.parameters()]
        with obs.timed("compile.graph",
                       key=repr((self.key, tuple(x.shape)))) as t:
            saved = [p.clone() for p in written]

            # the warm-up runs no collective (``reduce``, ``gather``): it
            # is local, and its writes are undone below
            def warm_up():
                if staged:
                    xb.copy_(xs[:rows])
                    fn.body(anchor, acc, xb)
                return tuple(fn.finish(anchor, acc, xs))

            example = _warm_up(device, warm_up)
            with torch.no_grad():
                for p, s in zip(written, saved):
                    p.copy_(s)
            del saved
            outs = [torch.empty_like(o) for o in example]
            del example
            if device.type == "cuda":
                # the capture allocates in a fresh pool, which cannot reuse
                # the blocks the warm-up left cached: give them back first
                torch.cuda.empty_cache()
            # the recorded functions reach the model through the program's
            # weak reference, so that what a capture keeps of them does not
            # keep the model alive
            ref = self._anchor
            body = None
            if staged:
                body, _ = capture(
                    observed(label + ".body",
                             lambda: fn.body(_alive(ref), acc, xb), device),
                    device, pool)

            def finish_run():
                for o, v in zip(outs, fn.finish(_alive(ref), acc, xs)):
                    o.copy_(v)

            finish, _ = capture(observed(label, finish_run, device), device,
                                pool)
        counter = obs.METRICS.counter
        return StepGraphs(pool=pool, x=xs, xb=xb, acc=acc,
                          acc_leaves=acc_leaves,
                          outs=outs, body=body, finish=finish,
                          pointers=_pointers(anchor), capture_s=t.seconds,
                          body_replays=(counter("compile.graph.replays",
                                                program=label + ".body")
                                        if staged else None),
                          finish_replays=counter("compile.graph.replays",
                                                 program=label))

    def capture(self, x: torch.Tensor) -> StepGraphs:
        """The graphs of ``x``'s shape, captured now if there are none yet
        or a tensor the model reads has moved (the old graphs, and their
        pool, go first); runs no step."""
        anchor = _alive(self._anchor)
        sig = (tuple(x.shape), x.dtype, x.device)
        g = self.graphs.get(sig)
        if g is None or _pointers(anchor) != g.pointers:
            # the old graphs, and their pool, go before the new capture
            self.graphs.pop(sig, None)
            del g
            g = self._capture(anchor, x)
            self.graphs[sig] = g
            self._registry._count_compile(self.kind, (self.key, sig[0]),
                                          g.capture_s)
        return g

    def __call__(self, x: torch.Tensor):
        """One step on ``x``: capture (first call of this shape, or after a
        tensor the model reads moved), then copy in, replay, copy out."""
        g = self.capture(x)
        self.replay(g, x)
        return self._fn.result(tuple(o.clone() for o in g.outs))

    def replay(self, g: StepGraphs, x: torch.Tensor) -> None:
        """The device work of one step on ``x`` through ``g``'s graphs, with
        the step's ``reduce`` and ``gather`` run eagerly around the finish
        graph."""
        fn = self._fn
        g.x.copy_(x)
        if g.body is not None:
            rows = g.xb.shape[0]
            for t in g.acc_leaves:
                t.zero_()
            for i in range(fn.num_microbatches):
                g.xb.copy_(g.x[i * rows: (i + 1) * rows])
                g.body()
            g.body_replays.inc(fn.num_microbatches)
        if fn.reduce is not None:
            fn.reduce(_alive(self._anchor), g.acc)
        g.finish()
        g.finish_replays.inc()
        if fn.gather is not None:
            fn.gather(_alive(self._anchor))

    @property
    def capture_s(self) -> float:
        return sum(g.capture_s for g in self.graphs.values())


Program = Union[GraphProgram, EagerProgram]


class ProgramRegistry:
    """One cache of programs, keyed ``(anchor, key)``.

    ``capture_fn`` replaces :func:`capture_cuda_graph` as the way a graph
    is recorded, and makes programs graphs on any device: the seam a test
    uses to exercise the graph bookkeeping on the CPU.  By default a CUDA
    model's programs are graphs and a CPU model's eager.

    ``node_counter(device)`` is called inside each capture and returns the
    capture observer's node count (a function of no argument), or None to
    observe nothing; by default :func:`cuda_node_counter` on the card and
    None elsewhere.  The seam a test uses to count nodes on the CPU.
    """

    def __init__(self, capture_fn: Optional[CaptureFn] = None,
                 node_counter: Optional[
                     Callable[[torch.device], Optional[Callable[[], int]]]
                 ] = None):
        self.capture_fn = capture_fn
        self.node_counter = node_counter
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
        """The memory pool ``anchor``'s serving programs share (made on
        first use, on the card with a one-node graph that holds it for the
        anchor's life)."""
        entry = self._pools.get(anchor)
        if entry is None:
            handle = new_pool(device)
            hold = (_hold_pool(handle, device) if device.type == "cuda"
                    else None)
            entry = (handle, hold)
            self._pools[anchor] = entry
        return entry[0]

    def pools(self, anchor) -> List[Any]:
        """The memory pools ``anchor``'s programs hold: the serving pool
        (once made), then one a captured step shape."""
        entry = self._pools.get(anchor)
        out = [] if entry is None else [entry[0]]
        for prog in self._tables.get(anchor, {}).values():
            if isinstance(prog, StepProgram):
                out += [g.pool for g in prog.graphs.values()]
        return [h for h in out if h is not None]

    def pool_bytes(self, anchor) -> int:
        """Bytes the card holds in ``anchor``'s graph memory pools (0
        without one), from the caching allocator's snapshot."""
        ids = {tuple(h) for h in self.pools(anchor)}
        if not ids:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in ids)

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

    def jit(self, anchor, key: Hashable, fn: StagedStep
            ) -> Union[StepProgram, EagerStepProgram]:
        """The training step program of ``fn`` on ``anchor`` (a model whose
        parameters the step writes in place), cached under ``(anchor,
        key)``: a :class:`StepProgram` on a CUDA model (graphs captured
        lazily, once per batch shape; each capture counts a compile), an
        :class:`EagerStepProgram` on a CPU model (one compile of 0 s, as
        :meth:`capture` counts an eager program)."""
        table = self.table(anchor)
        prog = table.get(key)
        if prog is not None:
            self.stats["hits"] += 1
            obs.cache_event(prog.kind, hit=True)
            return prog
        device = read_tensors(anchor)[0].device
        if self.capture_fn is None and device.type != "cuda":
            prog = EagerStepProgram(anchor, key, fn)
            self._count_compile(prog.kind, key, 0.0)
        else:
            prog = StepProgram(self, anchor, key, fn)
        # captures happen on first use; an instant marker keeps "compile."
        # visible in traces of train-only runs
        obs.event("compile.jit", key=repr(key))
        table[key] = prog
        return prog

    def observed(self, label: str, run: Callable[[], Any],
                 device: torch.device) -> Callable[[], Any]:
        """``run`` under a capture observer of program ``label``
        (installed for the call, as ``obs.set_sync`` installs a hook): the
        capture's nodes go to the spans open as they are added, and the
        finished map is published (``obs.capture.record_capture``).  The
        function a capture records."""
        counter = self.node_counter
        if counter is None:
            counter = cuda_node_counter if device.type == "cuda" else None

        def observed_run():
            count = counter(device) if counter is not None else None
            if count is None:
                return run()
            observer = obs.CaptureObserver(label, count)
            obs.set_capture_observer(observer)
            try:
                out = run()
                layer_map = observer.finish()
            finally:
                obs.set_capture_observer(None)
            obs.record_capture(layer_map)
            return out

        return observed_run

    def _count_compile(self, kind: str, key: Hashable, seconds: float) -> None:
        self.stats["compiles"] += 1
        self.stats["compile_s"] += seconds
        obs.compile_event(kind, key, seconds)


# The process-wide default registry: serving engines and the direct path
# share it unless a caller passes its own (benchmarks and tests that count
# compiles).
REGISTRY = ProgramRegistry()
