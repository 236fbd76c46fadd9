"""Recompile sentry: make "one capture per (kind, bucket)" assertable.

The port's counterpart of the reference's ``repro/analysis/sentry.py``.
There, a program is a jitted XLA computation, and its silent-recompile bug
class is an argument whose abstract value changes between calls.  Here a
program is a CUDA graph that ``repro_torch.compile.ProgramRegistry``
captures, and the sentry counts what the registry keys on:

  * per tensor leaf of a call, its (shape, dtype, device): a step program
    captures once per such batch signature (``StepProgram.capture``), and
    a serving program's static buffers fix each field's shape and dtype;
  * the registry key, ``(kind, bucket[, component])`` for serving and the
    step key for training, which arrives with every capture through the
    shared compile hook (``obs.on_compile``; the registry emits one event a
    miss and one a recapture, ``compile.py``).

Two findings:

  * ``"dtype-promotion-leak"``: two calls of a wrapped function share every
    shape but differ in dtype (a float64 batch into a float32 step) -- an
    implicit promotion is making a second program;
  * ``"recapture-storm"``: a wrapped function recaptures on calls whose
    signature it has seen before, again and again.  The registry recaptures
    a program when a tensor the model reads has moved (a parameter
    replaced instead of written in place); when that happens on every call,
    every call pays a capture.  This is the port's silent recompile.

The reference's weak-type findings have no counterpart: a torch tensor has
one dtype and no weak-type flag, and the registry keys on no Python
scalar.  Different shapes (bucketing) are distinct programs and never a
finding.

Usage::

    with CompileSentry() as sentry:
        step = sentry.wrap(make_em_step(model), name="em_step")
        for _ in range(3):
            step(x)
    sentry.assert_max_compiles(1, name="em_step")
    sentry.assert_no_leaks()

For serving, wrap nothing and use the registry's count::

    with CompileSentry(registry=engine.registry) as sentry:
        engine.run(requests)
    assert sentry.registry_compiles() <= kinds * buckets

Stdlib and torch only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

Signature = Tuple[Tuple[Any, ...], ...]

# recaptures of seen signatures after which a wrapped function is named as
# a recapture storm (one recapture is the legitimate answer to one replaced
# parameter)
STORM_RECAPTURES = 2


@dataclasses.dataclass(frozen=True)
class SentryFinding:
    """One detected compile-hygiene leak."""

    kind: str  # "dtype-promotion-leak" | "recapture-storm"
    fn: str  # wrapped-function name
    message: str

    def __str__(self) -> str:
        return f"{self.kind} in {self.fn}: {self.message}"


def _leaves(tree: Any) -> List[Any]:
    """The leaves of nested tuples, lists and dicts (dict keys sorted)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=repr)
                for leaf in _leaves(tree[k])]
    return [tree]


def _leaf_sig(leaf: Any) -> Tuple[Any, ...]:
    """(shape, dtype, device) of a tensor leaf -- what a captured program
    is specialised to.  Arrays and scalars key by their shape and dtype or
    their value; other objects (a model) by their type."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return (tuple(leaf.shape), str(leaf.dtype), "numpy")
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return ("static", repr(leaf), None)
    return ("static", type(leaf).__name__, None)


def _signature(args: tuple, kwargs: dict) -> Signature:
    return tuple(_leaf_sig(leaf) for leaf in _leaves((args, kwargs)))


class CompileSentry:
    """Context manager counting captures by signature and by registry key.

    ``wrap(fn, name)`` returns ``fn`` instrumented to record each call's
    signature and the compile events the call set off.  A call with a new
    signature is a program the registry must capture; a compile event
    during a call whose signature was seen before is a recapture.
    ``compiles(name)`` is the sum of the two (the reference's count, by
    signature); ``captures(name)`` counts the compile events themselves,
    the first calls' included, so a program that captured twice on its
    first call shows there.
    """

    def __init__(self, registry: Optional[Any] = None):
        self.registry = registry
        self._reg_compiles0 = 0
        self._sigs: Dict[str, List[Signature]] = {}
        self._calls: Dict[str, int] = {}
        self._recaptures: Dict[str, List[str]] = {}
        self._captures: Dict[str, List[str]] = {}
        self.findings: List[SentryFinding] = []
        # registry compile events observed while active, via the shared
        # obs hook (the registry emits; obs.events counts the metrics; the
        # sentry only listens, so nothing double counts)
        self.compile_events: List[Dict[str, Any]] = []
        self._listener: Optional[Callable] = None
        self.active = False

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "CompileSentry":
        self.active = True
        if self.registry is not None:
            self._reg_compiles0 = int(self.registry.stats["compiles"])
        self._listener = obs.on_compile(self.compile_events.append)
        return self

    def __exit__(self, *exc) -> None:
        self.active = False
        if self._listener is not None:
            obs.remove_compile_listener(self._listener)
            self._listener = None

    # --------------------------------------------------------------- wrapping
    def wrap(self, fn: Callable, name: Optional[str] = None) -> Callable:
        """Instrument ``fn``: every call records its signature and the
        compile events it set off."""
        label = name or getattr(fn, "__name__", None) or repr(fn)
        self._sigs.setdefault(label, [])
        self._calls.setdefault(label, 0)
        self._recaptures.setdefault(label, [])
        self._captures.setdefault(label, [])

        def wrapped(*args, **kwargs):
            sig = _signature(args, kwargs)
            seen = sig in self._sigs[label]
            mark = len(self.compile_events)
            out = fn(*args, **kwargs)
            self._record(label, sig, seen,
                         self.compile_events[mark:] if self.active else [])
            return out

        wrapped.__name__ = f"sentry[{label}]"
        return wrapped

    def _record(self, label: str, sig: Signature, seen: bool,
                events: List[Dict[str, Any]]) -> None:
        self._calls[label] += 1
        self._captures[label] += [e["key"] for e in events]
        if seen:
            if events:
                self._recaptures[label] += [e["key"] for e in events]
                n = len(self._recaptures[label])
                if n >= STORM_RECAPTURES:
                    keys = sorted(set(self._recaptures[label]))
                    self._report(SentryFinding(
                        "recapture-storm", label,
                        f"calls with a signature already captured "
                        f"recaptured at least {STORM_RECAPTURES} times "
                        f"(registry key(s) {', '.join(keys[:3])}): a tensor "
                        f"the model reads moves between calls (a parameter "
                        f"replaced instead of written in place), so every "
                        f"call pays a capture"))
            return
        for prev in self._sigs[label]:
            self._diff(label, prev, sig)
        self._sigs[label].append(sig)

    def _diff(self, label: str, a: Signature, b: Signature) -> None:
        """Flag signature pairs that differ ONLY in dtype -- same shapes,
        so the caller almost certainly meant them to hit one program."""
        if len(a) != len(b):
            return
        if any(la[0] != lb[0] for la, lb in zip(a, b)):
            return  # genuine shape polymorphism (bucketing) -- not a leak
        diffs = [f"{la[1]}->{lb[1]}" for la, lb in zip(a, b) if la[1] != lb[1]]
        if diffs:
            self._report(SentryFinding(
                "dtype-promotion-leak", label,
                f"two calls share every shape but differ in dtype "
                f"({', '.join(sorted(set(diffs))[:4])}) -- an implicit "
                f"promotion is making a second program"))

    def _report(self, finding: SentryFinding) -> None:
        if all(str(finding) != str(f) for f in self.findings):
            self.findings.append(finding)

    # ------------------------------------------------------------- accounting
    def signatures(self, name: str) -> Tuple[Signature, ...]:
        return tuple(self._sigs.get(name, ()))

    def recaptures(self, name: Optional[str] = None) -> int:
        """Compile events during calls whose signature was seen before."""
        names = [name] if name is not None else list(self._recaptures)
        return sum(len(self._recaptures.get(n, ())) for n in names)

    def compiles(self, name: Optional[str] = None) -> int:
        """Captures attributable to the wrapped function(s): one a distinct
        signature, plus every recapture."""
        names = [name] if name is not None else list(self._sigs)
        return sum(len(self._sigs.get(n, ())) for n in names) + \
            self.recaptures(name)

    def captures(self, name: Optional[str] = None) -> int:
        """Compile events set off during the wrapped function(s)' calls,
        whatever their signature."""
        names = [name] if name is not None else list(self._captures)
        return sum(len(self._captures.get(n, ())) for n in names)

    def registry_compiles(self) -> int:
        """The registry's compiles (captures and recaptures) since
        ``__enter__``."""
        if self.registry is None:
            raise ValueError("CompileSentry was built without a registry")
        return int(self.registry.stats["compiles"]) - self._reg_compiles0

    # ------------------------------------------------------------- assertions
    def assert_max_compiles(self, limit: int, name: Optional[str] = None):
        got = self.compiles(name)
        if got > limit:
            raise AssertionError(
                f"recompile sentry: {got} compiles for "
                f"{name or 'all wrapped fns'} (limit {limit})\n"
                + self.report()
            )

    def assert_no_leaks(self) -> None:
        if self.findings:
            raise AssertionError(
                "recompile sentry found compile-hygiene leaks:\n"
                + "\n".join(f"  - {f}" for f in self.findings)
            )

    def report(self) -> str:
        lines = []
        for label, sigs in self._sigs.items():
            lines.append(
                f"  {label}: {self._calls[label]} call(s), "
                f"{len(sigs)} distinct signature(s), "
                f"{self.recaptures(label)} recapture(s), "
                f"{self.compiles(label)} compile(s), "
                f"{self.captures(label)} capture event(s)")
            for i, sig in enumerate(sigs):
                lines.append(f"    sig {i}: {sig}")
        for f in self.findings:
            lines.append(f"  finding: {f}")
        return "\n".join(lines) or "  (nothing wrapped)"
