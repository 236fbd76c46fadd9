"""AST-based lint of the port: the reference's conventions in the port's
idiom, and two of the port's own ground rules.

The port's counterpart of ``repro/analysis/lint.py``.  Six rules:

  * ``neg-inf-literal``     -- no NEG_INF-scale numeric literals (|v| >=
    1e20) outside ``core/layers.py``; import ``NEG_INF`` instead (the
    reference's rule as it is).
  * ``kernel-contract``     -- the hand-written kernels (``*_cuda``), their
    plain versions (``*_plain``), the nvcc builder ``kernels.build`` and
    ``ctypes`` loads are private to ``repro_torch/kernels/``: everything
    else reaches a kernel through the ``kernels.ops`` ``KernelOp``s, which
    own the device dispatch and the launch counters.  The counterpart of
    the reference's ``pallas-contract``.
  * ``bare-graph``          -- no ``torch.cuda.graph`` /
    ``torch.cuda.CUDAGraph`` / ``torch.compile`` / ``torch.jit.*`` outside
    ``repro_torch/compile.py``: programs go through
    ``compile.ProgramRegistry``, which owns the pools, the pointer checks
    and the capture counts the sentry reads.  The counterpart of
    ``bare-jit``.
  * ``timing-outside-obs``  -- no raw ``time.time`` / ``time.perf_counter``
    (or their ``_ns`` / monotonic / process_time cousins) outside
    ``repro_torch/obs/`` and ``repro_torch/bench/`` (the port's
    counterpart of ``benchmarks/``); use ``obs.timed`` / ``obs.span`` /
    ``obs.now`` (the reference's rule as it is).
  * ``atomic-accumulate``   -- no ``index_add(_)``, ``scatter_add(_)``,
    ``scatter_reduce(_)`` or ``index_put(_)(..., accumulate=True)`` on the
    row paths (``core/``, ``serve/``, ``mixture/``, ``eval/``): on CUDA
    they accumulate with atomics in no fixed order, which breaks row
    independence and the bitwise EM statistics (``core/layers.py``
    ``scope_sums``).
  * ``cpu-default``         -- no parameter default of ``"cpu"`` or
    ``torch.device("cpu")``, nor a module-level constant holding one used
    as a default, anywhere in the package: every entry point runs on the
    card unless the caller asks for the CPU, and never falls back to it
    quietly.

The reference's ``interpret-default`` and ``donated-read`` have no
counterpart: the port has no interpret mode (the device of the tensors
decides, ``kernels.dispatch``), and its step writes the parameters in
place and hands back clones (``compile.StepProgram``), so there is no
donated buffer to read.

CLI::

    python -m repro_torch.analysis.lint            # scan src/repro_torch
    python -m repro_torch.analysis.lint PATH ...   # explicit roots/files
    python -m repro_torch.analysis.lint --list-rules

Exit 0 when clean, 1 on any violation.  Waivers live in
``analysis/lint_waivers.json``: a list of ``{"rule", "path", "line",
"reason"}`` entries (``line`` optional); every entry needs its reason.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import sys
from typing import Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# |literal| at or above this is "NEG_INF scale" (spelled as an expression
# so the lint does not flag its own definition)
_NEG_INF_SCALE = 10.0 ** 20

RULES = {
    "neg-inf-literal": (
        "NEG_INF-scale literal; import NEG_INF from repro_torch.core.layers"
    ),
    "kernel-contract": (
        "*_cuda / *_plain kernels, kernels.build and ctypes loads are "
        "private to repro_torch/kernels/; call the kernels.ops KernelOps"
    ),
    "bare-graph": (
        "bare torch.cuda.graph/CUDAGraph/torch.compile/torch.jit; route "
        "through repro_torch.compile.ProgramRegistry"
    ),
    "timing-outside-obs": (
        "raw time.time/time.perf_counter outside repro_torch/obs/ and "
        "repro_torch/bench/; use obs.timed / obs.span / obs.now"
    ),
    "atomic-accumulate": (
        "index_add/scatter_add/scatter_reduce/index_put(accumulate=True) "
        "on a row path (core/, serve/, mixture/, eval/) accumulates with "
        "atomics on CUDA"
    ),
    "cpu-default": (
        "a parameter defaults to the CPU; default to None (CUDA, "
        "core.einet.resolve_device) and let the caller ask for the CPU"
    ),
}

# rule -> path prefixes (repo-module style, see _relpath) where it is OFF;
# a prefix matches at the start of the rel path or at any "/" boundary
_ALLOW = {
    "neg-inf-literal": ("repro_torch/core/layers.py",),
    "kernel-contract": ("repro_torch/kernels/",),
    "bare-graph": ("repro_torch/compile.py",),
    "timing-outside-obs": ("repro_torch/obs/", "repro_torch/bench/"),
}

# rule -> the only path prefixes where it is ON
_ONLY = {
    "atomic-accumulate": ("repro_torch/core/", "repro_torch/serve/",
                          "repro_torch/mixture/", "repro_torch/eval/"),
}

# the wall-clock readers the timing rule forbids (the reference's set)
_TIME_ATTRS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
}

# torch names that end like a kernel function and are not one
_NOT_KERNELS = {"is_cuda"}
_KERNEL_SUFFIXES = ("_cuda", "_plain")
_CTYPES_LOADS = {"CDLL", "cdll", "PyDLL", "pydll", "LoadLibrary"}
_ATOMIC_ATTRS = {"index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce_", "scatter_reduce"}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # repo-module style (see _relpath)
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _relpath(path: str) -> str:
    """Normalize to the module-ish form rules match on: the posix path
    from the last ``src/`` component (``repro_torch/kernels/ops.py``)."""
    parts = pathlib.PurePath(path).as_posix().split("/")
    if "src" in parts:
        parts = parts[len(parts) - parts[::-1].index("src"):]
    return "/".join(p for p in parts if p not in (".", ""))


def _matches(rel: str, prefixes: Iterable[str]) -> bool:
    probe = "/" + rel
    return any(
        probe.startswith("/" + p) or "/" + p in probe
        or rel == p.rstrip("/")
        for p in prefixes
    )


def _applies(rule: str, rel: str) -> bool:
    if rule in _ONLY and not _matches(rel, _ONLY[rule]):
        return False
    return not _matches(rel, _ALLOW.get(rule, ()))


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a chain of attributes on a name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# ------------------------------------------------------------------- rules
def _check_neg_inf(tree: ast.AST, rel: str) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float)
        ) and not isinstance(node.value, bool):
            if abs(node.value) >= _NEG_INF_SCALE:
                yield Violation(
                    "neg-inf-literal", rel, node.lineno,
                    f"literal {node.value!r} is NEG_INF-scale; import "
                    f"NEG_INF from repro_torch.core.layers")


def _is_kernel_name(name: Optional[str]) -> bool:
    return bool(name) and name not in _NOT_KERNELS and name.endswith(
        _KERNEL_SUFFIXES)


def _check_kernel_contract(tree: ast.AST, rel: str) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = [a.name for a in node.names]
            if mod == "ctypes" or mod.startswith("ctypes."):
                yield Violation("kernel-contract", rel, node.lineno,
                                "ctypes import; kernels are loaded by "
                                "repro_torch.kernels.build only")
            if mod.endswith("kernels.build") or (
                    mod.endswith("kernels") and "build" in names):
                yield Violation("kernel-contract", rel, node.lineno,
                                "kernels.build outside repro_torch/kernels/;"
                                " the KernelOps build on first launch")
            for name in names:
                if _is_kernel_name(name):
                    yield Violation(
                        "kernel-contract", rel, node.lineno,
                        f"import of raw kernel {name!r}; use the "
                        f"repro_torch.kernels.ops KernelOp")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "ctypes" or alias.name.startswith("ctypes."):
                    yield Violation("kernel-contract", rel, node.lineno,
                                    "ctypes import; kernels are loaded by "
                                    "repro_torch.kernels.build only")
                elif alias.name.endswith("kernels.build"):
                    yield Violation("kernel-contract", rel, node.lineno,
                                    "kernels.build outside "
                                    "repro_torch/kernels/")
        elif isinstance(node, ast.Attribute):
            dotted = _dotted(node) or ""
            if _is_kernel_name(node.attr):
                yield Violation(
                    "kernel-contract", rel, node.lineno,
                    f"raw kernel {node.attr!r}; use the "
                    f"repro_torch.kernels.ops KernelOp (it owns dispatch "
                    f"and the launch counters)")
            elif node.attr == "build" and dotted.endswith("kernels.build"):
                yield Violation("kernel-contract", rel, node.lineno,
                                "kernels.build outside repro_torch/kernels/")
            elif node.attr in _CTYPES_LOADS and dotted.startswith("ctypes"):
                yield Violation("kernel-contract", rel, node.lineno,
                                f"ctypes.{node.attr} load outside "
                                f"repro_torch/kernels/")
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if _is_kernel_name(node.func.id):
                yield Violation(
                    "kernel-contract", rel, node.lineno,
                    f"direct call to raw kernel {node.func.id!r}; use the "
                    f"repro_torch.kernels.ops KernelOp")


def _check_bare_graph(tree: ast.AST, rel: str) -> Iterator[Violation]:
    msg = ("route through repro_torch.compile.ProgramRegistry so programs "
           "share its pools, pointer checks and capture counts")
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node) or ""
            hit = None
            if node.attr == "CUDAGraph":
                hit = "CUDAGraph"
            elif node.attr in ("graph", "make_graphed_callables") and \
                    dotted.endswith("cuda." + node.attr):
                hit = f"torch.cuda.{node.attr}"
            elif dotted == "torch.compile":
                hit = "torch.compile"
            elif dotted.startswith("torch.jit.") and dotted.count(".") == 2:
                hit = dotted
            if hit:
                yield Violation("bare-graph", rel, node.lineno,
                                f"bare {hit}; {msg}")
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = {a.name for a in node.names}
            bad = set()
            if mod in ("torch.cuda", "torch.cuda.graphs"):
                bad = names & {"graph", "CUDAGraph", "make_graphed_callables"}
            elif mod == "torch":
                bad = names & {"compile", "jit"}
            elif mod == "torch.jit" or mod.startswith("torch.jit."):
                bad = names
            for name in sorted(bad):
                yield Violation("bare-graph", rel, node.lineno,
                                f"from {mod} import {name}; {msg}")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch.jit" or alias.name.startswith(
                        "torch.jit."):
                    yield Violation("bare-graph", rel, node.lineno,
                                    f"import {alias.name}; {msg}")


def _check_timing(tree: ast.AST, rel: str) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ) and node.value.id == "time" and node.attr in _TIME_ATTRS:
            yield Violation(
                "timing-outside-obs", rel, node.lineno,
                f"raw time.{node.attr}; use obs.timed / obs.span / obs.now "
                f"so the measurement reaches the metrics registry")
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in _TIME_ATTRS:
                    yield Violation(
                        "timing-outside-obs", rel, node.lineno,
                        f"from time import {alias.name}; use obs.timed / "
                        f"obs.span / obs.now instead")


def _accumulates(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "accumulate":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    # index_put_(indices, values, accumulate)
    if len(call.args) >= 3:
        a = call.args[2]
        return not (isinstance(a, ast.Constant) and a.value is False)
    return False


def _check_atomic(tree: ast.AST, rel: str) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in _ATOMIC_ATTRS:
            yield Violation(
                "atomic-accumulate", rel, node.lineno,
                f"{node.attr} on a row path accumulates with atomics on "
                f"CUDA (no fixed order): sum in a fixed order instead")
        elif isinstance(node, ast.Call) and _terminal_name(node.func) in (
                "index_put_", "index_put") and _accumulates(node):
            yield Violation(
                "atomic-accumulate", rel, node.lineno,
                f"{_terminal_name(node.func)}(..., accumulate=True) on a row "
                f"path accumulates with atomics on CUDA")


def _is_cpu(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and (
            node.value == "cpu" or node.value.startswith("cpu:"))
    if isinstance(node, ast.Call) and _terminal_name(node.func) == "device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _check_cpu_default(tree: ast.AST, rel: str) -> Iterator[Violation]:
    consts: Set[str] = set()
    for stmt in getattr(tree, "body", []):
        if isinstance(stmt, ast.Assign) and _is_cpu(stmt.value):
            consts |= {t.id for t in stmt.targets if isinstance(t, ast.Name)}
        elif isinstance(stmt, ast.AnnAssign) and _is_cpu(stmt.value) and \
                isinstance(stmt.target, ast.Name):
            consts.add(stmt.target.id)

    def bad(default) -> bool:
        return _is_cpu(default) or (isinstance(default, ast.Name)
                                    and default.id in consts)

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            a = node.args
            params = list(a.posonlyargs) + list(a.args)
            defaults = [None] * (len(params) - len(a.defaults)) + list(
                a.defaults)
            params += list(a.kwonlyargs)
            defaults += list(a.kw_defaults)
            name = getattr(node, "name", "<lambda>")
            for arg, default in zip(params, defaults):
                if default is not None and bad(default):
                    yield Violation(
                        "cpu-default", rel, default.lineno,
                        f"{name}({arg.arg}=...) defaults to the CPU; "
                        f"default to None (CUDA unless the caller asks)")
        elif isinstance(node, ast.ClassDef):
            # dataclass fields are __init__ parameters with defaults
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                        and bad(stmt.value):
                    yield Violation(
                        "cpu-default", rel, stmt.lineno,
                        f"field of {node.name!r} defaults to the CPU; "
                        f"default to None (CUDA unless the caller asks)")


_CHECKS = (
    _check_neg_inf,
    _check_kernel_contract,
    _check_bare_graph,
    _check_timing,
    _check_atomic,
    _check_cpu_default,
)


# ------------------------------------------------------------------ driver
def lint_source(src: str, path: str = "<snippet>") -> List[Violation]:
    """Lint one source string (the negative-test entry point)."""
    rel = _relpath(path)
    tree = ast.parse(src)
    out: List[Violation] = []
    for check in _CHECKS:
        out.extend(v for v in check(tree, rel) if _applies(v.rule, rel))
    return sorted(set(out), key=lambda v: (v.path, v.line, v.rule,
                                           v.message))


def _iter_py_files(paths: Sequence[str]) -> Iterator[pathlib.Path]:
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        else:
            yield path


def load_waivers(path: Optional[str] = None) -> List[dict]:
    wpath = pathlib.Path(path) if path else (
        pathlib.Path(__file__).parent / "lint_waivers.json"
    )
    if not wpath.exists():
        return []
    waivers = json.loads(wpath.read_text())
    for w in waivers:
        missing = {"rule", "path", "reason"} - set(w)
        if missing:
            raise ValueError(
                f"waiver {w!r} is missing required field(s) {sorted(missing)}"
            )
        if not str(w["reason"]).strip():
            raise ValueError(f"waiver {w!r} has an empty reason")
    return waivers


def _waived(v: Violation, waivers: Iterable[dict]) -> bool:
    return any(
        w["rule"] == v.rule
        and (v.path == w["path"] or v.path.endswith("/" + w["path"]))
        and ("line" not in w or int(w["line"]) == v.line)
        for w in waivers
    )


def run_lint(
    paths: Sequence[str], waivers_path: Optional[str] = None
) -> Tuple[List[Violation], List[Violation]]:
    """Lint files/trees -> (violations, waived)."""
    waivers = load_waivers(waivers_path)
    violations: List[Violation] = []
    waived: List[Violation] = []
    for f in _iter_py_files(paths):
        for v in lint_source(f.read_text(), str(f)):
            (waived if _waived(v, waivers) else violations).append(v)
    return violations, waived


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "paths", nargs="*",
        default=[str(pathlib.Path(__file__).resolve().parents[1])],
        help="files or trees to lint (default: src/repro_torch)")
    parser.add_argument("--waivers", default=None,
                        help="waiver JSON (default: analysis/lint_waivers.json)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        return 0
    violations, waived = run_lint(args.paths, args.waivers)
    for v in violations:
        print(v)
    for v in waived:
        print(f"{v}  [waived]")
    n_files = sum(1 for _ in _iter_py_files(args.paths))
    print(
        f"lint: {n_files} file(s), {len(violations)} violation(s), "
        f"{len(waived)} waived, {len(RULES)} rule(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
