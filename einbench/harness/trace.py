"""A profiled part of a run's window on the card, and its reduction to
busy time, kernel time by name and idle gaps labelled by what the host
was doing.

torch.profiler can drop the first kernels of a profile and report
kernels that ran before it, so the traced part is fenced on the device by
``FENCE`` marker kernels at each end (an in-place XOR of a one-byte
tensor, whose kernel name is learnt once by profiling the markers alone),
and only what runs between the two fences is read.  The host marks its
own spans with ``record_function("einbench.<label>")``; a device gap is
labelled by the innermost such span around its middle."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

FENCE = 64
PREFIX = "einbench."


def _events(prof) -> List:
    """(name, is_device, start_ns, end_ns) of every event of a profile."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() == cuda, start,
                    start + e.duration_ns()))
    return out


def base_name(name: str) -> str:
    """A kernel's function name without its namespace, template arguments
    or parameter list ("void (anonymous namespace)::grouped_fwd_kernel<2>
    (float const*, ...)" -> "grouped_fwd_kernel")."""
    s = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return s.split("(")[0].split("<")[0].split("::")[-1].strip()


class Window:
    """Start and stop a fenced profile inside a running window;
    ``span(label)`` marks host work while a profile is on."""

    def __init__(self):
        from torch.profiler import ProfilerActivity

        self.acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self.flag = torch.zeros(1, dtype=torch.int8, device="cuda")
        self.prof = None
        self._span = None
        self.fence_name = self._learn_fence()

    def _fence(self) -> None:
        for _ in range(FENCE):
            self.flag.bitwise_xor_(self.flag)

    def _learn_fence(self) -> str:
        from torch.profiler import profile

        self._fence()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=self.acts[1:]) as prof:
                self._fence()
                torch.cuda.synchronize()
                time.sleep(0.02)
            names = collections.Counter(n for n, dev, _, _ in _events(prof) if dev)
            if names:
                return names.most_common(1)[0][0]
        raise RuntimeError("three profiles in turn recorded no device kernel")

    def start(self) -> None:
        from torch.profiler import profile

        torch.cuda.synchronize()
        self.prof = profile(activities=self.acts)
        self.prof.__enter__()
        time.sleep(0.02)
        self._fence()
        torch.cuda.synchronize()
        time.sleep(0.005)
        self._span = self.span("window")
        self._span.__enter__()

    @property
    def on(self) -> bool:
        return self.prof is not None

    def span(self, label: str):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(PREFIX + label)

    def stop(self) -> Dict:
        self._span.__exit__(None, None, None)
        torch.cuda.synchronize()
        time.sleep(0.005)
        self._fence()
        torch.cuda.synchronize()
        time.sleep(0.02)
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        return reduce(_events(prof), self.fence_name)


# the host waits this long on each side of the traced part before it
# fences: the device window is the one gap between markers at least as wide
MIN_GAP_NS = 5_000_000


def _bounds(dev, fence_name) -> Optional[Tuple[int, int]]:
    """The device time between the leading and trailing markers: the
    widest gap between two consecutive markers, at least ``MIN_GAP_NS``
    wide, with no more than a fence's markers on either side (the profiler
    may drop a session's first kernels)."""
    marks = sorted((s, e) for n, s, e in dev if n == fence_name)
    gaps = [(marks[i + 1][0] - marks[i][1], i) for i in range(len(marks) - 1)]
    if not gaps:
        return None
    gap, i = max(gaps)
    if gap < MIN_GAP_NS or i + 1 > FENCE or len(marks) - i - 1 > FENCE:
        return None
    return marks[i][1], marks[i + 1][0]


def reduce(events, fence_name: str) -> Dict:
    """Busy and idle seconds, kernel seconds by name and idle gaps by host
    label inside the fenced part."""
    # the host spans' annotations show on the device timeline too: they
    # are not device work
    dev = [(n, s, e) for n, is_dev, s, e in events
           if is_dev and not n.startswith(PREFIX)]
    host = [(n[len(PREFIX):], s, e) for n, is_dev, s, e in events
            if not is_dev and n.startswith(PREFIX)]
    bounds = _bounds(dev, fence_name)
    if bounds is None:
        marks = sum(n == fence_name for n, _, _ in dev)
        raise RuntimeError(
            f"the profile holds {marks} of the {2 * FENCE} fence markers, not "
            "a run of them on each side of the traced part: its device "
            "window is unknown")
    lo, hi = bounds
    inside = sorted((s, e, n) for n, s, e in dev
                    if n != fence_name and lo <= s < hi)
    kernels = collections.Counter()
    idle: List[Tuple[int, int]] = []
    last = lo
    for s, e, n in inside:
        kernels[n] += (min(e, hi) - s) / 1e9
        if s > last:
            idle.append((last, s))
        last = max(last, min(e, hi))
    if hi > last:
        idle.append((last, hi))
    busy = (hi - lo) - sum(b - a for a, b in idle)
    gaps = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for a, b in idle:
        mid = (a + b) // 2
        around = [(e - s, n) for n, s, e in host if s <= mid < e and n != "window"]
        label = min(around)[1] if around else "harness"
        g = gaps[label]
        g[0] += 1
        g[1] += (b - a) / 1e9
        g[2] = max(g[2], (b - a) / 1e9)
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernels": dict(kernels), "gaps": dict(gaps),
            "device_events": len(inside)}


def matching(kernels: Dict[str, float], rule: Dict) -> float:
    """Seconds of the kernels a layer's rule names: ``base`` lists exact
    function names, ``contains`` substrings of the full name."""
    base = set(rule.get("base", ()))
    subs = tuple(rule.get("contains", ()))
    return sum(t for n, t in kernels.items()
               if base_name(n) in base or any(s in n for s in subs))
