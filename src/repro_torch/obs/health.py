"""Device-side numerical-health telemetry for the EM training step.

The port's counterpart of the reference's ``repro/obs/health.py``.  EiNet
failure modes live inside the step's device work -- rows pinned at
``NEG_INF`` after a saturated log-einsum-exp, EF parameters stuck at their
clamp bounds, exploding E-step statistics -- where host-side tracing
(:mod:`repro_torch.obs.trace`) cannot see.  This module computes a
fixed-shape **health vector** inside the training step: every slot is a
reduction over tensors the step holds on the device, stacked into one
float32 vector with no host readback until the caller fetches it, so on
the card it is one more output of the captured step graph.

Layout (:class:`HealthSpec`), the reference's slots in its order:

  * ``ll.mean`` / ``ll.min`` / ``ll.nonfinite``  -- batch log-likelihood
    health (mean over the full batch from the E-step statistics; min and
    non-finite count over the probe batch);
  * ``leaf.sat_frac``    -- fraction of leaf-region rows pinned at NEG_INF;
  * ``leaf.clamp_frac``  -- fraction of EF parameters at their clamp bounds
    (``ExponentialFamily.clamp_fraction``);
  * ``weight.entropy``   -- mean sum-weight entropy (collapse detector);
  * ``stat.norm.max`` / ``stat.norm.mean`` / ``stat.nonfinite`` -- E-step
    statistic block norms and non-finite count;
  * ``seg{i}.sat_frac``  -- per execution-plan segment, the saturated-row
    fraction of that segment's log-einsum-exp output.

The per-segment slots come from **taps**: the walk of
``EiNet.forward_rows`` calls :func:`tap_segment` after each segment.  With
no collector active a tap is one thread-local attribute read and adds no
tensor op, so a step with health off launches exactly what it launched
before the taps existed.  Under :func:`collect` -- active only around the
dedicated health forward of ``train/pipeline.py`` -- each tap appends its
segment's saturation fraction to the vector under construction.  The E-step's own
forward never runs under a collector.

Gating: the ``EiNet(health=...)`` ctor knob (``None`` defers to the
``REPRO_HEALTH`` environment variable), overridable per step through
``TrainConfig(health=...)``.  The fetched vector feeds ``train.health.*``
gauges (:func:`publish`) and the divergence flight recorder
(:class:`HealthWatcher` -> :mod:`repro_torch.obs.incident`).

This submodule imports torch and is not re-exported by
``repro_torch.obs``, whose package root stays stdlib-only.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.layers import NEG_INF

# a log-space row is "saturated" when it has collapsed to the NEG_INF
# sentinel (halved so float rounding in the stabilised frame cannot unpin it)
SAT_THRESHOLD = 0.5 * NEG_INF

BASE_SLOTS: Tuple[str, ...] = (
    "ll.mean",
    "ll.min",
    "ll.nonfinite",
    "leaf.sat_frac",
    "leaf.clamp_frac",
    "weight.entropy",
    "stat.norm.max",
    "stat.norm.mean",
    "stat.nonfinite",
)

DEFAULT_INCIDENT_DIR = "artifacts/incidents_torch"


def resolve_health(value: Optional[bool]) -> bool:
    """Ctor-knob resolution: an explicit value wins, else ``REPRO_HEALTH``."""
    if value is not None:
        return bool(value)
    env = os.environ.get("REPRO_HEALTH", "").strip().lower()
    return env not in ("", "0", "false", "off", "no")


@dataclasses.dataclass(frozen=True)
class HealthSpec:
    """The fixed slot layout of one model's health vector: the base slots,
    then one saturation slot per execution segment in plan order."""

    names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.names)

    @property
    def num_segments(self) -> int:
        return len(self.names) - len(BASE_SLOTS)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def to_dict(self, vec) -> Dict[str, float]:
        if isinstance(vec, torch.Tensor):
            vec = vec.detach().cpu().tolist()
        return {n: float(v) for n, v in zip(self.names, vec)}


def spec_for(num_segments: int) -> HealthSpec:
    """The layout of a model whose forward walks ``num_segments`` segments
    (``EiNet.walk_segments``)."""
    return HealthSpec(BASE_SLOTS + tuple(
        f"seg{i}.sat_frac" for i in range(num_segments)))


# ------------------------------------------------------------------- taps
_TAP = threading.local()


class _Collector:
    """Context manager arming the tap sites for one forward."""

    __slots__ = ("items", "_prev")

    def __init__(self):
        self.items: List[torch.Tensor] = []
        self._prev = None

    def __enter__(self) -> List[torch.Tensor]:
        self._prev = getattr(_TAP, "items", None)
        _TAP.items = self.items
        return self.items

    def __exit__(self, *exc) -> bool:
        _TAP.items = self._prev
        return False


def collect() -> _Collector:
    """Arm :func:`tap_segment` for the ``with`` body (one health forward)."""
    return _Collector()


def tap_segment(value: torch.Tensor) -> None:
    """Per-segment tap site (called by ``EiNet.forward_rows``).

    No collector active: one thread-local attribute read, no tensor op.
    Collector active: appends this segment's saturated-entry fraction to
    the health vector under construction."""
    items = getattr(_TAP, "items", None)
    if items is None:
        return
    items.append(saturation_fraction(value))


# --------------------------------------------------------- vector assembly
def saturation_fraction(value: torch.Tensor) -> torch.Tensor:
    return torch.mean((value <= SAT_THRESHOLD).to(torch.float32))


def _nonfinite_count(tree: Dict[str, Any]) -> torch.Tensor:
    leaves = []
    for v in tree.values():
        leaves += v if isinstance(v, list) else [v]
    return sum(torch.sum(~torch.isfinite(leaf)) for leaf in leaves)


def _weight_entropy(einsum_w: List[torch.Tensor]) -> torch.Tensor:
    """Mean entropy of the (K x K) child distribution of every sum node --
    near-zero entropy means the circuit has collapsed onto single children."""
    ents = []
    for w in einsum_w:
        p = w / torch.clamp(torch.sum(w, dim=(-2, -1), keepdim=True),
                            min=1e-38)
        ents.append(torch.mean(
            -torch.sum(p * torch.log(torch.clamp(p, min=1e-38)),
                       dim=(-2, -1))))
    return torch.mean(torch.stack(ents))


def probe_forward(model, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """One forward of ``model`` on the batch ``x`` through the tap sites:
    (leaf rows, per-row log-likelihood, one saturation fraction a
    segment).  The taps must match the model's health spec."""
    leaf_rows = model.leaf_rows(x, None)
    with collect() as taps:
        root = model.forward_rows(leaf_rows)
    if len(taps) != model.health_spec.num_segments:
        raise AssertionError(
            f"health taps out of sync with the plan: got {len(taps)} "
            f"segments, spec has {model.health_spec.num_segments}")
    ll_rows = torch.logsumexp(
        root + torch.log(model.class_prior)[None, :], dim=-1)
    return leaf_rows, ll_rows, taps


@torch.no_grad()
def health_vector(model, probe_x: torch.Tensor, stats: Dict[str, Any],
                  new_params: Dict[str, Any]) -> torch.Tensor:
    """Assemble the health vector inside the training step.

    ``model`` still holds the parameters the E-step ran on (the step writes
    ``new_params`` into it after this call).  ``probe_x`` is the batch the
    dedicated health forward runs on -- the full batch at one microbatch,
    the first microbatch otherwise; ``stats`` are the E-step statistics
    (full batch, exact); ``new_params`` the post-update parameters whose
    entropy and clamp state are monitored."""
    leaf_rows, ll_rows, taps = probe_forward(model, probe_x)
    norms = torch.stack(
        [torch.sqrt(torch.sum(torch.square(n))) for n in stats["n_einsum"]]
        + [torch.sqrt(torch.sum(torch.square(stats["s_phi"])))])
    base = {
        "ll.mean": stats["ll"] / stats["count"],
        "ll.min": torch.min(ll_rows),
        "ll.nonfinite": torch.sum(~torch.isfinite(ll_rows)),
        "leaf.sat_frac": saturation_fraction(leaf_rows),
        "leaf.clamp_frac": model.ef.clamp_fraction(new_params["phi"]),
        "weight.entropy": _weight_entropy(new_params["einsum"]),
        "stat.norm.max": torch.max(norms),
        "stat.norm.mean": torch.mean(norms),
        "stat.nonfinite": _nonfinite_count(stats),
    }
    return torch.stack([base[n].to(torch.float32) for n in BASE_SLOTS]
                       + [t.to(torch.float32) for t in taps])


def publish(spec: HealthSpec, vec) -> None:
    """Feed a fetched health vector into the ``train.health.*`` gauges."""
    from repro_torch.obs.metrics import METRICS

    for name, value in spec.to_dict(vec).items():
        METRICS.gauge(f"train.health.{name}").set(value)


# ------------------------------------------------- divergence flight recorder
class DivergenceError(RuntimeError):
    """Training diverged; ``bundle`` is the incident-bundle directory."""

    def __init__(self, reason: str, bundle: Optional[str]):
        super().__init__(
            f"training diverged: {reason}"
            + (f" (incident bundle: {bundle})" if bundle else ""))
        self.reason = reason
        self.bundle = bundle


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """What the flight recorder does when the health vector trips.

    on_incident: "abort" raises :class:`DivergenceError` after dumping the
      bundle; "continue" dumps and keeps training.
    max_incidents: bundles dumped per run -- a persistently-NaN run under
      "continue" records ONE bundle, not one per step.
    stat_norm_factor: trip when ``stat.norm.max`` exceeds this multiple of
      its running median (needs >= ``min_history`` observations).
    sat_spike: trip when any segment's saturation fraction exceeds its
      running median by this much.
    """

    on_incident: str = "abort"  # "abort" | "continue"
    max_incidents: int = 1
    stat_norm_factor: float = 50.0
    sat_spike: float = 0.25
    min_history: int = 3
    window: int = 64
    incident_dir: str = DEFAULT_INCIDENT_DIR


class HealthWatcher:
    """Watches the per-step health vector and dumps incident bundles.

    Host-side: one ``spec.size``-float readback per step.  Triggers:

      * non-finite log-likelihood or E-step statistics (immediate);
      * ``stat.norm.max`` exploding past ``stat_norm_factor`` x its running
        median;
      * any segment saturation fraction spiking ``sat_spike`` above its
        running median.

    The relative triggers compare against the run's own recent history
    (``window`` steps), so a model that starts saturated does not trip --
    only a step that suddenly degrades does.
    """

    def __init__(self, model, policy: Optional[HealthPolicy] = None):
        self.spec: HealthSpec = model.health_spec
        self.policy = policy or HealthPolicy()
        if self.policy.on_incident not in ("abort", "continue"):
            raise ValueError(
                f"on_incident={self.policy.on_incident!r}; "
                "'abort' or 'continue'")
        self.history: "collections.deque" = collections.deque(
            maxlen=self.policy.window)
        self.incidents: List[str] = []
        self._sat_names = [n for n in self.spec.names
                           if n.endswith(".sat_frac")]

    def _median(self, name: str) -> Optional[float]:
        vals = sorted(h[name] for h in self.history
                      if math.isfinite(h[name]))
        if len(vals) < self.policy.min_history:
            return None
        mid = len(vals) // 2
        return (vals[mid] if len(vals) % 2
                else 0.5 * (vals[mid - 1] + vals[mid]))

    def _check(self, vals: Dict[str, float]) -> Optional[str]:
        if (vals["ll.nonfinite"] > 0 or not math.isfinite(vals["ll.mean"])
                or vals["stat.nonfinite"] > 0):
            return (
                f"non-finite values: ll.mean={vals['ll.mean']}, "
                f"ll.nonfinite={vals['ll.nonfinite']:.0f}, "
                f"stat.nonfinite={vals['stat.nonfinite']:.0f}")
        med = self._median("stat.norm.max")
        if med is not None and med > 0.0 and (
                vals["stat.norm.max"] > self.policy.stat_norm_factor * med):
            return (
                f"statistic norm exploded: stat.norm.max="
                f"{vals['stat.norm.max']:.3e} vs running median {med:.3e}")
        for name in self._sat_names:
            med = self._median(name)
            if med is not None and vals[name] > med + self.policy.sat_spike:
                return (f"saturation spike: {name}={vals[name]:.3f} vs "
                        f"running median {med:.3f}")
        return None

    def observe(self, step: int, vec, params=None) -> Optional[str]:
        """Record one step's health vector; returns the bundle path when an
        incident fired this step (and raises under the "abort" policy)."""
        vals = self.spec.to_dict(vec)
        reason = self._check(vals)
        self.history.append({"step": int(step), **vals})
        if reason is None:
            return None
        bundle = None
        if len(self.incidents) < self.policy.max_incidents:
            from repro_torch.obs import incident as incident_lib

            bundle = incident_lib.dump_incident(
                self.policy.incident_dir, reason=reason, step=int(step),
                history=list(self.history), params=params, spec=self.spec)
            self.incidents.append(bundle)
            print(f"[health] incident at step {step}: {reason} -> {bundle}")
        if self.policy.on_incident == "abort":
            raise DivergenceError(reason, bundle)
        return bundle
