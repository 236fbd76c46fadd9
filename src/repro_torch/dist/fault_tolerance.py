"""Fault-tolerant training loop: deterministic checkpoint-restart and
straggler detection.

The port's counterpart of the reference's ``repro/dist/fault_tolerance.py``,
host-side Python with the same contract: the recovery is *exact state
reproduction*.  The data is a pure function of the step (``batch_at``)
and the step function is deterministic, so a run with N injected failures
ends in a state bit for bit that of a run with none.  Restart = restore
the newest committed checkpoint, replay from its step; with none
committed yet, replay from ``init``.

The port's training step writes the module's parameters in place, so the
state a step returns holds views of the module, and a state the loop
resumes from (``init``, or a restored checkpoint) has to be written back
into the module before the next step: ``load_state`` does that (the
launcher passes a snapshot of the initial parameters as ``init``, and a
``load_state`` that copies a state's parameters into the module in place
-- no tensor moves, so no step or serving graph recaptures).  Without
``load_state`` the loop is the reference's, for functional steps.

A restart *budget* bounds crash loops: a persistent fault must surface as
an error, not an infinite replay cycle.

``StragglerMonitor`` is the detection half of slow-node mitigation:
per-shard step-time windows, median-based outlier detection, and a
spare-remapping plan.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    checkpoint_every: int = 100       # steps between committed checkpoints
    max_restarts: int = 3             # total failures tolerated per run
    straggler_factor: float = 2.0     # mean step time > factor * fleet median
    straggler_window: int = 16        # samples per shard before judging


def run_training(
    step_fn: Callable[[Any, Any], Any],
    init: Any,
    batch_at: Callable[[int], Any],
    mgr,
    num_steps: int,
    cfg: LoopConfig = LoopConfig(),
    fail_injector: Optional[Callable[[int], None]] = None,
    on_step: Optional[Callable[[int, Any], None]] = None,
    load_state: Optional[Callable[[Any], Any]] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Run ``num_steps`` deterministic steps with checkpoint-restart recovery.

    Args:
      step_fn: (state, batch) -> state.  Deterministic.
      init: initial state tree (also the restore template).
      batch_at: step -> batch.  Pure function of the step index.
      mgr: a ``repro_torch.checkpoint.CheckpointManager``.
      fail_injector: test hook, called with the step index before each step;
        raising simulates a node failure at that step.
      on_step: observer called with (completed_step_count, state).
      load_state: called with every state the loop starts or resumes from
        (``init``, a restored checkpoint); returns the state to step from.
        A step that updates a module in place passes one that writes the
        state into the module.

    Returns (final_state, stats) where stats["restarts"] counts recoveries.
    Raises RuntimeError once failures exceed ``cfg.max_restarts``.
    """
    load = load_state or (lambda s: s)
    step = 0
    if mgr.latest_step() is not None:  # resume a preempted run
        step, state = mgr.restore(init)
    else:
        state = init
    state = load(state)
    restarts = 0
    failures: List[str] = []
    t_start = obs.now()
    while step < num_steps:
        try:
            if fail_injector is not None:
                fail_injector(step)
            state = step_fn(state, batch_at(step))
            step += 1
            if on_step is not None:
                on_step(step, state)
            if cfg.checkpoint_every > 0 and step % cfg.checkpoint_every == 0:
                mgr.save(step, state)
        except Exception as e:  # noqa: BLE001 -- any step failure is a "node loss"
            restarts += 1
            failures.append(f"step {step}: {e!r}")
            if restarts > cfg.max_restarts:
                raise RuntimeError(
                    f"restart budget exhausted ({cfg.max_restarts} allowed, "
                    f"{restarts} failures): {failures}") from e
            try:
                mgr.wait()  # let an in-flight async commit land before looking
            except Exception as we:  # noqa: BLE001 -- a failed write just means
                failures.append(f"checkpoint writer: {we!r}")  # an older restore
            if mgr.latest_step() is None:
                step, state = 0, init  # nothing committed yet: replay all
            else:
                step, state = mgr.restore(init)
            state = load(state)
    mgr.wait()
    stats = {
        "restarts": restarts,
        "failures": failures,
        "final_step": step,
        "wall_time_s": obs.now() - t_start,
    }
    return state, stats


class StragglerMonitor:
    """Detect persistently slow data shards and plan spare remappings.

    ``record(shard, step_time)`` feeds per-shard timings; a shard is a
    straggler once its windowed mean exceeds ``straggler_factor`` times the
    median of the other shards' windowed means (a uniformly slow fleet
    flags nobody).  ``mitigate()`` consumes spares in order, returning
    {straggler_shard: spare_id}.  Shards are only judged on full windows,
    so a cold-start blip cannot trigger a remap.
    """

    def __init__(self, num_shards: int, cfg: LoopConfig = LoopConfig(),
                 spares: Optional[Sequence[int]] = None):
        self.cfg = cfg
        self.num_shards = num_shards
        self.times: Dict[int, collections.deque] = {
            s: collections.deque(maxlen=cfg.straggler_window)
            for s in range(num_shards)
        }
        self.spares: List[int] = list(spares) if spares else []
        self.remapped: Dict[int, int] = {}

    def record(self, shard: int, step_time: float) -> None:
        self.times[shard].append(float(step_time))

    def _windowed_means(self) -> Dict[int, float]:
        return {
            s: sum(d) / len(d)
            for s, d in self.times.items()
            if len(d) >= self.cfg.straggler_window
        }

    def stragglers(self) -> List[int]:
        means = self._windowed_means()
        if len(means) < 2:  # nothing to compare against
            return []
        out = []
        for s, m in means.items():
            # leave-one-out median: a shard must not dilute its own baseline
            others = [v for t, v in means.items() if t != s]
            med = statistics.median(others)
            if med > 0.0 and m > self.cfg.straggler_factor * med:
                out.append(s)
        return sorted(out)

    def mitigate(self) -> Dict[int, int]:
        """Assign spares to stragglers (first detected, first served).
        Returns this round's {straggler: spare}; empty when no spares are
        left or nobody qualifies.  A remapped shard's window resets so the
        spare is judged on its own timings."""
        remap: Dict[int, int] = {}
        for s in self.stragglers():
            if not self.spares:
                break
            spare = self.spares.pop(0)
            remap[s] = spare
            self.remapped[s] = spare
            self.times[s].clear()
        return remap
