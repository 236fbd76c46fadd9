"""Atomic, asynchronous checkpoints, in the reference's on-disk layout.

The port's counterpart of the reference's ``repro/checkpoint/checkpoint.py``.
Layout:  <dir>/step_<N>/
            meta.json      -- leaf paths, shapes, dtypes, step, process count
            shard_<r>.npz  -- process r's leaves, named a0, a1, ... in path
                              order

A state is a tree of dicts and lists (``repro_torch.tree``): dict keys in
sorted order, paths joined with ``/``, the strings and array names the
reference writes.  So a checkpoint of the reference's training state
(``{"last_ll", "params": {...}, "step"}``) restores into the port, and
the port's into the reference.

Guarantees:
  * atomic commit: writes go to ``step_<N>.tmp`` and are renamed only after
    fsync -- a killed writer never corrupts the latest checkpoint.
  * restore picks the newest *committed* step (ignores .tmp debris).
  * optional async writer thread: ``save`` copies the leaves to host
    memory before it returns (the training step then writes the module's
    parameters in place), and a thread writes the files; ``wait()`` joins
    it before the next save or a restore.
  * each process (rank r of a ``torch.distributed`` job, 0 without one)
    writes its own ``shard_<r>.npz`` and restores from it, as each process
    of the reference does.  With several processes, rank 0 commits: each
    rank marks its shard written (``done_<r>``), rank 0 waits for every
    mark, writes ``meta.json`` and renames; every writer finishes only once
    the step is committed, so after ``wait()`` every rank sees the same
    newest step.  The ranks share the directory.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch import tree as tree_lib

COMMIT_TIMEOUT_S = 600.0  # how long a writer waits for the other ranks
_POLL_S = 0.02


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array that owns its memory (a copy, so a
    later in-place write to the tensor does not reach the checkpoint)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _restored(ref, arr: np.ndarray):
    """A checkpointed array as a leaf like ``ref``: a tensor of its dtype
    on its device, an array of its dtype, or the array itself."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device,
                                                  dtype=ref.dtype)
    if hasattr(ref, "dtype"):
        return arr.astype(ref.dtype)
    return arr


def _wait_for(done, what: str) -> None:
    # a timeout, not a measurement: the obs clock is monotonic
    deadline = obs.now() + COMMIT_TIMEOUT_S
    while not done():
        if obs.now() > deadline:
            raise TimeoutError(f"checkpoint: no {what} after "
                               f"{COMMIT_TIMEOUT_S:.0f} s")
        time.sleep(_POLL_S)


def _fsynced(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Checkpoints of one process under ``directory``: ``rank`` and
    ``world`` default to the ``torch.distributed`` job's (0 and 1 without
    one)."""

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True,
                 rank: Optional[int] = None, world: Optional[int] = None):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self.rank = process_index() if rank is None else rank
        self.world = process_count() if world is None else world
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # copy to host memory now, write (maybe on a thread) after
        paths, leaves = tree_lib.flatten(tree)
        host = [_host(leaf) for leaf in leaves]
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, paths, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, paths, host)

    def _write(self, step: int, paths: List[str],
               host: List[np.ndarray]) -> None:
        try:
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            meta = {
                "step": step,
                "paths": paths,
                "shapes": [list(a.shape) for a in host],
                "dtypes": [str(a.dtype) for a in host],
                "num_processes": self.world,
            }
            np.savez(os.path.join(tmp, f"shard_{self.rank}.npz"),
                     **{f"a{i}": a for i, a in enumerate(host)})
            if self.world > 1:
                _fsynced(os.path.join(tmp, f"done_{self.rank}"), "")
                if self.rank != 0:
                    # done once rank 0 has committed the step (renamed tmp)
                    _wait_for(lambda: not os.path.exists(tmp),
                              f"commit of step {step} by rank 0")
                    return
                marks = [os.path.join(tmp, f"done_{r}")
                         for r in range(self.world)]
                _wait_for(lambda: all(os.path.exists(m) for m in marks),
                          f"shards of step {step} from every rank")
                for m in marks:
                    os.remove(m)
            _fsynced(os.path.join(tmp, "meta.json"), json.dumps(meta))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "meta.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``tree_like`` (its values are
        ignored; a tensor leaf gives a tensor of its dtype on its device).
        Returns (step, tree) with new leaves; to write them into a module,
        ``repro_torch.core.em.load_params`` copies them in place."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, f"shard_{self.rank}.npz")) as data:
            arrays = [data[f"a{i}"] for i in range(len(meta["paths"]))]
        paths, _ = tree_lib.flatten(tree_like)
        assert paths == meta["paths"], (
            "checkpoint tree mismatch:\n"
            f"  want {paths[:5]}...\n  have {meta['paths'][:5]}...")
        return step, tree_lib.unflatten_like(tree_like, arrays, _restored)
