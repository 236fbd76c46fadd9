"""Atomic, asynchronous checkpoints, in the reference's on-disk layout.

The port's counterpart of the reference's ``repro/checkpoint/checkpoint.py``.
Layout:  <dir>/step_<N>/
            meta.json      -- leaf paths, shapes, dtypes, step, process count
            shard_0.npz    -- the leaves, named a0, a1, ... in path order

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
  * one process writes one shard file, ``shard_0.npz``; several processes
    are later work.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

PROCESS = 0  # this process's index; one process writes every checkpoint


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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
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
                "num_processes": 1,
            }
            np.savez(os.path.join(tmp, f"shard_{PROCESS}.npz"),
                     **{f"a{i}": a for i, a in enumerate(host)})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
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
        with np.load(os.path.join(d, f"shard_{PROCESS}.npz")) as data:
            arrays = [data[f"a{i}"] for i in range(len(meta["paths"]))]
        paths, _ = tree_lib.flatten(tree_like)
        assert paths == meta["paths"], (
            "checkpoint tree mismatch:\n"
            f"  want {paths[:5]}...\n  have {meta['paths'][:5]}...")
        return step, tree_lib.unflatten_like(tree_like, arrays, _restored)
