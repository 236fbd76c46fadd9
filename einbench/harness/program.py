"""The system under test: the PyTorch and CUDA port ``repro_torch``, reached
through its public entry points only.  This is the one module of the
harness that imports it.  The benchmark takes from it the model, its
training step and serving engine, and its counters; it takes no weights,
tables or reference numbers from it."""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict

from harness.spec import ROOT

_SRC = os.path.join(ROOT, "src")


def _path() -> None:
    if _SRC not in sys.path:
        sys.path.insert(0, _SRC)


def build_model(cfg: Dict, device):
    """The configuration's EiNet on ``device`` (the program initialises it
    from its fixed seed 0; the benchmark then loads its own weights)."""
    _path()
    from repro_torch.configs import EinetConfig
    from repro_torch.launch.cells import build_einet

    fields = {f.name for f in dataclasses.fields(EinetConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in fields}
    return build_einet(EinetConfig(**kw), device=device, seed=0)


def params_of(model) -> Dict:
    _path()
    from repro_torch.core.em import params_of as of

    return of(model)


def load_params(model, params: Dict) -> None:
    _path()
    from repro_torch.core.em import load_params as load

    load(model, params)


def em_step(model, em: Dict, microbatches: int):
    """``make_em_step``'s step: stochastic EM, health off."""
    _path()
    from repro_torch.core.em import EMConfig
    from repro_torch.train import TrainConfig, make_em_step

    cfg = TrainConfig(em=EMConfig(**em), mode="stochastic",
                      num_microbatches=int(microbatches), health=False)
    return make_em_step(model, cfg)


def engine(model, max_batch: int):
    _path()
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(model, max_batch=int(max_batch))


def request(i: int, kind: str, x, evidence, seed: int):
    _path()
    from repro_torch.serve.engine import Request

    return Request(req_id=i, kind=kind, x=x, evidence_mask=evidence,
                   query_mask=~evidence, seed=int(seed))


def capture_seconds() -> float:
    """Seconds the program has spent capturing its programs (its
    ``compile.programs.seconds`` counter)."""
    _path()
    from repro_torch import obs

    return float(sum(m.value for _, m in
                     obs.METRICS.find("compile.programs.seconds")))


def release() -> None:
    """Drop the program's registry entries, so that its graphs and pools
    go with the model."""
    _path()
    from repro_torch import compile as compile_lib

    compile_lib.REGISTRY.clear()

