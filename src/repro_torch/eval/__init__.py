"""Generative-image evaluation workbench (the paper's §4.2 / Fig. 4 surface).

Everything the port needs to *measure* an EiNet as an image model, served
through the batched exact-inference engine (``repro_torch.serve``):

  * ``metrics``    -- held-out log-likelihood / bits-per-dim, streamed through
                      the engine (kinds ``joint_ll`` / ``marginal_ll``) with
                      parity counted against direct ``model.query`` calls.
  * ``masks``      -- the Fig. 4 structured evidence masks (left-half,
                      bottom-half, center-square, random-pixel).
  * ``inpainting`` -- the Fig. 4 harness: ``conditional_sample`` + ``mpe``
                      per-request through the engine, parity vs direct calls,
                      reconstruction metrics.
  * ``grids``      -- PNG sample/inpainting grid artifacts (a stdlib PNG
                      encoder) + per-run metrics JSON.
  * ``workbench``  -- the end-to-end run behind ``repro_torch.launch.eval``.
"""

from repro_torch.eval.masks import MASK_KINDS, make_mask
from repro_torch.eval.metrics import (
    EngineLLResult,
    bits_per_dim,
    engine_log_likelihoods,
    evaluate_bpd,
)
from repro_torch.eval.inpainting import InpaintingReport, run_inpainting
from repro_torch.eval.grids import save_image_grid, save_metrics_json
from repro_torch.eval.workbench import EvalConfig, run_eval

__all__ = [
    "MASK_KINDS",
    "make_mask",
    "EngineLLResult",
    "bits_per_dim",
    "engine_log_likelihoods",
    "evaluate_bpd",
    "InpaintingReport",
    "run_inpainting",
    "save_image_grid",
    "save_metrics_json",
    "EvalConfig",
    "run_eval",
]
