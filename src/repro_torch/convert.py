"""Carry parameters between the JAX reference and the port, as numpy.

The reference keeps an EiNet's parameters as a dict
``{"phi": (D, K, R, |T|), "einsum": [per pair (L, K_out, K, K)],
"mixing": [per pair (M, C, K_out), or (0, 0, K_out) without mixing],
"class_prior": (num_classes,)}``; the port keeps the same arrays as the
``EiNet`` module's parameters.  With these two functions both packages
compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(params_np: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """The reference's parameter dict (numpy arrays) as a ``state_dict`` for
    ``model`` (tensors on the model's device); load it with
    ``model.load_state_dict``.  Raises on any shape mismatch."""
    n = len(model.pair_specs)
    if len(params_np["einsum"]) != n or len(params_np["mixing"]) != n:
        raise ValueError(
            f"reference params have {len(params_np['einsum'])} einsum / "
            f"{len(params_np['mixing'])} mixing entries; the model has {n} pairs"
        )
    flat = {"phi": params_np["phi"], "class_prior": params_np["class_prior"]}
    for i in range(n):
        flat[f"einsum.{i}"] = params_np["einsum"][i]
        flat[f"mixing.{i}"] = params_np["mixing"][i]
    own = dict(model.named_parameters())
    out = {}
    for name, arr in flat.items():
        arr = np.asarray(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(
                f"{name}: reference shape {arr.shape} != port shape "
                f"{tuple(own[name].shape)}"
            )
        out[name] = torch.from_numpy(arr.copy()).to(own[name].device)
    return out


def params_to_numpy(model) -> Dict[str, Any]:
    """The model's parameters in the reference's dict layout, as numpy."""
    def np_of(t):
        return t.detach().cpu().numpy().copy()

    return {
        "phi": np_of(model.phi),
        "einsum": [np_of(w) for w in model.einsum],
        "mixing": [np_of(v) for v in model.mixing],
        "class_prior": np_of(model.class_prior),
    }
