"""Carry parameters between the JAX reference and the port, as numpy.

The reference keeps an EiNet's parameters as a dict
``{"phi": (D, K, R, |T|), "einsum": [per pair (L, K_out, K, K)],
"mixing": [per pair (M, C, K_out), or (0, 0, K_out) without mixing],
"class_prior": (num_classes,)}``; the port keeps the same arrays as the
``EiNet`` module's parameters.  With these functions both packages
compute with the same weights; the ``mixture_*`` pair does the same for a
mixture of EiNets, whose component parameters are stacked on a leading
axis in both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.em import params_of


def params_from_jax(params_np: Dict[str, Any], model) -> Dict[str, torch.Tensor]:
    """The reference's parameter dict (numpy arrays) as a ``state_dict`` for
    ``model`` (tensors on the model's device); load it with
    ``model.load_state_dict``.  Raises on any shape mismatch."""
    return _state_dict(params_np, {}, model)


def params_to_numpy(model) -> Dict[str, Any]:
    """The model's parameters in the reference's dict layout, as numpy."""
    return {key: ([_np_of(t) for t in val] if isinstance(val, list)
                  else _np_of(val))
            for key, val in params_of(model).items()}


def mixture_params_from_jax(params_np: Dict[str, Any],
                            mix) -> Dict[str, torch.Tensor]:
    """The reference's mixture parameters ``{"components": <stacked EiNet
    dict, leading C axis>, "mixture_weights": (C,)}`` (numpy) as a
    ``state_dict`` for the ``EiNetMixture`` ``mix`` (tensors on its
    device); load it with ``mix.load_state_dict``.  Raises on any shape
    mismatch."""
    return _state_dict(params_np["components"],
                       {"mixture_weights": params_np["mixture_weights"]}, mix)


def mixture_params_to_numpy(mix) -> Dict[str, Any]:
    """The mixture's parameters in the reference's layout, as numpy: the
    stacked components in the EiNet layout, and the weights."""
    return {"components": params_to_numpy(mix),
            "mixture_weights": _np_of(mix.mixture_weights)}


def _np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _state_dict(einet_np: Dict[str, Any], extra: Dict[str, Any],
                module) -> Dict[str, torch.Tensor]:
    """An EiNet parameter dict (plus ``extra`` named arrays) as tensors
    named as ``module``'s parameters, on their devices; raises on a pair
    count or any shape that differs."""
    n = len(module.einsum)
    if len(einet_np["einsum"]) != n or len(einet_np["mixing"]) != n:
        raise ValueError(
            f"reference params have {len(einet_np['einsum'])} einsum / "
            f"{len(einet_np['mixing'])} mixing entries; the model has {n} pairs"
        )
    flat = {"phi": einet_np["phi"], "class_prior": einet_np["class_prior"],
            **extra}
    for i in range(n):
        flat[f"einsum.{i}"] = einet_np["einsum"][i]
        flat[f"mixing.{i}"] = einet_np["mixing"][i]
    own = dict(module.named_parameters())
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
