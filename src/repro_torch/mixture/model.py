"""Mixtures of EiNets: the paper's §4.2 CelebA model.

An :class:`EiNetMixture` is C architecturally identical EiNet components
plus linear-domain mixture weights:

    log p(x) = log sum_c  w_c  p_c(x)

The C components share ONE ``EiNet`` structure (one set of static tables on
the device) and keep their parameters stacked on a leading component axis,
in the reference's layout: ``phi`` (C, D, K, R, |T|), ``einsum[i]`` (C, L,
K_out, K, K), ``mixing[i]`` (C, M, C_i, K_out), ``class_prior`` (C,
num_classes), and ``mixture_weights`` (C,).  ``bound(c)`` binds component
c's slices to the shared structure for a call, so every EiNet method (the
forward, sampling, the EM updates) runs on component c unchanged: its
kernel launches read the slices in place, gradients land on the stacked
tensors, and in-place writes go to component c's slice.

The top-level mixture IS a mixing layer, so ``log p`` routes through the
same ``log_mix_exp`` (an ``autograd.Function`` under autograd) as every
in-circuit mixing layer: one (M=1, C, K=1) cell.  Its EM gradient
``w * dL/dw`` is exactly the summed responsibilities
(``repro_torch.mixture.train``).

Query surface: the ``mixture_*`` kinds mirror EiNet's six kinds at the
mixture level, plus component responsibilities and component-pinned
sampling, decoding and LL (the ``component_kinds``, which the serving
engine folds into its coalescing key).  Sampling picks each row's component
first (by Gumbel-max from that row's own noise, or argmax for MPE), then
runs every component over all rows and keeps each row's chosen one: static
shapes, so every kind captures into a CUDA graph; the kernels' row
independence makes a row's answer independent of its batch.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.einet import EiNet, seed_tensor
from repro_torch.core.em import params_of
from repro_torch.core.layers import NEG_INF, gumbel, log_mix_exp

# mixture-level analogues of EiNet.QUERY_KINDS + responsibilities
MIXTURE_QUERY_KINDS = (
    "mixture_joint_ll",
    "mixture_marginal_ll",
    "mixture_conditional_ll",
    "mixture_sample",
    "mixture_conditional_sample",
    "mixture_mpe",
    "mixture_responsibility",
    # component-pinned kinds (Request.component required; the engine
    # coalesces by (kind, component))
    "mixture_component_ll",
    "mixture_component_sample",
    "mixture_component_mpe",
)
MIXTURE_COMPONENT_KINDS = (
    "mixture_component_ll",
    "mixture_component_sample",
    "mixture_component_mpe",
)

# kinds whose answer is a number (or, for responsibilities, a (C,) row of
# numbers): compared within a tolerance, not for identity
MIXTURE_VALUE_KINDS = (
    "mixture_joint_ll",
    "mixture_marginal_ll",
    "mixture_conditional_ll",
    "mixture_responsibility",
    "mixture_component_ll",
)

_W_FLOOR = 1e-38  # log-domain guard for mixture weights (matches layers.py)


def component_slice(tree: Dict[str, Any], c: int) -> Dict[str, Any]:
    """Component ``c`` of a dict in the EiNet layout whose tensors carry a
    leading component axis (parameters or statistics): views, not copies."""
    return {key: ([t[c] for t in val] if isinstance(val, list) else val[c])
            for key, val in tree.items()}


class EiNetMixture(nn.Module):
    """C EiNet components with stacked parameters + mixture weights.

    ``component`` holds the static structure; its own parameters are not
    the mixture's (it is not registered as a submodule), and are replaced
    by component c's slices inside ``bound(c)``.  The mixture's parameters
    are initialised from ``seed`` (or loaded, e.g. from
    ``repro_torch.convert.mixture_params_from_jax``).
    """

    query_kinds = MIXTURE_QUERY_KINDS
    component_kinds = MIXTURE_COMPONENT_KINDS
    value_kinds = MIXTURE_VALUE_KINDS

    def __init__(self, component: EiNet, num_components: int, seed: int = 0):
        super().__init__()
        if num_components < 1:
            raise ValueError(f"need >= 1 component, got {num_components}")
        # not a submodule: the stacked tensors below are the parameters
        self.__dict__["component"] = component
        self.num_components = int(num_components)
        self.num_vars = component.num_vars
        c_n = self.num_components

        def stacked(p: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(p.detach().new_empty((c_n,) + p.shape))

        self.phi = stacked(component.phi)
        self.einsum = nn.ParameterList([stacked(w) for w in component.einsum])
        self.mixing = nn.ParameterList([stacked(v) for v in component.mixing])
        self.class_prior = stacked(component.class_prior)
        self.mixture_weights = nn.Parameter(
            component.class_prior.detach().new_empty((c_n,)))
        if self.device.type != "meta":
            self.init_params(torch.Generator().manual_seed(int(seed)))

    @property
    def device(self) -> torch.device:
        return self.mixture_weights.device

    # --------------------------------------------------------------- binding
    def _slots(self) -> List[Tuple[nn.Module, str, torch.Tensor]]:
        """(owner module, parameter key, stacked tensor) of every component
        parameter of the shared structure."""
        net = self.component
        slots = [(net, "phi", self.phi), (net, "class_prior", self.class_prior)]
        slots += [(net.einsum, str(i), w) for i, w in enumerate(self.einsum)]
        slots += [(net.mixing, str(i), v) for i, v in enumerate(self.mixing)]
        return slots

    @contextlib.contextmanager
    def bound(self, c: int) -> Iterator[EiNet]:
        """The shared structure with component ``c``'s parameters: each of
        its parameters is, for the duration, the view ``stacked[c]``.
        Reads, gradients and in-place writes all go to the stacked
        tensors.  The structure's own parameters come back on exit."""
        c = int(c)
        if not 0 <= c < self.num_components:
            raise ValueError(
                f"component {c} not in [0, {self.num_components})")
        slots = self._slots()
        saved = [owner._parameters[key] for owner, key, _ in slots]
        try:
            for owner, key, stacked in slots:
                owner._parameters[key] = stacked[c]
            yield self.component
        finally:
            for (owner, key, _), p in zip(slots, saved):
                owner._parameters[key] = p

    # ------------------------------------------------------------- parameters
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Component c's parameters are the EiNet initialisation drawn
        after components 0..c-1's from ``generator``; uniform weights."""
        for c in range(self.num_components):
            with self.bound(c) as net:
                net.init_params(generator)
        self.mixture_weights.fill_(1.0 / self.num_components)

    def component_params(self, c: int) -> Dict[str, Any]:
        """Component c's parameters in the EiNet dict layout (detached
        views of the stacked tensors, not copies)."""
        return component_slice(params_of(self), c)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def project_params(self) -> None:
        """Project every component (``EiNet.project_params``) and
        renormalise the mixture weights, in place."""
        for c in range(self.num_components):
            with self.bound(c) as net:
                net.project_params()
        w = torch.clamp(self.mixture_weights, min=1e-12)
        self.mixture_weights.copy_(w / torch.sum(w))

    # ---------------------------------------------------------------- forward
    def component_log_likelihoods(
        self, x: torch.Tensor, marg_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Per-component log-densities: (B, C), one component at a time."""
        lls = []
        for c in range(self.num_components):
            with self.bound(c) as net:
                lls.append(net.log_likelihood(x, marg_mask))
        return torch.stack(lls, dim=1)

    @staticmethod
    def mix_log_likelihoods(weights: torch.Tensor,
                            comp_ll: torch.Tensor) -> torch.Tensor:
        """(C,) linear weights + (B, C) component LLs -> (B,) mixture LL,
        through ``log_mix_exp`` as one (M=1, C, K=1) mixing cell, so its EM
        gradient ``w * dL/dw`` is the summed responsibilities."""
        b, c = comp_ll.shape
        v = weights.reshape(1, c, 1)
        ln = comp_ll.reshape(b, 1, c, 1)
        mask = torch.ones((1, c), device=comp_ll.device)
        return log_mix_exp(v, ln, mask)[:, 0, 0]

    def log_likelihood(
        self, x: torch.Tensor, marg_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """log p(x) = log sum_c w_c p_c(x)  (marginals via ``marg_mask``)."""
        comp_ll = self.component_log_likelihoods(x, marg_mask)
        return self.mix_log_likelihoods(self.mixture_weights, comp_ll)

    def conditional_log_likelihood(
        self,
        x: torch.Tensor,
        query_mask: torch.Tensor,
        evidence_mask: torch.Tensor,
    ) -> torch.Tensor:
        joint = self.log_likelihood(x, query_mask | evidence_mask)
        ev = self.log_likelihood(x, evidence_mask)
        return joint - ev

    def _log_weights(self) -> torch.Tensor:
        return torch.log(torch.clamp(self.mixture_weights, min=_W_FLOOR))

    def responsibilities(
        self, x: torch.Tensor, marg_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Posterior over components r[b, c] = p(c | x_b), rows sum to 1.

        Saturation-safe: logits are clamped to the NEG_INF convention first,
        so rows whose every component underflows to -inf / NEG_INF resolve
        to the uniform posterior instead of NaN (0/0 softmax).
        """
        comp_ll = self.component_log_likelihoods(x, marg_mask)
        logits = torch.clamp(self._log_weights()[None, :] + comp_ll,
                             min=NEG_INF)
        return torch.softmax(logits, dim=-1)

    # --------------------------------------------------------------- sampling
    def _sample_components(
        self,
        choice: torch.Tensor,
        x: torch.Tensor,
        evidence_mask: torch.Tensor,
        noise: Optional[torch.Tensor],
        mode: str,
    ) -> torch.Tensor:
        """Each row's draw from its chosen component: component c = 0, 1,
        ... in turn samples all B rows (``noise`` holds each row's
        component uniforms first, then the component's own), and row b
        keeps component ``choice[b]``'s.  Shapes are static (no host sync,
        so the path captures into a CUDA graph); every op computes a row
        alone, so a row's bits are those of a pass over its rows only."""
        sub_noise = None if noise is None else noise[:, self.num_components:]
        out = torch.zeros_like(x)
        for c in range(self.num_components):
            with self.bound(c) as net:
                draw = net.conditional_sample(x, evidence_mask, sub_noise,
                                              mode=mode)
            out = torch.where((choice == c)[:, None], draw, out)
        return out

    def _choose(self, logits: torch.Tensor,
                noise: Optional[torch.Tensor]) -> torch.Tensor:
        """argmax of (B, C) logits, or a categorical draw by the Gumbel-max
        trick on each row's first C uniforms."""
        if noise is None:
            return torch.argmax(logits, dim=-1)
        return torch.argmax(
            logits + gumbel(noise[:, : self.num_components]), dim=-1)

    def conditional_sample_per_key(
        self,
        seeds,
        x: torch.Tensor,
        evidence_mask: torch.Tensor,
        mode: str = "sample",
    ) -> torch.Tensor:
        """Row-independent mixture sampling: one seed per batch row.

        Ancestral in the mixture too: first draw (or argmax, for MPE) the
        component from its evidence posterior p(c | x_e), then run that
        component's induced-tree top-down pass.  Each row's noise (C
        uniforms for the component, then the component's) comes from its
        own seed, so a row is a function of its own (seed, x, evidence).
        """
        if mode not in ("sample", "argmax"):
            raise ValueError(f"mode {mode!r}; expected 'sample' or 'argmax'")
        seeds = seed_tensor(seeds, x.device)
        if len(seeds) != x.shape[0]:
            raise ValueError(f"{len(seeds)} seeds for {x.shape[0]} rows")
        noise = None
        if mode == "sample":
            noise = self.component.row_noise(seeds, lead=self.num_components)
        comp_ll = self.component_log_likelihoods(x, evidence_mask)
        logits = torch.clamp(self._log_weights()[None, :] + comp_ll,
                             min=NEG_INF)
        choice = self._choose(logits, noise)
        return self._sample_components(choice, x, evidence_mask, noise, mode)

    def sample_per_key(self, seeds) -> torch.Tensor:
        """Unconditional per-seed sampling: (B, D).  With no evidence every
        component's evidence marginal is exactly 1 (normalized circuits),
        so the component posterior IS the mixture weights: the component is
        drawn from them directly, with no forward passes over C."""
        seeds = seed_tensor(seeds, self.device)
        b = len(seeds)
        noise = self.component.row_noise(seeds, lead=self.num_components)
        logits = torch.clamp(self._log_weights(), min=NEG_INF)
        choice = self._choose(logits[None, :].expand(b, -1), noise)
        x = torch.zeros((b, self.num_vars), device=self.device)
        ev = torch.zeros((b, self.num_vars), dtype=torch.bool,
                         device=self.device)
        return self._sample_components(choice, x, ev, noise, "sample")

    def component_conditional_sample_per_key(
        self,
        seeds,
        x: torch.Tensor,
        evidence_mask: torch.Tensor,
        component: int,
        mode: str = "sample",
    ) -> torch.Tensor:
        """Sampling pinned to one component: that component's own
        ``conditional_sample_per_key``."""
        with self.bound(component) as net:
            return net.conditional_sample_per_key(seeds, x, evidence_mask,
                                                  mode=mode)

    # ----------------------------------------------------------------- query
    @torch.inference_mode()
    def query(self, batch: Dict[str, Any], kind: str,
              component: Optional[int] = None) -> torch.Tensor:
        """Uniform exact-inference entry point (the serving-engine surface),
        run under ``torch.inference_mode()``.

        Same batch fields as ``EiNet.query`` -- "x", "evidence_mask",
        "query_mask", "seeds" -- so mixture requests share the engine's
        assembly and bucketing.  ``component`` is required by the
        ``mixture_component_*`` kinds and rejected otherwise.
        """
        if kind in MIXTURE_COMPONENT_KINDS:
            if component is None:
                raise ValueError(f"kind {kind!r} requires a component index")
        elif component is not None:
            raise ValueError(f"kind {kind!r} does not take a component")
        x = batch["x"]
        if kind == "mixture_joint_ll":
            return self.log_likelihood(x)
        if kind == "mixture_marginal_ll":
            return self.log_likelihood(x, batch["evidence_mask"])
        if kind == "mixture_conditional_ll":
            return self.conditional_log_likelihood(
                x, batch["query_mask"], batch["evidence_mask"])
        if kind == "mixture_responsibility":
            return self.responsibilities(x)
        if kind == "mixture_sample":
            return self.sample_per_key(batch["seeds"])
        if kind == "mixture_conditional_sample":
            return self.conditional_sample_per_key(
                batch["seeds"], x, batch["evidence_mask"])
        if kind == "mixture_mpe":
            return self.conditional_sample_per_key(
                batch["seeds"], x, batch["evidence_mask"], mode="argmax")
        if kind == "mixture_component_ll":
            with self.bound(component) as net:
                return net.log_likelihood(x)
        if kind == "mixture_component_sample":
            return self.component_conditional_sample_per_key(
                batch["seeds"], x, batch["evidence_mask"], component)
        if kind == "mixture_component_mpe":
            return self.component_conditional_sample_per_key(
                batch["seeds"], x, batch["evidence_mask"], component,
                mode="argmax")
        raise ValueError(
            f"unknown query kind {kind!r}; one of {MIXTURE_QUERY_KINDS}")
