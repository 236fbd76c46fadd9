"""The plain reference of a mixture of EiNets trained by soft EM (Peharz et
al., ICML 2020, §4.2's mixture of EiNets, with §3.5's EM).

    log p(x) = log sum_c w_c p_c(x)

Each component is ``reference.einet.Reference``'s circuit with its own
parameters.  One soft EM step on a batch:

  1. every component's log-likelihood of every row, in blocks, without
     gradients;
  2. the responsibilities r[b, c] = softmax_c(log w_c + ll_c(x_b)), an
     explicit tensor, detached;
  3. each component's expected statistics from the gradient of
     sum_b r[b, c] ll_c(x_b), block by block (``Reference.statistics``
     with each row weighted by its responsibility);
  4. each component's M-step and Sato blend (``Reference.em_step``), and
     the weights' update: (sum_b r[b, c] + alpha) normalised, blended
     linearly with the same step size.

Plain PyTorch in float32; contractions at the precision ``precision``
sets (``reference.einet``).  It imports nothing of the program and does
not differentiate through the mixture's top: the program takes one
gradient of the whole mixture's log-likelihood, whose top-level
``log_mix_exp`` hands each component its responsibilities.

Departures from the paper: §4.2 trains its CelebA mixture by hard EM on
k-means clusters; this is the soft step, the whole mixture as one circuit
and every row through every component.  The weights' statistics take a
Laplace term ``weight_alpha`` and the weights are blended as the other
parameters are (the paper states neither).  Rows run in blocks, the sums
taken block by block.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .einet import Reference, operand


class _WeightedReference(Reference):
    """``Reference`` whose E-step weighs row b's statistics by
    ``self.row_weights[b]``: the gradient of sum_b r_b ll(x_b)."""

    row_weights: Optional[torch.Tensor] = None

    def statistics(self, params: Dict, x: torch.Tensor, block: int) -> Dict:
        lay, k = self.lay, self.k
        ws = [w.detach().clone().requires_grad_(True) for w in params["einsum"]]
        mixed = [i for i, p in enumerate(lay.pairs) if p.mix_child is not None]
        vs = {i: params["mixing"][i].detach().clone().requires_grad_(True)
              for i in mixed}
        g_w = [torch.zeros_like(w) for w in ws]
        g_v = {i: torch.zeros_like(v) for i, v in vs.items()}
        npair = len(lay.pair_var)
        s_phi = x.new_zeros((npair, k, 2))
        s_den = x.new_zeros((npair, k))
        g_prior = torch.zeros_like(params["class_prior"])
        ll = x.new_zeros(())
        for lo in range(0, x.shape[0], block):
            xb = x[lo: lo + block]
            rb = self.row_weights[lo: lo + block]
            with torch.no_grad():
                rows = self.leaf_rows(params["phi"], xb)
            rows.requires_grad_(True)
            logprior = torch.log(params["class_prior"].detach()).requires_grad_(True)
            p = dict(params, einsum=ws,
                     mixing=[vs.get(i, m) for i, m in enumerate(params["mixing"])])
            with torch.enable_grad():
                root, _, _ = self.upward(p, rows)
                val = (rb * torch.logsumexp(root + logprior[None], -1)).sum()
                grads = torch.autograd.grad(
                    val, ws + [vs[i] for i in mixed] + [rows, logprior])
            with torch.no_grad():
                for acc, g in zip(g_w, grads[:len(ws)]):
                    acc += g
                for i, g in zip(mixed, grads[len(ws): len(ws) + len(mixed)]):
                    g_v[i] += g
                g_rows, g_lp = grads[-2], grads[-1]
                g_pairs = g_rows[:, self.pair_leaf]
                xp = xb[:, self.pair_var]
                t = torch.stack([xp, xp * xp], -1)
                s_phi += torch.einsum("bpk,bpt->pkt", operand(g_pairs), operand(t))
                s_den += g_pairs.sum(0)
                g_prior += g_lp
                ll += val.detach()
        with torch.no_grad():
            n_w = [w.detach() * g for w, g in zip(ws, g_w)]
            n_v = {i: vs[i].detach() * g_v[i] for i in mixed}
        return {"n_w": n_w, "n_v": n_v, "s_phi": s_phi, "s_den": s_den,
                "n_class": g_prior, "ll": ll, "rows": x.shape[0]}


class MixtureReference:
    """A configuration's mixture of ``num_components`` circuits on
    ``device``.  Parameters are ``{"components": [one dict a component,
    in the layout structure.Layout.shapes gives], "weights": (C,)}``."""

    def __init__(self, cfg: Dict, device):
        self.ref = _WeightedReference(cfg, device)
        self.lay = self.ref.lay
        self.num_components = int(cfg["num_components"])

    @torch.no_grad()
    def component_log_likelihoods(self, params: Dict, x: torch.Tensor,
                                  block: int) -> torch.Tensor:
        """(B, C): each component's log-likelihood of each row."""
        out = [torch.cat([self.ref.log_likelihood(p, x[lo: lo + block])
                          for lo in range(0, x.shape[0], block)])
               for p in params["components"]]
        return torch.stack(out, 1)

    @staticmethod
    def log_weights(params: Dict) -> torch.Tensor:
        return torch.log(params["weights"])

    def log_likelihood(self, params: Dict, x: torch.Tensor,
                       block: int) -> torch.Tensor:
        """(B,) log sum_c w_c p_c(x_b)."""
        lls = self.component_log_likelihoods(params, x, block)
        return torch.logsumexp(self.log_weights(params)[None] + lls, -1)

    def responsibilities(self, params: Dict, x: torch.Tensor,
                         block: int) -> torch.Tensor:
        """(B, C) r[b, c] = p(c | x_b)."""
        lls = self.component_log_likelihoods(params, x, block)
        return torch.softmax(self.log_weights(params)[None] + lls, -1)

    @torch.no_grad()
    def em_step(self, params: Dict, x: torch.Tensor, em: Dict,
                weight_alpha: float, block: int,
                resp: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, float, torch.Tensor]:
        """One stochastic soft EM step from ``params`` on ``x``: the new
        parameters, the batch's mean mixture log-likelihood before the
        step and the responsibilities the statistics were weighted by
        (``resp``, when given, in place of the softmax: a fault a control
        plants)."""
        lls = self.component_log_likelihoods(params, x, block)
        logits = self.log_weights(params)[None] + lls
        loss = float(torch.logsumexp(logits, -1).mean())
        r = torch.softmax(logits, -1) if resp is None else resp
        comps: List[Dict] = []
        for c, p in enumerate(params["components"]):
            self.ref.row_weights = r[:, c]
            new, _ = self.ref.em_step(p, x, em, block)
            comps.append(new)
        self.ref.row_weights = None
        lam = em["step_size"]
        n = r.sum(0) + weight_alpha
        w = (1.0 - lam) * params["weights"] + lam * n / n.sum()
        return {"components": comps, "weights": w}, loss, r
