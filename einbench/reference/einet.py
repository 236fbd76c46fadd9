"""The plain reference of an Einsum Network (Peharz et al., ICML 2020):
leaf log-densities, the log-einsum-exp and mixing layers (Eqs. 4-5,
Appendix B), the root's class prior, the E-step as one backward pass
(§3.5, Eq. 6), the M-step (Eq. 7) and Sato's online blend (Eqs. 8-9), and
ancestral sampling and MPE decoding by the induced-tree top-down pass.

Plain PyTorch in float32, contractions through ``torch.einsum``.  It
imports nothing of the program: the structure and the parameter layout
are worked out again from the configuration (``structure.layout_of``),
the sampling noise by a frozen copy of Philox (``philox``).  Rows are
processed in blocks so that a full-size cell fits beside nothing else.

``precision(tf32)`` sets the contractions' precision: float32 (TF32 off)
for the reference, TF32 for the control that must come out as not
correct.  TF32 is applied by rounding each contraction's operands to
TF32's 10-bit mantissa (products and sums stay float32), so the control
is TF32 whichever kernel cuBLAS picks: with TF32 merely allowed, cuBLAS
keeps short contractions (K=10 terms) in full float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .philox import uniforms
from .structure import layout_of

NEG = -1e30          # a row max clamped here stands for log 0
U_MIN = 2.0 ** -24   # uniforms are kept inside [2^-24, 1 - 2^-24]
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


_TF32 = [False]


@contextlib.contextmanager
def precision(tf32: bool):
    """Contractions in TF32 (``tf32``) or in full float32 inside."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    _TF32[0] = bool(tf32)
    try:
        yield
    finally:
        _TF32[0] = False
        torch.set_float32_matmul_precision(old)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), as a tensor core reads a float32 operand."""
    i = x.contiguous().view(torch.int32)
    r = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return r.view(torch.float32)


def operand(x: torch.Tensor) -> torch.Tensor:
    """A contraction's operand: as it is in float32, rounded to TF32 under
    ``precision(True)`` (the gradient passes straight through)."""
    if not _TF32[0]:
        return x
    return x + (tf32(x.detach()) - x).detach()


def log_einsum_exp(w: torch.Tensor, left: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """log sum_ij W[l,o,i,j] exp(left[b,l,i]) exp(right[b,l,j]), with
    the row maxes taken out before the exponentials (Eq. 4)."""
    a = torch.clamp(left.amax(-1, keepdim=True), min=NEG)
    b = torch.clamp(right.amax(-1, keepdim=True), min=NEG)
    t = torch.einsum("loij,blj->bloi", operand(w), operand(torch.exp(right - b)))
    s = torch.einsum("bloi,bli->blo", operand(t), operand(torch.exp(left - a)))
    return a + b + torch.log(s)


def log_mix_exp(v: torch.Tensor, ln: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """log sum_c V[m,c,k] exp(ln[b,m,c,k]) over each mixing node's real
    children."""
    lnm = torch.where(mask[None, :, :, None] > 0, ln, torch.full_like(ln, NEG))
    a = torch.clamp(lnm.amax(2, keepdim=True), min=NEG)
    s = (v[None] * torch.exp(lnm - a)).sum(2)
    return a[:, :, 0] + torch.log(s)


def gaussian(phi: torch.Tensor, min_var: float, max_var: float):
    mu = phi[..., 0]
    return mu, torch.clamp(phi[..., 1] - mu * mu, min_var, max_var)


class Reference:
    """One configuration's circuit on ``device``; parameters are passed in
    as a dict in the layout ``structure.Layout.shapes`` gives."""

    def __init__(self, cfg: Dict, device):
        self.cfg = cfg
        self.lay = layout_of(cfg)
        self.k = cfg["num_sums"]
        self.min_var, self.max_var = cfg["min_var"], cfg["max_var"]
        self.device = torch.device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        lay = self.lay
        self.pair_var, self.pair_rep = t(lay.pair_var), t(lay.pair_rep)
        self.pair_leaf = t(lay.pair_leaf)
        self.tabs = []
        for p in lay.pairs:
            self.tabs.append({
                "left": t(p.left), "right": t(p.right),
                "mix_child": None if p.mix_child is None else t(p.mix_child),
                "mix_mask": None if p.mix_mask is None else t(p.mix_mask)})

    # ------------------------------------------------------------ forward
    def leaf_rows(self, phi: torch.Tensor, x: torch.Tensor,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, leaves, K): each leaf's Gaussian log-density summed over its
        scope; a variable outside ``keep`` is marginalised (adds 0)."""
        mu, var = gaussian(phi[self.pair_var, :, self.pair_rep], self.min_var,
                           self.max_var)          # (P, K)
        xp = x[:, self.pair_var, None]            # (B, P, 1)
        e = -HALF_LOG_2PI - 0.5 * torch.log(var) - (xp - mu) ** 2 / (2 * var)
        if keep is not None:
            e = torch.where(keep[:, self.pair_var, None], e, torch.zeros_like(e))
        rows = e.new_zeros((x.shape[0], self.lay.num_leaves, self.k))
        return rows.index_add(1, self.pair_leaf, e)

    def upward(self, params: Dict, rows: torch.Tensor):
        """Root log-densities (B, classes), each pair's einsum output and
        the row buffer (leaves, then each pair's einsum and mixing rows)."""
        buffer, outs, root = rows, [], None
        for i, (p, tab) in enumerate(zip(self.lay.pairs, self.tabs)):
            s = log_einsum_exp(params["einsum"][i], buffer[:, tab["left"]],
                               buffer[:, tab["right"]])
            outs.append(s)
            new = [s]
            mix = None
            if p.mix_child is not None:
                mix = log_mix_exp(params["mixing"][i], s[:, tab["mix_child"]],
                                  tab["mix_mask"])
                new.append(mix)
            if p.final:
                root = (mix if mix is not None else s)[:, 0]
            else:
                buffer = torch.cat([buffer] + new, 1)
        return root, outs, buffer

    def log_likelihood(self, params: Dict, x: torch.Tensor,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        root, _, _ = self.upward(params, self.leaf_rows(params["phi"], x, keep))
        return torch.logsumexp(root + torch.log(params["class_prior"])[None], -1)

    # -------------------------------------------------------------- EM
    def statistics(self, params: Dict, x: torch.Tensor, block: int) -> Dict:
        """E-step over ``x`` in row blocks: the expected counts of every
        sum weight, the leaves' weighted sufficient statistics, the class
        counts and the summed log-likelihood."""
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
            with torch.no_grad():
                rows = self.leaf_rows(params["phi"], xb)
            rows.requires_grad_(True)
            logprior = torch.log(params["class_prior"].detach()).requires_grad_(True)
            p = dict(params, einsum=ws,
                     mixing=[vs.get(i, m) for i, m in enumerate(params["mixing"])])
            with torch.enable_grad():
                root, _, _ = self.upward(p, rows)
                val = torch.logsumexp(root + logprior[None], -1).sum()
                grads = torch.autograd.grad(
                    val, ws + [vs[i] for i in mixed] + [rows, logprior])
            with torch.no_grad():
                for acc, g in zip(g_w, grads[:len(ws)]):
                    acc += g
                for i, g in zip(mixed, grads[len(ws): len(ws) + len(mixed)]):
                    g_v[i] += g
                g_rows, g_lp = grads[-2], grads[-1]
                g_pairs = g_rows[:, self.pair_leaf]               # (b, P, K)
                xp = xb[:, self.pair_var]                          # (b, P)
                t = torch.stack([xp, xp * xp], -1)                 # (b, P, 2)
                s_phi += torch.einsum("bpk,bpt->pkt", operand(g_pairs), operand(t))
                s_den += g_pairs.sum(0)
                g_prior += g_lp
                ll += val.detach()
        with torch.no_grad():
            n_w = [w.detach() * g for w, g in zip(ws, g_w)]
            n_v = {i: vs[i].detach() * g_v[i] for i in mixed}
        return {"n_w": n_w, "n_v": n_v, "s_phi": s_phi, "s_den": s_den,
                "n_class": g_prior, "ll": ll, "rows": x.shape[0]}

    def project(self, phi: torch.Tensor) -> torch.Tensor:
        mu, var = gaussian(phi, self.min_var, self.max_var)
        return torch.stack([mu, mu * mu + var], -1)

    @torch.no_grad()
    def em_step(self, params: Dict, x: torch.Tensor, em: Dict,
                block: int) -> (Dict, float):
        """One stochastic EM step (E-step, M-step, blend with step size
        lambda) from ``params`` on ``x``; returns the new parameters and
        the batch's mean log-likelihood before the step."""
        st = self.statistics(params, x, block)
        alpha, floor, lam = em["laplace_alpha"], em["stat_floor"], em["step_size"]
        lay = self.lay
        new_w = []
        for n in st["n_w"]:
            w = torch.clamp(n + alpha, min=floor)
            new_w.append(w / w.sum((-2, -1), keepdim=True))
        new_v = []
        for i, v in enumerate(params["mixing"]):
            if i not in st["n_v"]:
                new_v.append(v)
                continue
            mask = self.tabs[i]["mix_mask"][:, :, None]
            m = torch.clamp(st["n_v"][i] + alpha * mask, min=floor) * mask
            new_v.append(m / m.sum(1, keepdim=True))
        phi = torch.zeros_like(params["phi"])
        phi[self.pair_var, :, self.pair_rep] = (
            st["s_phi"] / torch.clamp(st["s_den"], min=floor)[..., None])
        # a (variable, replica) in no leaf gets the projection of 0
        covered = torch.zeros(phi.shape[0], phi.shape[2], dtype=torch.bool,
                              device=phi.device)
        covered[self.pair_var, self.pair_rep] = True
        if not bool(covered.all()):
            raise ValueError("a (variable, replica) lies in no leaf")
        phi = self.project(phi)
        prior = st["n_class"] + alpha
        prior = prior / prior.sum()

        def blend(old, new):
            return (1.0 - lam) * old + lam * new

        out = {
            "phi": self.project(blend(params["phi"], phi)),
            "einsum": [blend(o, n) for o, n in zip(params["einsum"], new_w)],
            "mixing": [blend(o, n) for o, n in zip(params["mixing"], new_v)],
            "class_prior": blend(params["class_prior"], prior),
        }
        return out, float(st["ll"] / st["rows"])

    # ---------------------------------------------------------- queries
    @torch.no_grad()
    def query(self, params: Dict, kind: str, x, evidence, query, seeds,
              block: int, margin: bool = False):
        """One of the six query kinds over rows, in blocks: (B,) LLs for
        joint_ll, marginal_ll and conditional_ll, (B, D) rows for sample,
        conditional_sample and mpe.  With ``margin`` a drawing kind also
        gives each row's narrowest margin (see ``draw``)."""
        outs, margins = [], []
        for lo in range(0, x.shape[0], block):
            sl = slice(lo, lo + block)
            out = self._query(params, kind, x[sl], evidence[sl], query[sl],
                              seeds[sl], margin)
            if margin and kind not in ("joint_ll", "marginal_ll", "conditional_ll"):
                out, m = out
                margins.append(m)
            outs.append(out)
        if margins:
            return torch.cat(outs), torch.cat(margins)
        return torch.cat(outs)

    def _query(self, params, kind, x, ev, qm, seeds, margin=False):
        if kind == "joint_ll":
            return self.log_likelihood(params, x)
        if kind == "marginal_ll":
            return self.log_likelihood(params, x, ev)
        if kind == "conditional_ll":
            return (self.log_likelihood(params, x, qm | ev)
                    - self.log_likelihood(params, x, ev))
        if kind == "sample":
            return self.draw(params, torch.zeros_like(x), torch.zeros_like(ev),
                             seeds, True, margin)
        if kind == "conditional_sample":
            return self.draw(params, x, ev, seeds, True, margin)
        if kind == "mpe":
            return self.draw(params, x, ev, seeds, False, margin)
        raise ValueError(f"unknown query kind {kind!r}")

    def draw(self, params, x, ev, seeds, noisy: bool, margin: bool = False):
        """The induced-tree top-down pass: from the root down, each active
        sum node picks a child (mixing) or a pair (i, j) of child nodes
        (einsum cell) by Gumbel-max over weight x children's likelihoods,
        or by argmax without noise; each active leaf then draws its
        variables (the mean without noise).  Evidence is kept.

        With ``margin`` it also gives each row's narrowest choice: over the
        active sum nodes of the row's tree, the least gap between the best
        and the second-best score, over max(1, |best score|).  A draw can
        part from this one on the same noise without fault only where that
        gap lies within float32 rounding of the scores."""
        lay, k, dev = self.lay, self.k, x.device
        b = x.shape[0]
        root, outs, buffer = self.upward(params, self.leaf_rows(params["phi"], x, ev))
        noise = None
        if noisy:
            noise = torch.clamp(uniforms(seeds, lay.noise_size), U_MIN, 1 - U_MIN)
        narrow = torch.full((b,), math.inf, dtype=torch.float64, device=dev)

        def choose(logits, key, active=None):
            nonlocal narrow
            if noise is not None:
                off, shape = lay.noise[key]
                u = noise[:, off: off + int(np.prod(shape))].reshape(logits.shape)
                logits = logits - torch.log(-torch.log(u))
            if margin and logits.shape[-1] > 1:
                top = logits.topk(2, dim=-1).values.double()
                gap = (top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp(min=1.0)
                if active is not None:
                    gap = torch.where(active, gap, torch.full_like(gap, math.inf))
                narrow = torch.minimum(narrow, gap.reshape(b, -1).amin(-1))
            return logits.argmax(-1)

        dummy = lay.total_rows
        comp = torch.full((b, dummy + 1), -1, dtype=torch.int64, device=dev)
        rb = torch.arange(b, device=dev)[:, None]
        comp[:, lay.root_row] = choose(
            root + torch.log(params["class_prior"])[None], "root")
        for i in reversed(range(len(lay.pairs))):
            p, tab = lay.pairs[i], self.tabs[i]
            s = outs[i]
            if p.mix_child is not None:
                rows = torch.arange(p.mix_first_row, p.mix_first_row + p.mixed,
                                    device=dev)
                kk = comp[:, rows]
                active = kk >= 0
                kk = kk.clamp(min=0)
                logv = torch.log(torch.clamp(params["mixing"][i], min=1e-38))
                m, c = tab["mix_child"].shape
                lv = logv[torch.arange(m, device=dev)[None, :, None],
                          torch.arange(c, device=dev)[None, None, :], kk[:, :, None]]
                cll = s[rb[:, :, None], tab["mix_child"][None], kk[:, :, None]]
                logits = torch.where(tab["mix_mask"][None] > 0, lv + cll,
                                     torch.full_like(lv, NEG))
                pick = choose(logits, ("mix", i), active)              # (b, M)
                child = p.first_row + tab["mix_child"][torch.arange(m, device=dev)[None], pick]
                comp[rb, torch.where(active, child, torch.full_like(child, dummy))] = kk
            rows = torch.arange(p.first_row, p.first_row + p.cells, device=dev)
            kk = comp[:, rows]
            active = kk >= 0
            kk = kk.clamp(min=0)
            w = params["einsum"][i][torch.arange(p.cells, device=dev)[None], kk]
            left, right = buffer[:, tab["left"]], buffer[:, tab["right"]]
            logits = (torch.log(torch.clamp(w, min=1e-38)) + left[:, :, :, None]
                      + right[:, :, None, :]).reshape(b, p.cells, k * k)
            flat = choose(logits, ("einsum", i), active)
            for tab_rows, pick in ((tab["left"], flat // k), (tab["right"], flat % k)):
                dest = torch.where(active, tab_rows[None].expand(b, -1),
                                   torch.full_like(pick, dummy))
                comp[rb, dest] = pick
        kk = comp[:, self.pair_leaf]                                   # (b, P)
        active = kk >= 0
        kk = kk.clamp(min=0)
        phi = params["phi"][self.pair_var[None], kk, self.pair_rep[None]]  # (b, P, 2)
        mu, var = gaussian(phi, self.min_var, self.max_var)
        if noise is None:
            val = mu
        else:
            off, _ = lay.noise["leaves"]
            u = noise[:, off: off + len(lay.pair_var)]
            val = mu + torch.sqrt(var) * torch.special.ndtri(u)
        cols = torch.where(active, self.pair_var[None].expand(b, -1),
                           torch.full_like(kk, lay.num_vars))
        out = torch.zeros((b, lay.num_vars + 1), dtype=x.dtype, device=dev)
        out[rb, cols] = val.to(x.dtype)
        out = torch.where(ev, x, out[:, :lay.num_vars])
        return (out, narrow) if margin else out


def leaves_of(params: Dict) -> List[torch.Tensor]:
    """The parameter leaves in a fixed order: phi, each einsum, each
    mixing, the class prior."""
    return ([params["phi"]] + list(params["einsum"]) + list(params["mixing"])
            + [params["class_prior"]])
