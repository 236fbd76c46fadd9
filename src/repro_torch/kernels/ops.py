"""The public kernel entry points of the port, with device dispatch
(``repro_torch.kernels.dispatch``): CUDA tensors launch the hand-written
kernels, CPU tensors run their plain PyTorch versions.

  * ``log_einsum_exp(w, ln_left, ln_right)`` -- one layer pair: forward
    ``csrc/log_einsum_exp_fwd.cu`` (K1), backward
    ``csrc/log_einsum_exp_bwd.cu`` (K2).
  * ``grouped_log_einsum_exp(ws, x)`` -- a canonical run of depths in one
    launch: forward ``csrc/grouped_fwd.cu`` (K3), backward
    ``csrc/grouped_bwd.cu`` (K4).
  * ``gather_grouped_log_einsum_exp(tables, ws, vs, x)`` -- a gather run of
    depths (Poon-Domingos, mixing included) in one launch: forward
    ``csrc/gather_fwd.cu`` (K5), backward ``csrc/gather_bwd.cu`` (K6).
  * ``leaf_rows(theta, a, t, log_h, marg_mask, gather)`` -- the leaf layer,
    EF log-densities and scope sums, in one launch (``csrc/leaf_rows.cu``);
    no backward.
  * ``leaf_stats(g_leaf, t, gather, num_replica)`` -- the E-step's leaf
    statistics, s_phi and s_den from the leaf rows' posteriors and the
    batch's sufficient statistics, in one launch (``csrc/leaf_stats.cu``;
    a second, the slices' sum, where the batch is split); no autograd.

The three einsum ops work under autograd: each is a
``torch.autograd.Function`` that saves the unpadded primals and calls its
backward op (``log_einsum_exp_bwd``, ``grouped_log_einsum_exp_bwd``,
``gather_grouped_log_einsum_exp_bwd``), which recomputes the forward's
frame from them.  Without autograd (serving, under
``torch.inference_mode()``) the forward op runs directly.  ``leaf_rows``
under autograd gives rows whose backward raises: the E-step differentiates
from leaf rows built under ``no_grad``, so nothing takes a gradient into
the leaf parameters through them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import KernelOp
from repro_torch.kernels.grouped import (
    gather_grouped_log_einsum_exp_bwd_cuda,
    gather_grouped_log_einsum_exp_bwd_plain,
    gather_grouped_log_einsum_exp_cuda,
    gather_grouped_log_einsum_exp_plain,
    grouped_log_einsum_exp_bwd_cuda,
    grouped_log_einsum_exp_bwd_plain,
    grouped_log_einsum_exp_cuda,
    grouped_log_einsum_exp_plain,
)
from repro_torch.kernels.log_einsum_exp import (
    log_einsum_exp_bwd_cuda,
    log_einsum_exp_bwd_plain,
    log_einsum_exp_cuda,
    log_einsum_exp_plain,
)
from repro_torch.kernels.leaf_rows import leaf_rows_cuda, leaf_rows_plain
from repro_torch.kernels.leaf_stats import leaf_stats_cuda, leaf_stats_plain


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _LogEinsumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, ln_left, ln_right):
        ctx.save_for_backward(w, ln_left, ln_right)
        return log_einsum_exp.launch(w, ln_left, ln_right)

    @staticmethod
    def backward(ctx, g):
        return log_einsum_exp_bwd(*ctx.saved_tensors, g.contiguous())


class _GroupedLogEinsumExp(torch.autograd.Function):
    # the weights come unpacked after x: apply() tracks no tensor in a list
    @staticmethod
    def forward(ctx, x, *ws):
        ctx.save_for_backward(x, *ws)
        return grouped_log_einsum_exp.launch(list(ws), x)

    @staticmethod
    def backward(ctx, g_out):
        x, *ws = ctx.saved_tensors
        gws, gx = grouped_log_einsum_exp_bwd(ws, x, g_out.contiguous())
        return (gx, *gws)


class _GatherGroupedLogEinsumExp(torch.autograd.Function):
    # the tables are a non-tensor argument; ws then vs come unpacked after x
    @staticmethod
    def forward(ctx, tables, n_ws, x, *wvs):
        ctx.tables, ctx.n_ws = tables, n_ws
        ctx.save_for_backward(x, *wvs)
        return gather_grouped_log_einsum_exp.launch(
            tables, list(wvs[:n_ws]), list(wvs[n_ws:]), x)

    @staticmethod
    def backward(ctx, g_out):
        x, *wvs = ctx.saved_tensors
        n = ctx.n_ws
        gws, gvs, gx = gather_grouped_log_einsum_exp_bwd(
            ctx.tables, wvs[:n], wvs[n:], x, g_out.contiguous())
        return (None, None, gx, *gws, *gvs)


class _LeafRows(torch.autograd.Function):
    # the mask and the table are not differentiable; no backward kernel
    @staticmethod
    def forward(ctx, theta, a, t, log_h, marg_mask, gather):
        return leaf_rows.launch(theta, a, t, log_h, marg_mask, gather)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "leaf_rows has no backward: the leaf rows are not differentiable "
            "in the leaf parameters.  The E-step (core.em.em_statistics) "
            "builds them under torch.no_grad() and differentiates from the "
            "rows themselves; build them so, or detach phi")


class LogEinsumExpOp(KernelOp):
    """K1 forward, differentiable through K2."""

    def __call__(self, w, ln_left, ln_right):
        if _needs_grad((w, ln_left, ln_right)):
            return _LogEinsumExp.apply(w, ln_left, ln_right)
        return self.launch(w, ln_left, ln_right)


class GroupedLogEinsumExpOp(KernelOp):
    """K3 forward, differentiable through K4."""

    def __call__(self, ws, x):
        if _needs_grad([x, *ws]):
            return _GroupedLogEinsumExp.apply(x, *ws)
        return self.launch(ws, x)


class GatherGroupedLogEinsumExpOp(KernelOp):
    """K5 forward, differentiable through K6."""

    def __call__(self, tables, ws, vs, x):
        if _needs_grad([x, *ws, *vs]):
            return _GatherGroupedLogEinsumExp.apply(tables, len(ws), x, *ws,
                                                    *vs)
        return self.launch(tables, ws, vs, x)


class LeafRowsOp(KernelOp):
    """The leaf-rows kernel; under autograd its rows raise on backward."""

    def __call__(self, theta, a, t, log_h, marg_mask, gather):
        if _needs_grad((theta, a, t, log_h)):
            return _LeafRows.apply(theta, a, t, log_h, marg_mask, gather)
        return self.launch(theta, a, t, log_h, marg_mask, gather)


class LeafStatsOp(KernelOp):
    """The leaf-statistics kernel.  It has no backward, so it refuses
    operands that require a gradient rather than return statistics that
    autograd cannot follow."""

    def __call__(self, g_leaf, t, gather, num_replica):
        if _needs_grad((g_leaf, t)):
            raise RuntimeError(
                "leaf_stats has no backward: call it under torch.no_grad() "
                "(core.em.leaf_statistics does), or detach its operands")
        return self.launch(g_leaf, t, gather, num_replica)


log_einsum_exp = LogEinsumExpOp(
    "log_einsum_exp", log_einsum_exp_cuda, log_einsum_exp_plain)
log_einsum_exp_bwd = KernelOp(
    "log_einsum_exp_bwd", log_einsum_exp_bwd_cuda, log_einsum_exp_bwd_plain)
grouped_log_einsum_exp = GroupedLogEinsumExpOp(
    "grouped_log_einsum_exp", grouped_log_einsum_exp_cuda,
    grouped_log_einsum_exp_plain)
grouped_log_einsum_exp_bwd = KernelOp(
    "grouped_log_einsum_exp_bwd", grouped_log_einsum_exp_bwd_cuda,
    grouped_log_einsum_exp_bwd_plain)

gather_grouped_log_einsum_exp = GatherGroupedLogEinsumExpOp(
    "gather_grouped_log_einsum_exp", gather_grouped_log_einsum_exp_cuda,
    gather_grouped_log_einsum_exp_plain)
gather_grouped_log_einsum_exp_bwd = KernelOp(
    "gather_grouped_log_einsum_exp_bwd", gather_grouped_log_einsum_exp_bwd_cuda,
    gather_grouped_log_einsum_exp_bwd_plain)

leaf_rows = LeafRowsOp("leaf_rows", leaf_rows_cuda, leaf_rows_plain)
leaf_stats = LeafStatsOp("leaf_stats", leaf_stats_cuda, leaf_stats_plain)

KERNEL_OPS = (log_einsum_exp, log_einsum_exp_bwd, grouped_log_einsum_exp,
              grouped_log_einsum_exp_bwd, gather_grouped_log_einsum_exp,
              gather_grouped_log_einsum_exp_bwd, leaf_rows, leaf_stats)


def reset_counts() -> None:
    for op in KERNEL_OPS:
        op.reset_counts()
