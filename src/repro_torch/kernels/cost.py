"""The work of one kernel launch, from its shapes: bytes it must move and
floating-point operations it must do.

:func:`launch_cost` is the one count of a K1-K6 or leaf-rows launch that
the step cost counter (``repro_torch.launch.cost``) and ``chip_smoke.py``'s
bounds read.  It counts what a launch cannot avoid, whatever kernel
implements it:

  * bytes: each input read once and each output written once, float32
    (the weights included; a backward's weight gradients as one write the
    size of the weights, however many partials the kernel sums);
  * flops: the contraction, 2 K_out K^2 a cell and row for a forward pair;
    for a backward pair the three contractions (the forward's ``s``, the
    input gradients' ``c = ginv W`` and ``dW``, 2 K^2 K_out each) and the
    row and column sums of ``c`` (4 K^2).

A gather run's mixing and the max-shift's exponentials and logarithms are
not counted: they are O(K) a cell and row against the contraction's
O(K^2 K_out).  The leaf rows count the EF contraction T(x)^T theta over
every (row, variable, component, replica), 2 |T| flops each, as the
reference's leaf dot counts; their adds of log h and A and the scope sums
are not counted.  The leaf statistics count their contraction, 2 |T|
flops for each (row, variable, replica, component) (the pairs of a
model whose leaves cover every (variable, replica) row once), and read
g_leaf and t and write s_phi and s_den; s_den's sums are not counted.
The arguments are a launch's own (tensors, or anything
with ``shape`` and ``numel()``, such as meta tensors):

  ``log_einsum_exp``                     (w, ln_left, ln_right)
  ``log_einsum_exp_bwd``                 (w, ln_left, ln_right, g)
  ``grouped_log_einsum_exp``             (ws, x)
  ``grouped_log_einsum_exp_bwd``         (ws, x, g_out)
  ``gather_grouped_log_einsum_exp``      (tables, ws, vs, x)
  ``gather_grouped_log_einsum_exp_bwd``  (tables, ws, vs, x, g_out)
  ``leaf_rows``                          (theta, a, t, log_h, marg_mask,
                                          gather)
  ``leaf_stats``                         (g_leaf, t, gather, num_replica)
"""

from __future__ import annotations

from typing import Tuple

F32 = 4  # bytes of every operand


def _numel(ts) -> int:
    return sum(int(t.numel()) for t in ts)


def launch_cost(op_name: str, *args) -> Tuple[int, int]:
    """(bytes, flops) of one launch of the kernel op ``op_name`` (a
    ``kernels.ops`` ``KernelOp`` name) on ``args``."""
    if op_name in ("log_einsum_exp", "log_einsum_exp_bwd"):
        w, ln_left = args[0], args[1]
        cells, k_out, k = (int(s) for s in w.shape[:3])
        b = int(ln_left.shape[0])
        if op_name == "log_einsum_exp":
            # ln_l, ln_r and W read, the output written
            return (F32 * (2 * b * cells * k + cells * k_out * k * k
                           + b * cells * k_out),
                    2 * b * cells * k_out * k * k)
        # ln_l, ln_r and g read, gl and gr written, W read and gW written
        return (F32 * (4 * b * cells * k + b * cells * k_out
                       + 2 * cells * k_out * k * k),
                b * cells * (6 * k * k * k_out + 4 * k * k))
    if op_name == "grouped_log_einsum_exp":
        ws, x = args[0], args[1]
        b = int(x.shape[0])
        out = b * int(ws[-1].shape[0]) * int(ws[-1].shape[1])
        flops = sum(2 * b * int(w.shape[0]) * int(w.shape[1])
                    * int(w.shape[2]) ** 2 for w in ws)
        return F32 * (int(x.numel()) + _numel(ws) + out), flops
    if op_name == "grouped_log_einsum_exp_bwd":
        ws, x, g_out = args[0], args[1], args[2]
        b = int(x.shape[0])
        flops = sum(b * int(w.shape[0]) * (6 * int(w.shape[2]) ** 2
                                            * int(w.shape[1])
                                            + 4 * int(w.shape[2]) ** 2)
                    for w in ws)
        return F32 * (2 * int(x.numel()) + int(g_out.numel())
                      + 2 * _numel(ws)), flops
    if op_name == "gather_grouped_log_einsum_exp":
        tables, ws, vs, x = args[:4]
        b, k = int(x.shape[0]), int(tables.k)
        flops = sum(2 * b * len(left) * int(w.shape[1]) * k * k
                    for left, w in zip(tables.left, ws))
        return F32 * (int(x.numel()) + _numel(ws) + _numel(vs)
                      + b * int(tables.num_new_rows) * k), flops
    if op_name == "gather_grouped_log_einsum_exp_bwd":
        tables, ws, vs, x, g_out = args[:5]
        b, k = int(x.shape[0]), int(tables.k)
        flops = sum(b * len(left) * (6 * k * k * int(w.shape[1]) + 4 * k * k)
                    for left, w in zip(tables.left, ws))
        return F32 * (2 * int(x.numel()) + int(g_out.numel())
                      + 2 * (_numel(ws) + _numel(vs))), flops
    if op_name == "leaf_rows":
        theta, a, t, log_h, marg_mask, gather = args[:6]
        d, k, r, n_t = (int(s) for s in theta.shape)
        b = int(t.shape[0])
        # theta, A, t and log h read, the rows written; the mask a byte
        mask = 0 if marg_mask is None else int(marg_mask.numel())
        return (F32 * (int(theta.numel()) + int(a.numel()) + int(t.numel())
                       + int(log_h.numel()) + b * int(gather.shape[0]) * k)
                + mask, 2 * b * d * k * r * n_t)
    if op_name == "leaf_stats":
        g_leaf, t, _, r = args[:4]
        b, _, k = (int(s) for s in g_leaf.shape)
        d, n_t = int(t.shape[1]), int(t.shape[2])
        return (F32 * (int(g_leaf.numel()) + int(t.numel())
                       + d * k * int(r) * (n_t + 1)),
                2 * b * d * int(r) * k * n_t)
    raise KeyError(f"no cost model for kernel op {op_name!r}")
