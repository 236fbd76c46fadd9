"""The benchmark's own count of the work: floating-point operations and
bytes, from a circuit's layout alone, whatever kernel does the work.

``launch_cost`` is a frozen copy of the port's per-launch rules
(``kernels/cost.py``): bytes are each input read once and each output
written once, float32; a forward pair's flops are its contraction, 2
K_out K^2 a cell and row; a backward pair's its three contractions and the
row and column sums of ``c`` (6 K^2 K_out + 4 K^2).  The rest applies those
rules to a layout's einsum layers:

  * flops: every pair's rule, summed;
  * bytes: the least any implementation must move for the whole run of
    einsum layers, as one fused launch would: the leaf rows, the weights
    and the root read or written once (a backward also writes the leaf
    rows' gradient and the weights' statistics), so a share of the bound
    computed from them never passes 100%;
  * the leaf layer: 5 flops a (row, variable-in-leaf, K) for the Gaussian
    log-density and its sum into the leaf row, and 4 for the E-step's
    sufficient statistics.
"""

from __future__ import annotations

from typing import Dict, Tuple

F32 = 4


def _numel(ts) -> int:
    return sum(int(t.numel()) for t in ts)


def launch_cost(op_name: str, *args) -> Tuple[int, int]:
    """(bytes, flops) of one launch of a log-einsum-exp kernel op."""
    if op_name in ("log_einsum_exp", "log_einsum_exp_bwd"):
        w, ln_left = args[0], args[1]
        cells, k_out, k = (int(s) for s in w.shape[:3])
        b = int(ln_left.shape[0])
        if op_name == "log_einsum_exp":
            return (F32 * (2 * b * cells * k + cells * k_out * k * k
                           + b * cells * k_out),
                    2 * b * cells * k_out * k * k)
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
    raise KeyError(f"no cost rule for kernel op {op_name!r}")


class _Shape:
    """Anything with a shape and a numel, for ``launch_cost``."""

    def __init__(self, *shape):
        self.shape = tuple(int(s) for s in shape)

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _sizes(layout) -> Dict[str, int]:
    sh = layout.shapes()
    return {
        "weights": sum(_Shape(*s).numel() for s in sh["einsum"] + sh["mixing"]),
        "leaf_rows": layout.num_leaves * layout.k,
        "root": sh["class_prior"][0],
        "pair_elems": len(layout.pair_var) * layout.k,
    }


def forward(layout, rows: int) -> Tuple[int, int]:
    """(bytes, flops) of the einsum layers' upward pass over ``rows``."""
    k = layout.k
    flops = sum(launch_cost("log_einsum_exp",
                            _Shape(p.cells, p.k_out, k, k),
                            _Shape(rows, p.cells, k))[1]
                for p in layout.pairs)
    z = _sizes(layout)
    return F32 * (rows * z["leaf_rows"] + z["weights"] + rows * z["root"]), flops


def backward(layout, rows: int) -> Tuple[int, int]:
    """(bytes, flops) of the einsum layers' backward pass (the E-step's
    statistics) over ``rows``."""
    k = layout.k
    flops = sum(launch_cost("log_einsum_exp_bwd",
                            _Shape(p.cells, p.k_out, k, k),
                            _Shape(rows, p.cells, k))[1]
                for p in layout.pairs)
    z = _sizes(layout)
    return (F32 * (2 * rows * z["leaf_rows"] + rows * z["root"]
                   + 2 * z["weights"]), flops)


def leaf_flops(layout, rows: int, statistics: bool) -> int:
    return rows * _sizes(layout)["pair_elems"] * (9 if statistics else 5)


def em_step_flops(layout, rows: int) -> int:
    """One EM step's counted flops: the einsum layers up and back, and the
    leaf layer with its statistics."""
    return (forward(layout, rows)[1] + backward(layout, rows)[1]
            + leaf_flops(layout, rows, True))


# upward passes a query kind runs: the conditional LL runs two
UPWARD_PASSES = {"joint_ll": 1, "marginal_ll": 1, "conditional_ll": 2,
                 "sample": 1, "conditional_sample": 1, "mpe": 1}


def query_flops(layout, kind: str, rows: int) -> int:
    """Counted flops of the upward passes of ``rows`` queries of ``kind``."""
    return UPWARD_PASSES[kind] * (forward(layout, rows)[1]
                                  + leaf_flops(layout, rows, False))


def bound_s(n_bytes: int, flops: int, peak: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of flops over the
    float32 peak and bytes over the memory bandwidth."""
    return max(flops / peak["fp32_flops_per_s"],
               n_bytes / peak["hbm_bytes_per_s"])
