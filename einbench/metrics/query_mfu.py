"""Counted upward-pass flops of the requests answered in the window
(counts/einsum.py) over the summed wall time of the engine's steps and the
chip's float32 peak, in percent.  The top-down pass of the sampling kinds
is not counted, so the share cannot pass 100%."""


def read(run):
    if run["kind"] != "serve" or run["peak"] is None or not run["step_s"]:
        return None
    return 100.0 * run["query_flops"] / (
        sum(run["step_s"]) * run["peak"]["fp32_flops_per_s"])
