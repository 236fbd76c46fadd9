"""The benchmark's count of an EM step's flops (counts/einsum.py) over the
step's wall time in the window and the chip's float32 peak, in percent."""


def read(run):
    if run["kind"] != "train" or run["peak"] is None:
        return None
    per_step = run["window_s"] / run["steps"]
    return 100.0 * run["step_flops"] / (per_step * run["peak"]["fp32_flops_per_s"])
