"""The einsum layers' bound time (counts/einsum.py: the larger of their
flops over the float32 peak and their least bytes over the memory
bandwidth, for the work the traced part ran) over the device time of the
kernels that einbench/kernels/*.json put in the "einsum layers" layer, in
percent.  Read as kernel_roofline.train and kernel_roofline.serve."""

from harness.trace import matching
from harness.spec import Spec


def read(run):
    tr = run.get("trace")
    if tr is None or run.get("trace_bound_s") is None:
        return None
    spent = matching(tr["kernels"], Spec().kernel_layers()["einsum layers"])
    return 100.0 * run["trace_bound_s"] / spent if spent > 0 else None
