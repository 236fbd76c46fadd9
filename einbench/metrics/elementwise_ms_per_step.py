"""Device milliseconds per EM step in PyTorch's elementwise kernels (the
kernels layer "elementwise" names), over the traced steps."""

from harness.trace import matching
from harness.spec import Spec


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None or not run.get("trace_steps"):
        return None
    rule = Spec().kernel_layers()["elementwise"]
    return 1e3 * matching(tr["kernels"], rule) / run["trace_steps"]
