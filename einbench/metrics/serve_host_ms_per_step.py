"""Host milliseconds a ServeEngine step spends not waiting for the
device: the assemble, launch and finish phases of the program's
serve.step.seconds{phase} counters over serve.steps.count (the wait phase,
the host blocked in the result's copy, left out).  Process totals: the
window and its drain."""

from harness import counters

HOST_PHASES = ("assemble", "launch", "finish")


def read(run):
    if run["kind"] != "serve":
        return None
    steps = counters.value("serve.steps.count")
    spent = [counters.value("serve.step.seconds", phase=p)
             for p in HOST_PHASES]
    if not steps or any(s is None for s in spent):
        return None
    return 1e3 * sum(spent) / steps
