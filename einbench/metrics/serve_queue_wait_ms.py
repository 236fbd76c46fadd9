"""Mean milliseconds a request waited in the engine's queue, from submit
to the pop of its batch: the exact mean (sum over count) of the program's
serve.queue_wait.seconds histograms, every kind.  Process totals: the
window and its drain."""

from harness import counters


def read(run):
    if run["kind"] != "serve":
        return None
    hists = [h for _, h in counters.find("serve.queue_wait.seconds")]
    n = sum(h.count for h in hists)
    return 1e3 * sum(h.total for h in hists) / n if n else None
