"""Device milliseconds a serving replay takes, between the program's
timing events around it (serve.replay.device_seconds over
serve.replay.count).  Process totals: the window and its drain."""

from harness import counters


def read(run):
    if run["kind"] != "serve":
        return None
    n = counters.value("serve.replay.count")
    spent = counters.value("serve.replay.device_seconds")
    if not n or spent is None:
        return None
    return 1e3 * spent / n
