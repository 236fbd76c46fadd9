"""Wall milliseconds per ServeEngine.step call in the window, from the
harness's span around each call (host clock)."""


def read(run):
    if run["kind"] != "serve" or not run["step_s"]:
        return None
    return 1e3 * sum(run["step_s"]) / len(run["step_s"])
