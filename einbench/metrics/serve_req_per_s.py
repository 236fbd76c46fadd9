"""Requests answered inside the window, over the window (host clock)."""


def read(run):
    if run["kind"] != "serve":
        return None
    return run["completed"] / run["window_s"]
