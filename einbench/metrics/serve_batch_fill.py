"""Requests over bucket rows replayed in the window, from the engine's
stats counters (requests, padded_rows), in percent."""


def read(run):
    if run["kind"] != "serve":
        return None
    rows = run["requests"] + run["padded_rows"]
    return 100.0 * run["requests"] / rows if rows else None
