"""Rows through complete EM steps over the whole window (host clock)."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["rows"] * run["steps"] / run["window_s"]
