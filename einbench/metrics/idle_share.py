"""1 - the union of device activity over the traced part's length, in
percent (torch.profiler, between the fences).  Read as idle_share.train
and idle_share.serve."""


def read(run):
    tr = run.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
