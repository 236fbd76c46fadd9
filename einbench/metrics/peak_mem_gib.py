"""torch.cuda.max_memory_allocated over set-up and window, graph pools
included, in GiB."""


def read(run):
    return run["peak_mem_bytes"] / 2 ** 30 if run["peak_mem_bytes"] else None
