"""Graph nodes a replay of a mixture's training step spends on the mixture
itself, over its components: the spans mixture.top (the class prior's
logsumexp of each component and the top-level log_mix_exp),
mixture.top.bwd (their backward) and mixture.weights (the weights'
statistics, renormalisation, blend and copy), from the program's capture
counters (compile.graph.nodes, weighted by compile.graph.replays, as
launches_per_step reads them).  None where the program has no such span."""

from harness import counters

MIXTURE_SPANS = ("mixture.top", "mixture.top.bwd", "mixture.weights")


def read(run):
    if run["kind"] != "train":
        return None
    return counters.graph_launches(lambda p: not p.startswith("query."),
                                   MIXTURE_SPANS)
