"""Graph nodes the leaf layer puts in a training step's graph: the
layer.leaf span (the EF log-densities and the leaf rows) and
layer.leaf.bwd (the leaf statistics after the leaf rows' gradient), from
the program's capture counters (compile.graph.nodes, weighted by
compile.graph.replays, as launches_per_step reads them)."""

from harness import counters

LEAF_SPANS = ("layer.leaf", "layer.leaf.bwd")


def read(run):
    if run["kind"] != "train":
        return None
    return counters.graph_launches(lambda p: not p.startswith("query."),
                                   LEAF_SPANS)
