"""Graph nodes (kernels, copies and sets) launched a replay of the cell's
step graphs, from the program's capture counters: each program's
compile.graph.nodes times its compile.graph.replays, over the replays.
Read as launches_per_step.train (the training step's graphs: one a step
at one microbatch) and launches_per_step.serve (the query programs,
"query.<kind>.<bucket>", weighted by how often each was replayed).
Process totals: the set-up steps and, in serving, the drain count too."""

from harness import counters


def _serving(program):
    return program.startswith("query.")


def read(run):
    if run["kind"] == "train":
        return counters.graph_launches(lambda p: not _serving(p))
    return counters.graph_launches(_serving)
