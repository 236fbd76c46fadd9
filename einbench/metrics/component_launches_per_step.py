"""Graph nodes one component costs inside a replay of a mixture's
training step: the step's nodes (launches_per_step.train's) less the
mixture's own (mixture_launches_per_step's), over the run's number of
components (the configuration's num_components).  None where the program
has no mixture spans or the run is no mixture's."""

from harness.spec import Spec


def read(run):
    if run["kind"] != "train" or not run.get("components"):
        return None
    spec = Spec()
    total = spec.reader("launches_per_step.train").read(run)
    mixture = spec.reader("mixture_launches_per_step").read(run)
    if total is None or mixture is None:
        return None
    return (total - mixture) / run["components"]
