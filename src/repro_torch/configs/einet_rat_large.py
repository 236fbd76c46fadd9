"""Production-scale EiNet: the paper's RAT structure scaled to a 256-chip
pod (the §Perf "most representative of the paper" hillclimb cell).

1024 variables, depth 7, 16 replica, K=64 -> ~0.5B sum-weights; every einsum
layer's node count L is a multiple of 16 so the layer-node axis shards
exactly over the model axis (DESIGN.md §4: EiNet TP = shard L).
"""
from repro_torch.configs.base import EinetConfig

CONFIG = EinetConfig(
    name="einet-rat-large",
    structure="rat",
    num_vars=1024,
    depth=7,
    num_repetitions=16,
    num_sums=64,
    exponential_family="normal",
    batch_size=65536,  # 256 samples/chip: amortizes the step-constant EM-stat reduction
)
