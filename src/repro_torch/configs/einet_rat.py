"""The paper's efficiency-study architecture: RAT random binary trees
(Fig. 3/6 defaults D=4, R=10, K=10 at 512 variables)."""
from repro_torch.configs.base import EinetConfig

CONFIG = EinetConfig(
    name="einet-rat",
    structure="rat",
    num_vars=512,
    depth=4,
    num_repetitions=10,
    num_sums=10,
    exponential_family="normal",
    batch_size=2048,
)
