"""The paper's own architecture: PD-structure EiNet for 32x32 RGB images
(the SVHN configuration of §4.2: Delta=8, vertical splits, K=40, factorized
Gaussians over channels)."""
from repro_torch.configs.base import EinetConfig

CONFIG = EinetConfig(
    name="einet-pd-svhn",
    structure="pd",
    height=32,
    width=32,
    num_channels=3,
    delta=8,
    pd_axes=("w",),
    num_sums=40,
    exponential_family="normal",
    batch_size=512,
)
