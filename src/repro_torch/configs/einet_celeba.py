"""The paper's §4.2 CelebA architecture: one mixture COMPONENT of the
mixture-of-EiNets model -- a PD-structure EiNet over center-cropped CelebA
downsampled to 32x32 RGB (Delta=8, vertical splits, K=40, factorized
Gaussians over channels, the image-leaf variance clamp).

The full CelebA model is ``--mixture C`` of these, trained over k-means
image clusters (``repro.mixture``); each component flows through the same
launcher / serving machinery as any single EiNet.
"""
from repro_torch.configs.base import EinetConfig

CONFIG = EinetConfig(
    name="einet-pd-celeba",
    structure="pd",
    height=32,
    width=32,
    num_channels=3,
    delta=8,
    pd_axes=("w",),
    num_sums=40,
    exponential_family="normal",
    min_var=1e-6,
    max_var=1e-2,
    batch_size=512,
)
