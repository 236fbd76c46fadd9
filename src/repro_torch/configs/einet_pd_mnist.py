"""PD-structure EiNet for 28x28 grayscale images (the paper's MNIST-family
configuration of §4.2: Delta=7 vertical cuts, K=32, Gaussian leaves with the
image variance clamp).  The 28x28 counterpart of ``einet_pd`` (32x32 SVHN),
giving ``--arch``/``--dataset mnist`` a registered image-grid config path."""
from repro_torch.configs.base import EinetConfig

CONFIG = EinetConfig(
    name="einet-pd-mnist",
    structure="pd",
    height=28,
    width=28,
    num_channels=1,
    delta=7,
    pd_axes=("w",),
    num_sums=32,
    exponential_family="normal",
    min_var=1e-6,
    max_var=1e-2,
    batch_size=256,
)
