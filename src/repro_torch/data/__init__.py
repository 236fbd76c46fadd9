"""Data for the port's launch CLIs: numpy-only copies of the reference's
generators (``repro/data``), so the port never imports the JAX package."""

from repro_torch.data.synthetic import gaussian_mixture_images

__all__ = ["gaussian_mixture_images"]
