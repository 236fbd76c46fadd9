"""Data for the port, numpy only: synthetic generators, the image datasets
(MNIST, SVHN, CelebA, with the procedural offline stand-in) and the sharded
host loader -- copies of the reference's ``repro/data``, so the port never
imports the JAX package."""

from repro_torch.data import datasets, pipeline, synthetic
from repro_torch.data.datasets import load_image_dataset, to_domain
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.data.synthetic import gaussian_mixture_images

__all__ = [
    "datasets",
    "pipeline",
    "synthetic",
    "ShardedLoader",
    "gaussian_mixture_images",
    "load_image_dataset",
    "to_domain",
]
