"""Einsum Networks in PyTorch with hand-written CUDA kernels for Hopper.

The port of the JAX package ``repro`` (which stays the reference).  It
imports ``torch`` and ``numpy`` only.  Entry points run on CUDA unless the
caller passes ``device="cpu"``; on the card the log-einsum-exp ops launch
the kernels in ``repro_torch.kernels``, on the CPU their plain versions.
"""
