"""PyTorch and CUDA port of the platform's LM workload, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package imports
nothing of it.  It mirrors the reference's layout: ``configs`` (its own
copy), ``kernels`` (CUDA kernels written for sm_90a, with plain PyTorch
versions), ``models``, ``serve`` and ``convert`` (weights through numpy).
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
