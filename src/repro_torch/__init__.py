"""PyTorch port of the OCC system for an NVIDIA H100 (Hopper, sm_90a).

A second package beside the JAX reference `repro`: it imports torch and
numpy and nothing of `repro` or JAX.  Its entry points run on the card
unless the caller passes `device="cpu"`; its kernels are hand-written CUDA
under `kernels/csrc/`, built with nvcc on first use.
"""
