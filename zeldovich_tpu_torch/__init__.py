"""zeldovich_tpu_torch: the PyTorch + CUDA port of zeldovich_tpu.

The in-core, single-device paths on an NVIDIA Hopper card: the
half-spectrum main path and the full-grid pair path (f_NL, ZD_Version=1,
CornerModes with k_cutoff != 1), with the TPU package's Pallas kernels
rewritten as hand-written CUDA (kernels B1, B2, B4, B6/B7 and B8, see
ROADMAP.md).  Imports torch, never jax; the JAX package's jax-free host
modules (parameters, power spectrum, host pcg64, the v1 MT19937 stream,
output writer) are reused by import.
"""
