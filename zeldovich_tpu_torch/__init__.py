"""zeldovich_tpu_torch: the PyTorch + CUDA port of zeldovich_tpu.

The in-core, single-device, half-spectrum main path on an NVIDIA Hopper
card, with the TPU package's Pallas kernels rewritten as hand-written CUDA
(kernels B1 and B2, see ROADMAP.md).  Imports torch, never jax; the JAX
package's jax-free host modules (parameters, power spectrum, host pcg64,
output writer) are reused by import.
"""
