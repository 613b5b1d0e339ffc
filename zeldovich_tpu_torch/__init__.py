"""zeldovich_tpu_torch: the PyTorch + CUDA port of zeldovich_tpu.

The in-core, single-device paths on an NVIDIA Hopper card: the
half-spectrum main path and the full-grid pair path (f_NL, ZD_Version=1,
CornerModes with k_cutoff != 1), with the TPU package's Pallas kernels
rewritten as hand-written CUDA (kernels B1-B8, see
ROADMAP.md).  Imports torch, never jax, and nothing of zeldovich_tpu: the
host modules it shares with the JAX package are copies kept here under the
same relative names (``utils/parseheader``, ``utils/params``,
``utils/timers``, ``utils/power``, ``utils/output`` with ``native/``,
``ops/pcg``, ``ops/mt19937``, ``ops/v1``, and the writer and checkpoint
helpers in ``utils/streamio`` and ``utils/checkpoint``), byte for byte in
their formats; tests/test_torch_host.py holds each against its original.
"""
