"""wenet_tpu_torch — the PyTorch/CUDA port of wenet_tpu.

The JAX package (`wenet_tpu`) stays the reference; this package mirrors its
module names so every counterpart is easy to find:

  core/      wire formats and LDPC code tables (numpy, host side)
  ops/       FSK demod, LDPC decode, CRC, deframing, channel models on
             torch tensors
  kernels/   hand-written CUDA kernels for Hopper (sm_90a), built at first
             use with nvcc and bound with ctypes
  csrc/      the CUDA sources of those kernels
  parallel/  Monte-Carlo sweeps and the coarse acquisition search
  rx/        the streaming Receiver
  cli/       `python -m wenet_tpu_torch rx ...`
  utils/     DFT-as-matmul, polynomial atan2

It imports `torch` and never `jax`, and the receive path imports nothing of
the JAX package.  Only the CLI's payload sink is shared with it: the
jax-free application layer `wenet_tpu.rx.router` (SSDV images, telemetry
logs, UDP side-channels) and the stats bus `wenet_tpu.rx.stats`.
"""

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
