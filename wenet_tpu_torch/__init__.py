"""wenet_tpu_torch — the PyTorch/CUDA port of wenet_tpu.

The JAX package (`wenet_tpu`) stays the reference; this package mirrors its
module names so every counterpart is easy to find:

  core/      wire formats, packet codecs and LDPC code tables (numpy,
             host side)
  ops/       FSK demod, LDPC decode, CRC, deframing, channel models on
             torch tensors
  kernels/   hand-written CUDA kernels for Hopper (sm_90a), built at first
             use with nvcc and bound with ctypes
  csrc/      the CUDA sources of those kernels
  parallel/  Monte-Carlo sweeps and the coarse acquisition search
  rx/        the streaming Receiver, the payload router and stats bus,
             the ground-station apps (web, console, GUI models, uploader)
  tx/        the transmit side and the flight side (packet engine,
             radios, GPS, UBX, camera)
  ssdv/      the native SSDV codec (JPEG packetiser)
  examples/  link emulation, a router feeder, a secondary-payload listener
  cli/       `python -m wenet_tpu_torch {rx,tx,flight,ber,bench,ssdv}`
  utils/     DFT-as-matmul, polynomial atan2

It imports `torch` and never `jax`, and no module of it imports the JAX
package: the CLI's payload sink (`rx/router`, `rx/stats`, `core/packets`,
`ssdv/`) is the port's own copy of the JAX package's.
"""

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
