"""Wire formats and code tables the port needs, in numpy on the host.

Jax-free copies of the parts of `wenet_tpu.core` that the receive path, its
kernels and the CLI's payload sink (`packets`) use, so the port runs without
the JAX package.  The tests hold each copy equal to its original.
"""
from . import framing, ldpc_tables  # noqa: F401
