"""Scale-out layer (counterpart of wenet_tpu/parallel): rank meshes over
torch.distributed, the check-row-sharded BP decode, and the Monte-Carlo
sweeps whose batches split over a mesh with counters summed over it.
"""
from .mesh import make_mesh  # noqa: F401
