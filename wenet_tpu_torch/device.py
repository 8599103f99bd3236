"""Device resolution and float32 precision policy.

The reference forces full-precision float32 on the tone DFT and the
integrate-and-dump matmuls (`wenet_tpu/ops/fsk.py`, `Precision.HIGHEST`);
TF32 would degrade the integrators near the decode cliff.  Importing this
module pins the same policy for torch.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(name: str | torch.device | None = "cuda") -> torch.device:
    """Name -> torch.device.  Asking for CUDA without a card raises: the
    port never falls back to the CPU behind the caller's back."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
