"""Device selection and the exactness switches the limb layer needs.

Entry points of the port run on CUDA unless the caller asks for the CPU
(`device="cpu"`, as the CPU tests do).  With no card and no such
request they raise: the port never quietly runs its plain path where a
kernel was expected.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """None -> the current CUDA device (raises when there is none);
    anything else -> torch.device(device), raising for a CUDA device
    when CUDA is unavailable."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is "
                           "not available")
    return dev


def upload(arr, dev: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on `dev`.  To a CUDA device the copy
    goes through pinned memory without blocking the host, so it queues
    behind the work already on the stream instead of waiting for it (a
    copy from pageable memory synchronises)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def require_exact_fp32() -> None:
    """Pin full-precision float32 matmuls and assert it.

    The f32 limb layer (ops/limbs9.py) relies on every product and
    column sum being an exact integer below 2^24.  TF32 keeps ~10
    mantissa bits and would turn verdicts silently wrong, with no
    error, so every CUDA entry point sets and checks this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls still enabled")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")
