"""Device selection for the port's entry points.

Everything runs on CUDA unless the caller asks for another device, as the
CPU tests do with device="cpu". A request for CUDA on a machine without a
card raises; nothing drops to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev
