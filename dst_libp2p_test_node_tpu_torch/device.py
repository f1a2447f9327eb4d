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


def device_label(device) -> str:
    """What an artifact records as its device: "cpu", or the card's name and
    power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (a card runs slower under a lower
    limit)."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]
