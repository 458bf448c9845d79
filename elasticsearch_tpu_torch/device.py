"""Device resolution for the port.

Every entry point runs on the card unless its caller asks for the CPU: a
plane built without ``device=`` lands on ``cuda`` and raises when the
process has no CUDA device, rather than serving silently from the host.
"""

from __future__ import annotations

import functools
import shutil
import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}]")
    return dev


@functools.lru_cache(maxsize=1)
def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card),
    for labelling every printed time."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
