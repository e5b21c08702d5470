"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  Without a card and without that
request they raise: nothing falls back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# NVIDIA H100 SXM's published HBM3 stream rate (3.35 TB/s): the card the
# port's kernels are built for (sm_90a)
H100_HBM_STREAM_GBs = 3350.0


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_hbm_bytes(device: torch.device) -> Optional[int]:
    """The card's memory capacity, or None on the CPU (callers then keep
    the pool's CPU defaults)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)
