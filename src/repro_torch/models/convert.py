"""Weight bridge: a params tree of numpy arrays -> the port's params.

The tree has JAX's leaf names and layouts (stacked ``(L, ...)`` block
params, and for the moe family the ``moe`` leaves ``router (D, E)``,
``wg``/``wu (E, D, F)`` and ``wd (E, F, D)``), so the bridge is a per-leaf
copy.  bf16 leaves arrive either
widened to float32 or as a ``uint16`` view of their bits (numpy has no
bf16); the caller maps JAX arrays to numpy — the port never sees one.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(arr, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Any, device, dtype: torch.dtype) -> Any:
    """Nested dict of numpy arrays -> same-shaped dict of tensors on
    ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _leaf(tree, device, dtype)
