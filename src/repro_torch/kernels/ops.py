"""Public wrappers for the paged attention kernels.

One wrapper per kernel.  The device of the inputs picks the path, and
nothing else does:

* CUDA tensors launch the hand-written kernel (``kernels.build`` compiles
  it on first use) or the wrapper raises — there is no fallback;
* CPU tensors run the plain PyTorch version (``kernels.ref``).

``LAUNCHES`` counts kernel launches per wrapper (the CPU path does not
count), so a run can show that its main path went through the kernels;
``reset_launches()`` zeroes it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"paged_attention": 0,
                            "paged_prefill_attention": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 32          # query heads per kv head: one CTA's softmax rows


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, q, k_pages, v_pages, block_tables, lens, k_new, v_new,
           *, group_rows: bool):
    dev = q.device
    for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                      ("block_tables", block_tables), ("lens", lens),
                      ("k_new", k_new), ("v_new", v_new)):
        if t.device != dev:
            raise ValueError(f"{name}: {t_name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} unsupported "
                        f"(float32 or bfloat16)")
    for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                      ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t_name} is {t.dtype}, q is {q.dtype}")
    for t_name, t in (("block_tables", block_tables), ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {t_name} must be int32, got {t.dtype}")
    P, bt, K, hd = k_pages.shape
    H = q.shape[-2]
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: v_pages {tuple(v_pages.shape)} != "
                         f"k_pages {tuple(k_pages.shape)}")
    if q.shape[-1] != hd or hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} (pages {hd}) must "
                         f"be a multiple of 8 up to {MAX_HEAD_DIM}")
    if H % K:
        raise ValueError(f"{name}: {H} query heads not a multiple of {K} "
                         f"kv heads")
    if group_rows and H // K > MAX_GROUP:
        raise ValueError(f"{name}: {H // K} query heads per kv head > "
                         f"{MAX_GROUP}")
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lens.shape != (B,):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                         f"/ lens {tuple(lens.shape)} do not match B={B}")
    return P, bt, K, hd, H, B


def _stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    k_new, v_new, *, window: int = 0):
    """Single-token decode over a block-table-indexed KV pool (GQA).

    q: (B, H, hd); k_pages/v_pages: (P, bt, K, hd); block_tables: (B, nb)
    int32; seq_lens: (B,) int32; k_new/v_new: (B, K, hd).  See
    ``kernels.ref.paged_attention`` for the contract.  Returns (B, H, hd).
    """
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens, k_new, v_new, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    P, bt, K, hd, H, B = _check("paged_attention", q, k_pages, v_pages,
                                block_tables, seq_lens, k_new, v_new,
                                group_rows=True)
    if k_new.shape != (B, K, hd) or v_new.shape != (B, K, hd):
        raise ValueError(f"paged_attention: k_new/v_new must be "
                         f"{(B, K, hd)}, got {tuple(k_new.shape)}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = build.load()
    rc = lib.paged_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        B, H, K, hd, bt, block_tables.shape[1], int(window),
        1.0 / math.sqrt(hd), _stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            k_new, v_new, *, window: int = 0):
    """Chunked-prefill attention over a partial paged context (GQA).

    q: (B, C, H, hd); k_pages/v_pages: (P, bt, K, hd); block_tables:
    (B, nb) int32; ctx_lens: (B,) int32; k_new/v_new: (B, C, K, hd).  See
    ``kernels.ref.paged_prefill_attention`` for the contract.
    Returns (B, C, H, hd).
    """
    if q.device.type == "cpu":
        return ref.paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                           ctx_lens, k_new, v_new,
                                           window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for "
                         f"{q.device}")
    P, bt, K, hd, H, B = _check("paged_prefill_attention", q, k_pages,
                                v_pages, block_tables, ctx_lens, k_new,
                                v_new, group_rows=False)
    C = q.shape[1]
    if k_new.shape != (B, C, K, hd) or v_new.shape != (B, C, K, hd):
        raise ValueError(f"paged_prefill_attention: k_new/v_new must be "
                         f"{(B, C, K, hd)}, got {tuple(k_new.shape)}")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    lib = build.load()
    rc = lib.paged_prefill_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), ctx_lens.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        B, C, H, K, hd, bt, block_tables.shape[1], int(window),
        1.0 / math.sqrt(hd), _stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"paged_prefill_attention kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["paged_prefill_attention"] += 1
    return out
