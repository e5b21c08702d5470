"""Public wrappers for the hand-written kernels: paged decode and
chunked-prefill attention, the prompt forward's flash attention, RMSNorm,
the grouped expert matmul, the RAO scatter-add and the chunked SSD scan.

One wrapper per kernel.  The device of the inputs picks the path, and
nothing else does:

* CUDA tensors launch the hand-written kernel (``kernels.build`` compiles
  it on first use) or the wrapper raises — there is no fallback;
* CPU tensors run the plain PyTorch version (``kernels.ref``).

``LAUNCHES`` counts kernel launches per wrapper (the CPU path does not
count), so a run can show that its main path went through the kernels;
``LAUNCHES["paged_attention_split"]`` also counts the bf16 launches of
``paged_attention``, which take the split-KV cluster kernel
(``PAGED_DECODE_KERNELS``), ``LAUNCHES["flash_attention_mma"]`` those of
``flash_attention``, which take the tensor-core kernel
(``FLASH_KERNELS``), ``LAUNCHES["paged_prefill_attention_mma"]`` those of
``paged_prefill_attention`` (``PAGED_PREFILL_KERNELS``), and
``LAUNCHES["moe_gmm_wgmma"]`` the launches of ``moe_gmm`` that take the
TMA / wgmma kernel (``moe_gmm_kernel``), and ``LAUNCHES["ssd_scan_mma"]``
the calls of ``ssd_scan`` on the tensor-core kernel (all of them: two
launches each); ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build, ref

LAUNCHES: Dict[str, int] = {"paged_attention": 0,
                            "paged_attention_split": 0,
                            "paged_prefill_attention": 0,
                            "paged_prefill_attention_mma": 0,
                            "moe_gmm": 0, "moe_gmm_wgmma": 0,
                            "rao_scatter_add": 0,
                            "flash_attention": 0, "flash_attention_mma": 0,
                            "rmsnorm": 0, "ssd_scan": 0, "ssd_scan_mma": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 32          # query heads per kv head: one CTA's softmax rows
MAX_SSD_CHUNK = 128     # ssd_scan: one warp's cumsum, 4 steps a lane
SMEM_LIMIT = 232448     # opt-in shared memory of one H100 CTA (227 KB)
# one H100 SXM: 132 SMs, each 228 KB of shared memory (1 KB of it kept
# per resident CTA), 2,048 threads and 65,536 registers
H100_SMS, SM_SMEM, SM_SMEM_RESERVED = 132, 233472, 1024
SM_THREADS, SM_REGS = 2048, 65536
# the tensor-core ssd_scan (csrc/ssd_scan_mma.cu): 4-warp CTAs of at most
# 128 registers a thread, 64 columns of hd each, S staged 64 at a time
SSD_THREADS, SSD_MAX_REGS, SSD_SLAB, SSD_S_TILE = 128, 128, 64, 64
# paged_attention's kernel per dtype: bf16 split-KV over a thread-block
# cluster (f32 softmax weights), f32 one CTA per (slot, kv head)
PAGED_DECODE_KERNELS = {torch.bfloat16: "paged_attention_split_launch",
                        torch.float32: "paged_attention_launch"}
# flash_attention's kernel per dtype: bf16 on the tensor cores (mma.sync),
# f32 on the CUDA cores (plain FMA, no TF32: parity with the plain version)
FLASH_KERNELS = {torch.bfloat16: "flash_attention_mma_launch",
                 torch.float32: "flash_attention_launch"}
# paged_prefill_attention's kernel per dtype, the same split: bf16 on the
# tensor cores with f32 softmax weights (hi + lo bf16 parts), f32 on the
# CUDA cores
PAGED_PREFILL_KERNELS = {torch.bfloat16: "paged_prefill_attention_mma_launch",
                         torch.float32: "paged_prefill_attention_launch"}


def moe_gmm_kernel(xe, w) -> str:
    """The kernel a ``moe_gmm`` call launches on the card: bf16 with D and
    F multiples of 8 and 16-byte aligned bases (TMA's stride and address
    rules) takes the TMA / wgmma kernel; other bf16 shapes the WMMA one
    and f32 the FMA one (no TF32), both in ``csrc/moe_gmm.cu``."""
    if xe.dtype == torch.bfloat16 and xe.shape[2] % 8 == 0 \
            and w.shape[2] % 8 == 0 and xe.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        return "moe_gmm_wgmma_launch"
    return "moe_gmm_launch"


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
    On the card the dtype picks the kernel (``PAGED_DECODE_KERNELS``):
    bf16 the split-KV cluster one, f32 the one-CTA one.  The launch is
    sized from nb and bt alone: seq_lens stays on the device.
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
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_new, v_new)):
        raise ValueError("paged_attention: q, k_pages, v_pages, k_new and "
                         "v_new must be 16-byte aligned (the kernels copy "
                         "rows in 16 bytes)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    kernel = PAGED_DECODE_KERNELS[q.dtype]
    split = kernel == "paged_attention_split_launch"
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), B, H, K, hd, bt,
            block_tables.shape[1], int(window), 1.0 / math.sqrt(hd),
            _stream_ptr(q.device))
    lib = build.load()
    rc = lib.paged_attention_split_launch(*args) if split \
        else lib.paged_attention_launch(_DTYPES[q.dtype], *args)
    if rc:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"({kernel}): CUDA error {rc}")
    LAUNCHES["paged_attention"] += 1
    if split:
        LAUNCHES["paged_attention_split"] += 1
    return out


def paged_attention_split_geometry(H, K, hd, bt, nb) -> Dict[str, int]:
    """The bf16 decode kernel's launch at these shapes: ``split`` CTAs per
    cluster (one cluster per slot and kv head), ``stages`` of its K/V
    ring, ``smem`` bytes of shared memory a CTA, and ``clusters``, how
    many such clusters the current card holds at once
    (cudaOccupancyMaxActiveClusters; 0: the launch cannot run)."""
    geometry = (ctypes.c_int * 4)()
    rc = build.load().paged_attention_split_geometry(H, K, hd, bt, nb,
                                                     geometry)
    if rc:
        raise RuntimeError(f"paged_attention_split_geometry failed: CUDA "
                           f"error {rc}")
    return dict(zip(("split", "stages", "smem", "clusters"), geometry))


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            k_new, v_new, *, window: int = 0):
    """Chunked-prefill attention over a partial paged context (GQA).

    q: (B, C, H, hd); k_pages/v_pages: (P, bt, K, hd); block_tables:
    (B, nb) int32; ctx_lens: (B,) int32; k_new/v_new: (B, C, K, hd).  See
    ``kernels.ref.paged_prefill_attention`` for the contract.
    Returns (B, C, H, hd).  On the card the dtype picks the kernel
    (``PAGED_PREFILL_KERNELS``): bf16 the tensor-core one, f32 the
    CUDA-core one.
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
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_new, v_new)):
        raise ValueError("paged_prefill_attention: q, k_pages, v_pages, "
                         "k_new and v_new must be 16-byte aligned (the "
                         "kernels copy rows in 16 bytes)")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    kernel = PAGED_PREFILL_KERNELS[q.dtype]
    mma = kernel == "paged_prefill_attention_mma_launch"
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), B, C, H, K, hd, bt,
            block_tables.shape[1], int(window), 1.0 / math.sqrt(hd),
            _stream_ptr(q.device))
    lib = build.load()
    rc = lib.paged_prefill_attention_mma_launch(*args) if mma \
        else lib.paged_prefill_attention_launch(_DTYPES[q.dtype], *args)
    if rc:
        raise RuntimeError(f"paged_prefill_attention kernel launch failed "
                           f"({kernel}): CUDA error {rc}")
    LAUNCHES["paged_prefill_attention"] += 1
    if mma:
        LAUNCHES["paged_prefill_attention_mma"] += 1
    return out


def moe_gmm(xe, w):
    """Grouped expert matmul: xe (E, C, D) @ w (E, D, F) -> (E, C, F) per
    expert, summed in f32, in ``xe.dtype`` (float32 or bfloat16; w of the
    same dtype).  Any C, D and F; a zero-size operand gives the empty (or
    all-zero) result without a launch.  On the card ``moe_gmm_kernel``
    picks the kernel.  See ``kernels.ref.moe_gmm``."""
    if xe.device.type == "cpu":
        return ref.moe_gmm(xe, w)
    if xe.device.type != "cuda":
        raise ValueError(f"moe_gmm: no kernel for {xe.device}")
    if w.device != xe.device:
        raise ValueError(f"moe_gmm: w on {w.device}, xe on {xe.device}")
    if xe.dtype not in _DTYPES or w.dtype != xe.dtype:
        raise TypeError(f"moe_gmm: dtypes {xe.dtype} / {w.dtype} "
                        f"unsupported (both float32 or both bfloat16)")
    if xe.dim() != 3 or w.dim() != 3 or w.shape[0] != xe.shape[0] \
            or w.shape[1] != xe.shape[2]:
        raise ValueError(f"moe_gmm: shapes {tuple(xe.shape)} x "
                         f"{tuple(w.shape)} are not (E, C, D) x (E, D, F)")
    if not (xe.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm: xe and w must be contiguous")
    E, C, D = xe.shape
    F = w.shape[2]
    if 0 in (E, C, D, F):
        return xe.new_zeros((E, C, F))
    out = xe.new_empty((E, C, F))
    kernel = moe_gmm_kernel(xe, w)
    wgmma = kernel == "moe_gmm_wgmma_launch"
    args = (xe.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
            _stream_ptr(xe.device))
    lib = build.load()
    rc = lib.moe_gmm_wgmma_launch(*args) if wgmma \
        else lib.moe_gmm_launch(_DTYPES[xe.dtype], *args)
    if rc:
        raise RuntimeError(f"moe_gmm kernel launch failed ({kernel}): CUDA "
                           f"error {rc}")
    LAUNCHES["moe_gmm"] += 1
    if wgmma:
        LAUNCHES["moe_gmm_wgmma"] += 1
    return out


def rao_scatter_add(table, idx, vals):
    """RAO fetch-and-add over rows: ``table`` (N, D) plus ``vals`` (M, D)
    at rows ``idx`` (M,) int32, duplicates summed, in ``table.dtype``
    (float32 or bfloat16; vals of the same dtype).  Use the returned
    table: on the card it is ``table`` itself, updated in place (as the
    TPU kernel aliases its table); on the CPU a new tensor.  Row ids
    outside [0, N) are dropped on the card.  See
    ``kernels.ref.rao_scatter_add``."""
    if table.device.type == "cpu":
        return ref.rao_scatter_add(table, idx, vals)
    if table.device.type != "cuda":
        raise ValueError(f"rao_scatter_add: no kernel for {table.device}")
    for name, t in (("idx", idx), ("vals", vals)):
        if t.device != table.device:
            raise ValueError(f"rao_scatter_add: {name} on {t.device}, "
                             f"table on {table.device}")
    if table.dtype not in _DTYPES or vals.dtype != table.dtype:
        raise TypeError(f"rao_scatter_add: dtypes {table.dtype} / "
                        f"{vals.dtype} unsupported (both float32 or both "
                        f"bfloat16)")
    if idx.dtype != torch.int32:
        raise TypeError(f"rao_scatter_add: idx must be int32, got "
                        f"{idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1 or vals.dim() != 2 \
            or vals.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"rao_scatter_add: shapes table "
                         f"{tuple(table.shape)}, idx {tuple(idx.shape)}, "
                         f"vals {tuple(vals.shape)} are not (N, D), (M,), "
                         f"(M, D)")
    if not (table.is_contiguous() and idx.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("rao_scatter_add: table, idx and vals must be "
                         "contiguous")
    N, D = table.shape
    M = idx.shape[0]
    if 0 in (N, M, D):
        return table
    # a bf16 table accumulates in an f32 scratch and is rounded once
    scratch = torch.empty((N, D), dtype=torch.float32, device=table.device) \
        if table.dtype == torch.bfloat16 else None
    rc = build.load().rao_scatter_add_launch(
        _DTYPES[table.dtype], table.data_ptr(), idx.data_ptr(),
        vals.data_ptr(), None if scratch is None else scratch.data_ptr(),
        N, M, D, _stream_ptr(table.device))
    if rc:
        raise RuntimeError(f"rao_scatter_add kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["rao_scatter_add"] += 1
    return table


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal (optionally sliding-window) GQA attention of a prompt over
    its own keys: q (B, S, H, hd), k/v (B, T, K, hd) with H % K == 0, the
    kv heads read directly (no repeat).  See ``kernels.ref.flash_attention``
    for the contract.  Returns (B, S, H, hd) in q.dtype.  On the card the
    dtype picks the kernel (``FLASH_KERNELS``): bf16 the tensor-core one,
    f32 the CUDA-core one."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in FLASH_KERNELS:
        raise TypeError(f"flash_attention: dtype {q.dtype} unsupported "
                        f"(float32 or bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, S, H, hd), (B, T, K, hd)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernels copy rows in 16 bytes)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} query heads not a multiple "
                         f"of {K} kv heads")
    out = torch.empty_like(q)
    if 0 in (B, S, T, H):
        return out.zero_()
    kernel = FLASH_KERNELS[q.dtype]
    rc = getattr(build.load(), kernel)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, K, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        _stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({kernel}): CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.bfloat16:
        LAUNCHES["flash_attention_mma"] += 1
    return out


def rmsnorm(x, w, eps: float = 1e-5):
    """RMSNorm over the last dim: x (..., D), w (D,) of x's dtype (float32
    or bfloat16) -> x.shape, ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in
    f32 rounded once; the leading dims flatten into rows.  See
    ``kernels.ref.rmsnorm``."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for {x.device}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: dtypes {x.dtype} / {w.dtype} unsupported "
                        f"(both float32 or both bfloat16)")
    if x.dim() < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} does not match the "
                         f"last dim of x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    D = x.shape[-1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = build.load().rmsnorm_launch(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        x.numel() // D, D, float(eps), _stream_ptr(x.device))
    if rc:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    LAUNCHES["rmsnorm"] += 1
    return out


def _ssd_smem_bytes(chunk: int, hd: int, S: int) -> int:
    """Shared memory of one CTA of the CUDA-core ``ssd_scan`` kernel
    (csrc/ssd_scan.cu): the state, C, B^T, x and the masked C.B^T of one
    chunk, dt and its cumsum, in f32 (rows padded by one word against bank
    conflicts).  The wrapper accepts the shapes whose CTA fits, as it did
    when that kernel took its calls."""
    return 4 * (S * hd + chunk * (S + 1) + S * (chunk + 1) + chunk * hd
                + chunk * (chunk + 1) + 2 * chunk)


def ssd_scan_mma_geometry(B, L, h, hd, S, chunk, dtype) -> Dict[str, object]:
    """The launches of the tensor-core ``ssd_scan`` kernel
    (csrc/ssd_scan_mma.cu) at these shapes, x in ``dtype``: ``prep_grid``
    of the C.B^T launch (16-row tiles x chunks, B) and its shared memory
    ``prep_smem``; ``grid`` of the scan, one CTA of ``threads`` per (head,
    slab of 64 columns of hd) and row, its shared memory ``smem`` (x in
    its own dtype, two chunks; a 64-column tile of the old state; five
    f32 vectors of a chunk); the ``scratch_floats`` of C.B^T, C and B^T
    fragments; ``ctas_per_sm``, the scan CTAs one SM holds at most by
    shared memory, threads and the 128 registers its launch bounds allow
    (the card may hold more if ptxas needs fewer); and ``waves`` of such
    full SMs the grid takes on the 132 SMs of an H100 SXM."""
    rt = -(-chunk // 16)
    lp = 16 * rt
    n_chunks = -(-L // chunk)
    s_tiles = -(-S // SSD_S_TILE)
    es = 2 if dtype == torch.bfloat16 else 4
    hdp = 8 * -(-min(hd, SSD_SLAB) // 8)
    ldx = hdp + 16 // es
    smem = 2 * lp * ldx * es + 4 * (hdp * (SSD_S_TILE + 4) + 5 * lp)
    frags = rt * (rt + 1) + rt * 8 * s_tiles + 4 * s_tiles * 2 * rt
    slabs = -(-hd // SSD_SLAB)
    ctas = min(SM_SMEM // (smem + SM_SMEM_RESERVED),
               SM_THREADS // SSD_THREADS,
               SM_REGS // (SSD_THREADS * SSD_MAX_REGS))
    n_ctas = h * slabs * B
    return dict(prep_grid=(rt * n_chunks, B), prep_smem=4 * (
                    16 * (SSD_S_TILE + 4) * (1 + rt) + 16 * (lp + 4)),
                grid=(h * slabs, B), threads=SSD_THREADS, smem=smem,
                scratch_floats=B * n_chunks * frags * 128,
                ctas_per_sm=ctas, waves=-(-n_ctas // (H100_SMS * ctas)))


def _check_ssd(x, Bm, Cm, dt, A, chunk):
    """``ssd_scan``'s checks of a card call; returns (B, L, h, hd, S)."""
    for name, t in (("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: x dtype {x.dtype} unsupported (float32 "
                        f"or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("ssd_scan: x must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} is not (B, L, h, hd)")
    B, L, h, hd = x.shape
    S = Bm.shape[-1] if Bm.dim() == 3 else -1
    if Bm.shape != (B, L, S) or Cm.shape != (B, L, S) \
            or dt.shape != (B, L, h) or A.shape != (h,):
        raise ValueError(f"ssd_scan: shapes Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if not 1 <= chunk <= MAX_SSD_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, "
                         f"{MAX_SSD_CHUNK}]")
    if 0 in (hd, S) or _ssd_smem_bytes(chunk, hd, S) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {chunk}, hd {hd}, S {S} need "
                         f"{_ssd_smem_bytes(chunk, hd, S)} bytes of shared "
                         f"memory (limit {SMEM_LIMIT})")
    return B, L, h, hd, S


def ssd_scan(x, Bm, Cm, dt, A, *, chunk: int = 128):
    """Chunked Mamba2/SSD scan: x (B, L, h, hd) float32 or bfloat16; Bm,
    Cm (B, L, S), dt (B, L, h) and A (h,) float32.  Any L (a ragged last
    chunk counts as dt = 0 past L).  Returns (y (B, L, h, hd) f32, final
    state (B, h, hd, S) f32).  See ``kernels.ref.ssd_scan``.

    On the card every call, both x dtypes and every accepted shape, takes
    the tensor-core kernel of ``csrc/ssd_scan_mma.cu`` in two launches:
    C.B^T once per (row, chunk) into a scratch, then the scan
    (``ssd_scan_mma_geometry``).  ``LAUNCHES["ssd_scan"]`` and
    ``LAUNCHES["ssd_scan_mma"]`` count the call once.  The CUDA-core
    kernel of ``csrc/ssd_scan.cu`` is in the library but no call here
    reaches it."""
    if x.device.type == "cpu":
        return ref.ssd_scan(x, Bm, Cm, dt, A, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    B, L, h, hd, S = _check_ssd(x, Bm, Cm, dt, A, chunk)
    y = torch.empty((B, L, h, hd), dtype=torch.float32, device=x.device)
    if 0 in (B, L, h):
        return y, torch.zeros((B, h, hd, S), dtype=torch.float32,
                              device=x.device)
    st = torch.empty((B, h, hd, S), dtype=torch.float32, device=x.device)
    n = ssd_scan_mma_geometry(B, L, h, hd, S, chunk, x.dtype)[
        "scratch_floats"]
    scratch = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = build.load().ssd_scan_mma_launch(
        _DTYPES[x.dtype], x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dt.data_ptr(), A.data_ptr(), y.data_ptr(), st.data_ptr(),
        scratch.data_ptr(), n, B, L, h, hd, S, int(chunk),
        _stream_ptr(x.device))
    if rc:
        raise RuntimeError(f"ssd_scan kernel launch failed "
                           f"(ssd_scan_mma_launch): CUDA error {rc}")
    LAUNCHES["ssd_scan"] += 1
    LAUNCHES["ssd_scan_mma"] += 1
    return y, st


def ssd_scan_mma_card_geometry(B, L, h, hd, S, chunk, dtype) \
        -> Dict[str, int]:
    """What the library and the card report for the tensor-core
    ``ssd_scan`` launch at these shapes (x in ``dtype``): the sizes and
    grids ``ssd_scan_mma_geometry`` computes, the scan CTAs an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the scan
    kernel's registers a thread and local (spill) bytes."""
    out = (ctypes.c_longlong * 9)()
    rc = build.load().ssd_scan_mma_geometry(_DTYPES[dtype], B, L, h, hd, S,
                                            chunk, out)
    if rc:
        raise RuntimeError(f"ssd_scan_mma_geometry failed: CUDA error {rc}")
    return dict(zip(("scratch_floats", "smem", "prep_smem", "grid_x",
                     "grid_y", "prep_grid_x", "ctas_per_sm", "registers",
                     "local_bytes"), out))
