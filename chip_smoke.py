"""Chip smoke test of the PyTorch port: builds the hand-written CUDA
kernels from this checkout and drives the serving engine on one card:
the paged plane for the dense family (mistral-nemo-12b) and the moe
family (granite-moe-3b-a800m), each with chunked and with one-shot
prefill, mistral-nemo-12b also on the tiered near/far KV arena and on
the asyncio engine, the dense-cache plane for the hybrid family
(zamba2-7b), and the paged sliding-window plane (h2o-danube-3-4b, window
4096), chunked, one-shot and with the copy-on-write prefix cache.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build, kernel checks only
    python3 chip_smoke.py --profile  # also trace the seven engines

Phases (each prints its own lines and wall time; any failure raises):
  1. device   — card name, and name + power limit from nvidia-smi;
  2. build    — all seven kernels (paged_attention,
                paged_prefill_attention, flash_attention and moe_gmm as
                two sources each: the bf16 kernels
                paged_attention_split.cu (split-KV over a thread-block
                cluster), paged_prefill_attention_mma.cu,
                flash_attention_mma.cu and moe_gmm_wgmma.cu, and the f32
                ones; ssd_scan as ssd_scan_mma.cu, the tensor-core kernel
                of every call, and ssd_scan.cu, the CUDA-core kernel it
                replaced; rao_scatter_add as rao_scatter_onchip.cu, bf16 in
                one launch with the sums on chip, and rao_scatter.cu, f32
                and the three-launch kernel it replaced; rmsnorm as
                rmsnorm_row.cu, a row's loads in flight at once, and
                rmsnorm.cu, the one-warp kernel it replaced), one nvcc
                process per source (kernels/build.py),
                each kernel's ptxas registers and spills, each source's
                nvcc seconds;
  3. kernels  — each kernel against its plain PyTorch version: the
                attention kernels at mistral-nemo-12b's shapes (H=32, K=8,
                hd=128, bt=16, B=8, ctx up to 512, C in {8, 64}) with
                ragged lengths, -1 table entries, masked slots and a
                window; moe_gmm at granite's expert shapes (E=40, C in
                {8, 512, 37}, D x F in {1536 x 512, 512 x 1536}), C 1 and
                209 (the capacity group call), one tile (1, 64, 64, 128),
                a D tail (520) and an F tail (520) inside an expert, w a
                layer-1 slice of a stacked (L, E, D, F) tensor, every dim
                ragged (5, 130, 130, 130: D, F not multiples of 8, so the
                WMMA kernel) and a zero-size case, each bf16 case counted
                on LAUNCHES["moe_gmm_wgmma"] exactly when TMA takes it;
                rao_scatter_add at granite's combine
                shapes (D=1536, M in {320, 20480} random duplicates, and
                CENTRAL: every update on one row), both dtypes, then in
                bf16 the one-shot group call (837, 8360), the pad row (80%
                of the ids on the last row), ids out of range, N at and
                past one slab's rows, 5000 and 20000, M 20483 and D 130
                (a column a lane), with 256- and 512-thread CTAs, each bf16
                case on the on-chip kernel
                (LAUNCHES["rao_scatter_add_onchip"] one up) beside the
                three-launch kernel of rao_scatter.cu called through the
                library, printing its geometry
                (ops.rao_scatter_onchip_geometry); flash_attention at the
                three models' head shapes (32/8 x 128, 24/8 x 64, 32/32 x
                112), S in {17, 64, 189, 209, 300} (the main path's 189
                and 209; 17 and 300 no multiple of 16 or 64), B in {1, 4},
                windowed cases, S != T causal and not, and odd head dims
                (8, 40, 200: zero-padded to 16 in the bf16 kernel), each
                in bf16 (tensor-core kernel) and f32 (CUDA-core kernel);
                rmsnorm at D in {1536, 3584, 5120, 7168, 64, 130}, N in
                {1, 8, 512, 836, 1200}, both dtypes, on the row-spread
                kernel (LAUNCHES["rmsnorm_row"] one up) beside the one-warp
                kernel of rmsnorm.cu called through the library, printing
                its geometry (ops.rmsnorm_row_geometry); ssd_scan (y and
                final state) at zamba2's
                heads (h 112, hd 64, S 64) with L a multiple of 128, L
                ragged, one chunk and several, plus odd small shapes,
                chunk 1, hd and S not multiples of 8 (hd 130: three
                slabs) and a decay under which exp(acs) underflows, each
                on the tensor-core kernel (LAUNCHES["ssd_scan_mma"] one
                up) with the CUDA-core kernel of ssd_scan.cu, called
                through the library, held to the same tolerance beside
                it, and each printing its launch geometry as
                ops.ssd_scan_mma_geometry computes it and as the card
                reports it (CTAs an SM holds, registers, spills); and
                h2o-danube-3-4b's attention at its window, 4096 (32 / 8
                heads, hd 120, bt 16), in bf16 and f32: paged_attention
                at lengths 4,097-8,195 in a 520-column table,
                paged_prefill_attention with chunks of 64 at contexts
                4,100-8,130 in a 528-column table, each table's leading
                entries -1 as release_behind leaves them, and one
                flash_attention call, S = T = 5,000, whose rows past the
                window are also held one by one (|got - plain| over hd
                <= tol |plain| a row; the same for every causal windowed
                case with S = T), and the kernel called at window - 1
                and window + 1 must fail that check.
                Tolerance: the attention kernels |got - plain| <= tol, the
                others |got - plain| <= tol + tol * |plain|, with tol =
                2e-2 in bf16 and 1e-4 in f32 (TF32 off); ssd_scan 1e-3 in
                f32 (the JAX suite's test_ssd_scan_sweep), 2e-2 normwise
                with x in bf16.  paged_prefill_attention in bf16 runs the
                tensor-core kernel (LAUNCHES["paged_prefill_attention_mma"]
                one up, f32 none) at mistral's shapes and at granite's
                heads (24/8 x 64), hd 120, hd 256 (C 33), hd 232 (C 40),
                C 1, C 17, G 1,
                G 8, bt 32 and bt 24, windows 0 and 100, each printing its
                largest difference and the share of elements that differ
                at all, which must stay under 1% (f32 softmax weights);
                paged_attention in bf16 runs the split-KV kernel
                (LAUNCHES["paged_attention_split"] one up, f32 none) at
                mistral's shapes and at DECODE_CASES: granite's heads, hd
                120, 256 and 40 (17 query heads a kv head: two m-tiles),
                G 1, 8 and 32, bt 24, 32 and 1 (a 600-entry table), a
                context over 8 x 64 keys (CTAs walk several tiles), each with an L = 0 slot and -1 entries
                inside the live range, windows 0 and 100; the one-CTA
                kernel of paged_attention.cu, called through the library
                in bf16, is held to the same tolerance beside it; each
                case prints its launch geometry (CTAs per cluster, ring
                depth, shared memory, clusters the card holds at once,
                which must not be 0), its largest difference and the
                share of elements that differ, under 1%;
  4. tiny     — tiny f32 engines, each on the card (kernels) and on the
                CPU (plain versions) with identical greedy tokens: dense
                and dropless MoE on the chunked plane (a ragged trace),
                dense one-shot with prefill_batch 1 (ragged) and 4,
                capacity-routed MoE one-shot with prefill_batch 4, and a
                5-layer hybrid (2 groups of 2 Mamba2 layers and a tail
                layer) on the dense-cache plane with prefill_batch 4 (a
                trace of equal-length neighbours, so admission groups and
                waves form); then the tiered engines at one slot's worth of
                near frames (kv_near_blocks 2 of 6 pages): dense, danube
                (window 16) and dropless MoE, chunked, each also untiered
                on the card, with demotions and promotions on both devices
                and tokens identical across the three runs; and the
                asyncio dense engine (AsyncBatchServer, every request at
                once through run_closed_loop);
  5. serve    — full-width 40-layer mistral-nemo-12b, chunked and then
                one-shot (prefill_chunk=0), then (its params freed)
                full-width 32-layer granite-moe-3b-a800m, dropless chunked
                and then capacity-routed (auto: one-shot), each with
                random bf16 params from a seed serving 16 wire-encoded
                requests with 32 new tokens through BatchServer (8 slots,
                max_len 512; one-shot: prefill_batch 4 and 4 groups of 4
                equal prompt lengths; chunked: lengths 17-300), then
                (freed) full-width 81-layer zamba2-7b on the dense-cache
                plane (prefill_batch 4, two waves of 8 equal prompt
                lengths drawn from 17-300, so 4 group calls of 4): every
                request drains, logits stay finite, and each kernel
                launched exactly as the ticks say — paged_prefill_attention
                L per chunk tick (bf16: all on the tensor-core kernel,
                LAUNCHES["paged_prefill_attention_mma"] equal to it),
                paged_attention L per decode tick (bf16: all on the
                split-KV kernel, LAUNCHES["paged_attention_split"] equal
                to it),
                flash_attention L per group call, rmsnorm 2L + 1 per model
                call (all on the row-spread kernel,
                LAUNCHES["rmsnorm_row"] equal to it), moe_gmm 3L and
                rao_scatter_add L per model call (bf16: all on the
                on-chip kernel, LAUNCHES["rao_scatter_add_onchip"] equal
                to it, 0 in the f32 tiny engines);
                then (freed) full-width 24-layer h2o-danube-3-4b (window
                4096, hd 120; 8 slots, max_len 8,448, 32 new tokens a
                request): chunked, prompts of 4 x [17, 300], 4,096,
                4,101, 6,000 and 8,195 tokens, and one-shot
                (prefill_batch 4), a group of 4 x 300 and one of 4 x
                5,000 (ring-packed rows): every decoding slot past the
                window holds at most ceil(4096 / 16) + 2 blocks and every
                allocated block is freed by the drain;
                zamba2: ssd_scan 81 and flash_attention 13 per group call,
                rmsnorm 189 per model call, no paged kernel, every
                ssd_scan call on the tensor-core kernel
                (LAUNCHES["ssd_scan_mma"] equal to LAUNCHES["ssd_scan"],
                0 on the other paths); every bf16
                flash_attention launch on the tensor-core kernel
                (LAUNCHES["flash_attention_mma"] equal to
                LAUNCHES["flash_attention"]) and every bf16 moe_gmm launch
                on the TMA / wgmma kernel (LAUNCHES["moe_gmm_wgmma"] equal
                to LAUNCHES["moe_gmm"]), none in the f32 tiny engines;
  6. measure  — on inputs each main path itself produced, each kernel's
                time beside its plain version's, one PyTorch library call
                that computes the same function (never called by the port:
                scaled_dot_product_attention, torch.bmm, index_add_,
                F.rms_norm; none for ssd_scan) and its bound at 3.35 TB/s,
                989 TFLOP/s bf16 (matmul work and the SSD scan's bf16
                passes), 495 TFLOP/s TF32 (its TF32 passes; three passes
                a product) and 67 TFLOP/s f32 (elementwise work);
                ssd_scan at the zamba2 path's
                smallest and largest group call, the tensor-core kernel
                beside the CUDA-core kernel called through the library
                and the plain version, after both flushes, with the
                launch geometry and the f32-FMA bound (all its work at 67
                TFLOP/s); rao_scatter_add at the granite chunked path's
                decode tick and largest tick and the capacity one-shot
                path's largest group call, the on-chip kernel beside the
                three-launch kernel called through the library,
                index_add_ and the plain version, after both flushes;
                rmsnorm at the smallest (decode) and the largest call of
                mistral one-shot, granite one-shot and zamba2, the
                row-spread kernel beside the one-warp kernel called
                through the library, F.rms_norm and the plain version,
                after both flushes; moe_gmm at four calls
                of the granite chunked path (the gate and the down
                projection, each at decode and in the tick with the most
                work) and two of the capacity one-shot path (its largest
                gate and down group calls), the TMA / wgmma kernel beside
                the WMMA kernel called through the library on the same
                inputs, each also timed after an L2 flush that leaves no
                dirty lines; paged_prefill_attention at the mistral and
                the granite chunk tick with the most work, the
                tensor-core kernel beside the CUDA-core kernel of
                paged_prefill_attention.cu called through the library,
                SDPA over the gathered KV and the plain version, each
                timed after both flushes; paged_attention the same way at
                the mistral and the granite chunked paths' decode call
                with the most work: the split-KV kernel beside the
                one-CTA kernel of paged_attention.cu called through the
                library, SDPA over the gathered KV and the plain version;
                both paged kernels also at the danube chunked path's
                calls with the most work (SDPA's mask with the window);
  7. tiered and async — three more full-width mistral-nemo-12b paths
                through phase_serve, chunked, 16 requests of 32 new
                tokens: "mistral tiered flat" (max_len 1,024, prompts
                uniform in [512, 960]) and "mistral tiered", the same
                trace at kv_overcommit=2 (256 near frames of the 512-page
                pool, 2,621,440 bytes a page; warmup_migrations() before
                the first request): every migration event's destination
                frames equal their sources byte for byte (MigrationCheck,
                the swap case included), with demotions and promotions
                both above 0; every recorded paged-kernel call read an
                arena of near_frames + 1 pages through table ids in [-1,
                near_frames) (check_tables); after the drain nothing is
                resident near or far and allocated equals freed; each
                request's first-token logits lie within 2e-2 normwise of
                the flat twin's; then "mistral async": AsyncBatchServer
                with the "mistral chunked" configuration and prompts,
                Poisson arrivals at 4 requests a second
                (loadgen.make_trace, seed 0) driven by run_closed_loop:
                every request completes, no future is left, TTFT p50 /
                p99 from collect_metrics, first-token logits within 2e-2
                of the sync chunked run's; tier counters, the SimCXL
                migration cost (nic_report()["kv_migrate"]) and each
                path's TTFT and tok/s are printed;
  8. prefix   — two more serve paths (phase_serve and its checks):
                full-width h2o-danube-3-4b chunked, a cold run and then a
                prefix_cache=True run of 8 requests sharing a 1,024-token
                prefix (tails of 1 to 3,500 tokens; the first request
                alone until its prompt is in): the shared pages stay
                byte for byte the same after every tick of the hot run,
                the cache hits, the hot run allocates fewer blocks, and
                each hot request's first-token logits lie within 2e-2
                normwise of the cold run's.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from functools import partial
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import rpc as wire  # noqa: E402
from repro_torch.device import H100_HBM_STREAM_GBs  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.loadgen import (  # noqa: E402
    make_trace, run_closed_loop,
)
from repro_torch.runtime.scheduler import blocks_for  # noqa: E402
from repro_torch.runtime.server import (  # noqa: E402
    AsyncBatchServer, BatchServer, encode_request,
)

HBM_BYTES_PER_S = H100_HBM_STREAM_GBs * 1e9   # H100 SXM, published
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor peak
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM dense TF32 tensor peak
KERNELS = {
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention_split.cu",
        unsplit_source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:132"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_prefill_attention_mma.cu",
        cuda_core_source="src/repro_torch/kernels/csrc/"
                         "paged_prefill_attention.cu",
        replaces="src/repro/kernels/paged_prefill_attention.py:157"),
    "moe_gmm": dict(
        source="src/repro_torch/kernels/csrc/moe_gmm_wgmma.cu",
        wmma_source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:62"),
    "rao_scatter_add": dict(
        source="src/repro_torch/kernels/csrc/rao_scatter_onchip.cu",
        old_source="src/repro_torch/kernels/csrc/rao_scatter.cu",
        replaces="src/repro/kernels/rao_scatter.py:53"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_mma.cu",
        f32_source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:99"),
    "rmsnorm": dict(
        source="src/repro_torch/kernels/csrc/rmsnorm_row.cu",
        old_source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:29"),
    "ssd_scan": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan_mma.cu",
        cuda_core_source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:75"),
}
ATTENTION = ("paged_attention", "paged_prefill_attention")
MOE = ("moe_gmm", "rao_scatter_add")
ONESHOT = ("flash_attention", "rmsnorm")
DENSE_ARCH, MOE_ARCH = "mistral-nemo-12b", "granite-moe-3b-a800m"
HYBRID_ARCH, SWA_ARCH = "zamba2-7b", "h2o-danube-3-4b"
DEV = torch.device("cuda")
SPIN_CYCLES = 20_000_000         # ~10 ms at the H100's ~2 GHz SM clock


def phase(name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f"[{name}] wall {time.perf_counter() - t0:.2f} s",
                  flush=True)
            return out
        return run
    return deco


def time_ms(fn, reps, flush=None, clean=False):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events); the
    L2 is flushed before each run when ``flush`` is given, by writing it
    (which leaves up to the L2's size of dirty lines for ``fn`` to write
    back) or, with ``clean``, by reading it.  A device-side spin before
    the start event keeps the card busy while the host enqueues ``fn``,
    so host launch overhead does not count as device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None and clean:
            flush.max()
        elif flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close(got, exp, tol):
    """|got - exp| <= tol + tol * |exp| everywhere, and finite."""
    g, e = got.float(), exp.float()
    return bool(torch.isfinite(g).all()) and \
        bool(((g - e).abs() <= tol + tol * e.abs()).all())


# ------------------------------------------------------------ inputs
def pool_inputs(rng, B, H, K, hd, bt, nb, lens, dtype, *, C=None,
                neg_inside=(), masked=(), first_live=None):
    """Random q / arena / new kv on the card with a shuffled block table
    covering ``lens`` tokens per slot; ``neg_inside`` entries become -1,
    ``masked`` slots get all--1 rows, and with ``first_live`` each slot's
    leading blocks wholly before its first live position become -1, all
    but the slot's last, as ``KVBlockPager.release_behind`` leaves them."""
    P = B * nb + 1
    lead = (B,) if C is None else (B, C)
    perm = rng.permutation(P - 1)
    btab = np.full((B, nb), -1, np.int32)
    j = 0
    for b, L in enumerate(lens):
        for i in range(-(-int(L) // bt)):
            btab[b, i] = perm[j]
            j += 1
    for b, i in neg_inside:
        btab[b, i] = -1
    for b in masked:
        btab[b] = -1
    for b, lo in enumerate(first_live or ()):
        btab[b, :min(max(0, lo) // bt, -(-int(lens[b]) // bt) - 1)] = -1

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .to(DEV, dtype)
    return (rnd(*lead, H, hd), rnd(P, bt, K, hd), rnd(P, bt, K, hd),
            torch.from_numpy(btab).to(DEV),
            rnd(*lead, K, hd), rnd(*lead, K, hd))


@phase("device")
def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] torch.cuda.get_device_name: {name}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


@phase("build")
def phase_build():
    t0 = time.perf_counter()
    build.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'} s)")
    print("[build] nvcc seconds per source (all started together): " +
          ", ".join(f"{k} {v:.1f}" for k, v in build.nvcc_seconds.items()))
    kernel = "?"
    for line in (build.build_log or "").splitlines():
        m = re.search(r"Compiling entry function '_ZN(\w+)'", line)
        if m:   # the kernel's name, its int and bool template arguments
            # (the bf16 flash kernel's padded head dim, moe_gmm_wgmma's
            # tile, rmsnorm_row's vector mode and loads a thread) and the
            # bf16 mark
            kernel, rest = _last_name(m.group(1))
            args = re.match(r"I((?:\d+\w+?|[a-z])?(?:L[bi]\d+E)+)E", rest)
            targs = [v if t == "i" else ("false", "true")[int(v)]
                     for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))
                     ] if args else []
            kernel += (f"<{', '.join(targs)}>" if targs else "") + \
                (" bf16" if "bfloat16" in line else "")
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {kernel}: {line.strip()}")


def _last_name(nested):
    """The last <length><name> component of an Itanium-mangled nested
    name (the function's own name), and what follows the components (its
    template arguments and parameters)."""
    name, i = "?", 0
    while i < len(nested) and nested[i].isdigit():
        j = i
        while nested[j].isdigit():
            j += 1
        n = int(nested[i:j])
        name, i = nested[j:j + n], j + n
    return name, nested[i:]


@phase("kernels")
def phase_kernels(errs):
    """Each kernel against its plain version at the model's shapes."""
    rng = np.random.RandomState(0)
    H, K, hd, bt = 32, 8, 128, 16
    nb = 512 // bt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for window in (0, 100):
            check_decode(rng, errs, dtype, tol, "mistral", H, K, hd, bt, nb,
                         MISTRAL_LENS, window, timed=True)
            for C in (8, 64):
                check_prefill(rng, errs, dtype, tol, f"C {C}", H, K, hd, C,
                              bt, window, timed=True)
    for label, H, K, hd, C, bt in PREFILL_CASES:
        for window in (0, 100):
            check_prefill(rng, errs, torch.bfloat16, 2e-2, label, H, K, hd,
                          C, bt, window)
    for label, H, K, hd, bt, nb, lens in DECODE_CASES:
        for window in (0, 100):
            check_decode(rng, errs, torch.bfloat16, 2e-2, label, H, K, hd,
                         bt, nb, lens, window)
    check_swa_kernels(rng, errs)
    check_moe_kernels(rng, errs)
    check_rao_kernels(rng, errs)
    check_oneshot_kernels(rng, errs)
    check_rmsnorm_kernels(rng, errs)
    check_ssd_kernel(rng, errs)


# decode lengths of 8 slots: slot 0 is new (L = 0, its table row all -1),
# slots 3 and 6 have a -1 entry inside the live range (clamped to page 0)
MISTRAL_LENS = [0, 16, 17, 100, 255, 300, 511, 64]
NEG_INSIDE = ((3, 1), (6, 0))
# bf16 paged_attention cases beyond mistral's shapes: (label, H, K, hd,
# bt, nb, lens) — granite's heads, a head dim padded to 128, the largest,
# one padded to 48 with 17 query heads a kv head (two m-tiles of 16), one
# query head a kv head, 8 and 32, block sizes not dividing 64 and larger
# than 16, one-token blocks in a 600-entry table, and a context over 8 x 64
# keys (nb 64: each CTA walks two tiles)
DECODE_CASES = [("granite", 24, 8, 64, 16, 32, MISTRAL_LENS),
                ("hd 120", 32, 8, 120, 16, 32, MISTRAL_LENS),
                ("hd 256", 8, 2, 256, 16, 32, MISTRAL_LENS),
                ("hd 40 G 17", 34, 2, 40, 16, 32, MISTRAL_LENS),
                ("G 1", 8, 8, 128, 16, 32, MISTRAL_LENS),
                ("G 8", 32, 4, 128, 16, 32, MISTRAL_LENS),
                ("G 32", 32, 1, 128, 16, 32, MISTRAL_LENS),
                ("bt 24", 32, 8, 128, 24, 22, MISTRAL_LENS),
                ("bt 32", 32, 8, 128, 32, 16, MISTRAL_LENS),
                ("bt 1", 32, 8, 128, 1, 600, [0, 16, 17, 100, 255, 300, 599,
                                              64]),
                ("long", 32, 8, 128, 16, 64, [0, 900, 1023, 513, 1, 64, 700,
                                              1000]),
                ("long G 32 hd 256", 32, 1, 256, 16, 64,
                 [0, 900, 1023, 513, 1, 64, 700, 1000])]


def one_cta_decode(args, kw, out):
    """paged_attention.cu's kernel in bf16 on the wrapper's arguments,
    into out, launched through the library (no count): the kernel the
    split-KV one replaced on the main path, as the before of phases 3 and
    6.  Returns the CUDA error."""
    q, kp, vp, btab, lens, kn, vn = args
    B, H, hd = q.shape
    _, bt, K, _ = kp.shape
    return build.load().paged_attention_launch(
        1, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), btab.data_ptr(),
        lens.data_ptr(), kn.data_ptr(), vn.data_ptr(), out.data_ptr(), B, H,
        K, hd, bt, btab.shape[1], int(kw.get("window", 0)),
        1.0 / np.sqrt(hd), ops._stream_ptr(q.device))


def check_decode(rng, errs, dtype, tol, label, H, K, hd, bt, nb, lens,
                 window, timed=False, released=False):
    """paged_attention against its plain version: 8 slots with ``lens``
    (slot 0 new, with an all--1 row; -1 entries inside the live range of
    slots 3 and 6; with ``released``, instead, each slot's leading blocks
    behind the window -1, as the engine's ``release_behind(slot, pos -
    window)`` leaves them).  bf16 must take the split-KV kernel, keep f32
    softmax weights (under 1% of the elements differ at all) and launch
    on a geometry the card holds; the one-CTA kernel is held to the same
    tolerance beside it."""
    where = dict(first_live=[L + 1 - window for L in lens]) if released \
        else dict(neg_inside=NEG_INSIDE, masked=(0,))
    q, kp, vp, btab, kn, vn = pool_inputs(
        rng, 8, H, K, hd, bt, nb, lens, dtype, **where)
    ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
    args = (q, kp, vp, btab, ln, kn, vn)
    run = partial(ops.paged_attention, *args, window=window)
    plain = partial(ref.paged_attention, *args, window=window)
    split = int(dtype == torch.bfloat16)
    before = dict(ops.LAUNCHES)
    got = run()
    exp = plain()
    old = torch.empty_like(q)
    if split and one_cta_decode(args, dict(window=window), old):
        raise AssertionError("the one-CTA decode kernel did not launch")
    torch.cuda.synchronize()
    e = max_err(got, exp)
    share = float((got != exp).float().mean())
    ok = bool(torch.isfinite(got).all()) and e <= tol and \
        ops.LAUNCHES["paged_attention"] == before["paged_attention"] + 1 \
        and ops.LAUNCHES["paged_attention_split"] == \
        before["paged_attention_split"] + split and \
        (not split or share < 0.01)
    extra = ""
    if split:
        old_e = max_err(old, exp)
        ok = ok and old_e <= tol and bool(torch.isfinite(old).all())
        geo = ops.paged_attention_split_geometry(H, K, hd, bt, nb)
        ok = ok and geo["clusters"] > 0
        errs["paged_attention_unsplit"].append(old_e)
        extra = (f"; one-CTA kernel max_abs_err {old_e:.3g}; geometry "
                 f"{geo}")
    if timed:
        extra += f"; kernel {time_ms(run, 10):.4f} ms"
        if split:
            extra += (f", one-CTA kernel "
                      f"{time_ms(partial(one_cta_decode, args, dict(window=window), old), 10):.4f} ms")
        extra += f", plain {time_ms(plain, 3):.4f} ms"
    print(f"[kernels] paged_attention{'_split' if split else ''} "
          f"{str(dtype)[6:]} {label}: H {H} K {K} hd {hd} bt {bt} nb {nb} "
          f"window {window}: max_abs_err {e:.3g} (tol {tol}), max|exp| "
          f"{float(exp.float().abs().max()):.4g}, elements that differ "
          f"{share:.3%}{extra}")
    if not ok:
        raise AssertionError(f"paged_attention disagrees or took the wrong "
                             f"kernel: {e}, {share:.3%}, {ops.LAUNCHES}")
    errs["paged_attention"].append(e)


# bf16 paged_prefill_attention cases beyond mistral's shapes: (label, H,
# K, hd, C, bt) — granite's heads, a head dim padded to 128, the largest
# and one padded to 240 (two warps share a row there, the second owning
# 14 column tiles of 30), chunks of 1 and 17 (no multiple of 16), one and
# eight query heads per kv head, block sizes larger than 16 and not
# dividing 64
PREFILL_CASES = [("granite", 24, 8, 64, 64, 16), ("hd 120", 32, 8, 120, 64, 16),
                 ("hd 256", 8, 2, 256, 33, 16), ("hd 232", 8, 2, 232, 40, 16),
                 ("C 1", 32, 8, 128, 1, 16),
                 ("C 17", 32, 8, 128, 17, 16), ("G 1", 8, 8, 128, 64, 16),
                 ("G 8", 32, 4, 128, 64, 16), ("bt 32", 32, 8, 128, 64, 32),
                 ("bt 24", 32, 8, 128, 64, 24)]


def check_prefill(rng, errs, dtype, tol, label, H, K, hd, C, bt, window,
                  timed=False, ctx=None, nb=None):
    """paged_prefill_attention against its plain version: 8 slots with
    ragged contexts up to 448 (a masked slot, a new one), -1 table entries
    inside the live range; or, given ``ctx``, those contexts in a table of
    ``nb`` columns whose leading blocks behind each chunk's window are -1,
    as the chunked engine's ``release_behind(slot, ctx - window + 1)``
    leaves them.  bf16 must take the tensor-core kernel and keep f32
    softmax weights: under 1% of the elements may differ at all (bf16
    weights change far more)."""
    B = 8
    if ctx is None:
        nb = -(-512 // bt)
        ctx = [0, 0, 16, 37, 128, 200, 300, 448]       # 0, 0: masked, new
        where = dict(neg_inside=((4, 0), (5, 2)), masked=(0,))
    else:
        where = dict(first_live=[c - window + 1 for c in ctx])
    q, kp, vp, btab, kn, vn = pool_inputs(
        rng, B, H, K, hd, bt, nb, [c + C for c in ctx], dtype, C=C, **where)
    cx = torch.tensor(ctx, dtype=torch.int32, device=DEV)
    run = partial(ops.paged_prefill_attention, q, kp, vp, btab, cx, kn, vn,
                  window=window)
    plain = partial(ref.paged_prefill_attention, q, kp, vp, btab, cx, kn, vn,
                    window=window)
    mma = int(dtype == torch.bfloat16)
    before = dict(ops.LAUNCHES)
    got = run()
    exp = plain()
    torch.cuda.synchronize()
    e = max_err(got, exp)
    mag = float(exp.float().abs().max())
    share = float((got != exp).float().mean())
    ok = bool(torch.isfinite(got).all()) and e <= tol and \
        ops.LAUNCHES["paged_prefill_attention"] == \
        before["paged_prefill_attention"] + 1 and \
        ops.LAUNCHES["paged_prefill_attention_mma"] == \
        before["paged_prefill_attention_mma"] + mma and \
        (not mma or share < 0.01)
    times = ""
    if timed:
        times = (f"; kernel {time_ms(run, 10):.4f} ms, plain "
                 f"{time_ms(plain, 3):.4f} ms")
    print(f"[kernels] paged_prefill_attention{'_mma' if mma else ''} "
          f"{str(dtype)[6:]} {label}: H {H} K {K} hd {hd} C {C} bt {bt} "
          f"nb {nb} window {window}: max_abs_err {e:.3g} (tol {tol}), max|exp| "
          f"{mag:.4g}, elements that differ {share:.3%}{times}")
    if not ok:
        raise AssertionError(f"paged_prefill_attention disagrees or took the "
                             f"wrong kernel: {e}, {share:.3%}, {ops.LAUNCHES}")
    errs["paged_prefill_attention" if mma
         else "paged_prefill_attention_cuda_core"].append(e)


# h2o-danube-3-4b's heads (32 / 8, hd 120) at its window, 4096, on the
# shapes its full-width paths give the kernels: decode lengths past the
# window (the table of 520 columns the decode bucket ships at 8,196
# tokens), chunks of 64 at contexts past it (the full 528-column table of
# max_len 8448), each table's leading entries -1 as release_behind leaves
# them; and (check_oneshot_kernels) one prompt forward of 5,000 tokens
SWA = dict(H=32, K=8, hd=120, bt=16, window=4096)
SWA_DECODE_LENS = [4097, 4100, 4111, 5000, 6000, 7003, 8192, 8195]
SWA_PREFILL_CTX = [4100, 4103, 4500, 5000, 6100, 7000, 8000, 8130]


def check_swa_kernels(rng, errs):
    """The paged attention kernels of the sliding-window paths at
    h2o-danube-3-4b's shapes, window 4096, each in bf16 and f32 against
    its plain version (check_decode, check_prefill; flash_attention's
    case, S = T = 5,000, is one of check_oneshot_kernels')."""
    H, K, hd, bt, W = (SWA[k] for k in ("H", "K", "hd", "bt", "window"))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        check_decode(rng, errs, dtype, tol, "danube window", H, K, hd, bt,
                     520, SWA_DECODE_LENS, W, released=True)
        check_prefill(rng, errs, dtype, tol, "danube window", H, K, hd, 64,
                      bt, W, ctx=SWA_PREFILL_CTX, nb=528)


def close_normwise(got, exp, tol):
    """max |got - exp| <= tol * max |exp|, and finite."""
    g, e = got.float(), exp.float()
    return bool(torch.isfinite(g).all()) and \
        float((g - e).abs().max()) <= tol * float(e.abs().max())


def cuda_core_ssd(args, kw, y, st):
    """ssd_scan.cu's CUDA-core kernel on the wrapper's arguments, into y
    and st, launched through the library (no count): the kernel the
    tensor-core one replaced on the main path, as the before of phases 3
    and 6.  Returns the CUDA error."""
    x, Bm, Cm, dt, A = args
    B, L, h, hd = x.shape
    return build.load().ssd_scan_launch(
        ops._DTYPES[x.dtype], x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dt.data_ptr(), A.data_ptr(), y.data_ptr(), st.data_ptr(), B, L, h,
        hd, Bm.shape[-1], int(kw.get("chunk", 128)),
        ops._stream_ptr(x.device))


def ssd_geometry_line(x, S, chunk):
    """The tensor-core ssd_scan launch at x's shapes: what
    ops.ssd_scan_mma_geometry computes and what the card reports (CTAs an
    SM holds, registers, spills); raises if the two disagree on a size or
    a grid, or the card holds fewer CTAs than computed."""
    B, L, h, hd = x.shape
    geo = ops.ssd_scan_mma_geometry(B, L, h, hd, S, chunk, x.dtype)
    card = ops.ssd_scan_mma_card_geometry(B, L, h, hd, S, chunk, x.dtype)
    same = (card["scratch_floats"], card["smem"], card["prep_smem"],
            (card["grid_x"], card["grid_y"]), card["prep_grid_x"]) == \
        (geo["scratch_floats"], geo["smem"], geo["prep_smem"], geo["grid"],
         geo["prep_grid"][0])
    if not same or card["ctas_per_sm"] < geo["ctas_per_sm"]:
        raise AssertionError(f"ssd_scan geometry: computed {geo}, card "
                             f"{card}")
    return (f"grid {geo['grid']} x {geo['threads']} threads after C.B^T "
            f"grid {geo['prep_grid']}; smem {geo['smem']} B (C.B^T "
            f"{geo['prep_smem']} B), scratch {4 * geo['scratch_floats']} B;"
            f" CTAs per SM {card['ctas_per_sm']} (computed at least "
            f"{geo['ctas_per_sm']}), waves {geo['waves']}; "
            f"{card['registers']} registers, {card['local_bytes']} bytes "
            f"of spill")


def check_ssd_kernel(rng, errs):
    """ssd_scan's y and final state against the plain chunk math: zamba2's
    heads (h 112, hd 64, S 64, chunk 128) with L a multiple of 128 (two
    chunks), L ragged (209: a partial last chunk), one chunk; then small
    odd shapes (hd and S not multiples of 16, chunk not a power of two),
    chunk 1, hd and S not multiples of 8 (hd 130: three slabs of hd, the
    last 2 wide), and a decay so strong that exp(acs) underflows to 0.
    dt = softplus(randn), as the model's projection gives it, or
    |randn| / 10 as the JAX suite draws it; "strong": A = -60 with dt =
    softplus.  Every case takes the tensor-core kernel
    (LAUNCHES["ssd_scan_mma"] one up); the CUDA-core kernel, called
    through the library, is held to the same tolerance beside it."""
    def rnd(shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(DEV)
    cases = [(2, 256, 112, 64, 64, 128, "softplus"),
             (4, 209, 112, 64, 64, 128, "softplus"),
             (2, 128, 112, 64, 64, 128, "small"),
             (1, 77, 3, 32, 16, 64, "small"),
             (2, 300, 2, 40, 24, 100, "softplus"),
             (2, 37, 3, 24, 16, 1, "softplus"),
             (2, 150, 5, 20, 13, 128, "small"),
             (1, 200, 2, 130, 70, 48, "softplus"),
             (2, 256, 8, 64, 64, 128, "strong")]
    for B, L, h, hd, S, chunk, dts in cases:
        Bm, Cm = rnd((B, L, S)), rnd((B, L, S))
        raw = rnd((B, L, h))
        dt = raw.abs() * 0.1 if dts == "small" \
            else torch.nn.functional.softplus(raw)
        A = -(rnd((h,)).abs() + 0.2) if dts == "small" \
            else torch.full((h,), -60.0, device=DEV) if dts == "strong" \
            else -torch.exp(rnd((h,), 0.5))
        x32 = rnd((B, L, h, hd))
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            x = x32.to(dtype)
            before = dict(ops.LAUNCHES)
            y, st = ops.ssd_scan(x, Bm, Cm, dt, A, chunk=chunk)
            ey, est = ref.ssd_scan(x, Bm, Cm, dt, A, chunk=chunk)
            oy, ost = torch.empty_like(y), torch.empty_like(st)
            if cuda_core_ssd((x, Bm, Cm, dt, A), dict(chunk=chunk), oy, ost):
                raise AssertionError("the CUDA-core ssd_scan kernel did not "
                                     "launch")
            torch.cuda.synchronize()
            e = max(max_err(y, ey), max_err(st, est))
            old = max(max_err(oy, ey), max_err(ost, est))
            check = close if dtype == torch.float32 else close_normwise
            ok = check(y, ey, tol) and check(st, est, tol) and \
                check(oy, ey, tol) and check(ost, est, tol) and \
                all(ops.LAUNCHES[k] == before[k] + 1
                    for k in ("ssd_scan", "ssd_scan_mma"))
            print(f"[kernels] ssd_scan x {str(dtype)[6:]} B {B} L {L} h {h} "
                  f"hd {hd} S {S} chunk {chunk} dt {dts}: max_abs_err "
                  f"{e:.3g}, CUDA-core kernel {old:.3g} (y max "
                  f"{float(ey.abs().max()):.3g}, state max "
                  f"{float(est.abs().max()):.3g}; tol {tol} "
                  f"{'abs + rel' if dtype == torch.float32 else 'normwise'})"
                  f"; {ssd_geometry_line(x, S, chunk)}")
            if not ok:
                raise AssertionError(f"ssd_scan disagrees: {e} (CUDA-core "
                                     f"kernel {old})")
            errs["ssd_scan"].append(e)
            errs["ssd_scan_cuda_core"].append(old)


def window_rows_err(got, exp, window):
    """The largest ||got - exp|| / ||exp|| over hd, of any (batch row,
    query row at or past ``window``, head): the rows whose window cuts
    keys off, each held to its own size (a window edge one key off moves
    some such row by far more than bf16 rounding does)."""
    g, e = got[:, window:].float(), exp[:, window:].float()
    return float(((g - e).norm(dim=-1)
                  / e.norm(dim=-1).clamp_min(1e-30)).max())


def check_oneshot_kernels(rng, errs):
    """flash_attention at the served models' head shapes against the plain
    version.  A causal windowed case with S = T > window also holds the
    rows past the window row by row (``window_rows_err``), and shows that
    the check sees a window one key off: the kernel called at window - 1
    and window + 1 must fail it."""
    def rnd(shape, dtype, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(DEV, dtype)
    # (B, S, T, H, K, hd, window, causal)
    flash_cases = [(B, S, S, H, K, hd, 0, True)
                   for H, K, hd in ((32, 8, 128), (24, 8, 64), (32, 32, 112))
                   for S in (17, 64, 189, 209, 300) for B in (1, 4)]
    flash_cases += [(4, 300, 300, 32, 8, 128, 100, True),
                    (4, 209, 209, 24, 8, 64, 64, True),
                    (1, 189, 189, 32, 32, 112, 17, True),
                    (2, 77, 150, 32, 8, 128, 0, False),
                    (2, 150, 77, 32, 8, 128, 0, True),
                    (2, 20, 20, 6, 3, 8, 0, True),
                    (1, 33, 33, 4, 2, 40, 0, True),
                    (1, 65, 65, 8, 1, 200, 16, True),
                    (1, 5000, 5000, SWA["H"], SWA["K"], SWA["hd"],
                     SWA["window"], True)]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        mma = int(dtype == torch.bfloat16)
        top = 0.0   # the largest |plain output| the cases met
        for B, S, T, H, K, hd, window, causal in flash_cases:
            q = rnd((B, S, H, hd), dtype)
            k = rnd((B, T, K, hd), dtype)
            v = rnd((B, T, K, hd), dtype)
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            exp = ref.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            e = max_err(got, exp)
            mag = float(exp.float().abs().max())
            top = max(top, mag)
            ok = bool(torch.isfinite(got).all()) and e <= tol and \
                ops.LAUNCHES["flash_attention"] == \
                before["flash_attention"] + 1 and \
                ops.LAUNCHES["flash_attention_mma"] == \
                before["flash_attention_mma"] + mma
            rows = ""
            if window and causal and S == T > window:
                row = window_rows_err(got, exp, window)
                off = [window_rows_err(ops.flash_attention(
                    q, k, v, causal=True, window=w), exp, window)
                    for w in (window - 1, window + 1)]
                ok = ok and row <= tol and min(off) > tol
                rows = (f"; rows [{window}, {S}) normwise a row {row:.3g} "
                        f"(tol {tol}), the kernel at window {window - 1} / "
                        f"{window + 1} {off[0]:.3g} / {off[1]:.3g} (must "
                        f"exceed the tol)")
            print(f"[kernels] flash_attention{'_mma' if mma else ''} "
                  f"{str(dtype)[6:]} B {B} S {S} T {T} H {H} K {K} hd {hd} "
                  f"window {window} causal {causal}: max_abs_err {e:.3g} "
                  f"(tol {tol}), max|exp| {mag:.4g}{rows}")
            if not ok:
                raise AssertionError(f"flash_attention disagrees: {e}")
            errs["flash_attention"].append(e)
        print(f"[kernels] flash_attention {str(dtype)[6:]}: largest |exp| "
              f"over {len(flash_cases)} cases {top:.4g} (tol {tol})")


def old_rmsnorm(x, w, eps, out):
    """rmsnorm.cu's one-warp kernel on the wrapper's arguments, into out,
    launched through the library (no count): the kernel the row-spread
    one replaced on the main path, as the before of phases 3 and 6.
    Returns the CUDA error."""
    D = x.shape[-1]
    return build.load().rmsnorm_launch(
        ops._DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        x.numel() // D, D, float(eps), ops._stream_ptr(x.device))


def rms_geometry_line(x):
    D = x.shape[-1]
    geo = ops.rmsnorm_row_geometry(x.numel() // D, D, x.dtype)
    return (f"{geo['threads_per_row']} threads a row x {geo['rows_per_cta']}"
            f" rows a CTA, {geo['per_thread']} loads of {geo['vec']} "
            f"elements a thread, grid {geo['grid']}")


def check_rmsnorm_kernels(rng, errs):
    """rmsnorm at the served widths (1536, 3584, 5120, 7168), the q/k-norm
    width 64 and an odd width (130: an element a unit), at decode (1, 8)
    and prefill (512, 836, 1200) row counts, both dtypes, on the
    row-spread kernel (LAUNCHES["rmsnorm_row"] one up), with the one-warp
    kernel of rmsnorm.cu, called through the library, held to the same
    tolerance beside it."""
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for D in (1536, 3584, 5120, 7168, 64, 130):
            for N in (1, 8, 512, 836, 1200):
                x = torch.from_numpy(rng.randn(N, D).astype(np.float32)) \
                    .to(DEV, dtype)
                w = torch.from_numpy((rng.randn(D) * 0.1).astype(np.float32)) \
                    .to(DEV, dtype)
                before = dict(ops.LAUNCHES)
                got = ops.rmsnorm(x, w, 1e-5)
                exp = ref.rmsnorm(x, w, 1e-5)
                old = torch.empty_like(x)
                if old_rmsnorm(x, w, 1e-5, old):
                    raise AssertionError("the one-warp rmsnorm kernel did not "
                                         "launch")
                torch.cuda.synchronize()
                e, o = max_err(got, exp), max_err(old, exp)
                ok = close(got, exp, tol) and close(old, exp, tol) and \
                    all(ops.LAUNCHES[k] == before[k] + 1
                        for k in ("rmsnorm", "rmsnorm_row"))
                print(f"[kernels] rmsnorm {str(dtype)[6:]} ({N}, {D}): "
                      f"max_abs_err {e:.3g}, one-warp kernel {o:.3g} (tol "
                      f"{tol} abs + rel); {rms_geometry_line(x)}")
                if not ok:
                    raise AssertionError(f"rmsnorm disagrees: {e} (one-warp "
                                         f"kernel {o})")
                errs["rmsnorm"].append(e)
                errs["rmsnorm_old"].append(o)


def check_moe_kernels(rng, errs):
    """moe_gmm against its plain version at granite's shapes (E = 40
    experts, d_model 1536, d_ff_expert 512)."""
    E, Dm, Fe = 40, 1536, 512

    def rnd(shape, dtype, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(DEV, dtype)
    # granite's (C, D, F) at decode, a full chunk and a ragged chunk, for
    # the gate/up and the down projection; C 1 and the capacity group
    # call's 209; one tile; a D tail and an F tail inside an expert (a map
    # that leaked into the next expert's weights would show in the first);
    # w as layer 1 of a stacked (L, E, D, F) tensor (a base offset); then
    # every dim ragged (D, F not multiples of 8: the WMMA kernel's
    # unvectorised loads).  (E, C, D, F, w stacked)
    gmm_cases = [(E, C, D, F, False) for C in (8, 512, 37)
                 for D, F in ((Dm, Fe), (Fe, Dm))]
    gmm_cases += [(E, 1, Dm, Fe, False), (E, 209, Dm, Fe, False),
                  (1, 64, 64, 128, False), (4, 64, 520, 512, False),
                  (4, 64, 512, 520, False), (E, 8, Dm, Fe, True),
                  (E, 512, Dm, Fe, True), (5, 130, 130, 130, False)]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for Eg, C, D, F, stacked in gmm_cases:
            xe = rnd((Eg, C, D), dtype)
            w = rnd((2, Eg, D, F), dtype, 1 / np.sqrt(D))[1] if stacked \
                else rnd((Eg, D, F), dtype, 1 / np.sqrt(D))
            # TMA takes bf16 with D, F multiples of 8 (the bases here are
            # all 16-byte aligned)
            tma = dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
            before = dict(ops.LAUNCHES)
            got = ops.moe_gmm(xe, w)
            exp = ref.moe_gmm(xe, w)
            torch.cuda.synchronize()
            e = max_err(got, exp)
            ok = close(got, exp, tol) and got.shape == (Eg, C, F) and \
                ops.LAUNCHES["moe_gmm"] == before["moe_gmm"] + 1 and \
                ops.LAUNCHES["moe_gmm_wgmma"] == \
                before["moe_gmm_wgmma"] + tma
            k_ms = time_ms(lambda: ops.moe_gmm(xe, w), 5)
            # errors: the TMA kernel's under moe_gmm, moe_gmm.cu's
            # (WMMA bf16, FMA f32) under moe_gmm_wmma
            name, key = ("moe_gmm_wgmma", "moe_gmm") if tma else \
                ("moe_gmm", "moe_gmm_wmma")
            print(f"[kernels] {name} {str(dtype)[6:]} ({Eg}, {C}, {D}) x "
                  f"({Eg}, {D}, {F}){' w = stack[1]' if stacked else ''}: "
                  f"max_abs_err {e:.3g} (tol {tol} abs + rel); kernel "
                  f"{k_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"{name} disagrees or took the wrong "
                                     f"kernel: {e}, {ops.LAUNCHES}")
            errs[key].append(e)
        before = ops.LAUNCHES["moe_gmm"]
        empty = ops.moe_gmm(rnd((E, 0, Dm), dtype), rnd((E, Dm, Fe), dtype))
        if empty.shape != (E, 0, Fe) or \
                ops.LAUNCHES["moe_gmm"] != before:
            raise AssertionError("moe_gmm zero-size case launched or "
                                 f"gave {tuple(empty.shape)}")
        print(f"[kernels] moe_gmm {str(dtype)[6:]} zero-size ({E}, 0, {Dm}):"
              f" empty {tuple(empty.shape)}, no launch")


def old_rao(table, idx, vals):
    """rao_scatter.cu on the wrapper's arguments, in place, launched
    through the library (no count), bf16 with the N x D f32 scratch its
    wrapper allocated (widen, scatter, narrow): the kernel the on-chip one
    replaced on the main path, as the before of phases 3 and 6.  Returns
    the CUDA error."""
    N, D = table.shape
    scratch = torch.empty((N, D), dtype=torch.float32, device=table.device) \
        if table.dtype == torch.bfloat16 else None
    return build.load().rao_scatter_add_launch(
        ops._DTYPES[table.dtype], table.data_ptr(), idx.data_ptr(),
        vals.data_ptr(), None if scratch is None else scratch.data_ptr(), N,
        idx.shape[0], D, ops._stream_ptr(table.device))


def rao_geometry_line(N, M, D):
    geo = ops.rao_scatter_onchip_geometry(N, M, D)
    return (f"tiles of {geo['rows']} rows x {geo['cols']} columns "
            f"({geo['vec']} a lane), clusters of {geo['split']} CTAs of "
            f"{geo['threads']} threads x {geo['per_cta']} updates, grid "
            f"{geo['grid']} = {geo['ctas']} CTAs, {geo['smem']} B of shared "
            f"memory a CTA")


def check_rao_kernels(rng, errs):
    """rao_scatter_add at granite's combine (D 1536): random duplicates at
    the decode (9, 320) and largest tick (513, 20480) shapes and CENTRAL
    (every update on row 0), in bf16 (the on-chip kernel,
    LAUNCHES["rao_scatter_add_onchip"] one up) and f32 (the atomic
    kernel); then in bf16 the one-shot group call (837, 8360), the pad row
    (80% of the ids on the last row, as dropless routing pads), ids
    outside [0, N) (dropped; held against the plain version of the ids in
    range), N at and past one slab's rows (the geometry's row tiles) and
    far past it (also with CTAs of 256 threads), M not a multiple of any
    block size, and D 130 (a column a lane), each with CTAs of 256 and of
    512 threads.  In bf16 the three-launch kernel of rao_scatter.cu,
    called through the library, is held to the same tolerance beside it;
    each case prints the on-chip geometry."""
    slab_rows = ops.rao_slab_bytes(512) // (4 * ops.RAO_COLS)
    cases = [(dtype, name, N, M, 1536)
             for dtype in (torch.bfloat16, torch.float32)
             for name, N, M in (("duplicates", 9, 320),
                                ("duplicates", 513, 20480),
                                ("CENTRAL", 513, 20480))]
    cases += [(torch.bfloat16, name, N, M, D) for name, N, M, D in (
        ("duplicates", 837, 8360, 1536), ("pad row", 513, 20480, 1536),
        ("out of range", 513, 20480, 1536),
        ("duplicates", slab_rows, 8000, 1536),
        ("duplicates", slab_rows + 1, 8000, 1536),
        ("pad row", 20000, 20480, 1536), ("duplicates", 5000, 1000, 1536),
        ("duplicates", 513, 20483, 1536), ("duplicates", 65, 300, 130),
        ("pad row", 65, 3000, 130))]
    for dtype, name, N, M, Dm in cases:
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        idx = rng.randint(0, N, size=M).astype(np.int32)
        if name == "CENTRAL":               # every update on row 0, ones
            idx[:] = 0
            vals = torch.ones((M, Dm), dtype=dtype, device=DEV)
        else:
            vals = torch.from_numpy(rng.randn(M, Dm).astype(np.float32)) \
                .to(DEV, dtype)
        if name == "pad row":
            idx[rng.rand(M) < 0.8] = N - 1
        elif name == "out of range":
            idx[::3] = rng.choice([-1, -9, N, N + 100], size=idx[::3].shape)
        keep = torch.from_numpy((idx >= 0) & (idx < N)).to(DEV)
        idx = torch.from_numpy(idx).to(DEV)
        table = torch.from_numpy(rng.randn(N, Dm).astype(np.float32)) \
            .to(DEV, dtype)
        exp = ref.rao_scatter_add(table, idx[keep], vals[keep])
        old = table.clone()
        before = dict(ops.LAUNCHES)
        got = ops.rao_scatter_add(table, idx, vals)
        onchip = dtype == torch.bfloat16
        if onchip and old_rao(old, idx, vals):
            raise AssertionError("the three-launch rao_scatter_add kernel did "
                                 "not launch")
        torch.cuda.synchronize()
        e = max_err(got, exp)
        o = max_err(old, exp) if onchip else e
        ok = close(got, exp, tol) and (not onchip or close(old, exp, tol)) \
            and got is table and \
            ops.LAUNCHES["rao_scatter_add"] == before["rao_scatter_add"] + 1 \
            and ops.LAUNCHES["rao_scatter_add_onchip"] == \
            before["rao_scatter_add_onchip"] + onchip
        print(f"[kernels] rao_scatter_add{'_onchip' if onchip else ''} "
              f"{str(dtype)[6:]} {name} N {N} M {M} D {Dm}: max_abs_err "
              f"{e:.3g}" + (f", three-launch kernel {o:.3g}" if onchip else "")
              + f" (tol {tol} abs + rel)"
              + (f"; {rao_geometry_line(N, M, Dm)}" if onchip else ""))
        if not ok:
            raise AssertionError(f"rao_scatter_add disagrees: {e} "
                                 f"(three-launch kernel {o})")
        errs["rao_scatter_add"].append(e)
        if onchip:
            errs["rao_scatter_add_old"].append(o)


def tiny_trace(vocab):
    rng = np.random.RandomState(4321)
    lens_new = [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4), (5, 2), (13, 3)]
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in lens_new]


def grouped_trace(vocab):
    """Equal prompt lengths back to back, so prefill_batch groups form."""
    rng = np.random.RandomState(77)
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in [(6, 3)] * 4 + [(11, 2)] * 3 + [(6, 4), (20, 3)]]


def decode_outputs(bufs):
    out = {}
    for buf in bufs:
        msg = wire.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


def drain_outputs(srv, trace):
    wires = [encode_request(i, p, m) for i, (p, m) in enumerate(trace)]
    if isinstance(srv, AsyncBatchServer):
        # every request at once through the engine coroutine
        bufs, _ = run_closed_loop(srv, wires,
                                  make_trace("all-at-once", len(wires)))
        return decode_outputs(bufs)
    for w in wires:
        srv.submit_wire(w)
    return decode_outputs(srv.run_until_drained())


TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32", cache_dtype="float32")
CHUNKED_KERNELS = ("paged_prefill_attention", "paged_attention", "rmsnorm")
ONESHOT_KERNELS = ("flash_attention", "paged_attention", "rmsnorm")
HYBRID_KERNELS = ("ssd_scan", "ssd_scan_mma", "flash_attention", "rmsnorm")
# counts of the kernels that take bf16 only
BF16_ONLY = ("paged_attention_split", "paged_prefill_attention_mma",
             "flash_attention_mma", "moe_gmm_wgmma", "rao_scatter_add_onchip")


TIER_KNOBS = ("kv_overcommit", "kv_near_blocks", "kv_demote_after")


def leaked(srv):
    """Pages (paged plane, near or far) or pool blocks (dense plane) still
    held after a drain."""
    kv = srv.kv_stats()
    if kv["paged_kv"]:
        far = kv["tier"]["far_resident"] if kv["tiered"] else 0
        return kv["paged"]["pages_in_use"] + far + \
            kv["blocks_allocated"] - kv["blocks_freed"]
    return kv["blocks_allocated"] - kv["blocks_freed"]


@phase("tiny")
def phase_tiny():
    """Tiny f32 engines on the card (kernels) and on the CPU (plain):
    dense and dropless MoE (8 experts, top-2) chunked, then dense one-shot
    with prefill_batch 1 and 4, capacity-routed MoE one-shot with
    prefill_batch 4, the 5-layer hybrid (layout 2 x 2 + 1 tail) on the
    dense-cache plane with prefill_batch 4, then the tiered engines at one
    slot's worth of near frames (dense, danube with its window of 16,
    dropless MoE; each also untiered on the card) and the asyncio dense
    engine."""
    dense = reduced(get_config(DENSE_ARCH)).replace(**TINY)
    moe = reduced(get_config(MOE_ARCH)).replace(**TINY)
    hybrid = reduced(get_config(HYBRID_ARCH)).replace(**dict(TINY,
                                                             n_layers=5))
    swa = reduced(get_config(SWA_ARCH)).replace(**TINY)
    one_slot = dict(kv_near_blocks=blocks_for(32, 16))    # max_len, bt
    engines = (
        ("dense chunked", dense, {}, tiny_trace, 3, CHUNKED_KERNELS),
        ("moe dropless chunked", moe.replace(moe_routing="dropless"), {},
         tiny_trace, 3, CHUNKED_KERNELS + MOE),
        ("dense one-shot pfb1", dense, dict(prefill_chunk=0), tiny_trace, 3,
         ONESHOT_KERNELS),
        ("dense one-shot pfb4", dense, dict(prefill_chunk=0,
                                            prefill_batch=4),
         grouped_trace, 4, ONESHOT_KERNELS),
        ("moe capacity one-shot pfb4", moe.replace(moe_routing="capacity"),
         dict(prefill_batch=4), grouped_trace, 4, ONESHOT_KERNELS + MOE),
        ("hybrid dense pfb4", hybrid, dict(prefill_batch=4), grouped_trace,
         4, HYBRID_KERNELS),
        ("dense tiered", dense, one_slot, tiny_trace, 3, CHUNKED_KERNELS),
        ("danube tiered", swa, one_slot, tiny_trace, 3, CHUNKED_KERNELS),
        ("moe dropless tiered", moe.replace(moe_routing="dropless"),
         one_slot, tiny_trace, 3, CHUNKED_KERNELS + MOE),
        ("dense async", dense, dict(engine=AsyncBatchServer), tiny_trace, 3,
         CHUNKED_KERNELS),
    )
    for label, cfg, kw, trace_of, slots, kernels in engines:
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(3), "cpu")
        trace = trace_of(cfg.vocab)
        kw = dict(kw)
        cls = kw.pop("engine", BatchServer)
        outs = {}
        tier = ""
        # a tiered engine's twin: the same engine untiered, on the card
        runs = ["cpu", "cuda"] + (["cuda untiered"]
                                  if set(kw) & set(TIER_KNOBS) else [])
        for run in runs:
            dev = run.split()[0]
            p = params if dev == "cpu" else _tree_to(params, DEV)
            before = dict(ops.LAUNCHES)
            run_kw = {k: v for k, v in kw.items() if k not in TIER_KNOBS} \
                if run == "cuda untiered" else kw
            srv = cls(model, batch_slots=slots, max_len=32, params=p,
                      device=dev, nic_cost=None, **run_kw)
            if srv.tiered:
                srv.warmup_migrations()
            outs[run] = drain_outputs(srv, trace)
            if run_kw is kw and bool(srv.tiered) != bool(
                    set(kw) & set(TIER_KNOBS)):
                raise AssertionError(f"tiny {label}: tiering is "
                                     f"{srv.tiered}")
            if srv.tiered and not (srv.pager.demotions and
                                   srv.pager.promotions):
                raise AssertionError(f"tiny {label} {run}: no migration at "
                                     f"one slot's worth of near frames")
            if srv.tiered and run == "cuda":
                t = srv.kv_stats()["tier"]
                tier = f"; {t['demotions']} demotions, {t['promotions']} " \
                    f"promotions at {t['near_frames']} near frames"
            launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
            if leaked(srv):
                raise AssertionError(f"{label} {dev}: pages leaked")
            if dev == "cuda" and not all(launched[k] for k in kernels):
                raise AssertionError(f"tiny {label} skipped a kernel: "
                                     f"{launched}")
            if launched["rmsnorm_row"] != launched["rmsnorm"]:
                raise AssertionError(f"the tiny {label} engine took another "
                                     f"rmsnorm kernel: {launched}")
            if any(launched[k] for k in BF16_ONLY):
                raise AssertionError(f"the f32 tiny {label} engine took a "
                                     f"bf16 kernel: {launched}")
            if cfg.family == "hybrid" and \
                    any(launched[k] for k in ATTENTION + MOE):
                raise AssertionError(f"the tiny {label} engine launched a "
                                     f"paged or MoE kernel: {launched}")
            if dev == "cpu" and any(launched.values()):
                raise AssertionError(f"the CPU {label} engine launched a "
                                     f"kernel")
        same = all(o == outs["cpu"] for o in outs.values())
        st = srv.stats
        print(f"[tiny] {label} ({cfg.family}): {len(outs['cuda'])} requests,"
              f" {st['prefills']} prefills, {st['prefill_chunks']} chunk "
              f"ticks{tier}; greedy tokens identical "
              f"{' vs '.join(outs)}: {same}")
        if not same or len(outs["cuda"]) != len(trace):
            raise AssertionError(f"tiny {label} engine tokens differ:\n"
                                 f"{outs}")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class Recorder:
    """Keeps the arguments of one call of a kernel wrapper in every model
    call of the main path: call ``offset`` of each run of ``period``
    (layer 0's, unless an offset picks another) — a reference, not a copy;
    no device sync.  Recorders of one wrapper nest (each wraps what it
    finds when entered); ``key`` names what it keeps."""

    def __init__(self, name, period, offset=0, key=None):
        self.name, self.period, self.offset = name, period, offset
        self.key = key or name
        self.fn = None
        self.calls = []
        self.n = 0

    def __call__(self, *args, **kw):
        if self.n % self.period == self.offset:
            self.calls.append((args, kw))
        self.n += 1
        return self.fn(*args, **kw)

    def __enter__(self):
        self.fn = getattr(ops, self.name)
        setattr(ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.fn)


# the served paths: (arch, label, moe routing, server options)
PATHS = {
    "mistral chunked": (DENSE_ARCH, "chunked", None, {}),
    "mistral one-shot": (DENSE_ARCH, "one-shot", None,
                         dict(prefill_chunk=0, prefill_batch=4)),
    "granite chunked": (MOE_ARCH, "dropless chunked", "dropless", {}),
    "granite one-shot": (MOE_ARCH, "capacity one-shot", "capacity",
                         dict(prefill_batch=4)),
    "zamba2 dense": (HYBRID_ARCH, "dense", None, dict(prefill_batch=4)),
    "danube chunked": (SWA_ARCH, "chunked", None, {}),
    "danube one-shot": (SWA_ARCH, "one-shot", None,
                        dict(prefill_chunk=0, prefill_batch=4)),
    "danube prefix cold": (SWA_ARCH, "chunked prefix cold", None, {}),
    "danube prefix": (SWA_ARCH, "chunked prefix", None,
                      dict(prefix_cache=True)),
    "mistral tiered flat": (DENSE_ARCH, "tiered flat", None, {}),
    "mistral tiered": (DENSE_ARCH, "tiered", None,
                       dict(kv_overcommit=2.0)),
    "mistral async": (DENSE_ARCH, "async", None, {}),
}
# the tiered paths' engines hold 1,024 tokens a slot: 8 x 64 = 512 pages
# of 16 tokens, of which kv_overcommit=2 leaves 256 near frames; prompts
# of 512-960 tokens (32 new) want up to 62 blocks a slot, so 8 slots'
# working sets overflow the near tier and engagement has to rotate
TIERED_MAX_LEN = 1024
TIERED_PATHS = ("mistral tiered flat", "mistral tiered")
# the async path: AsyncBatchServer driven by run_closed_loop, requests
# arriving as a Poisson process at 4 a second (loadgen.make_trace, seed 0)
ASYNC_PATHS = {"mistral async": dict(pattern="poisson", rate_rps=4.0)}
# the sliding-window paths' engines hold 8,448 tokens a slot and serve
# prompts past the window: chunked 4 short ones and 4,096 / 4,101 / 6,000
# / 8,195 tokens; one-shot a group of 4 x 300 and one of 4 x 5,000 (ring-
# packed rows); the other paths' engines hold 512 tokens
SWA_MAX_LEN = 8448
PATH_PROMPTS = {
    "danube chunked": lambda rng: np.concatenate(
        [rng.randint(17, 301, size=4), [4096, 4101, 6000, 8195]]),
    "danube one-shot": lambda rng: np.repeat([300, 5000], 4),
    "mistral tiered flat": lambda rng: rng.randint(512, 961, size=16),
    "mistral tiered": lambda rng: rng.randint(512, 961, size=16),
}
# the prefix paths: 8 requests that share a 1,024-token prefix (a multiple
# of the chunk and the block), cold and with the prefix cache; the first
# one's tail is one token and it is served alone until its prompt is in
# (and published), then the other 7 come at once
PREFIX_LEN = 1024
PREFIX_TAILS = (1, 17, 300, 1000, 2047, 2900, 3071, 3500)


def prefix_waves(vocab, seed):
    rng = np.random.RandomState(seed + 7)
    prefix = rng.randint(1, vocab - 1, size=PREFIX_LEN).tolist()
    prompts = [prefix + rng.randint(1, vocab - 1, size=t).tolist()
               for t in PREFIX_TAILS]
    return [prompts[:1], prompts[1:]]


# paths whose requests come in waves: each wave is submitted once the
# prompts before it are in
PATH_WAVES = {"danube prefix cold": prefix_waves,
              "danube prefix": prefix_waves}


class SharedPages:
    """The prefix-cache run's page check: ``snapshot`` keeps a copy of the
    first ``n_blocks`` pages of a slot (the published prefix), and every
    later tick of the engine must leave them byte for byte as they were."""

    def __init__(self, srv, n_blocks):
        self.srv, self.n_blocks = srv, n_blocks
        self.kept = None
        self.ticks = 0
        step = srv.step

        def run():
            out = step()
            if self.kept is not None:
                self.check()
            return out
        srv.step = run

    def snapshot(self, slot):
        row = self.srv.pager.block_table()[slot, :self.n_blocks]
        if (row < 0).any():
            raise AssertionError(f"the prefix blocks are not all mapped: "
                                 f"{row}")
        ids = torch.from_numpy(row.astype(np.int64)).to(DEV)
        pages = self.srv.pages
        self.kept = (ids, pages["kp"][:, ids].clone(),
                     pages["vp"][:, ids].clone())

    def check(self):
        ids, k0, v0 = self.kept
        pages = self.srv.pages
        self.ticks += 1
        if not (torch.equal(pages["kp"][:, ids], k0) and
                torch.equal(pages["vp"][:, ids], v0)):
            raise AssertionError(f"a shared prefix page changed after tick "
                                 f"{self.ticks}")


class MigrationCheck:
    """The tiered run's migration check: wraps the engine's migrate
    callable, keeps a copy of every real source frame before each event
    (pads are trash-to-trash and skipped) and holds each destination
    frame to it byte for byte after the event.  Counts the events, the
    pages each way, and the swaps: a near frame that one event both
    demotes and refills, or a far frame it both promotes and refills."""

    def __init__(self, srv):
        self.srv = srv
        self.fn = srv._kv_migrate
        self.events = self.demoted = self.promoted = self.swaps = 0
        srv._kv_migrate = self

    def __call__(self, near, far, ds, dd, ps, pd):
        nt, ft = self.srv.pager.near_frames, self.srv.pager.far_frames
        dem = [(s, d) for s, d in zip(ds.tolist(), dd.tolist()) if s != nt]
        pro = [(s, d) for s, d in zip(ps.tolist(), pd.tolist()) if s != ft]
        if any(d == ft for _, d in dem) or any(d == nt for _, d in pro):
            raise AssertionError(f"a real page migrates into a trash frame: "
                                 f"{dem} {pro}")
        srcs = {name: (near[name][:, [s for s, _ in dem]].clone(),
                       far[name][:, [s for s, _ in pro]].clone())
                for name in ("kp", "vp")}
        near, far = self.fn(near, far, ds, dd, ps, pd)
        for name, (dk, pk) in srcs.items():
            if not (torch.equal(far[name][:, [d for _, d in dem]], dk) and
                    torch.equal(near[name][:, [d for _, d in pro]], pk)):
                raise AssertionError(f"migration event {self.events}: a "
                                     f"{name} frame differs from its source "
                                     f"({dem}, {pro})")
        self.events += 1
        self.demoted += len(dem)
        self.promoted += len(pro)
        self.swaps += len({s for s, _ in dem} & {d for _, d in pro}) + \
            len({d for _, d in dem} & {s for s, _ in pro})
        return near, far


def check_tables(srv, recs):
    """Every recorded paged-kernel call of a tiered run read an arena of
    near_frames + 1 pages through a table of ids in [-1, near_frames): a
    CUDA kernel does not clamp an id past its arena as JAX's gather
    does.  Returns the number of calls checked."""
    nf = srv.pager.near_frames
    n = 0
    for key in ("paged_attention", "paged_prefill_attention"):
        for args, _ in recs[key]:
            kp, btab = args[1], args[3]
            if kp.shape[0] != nf + 1:
                raise AssertionError(f"{key} read an arena of {kp.shape[0]}"
                                     f" pages, the near tier has {nf} + 1")
            lo, hi = int(btab.min()), int(btab.max())
            if lo < -1 or hi >= nf:
                raise AssertionError(f"{key} table ids span [{lo}, {hi}], "
                                     f"outside [-1, {nf})")
            n += 1
    return n


def norms_per_call(cfg):
    """RMSNorms of one model call: ln1 and ln2 of each attention block, a
    pre-norm and a gated norm per Mamba2 layer (hybrid), the final norm."""
    if cfg.family == "hybrid":
        return 2 * transformer.hybrid_layout(cfg)[0] + 2 * cfg.n_layers + 1
    return 2 * cfg.n_layers + 1


def expected_launches(cfg, st, groups):
    """Each kernel's launches on the main path, from the engine's ticks
    and its one-shot group calls: every model call (chunk tick, decode
    tick, group call) runs ``norms_per_call`` norms and, for moe, 3L
    expert GEMMs and L combines; hybrid group calls run one flash
    attention per group and one SSD scan per Mamba2 layer, and its decode
    ticks neither (dense-cache decode attention is plain PyTorch)."""
    L, chunks, decodes = cfg.n_layers, st["prefill_chunks"], \
        st["decode_steps"]
    calls = chunks + decodes + groups
    exp = {"paged_prefill_attention": L * chunks,
           "paged_prefill_attention_mma": 0,
           "paged_attention": L * decodes, "paged_attention_split": 0,
           "flash_attention": L * groups, "flash_attention_mma": 0,
           "rmsnorm": norms_per_call(cfg) * calls,
           "moe_gmm": 0, "moe_gmm_wgmma": 0, "rao_scatter_add": 0,
           "rao_scatter_add_onchip": 0, "ssd_scan": 0, "ssd_scan_mma": 0}
    if cfg.family == "hybrid":   # every ssd_scan call on the tensor cores
        exp["paged_attention"] = 0
        exp["flash_attention"] = transformer.hybrid_layout(cfg)[0] * groups
        exp["ssd_scan"] = exp["ssd_scan_mma"] = L * groups
    if cfg.family == "moe":
        exp["moe_gmm"] = 3 * L * calls
        exp["rao_scatter_add"] = L * calls
    exp["rmsnorm_row"] = exp["rmsnorm"]     # every call, both dtypes
    if cfg.param_dtype == "bfloat16":   # bf16 runs the redesigned kernels
        exp["rao_scatter_add_onchip"] = exp["rao_scatter_add"]
        exp["paged_attention_split"] = exp["paged_attention"]
        exp["paged_prefill_attention_mma"] = exp["paged_prefill_attention"]
        exp["flash_attention_mma"] = exp["flash_attention"]
        exp["moe_gmm_wgmma"] = exp["moe_gmm"]
    return exp


@phase("serve")
def phase_serve(path, card, seed=0):
    arch, label, routing, kw = PATHS[path]
    cfg = get_config(arch)
    if routing is not None:
        cfg = cfg.replace(moe_routing=routing)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k} d_ff_expert "
           f"{cfg.d_ff_expert}" if cfg.family == "moe"
           else f"d_ff {cfg.d_ff}")
    if cfg.family == "hybrid":
        ffn += (f", Mamba2 d_inner {cfg.d_inner} ({cfg.n_ssm_heads} heads x "
                f"{cfg.ssm_head_dim}, state {cfg.ssm_state}), layout "
                f"{transformer.hybrid_layout(cfg)}")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, {ffn}, vocab {cfg.vocab}; "
          f"{n_params / 1e9:.2f} B bf16 params initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    max_len = SWA_MAX_LEN if cfg.sliding_window else \
        TIERED_MAX_LEN if path in TIERED_PATHS else 512
    engine = AsyncBatchServer if path in ASYNC_PATHS else BatchServer
    srv = engine(model, batch_slots=8, max_len=max_len, block_tokens=16,
                 params=params, device=DEV, sync_timers=True, **kw)
    del params
    migrations = None
    if srv.tiered:
        t0 = time.perf_counter()
        srv.warmup_migrations()
        print(f"[serve] {path}: {srv.pager.near_frames} near frames of "
              f"{srv.pager.n_pages} pages ({srv.pager.far_frames} far), "
              f"{srv.pager.block_bytes} bytes a page, near arena "
              f"{tuple(srv.pages['kp'].shape)}, far arena "
              f"{tuple(srv.far_pages['kp'].shape)}; migrations warmed up "
              f"in {time.perf_counter() - t0:.3f} s [{card}]")
        migrations = MigrationCheck(srv)
    oneshot = srv.prefill_chunk == 0
    rng = np.random.RandomState(seed)
    if path in PATH_WAVES:
        waves = PATH_WAVES[path](cfg.vocab, seed)
    else:
        if path in PATH_PROMPTS:
            plens = PATH_PROMPTS[path](rng)
        elif not srv.paged:   # 2 waves of 8 equal lengths (groups of 4)
            plens = np.repeat(rng.randint(17, 301, size=2), 8)
        elif oneshot:     # 4 groups of 4 equal prompt lengths, back to back
            plens = np.repeat(rng.randint(17, 301, size=4), 4)
        else:
            plens = rng.randint(17, 301, size=16)
        waves = [[rng.randint(1, cfg.vocab - 1, size=int(n)).tolist()
                  for n in plens]]
    n_req = sum(len(w) for w in waves)
    prompt_toks = sum(len(p) for w in waves for p in w)
    if path not in ASYNC_PATHS:     # the async path submits on its trace
        for i, p in enumerate(waves[0]):
            srv.submit_wire(encode_request(i, p, 32))
    finite = []
    group_rows = []
    first = {}      # request -> its first token's logits (chunked paths)

    def checked(step, rows=None):
        def run(*a):
            lg, out = step(*a)
            finite.append(torch.isfinite(lg).all())
            if rows is not None:
                rows.append(lg.shape[0])
            return lg, out
        return run

    def first_logits(step):
        def run(*a):
            lg, out = step(*a)
            for slot, req in srv.active.items():
                # a tiered tick chunks only its engaged slots
                if req.state.name == "PREFILLING" and \
                        len(req.prompt) - req.prefilled <= \
                        srv.prefill_chunk and \
                        (srv._engaged is None or slot in srv._engaged):
                    first[req.req_id] = lg[slot].clone()
            return lg, out
        return run
    admit_s = []                # host time of the pager's admissions

    def timed_admit(admit):
        def run(*a):
            t = time.perf_counter()
            out = admit(*a)
            admit_s.append(time.perf_counter() - t)
            return out
        return run
    srv.pager.admit = timed_admit(srv.pager.admit)
    resident = []   # blocks of each decoding slot past the window, a tick

    def window_held(step):
        def run(*a):
            resident.extend(srv.pager.resident_blocks(slot)
                            for slot, req in srv.active.items()
                            if req.state.name == "DECODE"
                            and req.pos > srv.window)
            return step(*a)
        return run
    if srv.paged:
        srv._paged_decode = checked(srv._paged_decode)
        if srv.window:
            srv._paged_decode = window_held(srv._paged_decode)
        srv._chunk_prefill = first_logits(checked(srv._chunk_prefill))
        srv._prefill_exact = checked(srv._prefill_exact, group_rows)
    else:
        srv._decode = checked(srv._decode)
        srv._prefill = checked(srv._prefill, group_rows)

    # record layer 0's call of each kernel in every model call (moe_gmm:
    # its first projection, the gate, and as "moe_gmm_down" its third;
    # rmsnorm: ln1, and on the hybrid the gated norm of the first Mamba2
    # layer, the widest)
    L = cfg.n_layers
    periods = {"paged_attention": (L, 0), "paged_prefill_attention": (L, 0),
               "flash_attention": (L, 0), "rmsnorm": (2 * L + 1, 0),
               "moe_gmm": (3 * L, 0), "moe_gmm_down": (3 * L, 2),
               "rao_scatter_add": (L, 0), "ssd_scan": (L, 0)}
    if cfg.family == "hybrid":
        periods["flash_attention"] = (transformer.hybrid_layout(cfg)[0], 0)
        periods["rmsnorm"] = (norms_per_call(cfg), 3)
    recorders = [Recorder(key.removesuffix("_down"), n, off, key)
                 for key, (n, off) in periods.items()]
    shared = SharedPages(srv, PREFIX_LEN // srv.pager.block_tokens) \
        if srv.pager.prefix_cache else None
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    metrics = None
    with ExitStack() as stack:
        for r in recorders:
            stack.enter_context(r)
        bufs = []
        n_in = len(waves[0])
        if path in ASYNC_PATHS:
            wires = [encode_request(i, p, 32)
                     for i, p in enumerate(waves[0])]
            arrivals = make_trace(n=len(wires), seed=seed,
                                  **ASYNC_PATHS[path])
            out, metrics = run_closed_loop(srv, wires, arrivals)
            bufs.extend(out)
        for wave in waves[1:]:      # step until every prompt so far is in
            while len(srv.queue) or any(r.state.name == "PREFILLING"
                                        for r in srv.active.values()):
                bufs.extend(srv.step())
            if shared is not None:
                shared.snapshot(next(s for s, r in srv.active.items()
                                     if r.req_id == 0))
            for i, p in enumerate(wave, n_in):
                srv.submit_wire(encode_request(i, p, 32))
            n_in += len(wave)
        if path not in ASYNC_PATHS:
            bufs.extend(srv.run_until_drained())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    recs = {r.key: r.calls for r in recorders}
    st = srv.stats
    groups = len(group_rows)
    outs = {}
    for buf in bufs:
        msg = wire.decode(buf, {1: "int", 2: "bytes"})
        outs[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    name = f"{cfg.name} {label}"
    print(f"[serve] {name}: {len(outs)}/{n_req} drained, {st['failed']} "
          f"failed, "
          f"{st['ticks']} ticks ({groups} group calls of {group_rows} rows, "
          f"{st['prefill_chunks']} chunk ticks, {st['decode_steps']} decode "
          f"ticks) in {wall:.2f} s; peak memory {peak:.2f} GiB [{card}]")
    if oneshot:
        # the group forwards run inside admission; splice_wall_s holds
        # only the page writes (as in the JAX engine)
        print(f"[serve] {name} prefill: {prompt_toks} tokens in "
              f"{st['admit_wall_s']:.3f} s of admission = "
              f"{prompt_toks / st['admit_wall_s']:.1f} tok/s ("
              f"{'page writes' if srv.paged else 'splices'} "
              f"{st['splice_wall_s']:.4f} s, of which the pager's "
              f"{len(admit_s)} admissions {sum(admit_s):.4f} s on the host; "
              f"{srv.pager.per_token_bytes} pool bytes a token) [{card}]")
    else:
        print(f"[serve] {name} prefill: {prompt_toks} tokens in "
              f"{st['splice_wall_s']:.3f} s of chunk ticks = "
              f"{prompt_toks / st['splice_wall_s']:.1f} tok/s [{card}]")
    print(f"[serve] {name} decode: {st['decode_tokens']} tokens in "
          f"{st['decode_wall_s']:.3f} s = "
          f"{st['decode_tokens'] / st['decode_wall_s']:.1f} tok/s [{card}]")
    ttft = sorted(r.first_token_t - r.arrival_t for r in srv.completed_reqs)
    sent = f"{n_req} arriving as {ASYNC_PATHS[path]}" \
        if path in ASYNC_PATHS else f"all {n_req} submitted at once" \
        if len(waves) == 1 else \
        f"{n_req} submitted in waves of {[len(w) for w in waves]}"
    print(f"[serve] {name} TTFT (submission to first token, {sent}): median {statistics.median(ttft):.3f} s, "
          f"max {ttft[-1]:.3f} s [{card}]")
    if metrics is not None:
        m = metrics.to_dict()
        print(f"[serve] {name} load ({ASYNC_PATHS[path]}, seed {seed}, "
              f"collect_metrics): {m['completed']}/{m['n_requests']} "
              f"completed in {m['makespan_s']} s; TTFT p50 "
              f"{m['ttft_p50_ms']} ms, p99 {m['ttft_p99_ms']} ms; latency "
              f"p50 {m['latency_p50_ms']} ms, p99 {m['latency_p99_ms']} ms; "
              f"{m['tokens_per_s']} tok/s over the makespan; slot "
              f"utilization {m['slot_utilization']}; decode "
              f"{st['decode_tokens'] / st['decode_wall_s']:.1f} tok/s; "
              f"futures left {len(srv._futures)} [{card}]")
        if m["completed"] != n_req or srv._futures or not srv._drained():
            raise AssertionError(f"the async engine left work: {m}, "
                                 f"{len(srv._futures)} futures")
    kv = srv.kv_stats()
    tier = None
    if srv.tiered:
        srv._drain_migrations()         # nothing may stay unlanded
        kv = srv.kv_stats()
        tier = kv["tier"]
        mig = srv.nic_report()["kv_migrate"]
        n_calls = check_tables(srv, recs)
        print(f"[serve] {name} tiers: {tier['demotions']} demotions "
              f"({tier['forced_demotions']} forced), {tier['promotions']} "
              f"promotions ({tier['prefetch_blocks']} prefetches, "
              f"{tier['demand_stall_blocks']} demand fetches); "
              f"{migrations.events} migration events, {migrations.demoted} "
              f"pages demoted and {migrations.promoted} promoted, each "
              f"byte for byte its source, {migrations.swaps} frames swapped "
              f"within an event; policy {tier['policy']}; SimCXL migration "
              f"cost {mig['n']} pages: PCIe {mig['pcie_us']:.1f} us vs CXL "
              f"{mig['cxl_us']:.1f} us ({mig['speedup_x']}x); {n_calls} "
              f"recorded paged-kernel calls read the {tier['near_frames']} + "
              f"1 page near arena with ids in [-1, {tier['near_frames']}); "
              f"after the drain near {tier['near_resident']}, far "
              f"{tier['far_resident']} resident [{card}]")
        if not (migrations.demoted and migrations.promoted) or \
                migrations.demoted != tier["demotions"] or \
                migrations.promoted != tier["promotions"]:
            raise AssertionError(f"migrations: the pager planned {tier}, "
                                 f"the engine ran {vars(migrations)}")
        if tier["far_resident"] or kv["paged"]["pages_in_use"] or \
                kv["blocks_allocated"] != kv["blocks_freed"]:
            raise AssertionError(f"the tiered drain left pages: {kv}")
    if shared is not None:
        pf = kv["prefix"]
        print(f"[serve] {name}: prefix hits {pf['hits']} ({pf['hit_tokens']}"
              f" tokens), {pf['published']} blocks published, shared pages "
              f"byte for byte after {shared.ticks} ticks; blocks allocated "
              f"{kv['blocks_allocated']} [{card}]")
        srv.pager.evict_prefixes()      # the cache's own references
    freed = srv.kv_stats()["blocks_freed"]
    if srv.window:
        bound = -(-srv.window // srv.pager.block_tokens) + 2
        print(f"[serve] {name} window {srv.window}: resident blocks of a "
              f"decoding slot past the window at most {max(resident)} "
              f"(bound {bound}, {len(resident)} slot ticks); blocks "
              f"allocated {kv['blocks_allocated']}, freed {freed} [{card}]")
        if max(resident) > bound or kv["blocks_allocated"] != freed:
            raise AssertionError(f"the window's footprint is not O(window):"
                                 f" {max(resident)} > {bound} or {kv}")
    expected = expected_launches(cfg, st, groups)
    print(f"[serve] {name} launches {launches}; expected {expected}")
    if len(outs) != n_req or st["failed"] or \
            any(len(v) != 32 for v in outs.values()):
        raise AssertionError(f"requests not drained: {st}")
    if leaked(srv):
        raise AssertionError("pages leaked")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits on the main path")
    if oneshot and group_rows != [4] * (n_req // 4):
        raise AssertionError(f"admission groups did not form: {group_rows}")
    if cfg.family == "hybrid":
        required = HYBRID_KERNELS
    else:
        required = (ONESHOT_KERNELS if oneshot else CHUNKED_KERNELS) + \
            (MOE if cfg.family == "moe" else ())
    if launches != expected or not all(launches[k] for k in required):
        raise AssertionError(f"launch counts do not match ticks: "
                             f"{launches} vs {expected}")
    return name, launches, recs, srv, dict(outs=outs, first=first, kv=kv,
                                           metrics=metrics, tier=tier)


def first_token_drift(ref, run, n, label):
    """Each request's first-token logits of ``run`` against ``ref``'s,
    max |got - ref| / max |ref|: all ``n`` requests must lie within 2e-2.
    Prints them and the share of greedy tokens the two runs agree on
    (bf16 batch shapes differ between the runs, so exact agreement is not
    required)."""
    errs = {}
    for rid, r in ref["first"].items():
        r, g = r.float(), run["first"][rid].float()
        errs[rid] = float((g - r).abs().max() / r.abs().max())
    r_out, g_out = ref["outs"], run["outs"]
    agree = sum(a == b for rid in r_out
                for a, b in zip(r_out[rid], g_out[rid]))
    whole = sum(r_out[rid] == g_out[rid] for rid in r_out)
    print(f"[{label}] first-token logits, normwise: "
          f"{', '.join(f'{r} {e:.3g}' for r, e in sorted(errs.items()))} "
          f"(tol 2e-2); greedy tokens agreeing {agree}/{32 * len(r_out)}, "
          f"{whole}/{len(r_out)} requests whole")
    if len(errs) != n or max(errs.values()) > 2e-2:
        raise AssertionError(f"{label}: first-token logits drift: {errs}")


def compare_prefix(cold, hot):
    """The prefix paths' runs side by side: the hot one must hit the
    cache, allocate fewer blocks, and give every request first-token
    logits within 2e-2 normwise of the cold run's; prints how many greedy
    tokens agree (the decode split count follows the table width, so
    exact agreement is not required)."""
    if not hot["kv"]["prefix"]["hits"] or \
            hot["kv"]["blocks_allocated"] >= cold["kv"]["blocks_allocated"]:
        raise AssertionError(f"the prefix cache did not share: cold "
                             f"{cold['kv']['blocks_allocated']} blocks, hot "
                             f"{hot['kv']}")
    first_token_drift(cold, hot, len(PREFIX_TAILS), "prefix hot vs cold")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------- bounds and library
def decode_work(q, btab, lens, kp, window):
    B, H, hd = q.shape
    _, bt, K, _ = kp.shape
    nb = btab.shape[1]
    es = q.element_size()
    rows = 0
    for L in lens:
        lo = max(0, L - window + 1) if window else 0
        rows += max(0, min(L, nb * bt) - lo)
    flops = 4 * hd * H * (rows + B)
    nbytes = (rows * K * hd * 2 + 2 * B * H * hd + 2 * B * K * hd) * es \
        + 4 * (btab.size + B)
    return nbytes, flops


def prefill_work(q, btab, ctx, kp, window):
    B, C, H, hd = q.shape
    _, bt, K, _ = kp.shape
    nb = btab.shape[1]
    es = q.element_size()
    rows, pairs = 0, 0
    cq = np.arange(C)
    for b, L0 in enumerate(ctx):
        p = np.arange(min(L0, nb * bt))
        p = p[btab[b, p // bt] >= 0] if p.size else p
        if window:
            p = p[p > L0 - window]
        rows += p.size
        paged = np.array([(p > L0 + c - window).sum() if window else p.size
                          for c in cq])
        own = np.minimum(cq + 1, window) if window else cq + 1
        pairs += int((paged + own).sum())
    flops = 4 * hd * (H // K) * K * pairs
    nbytes = (rows * K * hd * 2 + 2 * B * C * H * hd + 2 * B * C * K * hd) \
        * es + 4 * (btab.size + B)
    return nbytes, flops


def dense_inputs(q, kp, vp, btab, lens, kn, vn, *, chunk, window=0):
    """Gathered dense K/V (kv heads expanded to H) and the boolean mask of
    the same function, for one scaled_dot_product_attention call."""
    B = q.shape[0]
    P, bt, K, hd = kp.shape
    nb = btab.shape[1]
    H = q.shape[-2]
    G = H // K
    pages = btab.long().clamp_min(0)
    kg = kp[pages].reshape(B, nb * bt, K, hd)
    vg = vp[pages].reshape(B, nb * bt, K, hd)
    pos = torch.arange(nb * bt, device=DEV)
    L = lens.long()[:, None]
    if chunk:
        C = q.shape[1]
        live = (pos[None] < L) & (btab >= 0).repeat_interleave(bt, 1)
        live = live[:, None, :].expand(B, C, nb * bt)
        own = torch.ones(C, C, dtype=torch.bool, device=DEV).tril()
        if window:
            c = torch.arange(C, device=DEV)
            live = live & (pos[None, None] > (L[:, :, None] + c[None, :, None]
                                              - window))
            own = own & (c[None, :] > c[:, None] - window)
        mask = torch.cat([live, own[None].expand(B, C, C)], dim=-1)
        k = torch.cat([kg, kn], dim=1)
        v = torch.cat([vg, vn], dim=1)
        qd = q.transpose(1, 2)                         # (B, H, C, hd)
    else:
        live = pos[None] < L
        if window:
            live = live & (pos[None] > L - window)
        mask = torch.cat([live, torch.ones(B, 1, dtype=torch.bool,
                                           device=DEV)], dim=-1)[:, None]
        k = torch.cat([kg, kn[:, None]], dim=1)
        v = torch.cat([vg, vn[:, None]], dim=1)
        qd = q[:, :, None]                             # (B, H, 1, hd)
    k = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    return qd.contiguous(), k, v, mask[:, None]


def most_work(calls, work_fn):
    """The recorded attention call with the most flops, with its table and
    lengths on the host and its (bytes, flops)."""
    best, best_w = None, -1
    for args, kw in calls:
        q, kp, vp, btab, lens, kn, vn = args
        l_h = lens.cpu().numpy()
        b_h = btab.cpu().numpy()
        work = work_fn(q, b_h, l_h, kp, kw.get("window", 0))
        if work[1] > best_w:
            best, best_w = (args, kw, b_h, l_h, work), work[1]
    return best


def cuda_core_prefill(args, kw, out):
    """paged_prefill_attention.cu's kernel in bf16 on the wrapper's
    arguments, into out, launched through the library (no count): the
    kernel the tensor-core one replaced on the main path, as the before of
    phase 6.  Returns the CUDA error."""
    q, kp, vp, btab, ctx, kn, vn = args
    B, C, H, hd = q.shape
    _, bt, K, _ = kp.shape
    return build.load().paged_prefill_attention_launch(
        1, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), btab.data_ptr(),
        ctx.data_ptr(), kn.data_ptr(), vn.data_ptr(), out.data_ptr(), B, C,
        H, K, hd, bt, btab.shape[1], int(kw.get("window", 0)),
        1.0 / np.sqrt(hd), ops._stream_ptr(q.device))


def measure_prefill(recs, errs, flush, path):
    """Time paged_prefill_attention on a chunked path's own inputs (layer
    0's call in the chunk tick with the most work): the wrapper (which must
    take the tensor-core kernel), the CUDA-core kernel on the same inputs,
    SDPA over the gathered KV, the plain version and the bound; the first
    three also after a clean flush.  Returns the row and its label."""
    args, kw, b_h, l_h, (nbytes, flops) = most_work(
        recs["paged_prefill_attention"], prefill_work)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, kp = args[0], args[1]
    exp = ref.paged_prefill_attention(*args, **kw)
    before = ops.LAUNCHES["paged_prefill_attention_mma"]
    got = ops.paged_prefill_attention(*args, **kw)
    if ops.LAUNCHES["paged_prefill_attention_mma"] != before + 1:
        raise AssertionError(f"paged_prefill_attention ({path}) did not "
                             f"take the tensor-core kernel")
    old = torch.empty_like(got)
    cuda_core = partial(cuda_core_prefill, args, kw, old)
    if cuda_core():
        raise AssertionError("the CUDA-core kernel did not launch")
    qd, k, v, mask = dense_inputs(*args, chunk=True,
                                  window=kw.get("window", 0))
    library = partial(sdpa, qd, k, v, attn_mask=mask)
    lib = library().transpose(1, 2)
    torch.cuda.synchronize()
    err, old_err = max_err(got, exp), max_err(old, exp)
    if max(err, old_err) > 2e-2 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"paged_prefill_attention ({path}) disagrees on "
                             f"main-path inputs: {err}, CUDA-core {old_err}")
    errs["paged_prefill_attention"].append(err)
    errs["paged_prefill_attention_cuda_core"].append(old_err)
    run = partial(ops.paged_prefill_attention, *args, **kw)
    k_ms, c_ms, l_ms = (time_ms(f, 20, flush)
                        for f in (run, cuda_core, library))
    k_cl, c_cl, l_cl = (time_ms(f, 20, flush, clean=True)
                        for f in (run, cuda_core, library))
    p_ms = time_ms(partial(ref.paged_prefill_attention, *args, **kw), 5,
                   flush)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    K = kp.shape[2]
    print(f"[measure] paged_prefill_attention {path} on main-path inputs "
          f"q{tuple(q.shape)} kv heads {K} table{tuple(b_h.shape)} ctx "
          f"{l_h.tolist()}: tensor-core {k_ms:.4f} ms, CUDA-core {c_ms:.4f} "
          f"ms, sdpa {l_ms:.4f} ms, plain {p_ms:.4f} ms; after a clean flush "
          f"tensor-core {k_cl:.4f}, CUDA-core {c_cl:.4f}, sdpa {l_cl:.4f} ms;"
          f" bound {bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} ms, "
          f"{flops} flops -> {t_ops:.4f} ms); max_abs_err {err:.3g} "
          f"(CUDA-core {old_err:.3g}, sdpa vs plain {max_err(lib, exp):.3g}),"
          f" max|exp| {float(exp.float().abs().max()):.4g}, elements that "
          f"differ {float((got != exp).float().mean()):.3%}")
    row = dict(ms=k_ms, cuda_core_ms=c_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=float(bound),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               clean_ms=k_cl, cuda_core_clean_ms=c_cl, library_clean_ms=l_cl)
    return row, f"{path}: q{tuple(q.shape)} K {K}"


def measure_decode(recs, errs, flush, path):
    """Time paged_attention on a paged path's own inputs (layer 0's call in
    the decode tick with the most work): the wrapper (which must take the
    split-KV kernel), the one-CTA kernel on the same inputs, SDPA over the
    gathered KV, the plain version and the bound; the first three also
    after a clean flush.  Returns the row and its label."""
    args, kw, b_h, l_h, (nbytes, flops) = most_work(recs["paged_attention"],
                                                    decode_work)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, kp = args[0], args[1]
    _, bt, K, hd = kp.shape
    exp = ref.paged_attention(*args, **kw)
    before = ops.LAUNCHES["paged_attention_split"]
    got = ops.paged_attention(*args, **kw)
    if ops.LAUNCHES["paged_attention_split"] != before + 1:
        raise AssertionError(f"paged_attention ({path}) did not take the "
                             f"split-KV kernel")
    old = torch.empty_like(got)
    unsplit = partial(one_cta_decode, args, kw, old)
    if unsplit():
        raise AssertionError("the one-CTA decode kernel did not launch")
    qd, k, v, mask = dense_inputs(*args, chunk=False,
                                  window=kw.get("window", 0))
    library = partial(sdpa, qd, k, v, attn_mask=mask)
    lib = library()[:, :, 0]
    torch.cuda.synchronize()
    err, old_err = max_err(got, exp), max_err(old, exp)
    if max(err, old_err) > 2e-2 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"paged_attention ({path}) disagrees on "
                             f"main-path inputs: {err}, one-CTA {old_err}")
    errs["paged_attention"].append(err)
    errs["paged_attention_unsplit"].append(old_err)
    run = partial(ops.paged_attention, *args, **kw)
    k_ms, u_ms, l_ms = (time_ms(f, 20, flush)
                        for f in (run, unsplit, library))
    k_cl, u_cl, l_cl = (time_ms(f, 20, flush, clean=True)
                        for f in (run, unsplit, library))
    p_ms = time_ms(partial(ref.paged_attention, *args, **kw), 5, flush)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    geo = ops.paged_attention_split_geometry(q.shape[1], K, hd, bt,
                                             b_h.shape[1])
    print(f"[measure] paged_attention {path} on main-path inputs "
          f"q{tuple(q.shape)} kv heads {K} table{tuple(b_h.shape)} lens "
          f"{l_h.tolist()}: split-KV {k_ms:.4f} ms, one-CTA {u_ms:.4f} ms, "
          f"sdpa {l_ms:.4f} ms, plain {p_ms:.4f} ms; after a clean flush "
          f"split-KV {k_cl:.4f}, one-CTA {u_cl:.4f}, sdpa {l_cl:.4f} ms; "
          f"bound {bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} ms, "
          f"{flops} flops -> {t_ops:.4f} ms); geometry {geo}; max_abs_err "
          f"{err:.3g} (one-CTA {old_err:.3g}, sdpa vs plain "
          f"{max_err(lib, exp):.3g}), max|exp| "
          f"{float(exp.float().abs().max()):.4g}, elements that differ "
          f"{float((got != exp).float().mean()):.3%}")
    row = dict(ms=k_ms, unsplit_ms=u_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=float(bound),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               clean_ms=k_cl, unsplit_clean_ms=u_cl, library_clean_ms=l_cl)
    return row, f"{path}: q{tuple(q.shape)} K {K}"


@phase("measure")
def phase_measure(recs, errs):
    """Time each attention kernel on the mistral chunked path's own inputs
    (the layer-0 call of the tick with the most attention work), cold L2:
    paged_prefill_attention by ``measure_prefill`` and paged_attention by
    ``measure_decode``, each record keeping the other chunked paths' rows
    under ``shapes``."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    out = {}
    for name, measure in (("paged_prefill_attention", measure_prefill),
                          ("paged_attention", measure_decode)):
        row, label = measure(recs, errs, flush, "mistral chunked")
        out[name] = dict({k: v for k, v in row.items() if "clean" not in k},
                         shapes={label: row})
    return out


def gmm_work(xe, w):
    """Bytes and flops of one moe_gmm call, the dispatch padding rows
    counted as the kernel computes them."""
    E, C, D = xe.shape
    F = w.shape[2]
    return (E * C * D + E * D * F + E * C * F) * xe.element_size(), \
        2 * E * C * D * F


def rao_work(table, idx, vals):
    """Bytes and adds of one rao_scatter_add call: vals and idx read
    once, the table read and written once."""
    N, D = table.shape
    M = idx.shape[0]
    es = table.element_size()
    return M * D * es + 4 * M + 2 * N * D * es, M * D


def wmma_gmm(xe, w, out):
    """moe_gmm.cu's bf16 WMMA kernel on xe, w into out, launched through
    the library (no count): the kernel the TMA / wgmma one replaced on
    the main path, as the before of phase 6.  Returns the CUDA error."""
    E, C, D = xe.shape
    return build.load().moe_gmm_launch(
        1, xe.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D,
        w.shape[2], ops._stream_ptr(xe.device))


def measure_gmm(recs, errs, flush, path, ticks=("decode", "max")):
    """Time moe_gmm at calls of a granite path: layer 0's gate (its first
    projection) and down projection (its third), each in the model call
    of each of ``ticks`` — "decode" the one with the least work, "max"
    the one with the most.  On each: the wrapper (which must take the
    TMA / wgmma kernel), the WMMA kernel of moe_gmm.cu called through the
    library on the same inputs, torch.bmm, the plain version and the
    bound; the first three also after a clean flush.  Returns a row per
    call, keyed by path, projection, tick and shapes."""
    rows = {}
    for proj, key in (("gate", "moe_gmm"), ("down", "moe_gmm_down")):
        sized = sorted(recs[key], key=lambda c: gmm_work(*c[0])[1])
        picked = {"decode": sized[0], "max": sized[-1]}
        for tick in ticks:
            (xe, w), _ = picked[tick]
            nbytes, flops = gmm_work(xe, w)
            exp = ref.moe_gmm(xe, w)
            before = ops.LAUNCHES["moe_gmm_wgmma"]
            got = ops.moe_gmm(xe, w)
            if ops.LAUNCHES["moe_gmm_wgmma"] != before + 1:
                raise AssertionError(f"moe_gmm {proj} {tick} did not take "
                                     f"the TMA / wgmma kernel")
            old = torch.empty_like(got)
            wmma = partial(wmma_gmm, xe, w, old)
            if wmma():
                raise AssertionError("the WMMA kernel did not launch")
            lib_out = torch.bmm(xe, w)
            torch.cuda.synchronize()
            err, old_err = max_err(got, exp), max_err(old, exp)
            if not (close(got, exp, 2e-2) and close(old, exp, 2e-2)):
                raise AssertionError(f"moe_gmm {proj} {tick} disagrees on "
                                     f"main-path inputs: {err}, WMMA "
                                     f"{old_err}")
            errs["moe_gmm"].append(err)
            errs["moe_gmm_wmma"].append(old_err)
            run = partial(ops.moe_gmm, xe, w)
            bmm = partial(torch.bmm, xe, w)
            k_ms, w_ms, l_ms = (time_ms(f, 20, flush)
                                for f in (run, wmma, bmm))
            k_cl, w_cl, l_cl = (time_ms(f, 20, flush, clean=True)
                                for f in (run, wmma, bmm))
            p_ms = time_ms(partial(ref.moe_gmm, xe, w), 5, flush)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            print(f"[measure] moe_gmm {path} {proj} ({tick} tick) on "
                  f"main-path inputs {tuple(xe.shape)} x {tuple(w.shape)}: "
                  f"TMA/wgmma {k_ms:.4f} ms, WMMA {w_ms:.4f} ms, bmm "
                  f"{l_ms:.4f} ms, plain {p_ms:.4f} ms; after a clean flush "
                  f"TMA/wgmma {k_cl:.4f}, WMMA {w_cl:.4f}, bmm {l_cl:.4f} "
                  f"ms; bound {bound:.4f} ms ({nbytes} bytes -> "
                  f"{t_bytes:.4f} ms, {flops} ops -> {t_ops:.4f} ms); "
                  f"max_abs_err {err:.3g} (WMMA {old_err:.3g}, bmm vs plain "
                  f"{max_err(lib_out, exp):.3g})")
            label = (f"{path}: {proj} {tick} "
                     f"{tuple(xe.shape)}x{tuple(w.shape)}")
            rows[label] = dict(
                ms=k_ms, wmma_ms=w_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=float(bound),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                clean_ms=k_cl, wmma_clean_ms=w_cl, library_clean_ms=l_cl)
    return rows


@phase("measure")
def phase_measure_moe(recs, errs):
    """Time moe_gmm (``measure_gmm``) and rao_scatter_add on the granite
    chunked path's own inputs (layer 0's call in a decode tick and in the
    tick with the most work; the record keeps the gate's and the
    scatter's at the latter, and both kernels' other calls under
    ``shapes``), cold L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    shapes = measure_gmm(recs, errs, flush, "granite chunked")
    gate_max = next(v for k, v in shapes.items()
                    if k.startswith("granite chunked: gate max"))
    out = {"moe_gmm": dict(
        {k: v for k, v in gate_max.items() if "clean" not in k},
        shapes=shapes)}
    rows = measure_rao(recs, errs, flush, "granite chunked", ("decode", "max"))
    top = next(v for k, v in rows.items() if " max " in k)
    out["rao_scatter_add"] = dict(
        {k: v for k, v in top.items() if "clean" not in k}, shapes=rows)
    return out


def measure_rao(recs, errs, flush, path, ticks):
    """Time rao_scatter_add at layer 0's call of a granite path in each of
    ``ticks`` ("decode": the model call with the fewest updates, "max":
    the one with the most), on the path's own idx and vals into the zero
    table the path passes: the wrapper (which must take the on-chip
    kernel), the three-launch kernel of rao_scatter.cu called through the
    library, index_add_ and the plain version, the first three after a
    dirty and after a clean L2 flush; and the bound.  Returns a row per
    call, keyed by path, tick and M."""
    sized = sorted(recs["rao_scatter_add"], key=lambda c: rao_work(*c[0])[1])
    picked = {"decode": sized[0], "max": sized[-1]}
    rows = {}
    for label in ticks:
        (table, idx, vals), _ = picked[label]
        N, D = table.shape
        nbytes, flops = rao_work(table, idx, vals)
        zero = torch.zeros_like(table)        # the path's input
        exp = ref.rao_scatter_add(zero, idx, vals)
        before = ops.LAUNCHES["rao_scatter_add_onchip"]
        got = ops.rao_scatter_add(zero.clone(), idx, vals)
        if ops.LAUNCHES["rao_scatter_add_onchip"] != before + 1:
            raise AssertionError("rao_scatter_add did not take the on-chip "
                                 "kernel")
        old = zero.clone()
        if old_rao(old, idx, vals):
            raise AssertionError("the three-launch rao_scatter_add kernel did "
                                 "not launch")
        lib = zero.clone().index_add_(0, idx, vals)
        torch.cuda.synchronize()
        err, old_err = max_err(got, exp), max_err(old, exp)
        if not (close(got, exp, 2e-2) and close(old, exp, 2e-2)):
            raise AssertionError(f"rao_scatter_add disagrees on main-path "
                                 f"inputs: {err} (three-launch {old_err})")
        errs["rao_scatter_add"].append(err)
        errs["rao_scatter_add_old"].append(old_err)
        # each accumulates into its own copy, in place, call after call
        run = partial(ops.rao_scatter_add, zero.clone(), idx, vals)
        three = partial(old_rao, zero.clone(), idx, vals)
        index_add = partial(zero.clone().index_add_, 0, idx, vals)
        k_ms, o_ms, l_ms = (time_ms(f, 20, flush)
                            for f in (run, three, index_add))
        k_cl, o_cl, l_cl = (time_ms(f, 20, flush, clean=True)
                            for f in (run, three, index_add))
        p_ms = time_ms(partial(ref.rao_scatter_add, zero, idx, vals), 5,
                       flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[measure] rao_scatter_add ({path}, {label}) on main-path "
              f"inputs table {tuple(table.shape)} idx {tuple(idx.shape)} vals "
              f"{tuple(vals.shape)}: on-chip {k_ms:.4f} ms, three-launch "
              f"{o_ms:.4f} ms, index_add_ {l_ms:.4f} ms, plain {p_ms:.4f} ms;"
              f" after a clean flush on-chip {k_cl:.4f}, three-launch "
              f"{o_cl:.4f}, index_add_ {l_cl:.4f} ms; bound {bound:.4f} ms "
              f"({nbytes} bytes -> {t_bytes:.4f} ms, {flops} ops -> "
              f"{t_ops:.4f} ms); max_abs_err {err:.3g} (three-launch "
              f"{old_err:.3g}, index_add_ vs plain {max_err(lib, exp):.3g});"
              f" {rao_geometry_line(N, idx.shape[0], D)}")
        rows[f"{path}: {label} M {idx.shape[0]}"] = dict(
            ms=k_ms, old_ms=o_ms, plain_ms=p_ms, library_ms=l_ms,
            bound_ms=float(bound),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            clean_ms=k_cl, old_clean_ms=o_cl, library_clean_ms=l_cl)
    return rows


@phase("measure")
def phase_measure_paged(recs, errs, path):
    """Time paged_prefill_attention (``measure_prefill``) and
    paged_attention (``measure_decode``) on another chunked path's own
    inputs; returns each one's row under its label."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    out = {}
    for name, measure in (("paged_prefill_attention", measure_prefill),
                          ("paged_attention", measure_decode)):
        row, label = measure(recs, errs, flush, path)
        out[name] = {label: row}
    return out


@phase("measure")
def phase_measure_moe_oneshot(recs, errs):
    """Time moe_gmm (``measure_gmm``) at the capacity one-shot path's
    largest gate and down calls (a group call), whose shapes take other
    tile widths than the chunked path's, and rao_scatter_add
    (``measure_rao``) at its largest group call (two row tiles), cold L2;
    returns each one's rows."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    return {"moe_gmm": measure_gmm(recs, errs, flush, "granite one-shot",
                                   ("max",)),
            "rao_scatter_add": measure_rao(recs, errs, flush,
                                           "granite one-shot", ("max",))}


def flash_work(q, k, window):
    """Bytes and flops of one causal flash_attention call: q, k, v read
    once and the output written once; 4 hd flops (q.k and p.v) per live
    (query, key) pair of each query head."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    c = np.arange(S)
    live = np.minimum(c + 1, T)
    if window:
        live = np.minimum(live, window)
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * q.element_size()
    return nbytes, 4 * hd * H * B * int(live.sum())


def rms_work(x, w):
    """Bytes and f32 operations of one rmsnorm call: x read and the output
    written once, w once; square, sum, scale and weight per element."""
    D = x.shape[-1]
    N = x.numel() // D
    return (2 * N * D + D) * x.element_size(), 4 * N * D


@phase("measure")
def phase_measure_oneshot(recs, errs, name):
    """Time flash_attention and rmsnorm on a one-shot or dense-cache
    path's own inputs (layer 0's call in its smallest model call, a
    decode tick, and its largest), cold L2, beside the plain version and
    one library call the port never makes:
    scaled_dot_product_attention(is_causal, enable_gqa) and F.rms_norm;
    rmsnorm also beside the one-warp kernel of rmsnorm.cu called through
    the library, and each after a clean flush too.  Returns per kernel the
    largest call's row and, under ``shapes``, both."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for kname in ONESHOT:
        calls = recs[kname]
        if kname == "flash_attention":
            sized = sorted(calls, key=lambda c: flash_work(
                c[0][0], c[0][1], c[1].get("window", 0))[1])
        else:
            sized = sorted(calls, key=lambda c: c[0][0].numel())
        rows = {}
        for label, (args, kw) in (("smallest", sized[0]), ("max", sized[-1])):
            old = None
            if kname == "flash_attention":
                q, k, v = args
                window = kw.get("window", 0)
                if window:
                    raise AssertionError("the served configs have no window")
                nbytes, n_ops = flash_work(q, k, window)
                t_ops = n_ops / BF16_FLOPS * 1e3
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                run = partial(ops.flash_attention, q, k, v, **kw)
                plain = partial(ref.flash_attention, q, k, v, **kw)
                library = partial(sdpa, qt, kt, vt, is_causal=True,
                                  enable_gqa=True)
                lib = library().transpose(1, 2)
                lib_name = "sdpa(is_causal, enable_gqa)"
                shape = f"q {tuple(q.shape)} k {tuple(k.shape)}"
            else:
                x, w, eps = args
                nbytes, n_ops = rms_work(x, w)
                t_ops = n_ops / F32_FLOPS * 1e3
                w1 = (1.0 + w.float()).to(x.dtype)
                run = partial(ops.rmsnorm, x, w, eps)
                plain = partial(ref.rmsnorm, x, w, eps)
                library = partial(torch.nn.functional.rms_norm, x,
                                  (x.shape[-1],), w1, eps)
                lib = library()
                lib_name = "F.rms_norm"
                shape = f"x {tuple(x.shape)}"
                old_out = torch.empty_like(x)
                old = partial(old_rmsnorm, x, w, eps, old_out)
                if old():
                    raise AssertionError("the one-warp rmsnorm kernel did "
                                         "not launch")
            exp = plain()
            before = dict(ops.LAUNCHES)
            got = run()
            if kname == "rmsnorm" and ops.LAUNCHES["rmsnorm_row"] != \
                    before["rmsnorm_row"] + 1:
                raise AssertionError("rmsnorm did not take the row-spread "
                                     "kernel")
            torch.cuda.synchronize()
            err = max_err(got, exp)
            if not close(got, exp, 2e-2):
                raise AssertionError(f"{kname} disagrees on main-path inputs:"
                                     f" {err}")
            errs[kname].append(err)
            lib_err = max_err(lib, exp)
            k_ms = time_ms(run, 20, flush)
            p_ms = time_ms(plain, 5, flush)
            l_ms = time_ms(library, 20, flush)
            k_cl = time_ms(run, 20, flush, clean=True)
            l_cl = time_ms(library, 20, flush, clean=True)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=float(bound),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       clean_ms=k_cl, library_clean_ms=l_cl)
            old_note = ""
            if old is not None:
                old_err = max_err(old_out, exp)
                if not close(old_out, exp, 2e-2):
                    raise AssertionError(f"the one-warp rmsnorm kernel "
                                         f"disagrees on main-path inputs: "
                                         f"{old_err}")
                errs["rmsnorm_old"].append(old_err)
                row.update(old_ms=time_ms(old, 20, flush),
                           old_clean_ms=time_ms(old, 20, flush, clean=True))
                old_note = (f", one-warp kernel {row['old_ms']:.4f} ms (clean "
                            f"flush {row['old_clean_ms']:.4f}; max_abs_err "
                            f"{old_err:.3g}); {rms_geometry_line(x)}")
            print(f"[measure] {kname} ({name}, {label} call) on main-path "
                  f"inputs {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                  f"ms, {lib_name} {l_ms:.4f} ms (library vs plain "
                  f"max_abs_err {lib_err:.3g}); after a clean flush kernel "
                  f"{k_cl:.4f}, library {l_cl:.4f} ms; bound {bound:.4f} ms "
                  f"({nbytes} bytes -> {t_bytes:.4f} ms, {n_ops} ops -> "
                  f"{t_ops:.4f} ms); max_abs_err {err:.3g}{old_note}")
            rows[f"{name}: {label} {shape}"] = row
        top = next(v for k, v in rows.items() if ": max " in k)
        out[kname] = dict({k: v for k, v in top.items() if "clean" not in k},
                          shapes=rows)
    return out


def ssd_work(x, Bm, A, chunk):
    """Bytes and f32 operations of one ssd_scan call.  Bytes: x, B, C, dt
    and A read once, y and the final state written once.  Operations,
    counted for this call's L chunk by chunk (Lc steps, P = Lc (Lc + 1) / 2
    causal pairs): C.B^T once per (row, chunk), 2 S per pair, since it does
    not depend on the head; then per (row, head) the decay and dt of each
    pair (3), the intra-chunk product (2 hd per pair), the inter-chunk
    product and its scale (Lc hd (2 S + 1)), the state's weights, update
    and decay (Lc hd + 2 Lc S hd + S hd); an exp counts as one.  All of it
    at the f32 rate of the CUDA cores is the "f32-FMA bound"."""
    B, L, h, hd = x.shape
    S = Bm.shape[-1]
    nbytes = x.numel() * x.element_size() \
        + 4 * (2 * B * L * S + B * L * h + h) \
        + 4 * (B * L * h * hd + B * h * hd * S)
    n_ops = 0
    for t0 in range(0, L, chunk):
        Lc = min(chunk, L - t0)
        pairs = Lc * (Lc + 1) // 2
        per_head = pairs * (3 + 2 * hd) + Lc * hd * (2 * S + 1) \
            + Lc * hd + 2 * Lc * S * hd + S * hd
        n_ops += B * 2 * S * pairs + B * h * per_head
    return nbytes, n_ops


def ssd_tc_work(x, Bm, chunk):
    """The same call's work as the tensor-core kernel does it: (TF32
    tensor-core flops, bf16 tensor-core flops, f32 operations).  The
    products of ssd_work (C.B^T once per (row, chunk) over its causal
    pairs, M.x, C.st^T, (B^T w).x), 2 flops a multiply-add, each run as
    three passes: TF32 for two f32 operands (C.B^T, C.st^T, and every
    product with f32 x), bf16 for the products with a bf16 x as an
    operand (M.x and (B^T w).x); C.st^T only after a row's first chunk,
    where the state is not 0.  CUDA cores: the decay and dt of each pair
    (3), the inter term's scale, the state's decay and weights."""
    B, L, h, hd = x.shape
    S = Bm.shape[-1]
    tf32, bf16, f32 = 0, 0, 0
    for t0 in range(0, L, chunk):
        Lc = min(chunk, L - t0)
        pairs = Lc * (Lc + 1) // 2
        carry = t0 > 0
        x_flops = 2 * 3 * B * h * (pairs * hd + Lc * S * hd)
        tf32 += 2 * 3 * (B * S * pairs + B * h * carry * Lc * S * hd)
        if x.dtype == torch.bfloat16:
            bf16 += x_flops
        else:
            tf32 += x_flops
        f32 += B * h * (3 * pairs + carry * (Lc * hd + S * hd) + Lc * hd)
    return tf32, bf16, f32


@phase("measure")
def phase_measure_ssd(recs, errs):
    """Time ssd_scan on the zamba2 path's own inputs (layer 0's call in
    its smallest and its largest group call), after a dirty and after a
    clean L2 flush: the wrapper (the tensor-core kernel, two launches)
    beside the CUDA-core kernel of ssd_scan.cu called through the library
    and the plain version; no single PyTorch call computes an SSD scan
    (library: none).  Prints each call's launch geometry, the kernel's
    registers and spills; the record keeps the largest call and, under
    ``shapes``, both."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    sized = sorted(recs["ssd_scan"], key=lambda c: c[0][0].shape[1])
    rows = {}
    for label, (args, kw) in (("smallest", sized[0]), ("max", sized[-1])):
        x, Bm, Cm, dt, A = args
        chunk = kw["chunk"]
        nbytes, n_ops = ssd_work(x, Bm, A, chunk)
        tf32_flops, bf16_flops, f32_ops = ssd_tc_work(x, Bm, chunk)
        run = partial(ops.ssd_scan, *args, **kw)
        plain = partial(ref.ssd_scan, *args, **kw)
        oy = torch.empty(x.shape, dtype=torch.float32, device=DEV)
        ost = torch.empty(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1],
                          dtype=torch.float32, device=DEV)
        old = partial(cuda_core_ssd, args, kw, oy, ost)
        before = ops.LAUNCHES["ssd_scan_mma"]
        y, st = run()
        if ops.LAUNCHES["ssd_scan_mma"] != before + 1:
            raise AssertionError("ssd_scan did not take the tensor-core "
                                 "kernel")
        if old():
            raise AssertionError("the CUDA-core ssd_scan kernel did not "
                                 "launch")
        ey, est = plain()
        torch.cuda.synchronize()
        err = max(max_err(y, ey), max_err(st, est))
        old_err = max(max_err(oy, ey), max_err(ost, est))
        if not (close(y, ey, 1e-3) and close(st, est, 1e-3)
                and close(oy, ey, 1e-3) and close(ost, est, 1e-3)):
            raise AssertionError(f"ssd_scan disagrees on main-path inputs: "
                                 f"{err} (CUDA-core kernel {old_err})")
        errs["ssd_scan"].append(err)
        errs["ssd_scan_cuda_core"].append(old_err)
        k_ms, o_ms = (time_ms(f, 20, flush) for f in (run, old))
        k_cl, o_cl = (time_ms(f, 20, flush, clean=True) for f in (run, old))
        p_ms = time_ms(plain, 5, flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(tf32_flops / TF32_FLOPS + bf16_flops / BF16_FLOPS,
                    f32_ops / F32_FLOPS) * 1e3
        t_fma = n_ops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[measure] ssd_scan ({label} group call) on main-path inputs "
              f"x {tuple(x.shape)} {str(x.dtype)[6:]} B/C "
              f"{tuple(Bm.shape)} chunk {chunk}: tensor-core kernel "
              f"{k_ms:.4f} ms, CUDA-core kernel {o_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library: none; after a clean flush "
              f"tensor-core {k_cl:.4f}, CUDA-core {o_cl:.4f} ms; bound "
              f"{bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} ms, "
              f"{tf32_flops} TF32-pass flops at 495 TFLOP/s, {bf16_flops} "
              f"bf16-pass flops at 989 and {f32_ops} f32 ops -> "
              f"{t_ops:.4f} ms); f32-FMA bound {t_fma:.4f} ms "
              f"({n_ops} f32 ops); max_abs_err {err:.3g} (CUDA-core "
              f"{old_err:.3g})")
        print(f"[measure] ssd_scan ({label} group call) geometry: "
              f"{ssd_geometry_line(x, Bm.shape[-1], chunk)}")
        rows[f"zamba2 dense: {label} {tuple(x.shape)}"] = dict(
            ms=k_ms, cuda_core_ms=o_ms, plain_ms=p_ms, library_ms=None,
            bound_ms=float(bound),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            f32_fma_bound_ms=float(t_fma), clean_ms=k_cl,
            cuda_core_clean_ms=o_cl)
    top = next(v for k, v in rows.items() if k.startswith("zamba2 dense: max"))
    return {"ssd_scan": dict({k: v for k, v in top.items()
                              if "clean" not in k}, shapes=rows)}


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# device kernels by name: ours (attention, norms, moe_gmm, the rao
# kernels) and cuBLAS's matmuls
PROFILE_PARTS = (
    ("paged attention", ("paged",)),
    ("flash_attention", ("flash_attention",)),
    ("rmsnorm", ("rmsnorm",)),
    ("moe_gmm", ("moe_gmm",)),
    ("ssd_scan", ("ssd_scan", "ssd_cb")),
    ("rao_scatter_add", ("rao_scatter", "scatter_add_kernel",
                         "widen_kernel", "narrow_kernel")),
    ("cuBLAS gemm", ("gemm", "xmma", "cutlass", "nvjet")),
)


@phase("profile")
def phase_profile(srv, seed=1):
    """Device time by kernel, and the device's busy share, over one chunk
    tick (8 slots x 64 tokens; one-shot and dense-cache: the admission
    tick, two group calls of 4 x 200 tokens and a decode) and three decode
    ticks (8 slots) of the full-width engine, traced with
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(seed)
    vocab = srv.model.cfg.vocab
    for i in range(srv.slots):
        srv.submit_wire(encode_request(
            1000 + i, rng.randint(1, vocab - 1, size=200).tolist(), 16))
    if srv.prefill_chunk:
        srv.step()                          # admit + first 64-token chunk
        windows = (("chunk", 1), ("skip", 2), ("decode", 3))
    else:
        windows = (("admit", 1), ("decode", 3))
    torch.cuda.synchronize()
    for label, ticks in windows:
        if label == "skip":                 # rest of the prompts
            for _ in range(ticks):
                srv.step()
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                srv.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if "cuda" in str(e.device_type).lower() and _device_us(e)]
        busy = sum(_device_us(e) for e in kern) / 1e3
        parts = {}
        for part, words in PROFILE_PARTS:
            parts[part] = sum(_device_us(e) for e in kern
                              if any(w in e.key.lower() for w in words)) / 1e3
        other = busy - sum(parts.values())
        print(f"[profile] {srv.model.cfg.name} {label} x{ticks}: wall "
              f"{wall:.3f} ms, device busy {busy:.3f} ms "
              f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f", other {other:.3f} ms")
        for e in sorted(kern, key=_device_us, reverse=True)[:8]:
            print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
                  f"{e.key[:90]}")
    srv.run_until_drained()



def free_device():
    """Drop a finished path's engine: its hooks are closures that hold the
    engine, a reference cycle, so collect it before the allocator's cache
    is emptied and the next path's peak memory is read."""
    gc.collect()
    torch.cuda.empty_cache()

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="device, build and kernel phases only; prints no "
                         "result line")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill (or admission) tick and "
                         "three decode ticks of each full-width engine "
                         "with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    kind, card = phase_device()
    phase_build()
    errs = {name: [] for name in (*KERNELS, "moe_gmm_wmma",
                                  "paged_prefill_attention_cuda_core",
                                  "paged_attention_unsplit",
                                  "ssd_scan_cuda_core", "rao_scatter_add_old",
                                  "rmsnorm_old")}
    phase_kernels(errs)
    if args.quick:
        return 0
    phase_tiny()
    by_path = {}
    name, by_path[name], recs, srv, chunked = phase_serve("mistral chunked",
                                                          card)
    meas = phase_measure(recs, errs)
    if args.profile:
        phase_profile(srv)
    del srv, recs                      # free the arena and the params
    free_device()
    name, by_path[name], recs, srv, _ = phase_serve("mistral one-shot", card)
    meas.update(phase_measure_oneshot(recs, errs, name))
    if args.profile:
        phase_profile(srv)
    del srv, recs                      # free mistral's 24.5 GB of params
    free_device()
    # the tiered near/far arena against its untiered twin, then the
    # asyncio engine against the sync chunked run
    runs = {}
    for path in ("mistral tiered flat", "mistral tiered", "mistral async"):
        name, by_path[name], recs, srv, runs[path] = phase_serve(path, card)
        del srv, recs
        free_device()
    first_token_drift(runs["mistral tiered flat"], runs["mistral tiered"],
                      16, "tiered vs flat")
    first_token_drift(chunked, runs["mistral async"], 16, "async vs sync")
    del runs, chunked
    name, by_path[name], recs, srv, _ = phase_serve("granite chunked", card)
    meas.update(phase_measure_moe(recs, errs))
    for name, rows in phase_measure_paged(recs, errs,
                                          "granite chunked").items():
        meas[name]["shapes"].update(rows)
    if args.profile:
        phase_profile(srv)
    del srv, recs
    free_device()
    name, by_path[name], recs, srv, _ = phase_serve("granite one-shot", card)
    for kname, rows in phase_measure_oneshot(recs, errs, name).items():
        meas[kname]["shapes"].update(rows["shapes"])
    for kname, rows in phase_measure_moe_oneshot(recs, errs).items():
        meas[kname]["shapes"].update(rows)
    if args.profile:
        phase_profile(srv)
    del srv, recs
    free_device()
    name, by_path[name], recs, srv, _ = phase_serve("zamba2 dense", card)
    meas.update(phase_measure_ssd(recs, errs))
    for kname, rows in phase_measure_oneshot(recs, errs, name).items():
        meas[kname]["shapes"].update(rows["shapes"])
    if args.profile:
        phase_profile(srv)
    del srv, recs
    free_device()
    name, by_path[name], recs, srv, _ = phase_serve("danube chunked", card)
    for kname, rows in phase_measure_paged(recs, errs,
                                           "danube chunked").items():
        meas[kname]["shapes"].update(rows)
    if args.profile:
        phase_profile(srv)
    del srv, recs
    free_device()
    name, by_path[name], recs, srv, _ = phase_serve("danube one-shot", card)
    if args.profile:
        phase_profile(srv)
    del srv, recs
    free_device()
    runs = []
    for path in ("danube prefix cold", "danube prefix"):
        name, by_path[name], recs, srv, run = phase_serve(path, card)
        runs.append(run)
        del srv, recs
        free_device()
    compare_prefix(*runs)
    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=sum(n[name] for n in by_path.values()),
             launches_by_path={a: n[name] for a, n in by_path.items()},
             max_abs_err=max(errs[name]), **meas[name])
        for name in KERNELS]}
    # every bf16 paged_attention launch of the main path is the split-KV
    # kernel's (phase 5); the one-CTA kernel is timed beside
    dec = next(k for k in record["kernels"] if k["name"] == "paged_attention")
    dec["launches_split"] = sum(n["paged_attention_split"]
                                for n in by_path.values())
    dec["unsplit_max_abs_err"] = max(errs["paged_attention_unsplit"])
    # every bf16 paged_prefill_attention launch of the main path is the
    # tensor-core kernel's (phase 5); the CUDA-core kernel is timed beside
    pre = next(k for k in record["kernels"]
               if k["name"] == "paged_prefill_attention")
    pre["launches_mma"] = sum(n["paged_prefill_attention_mma"]
                              for n in by_path.values())
    pre["cuda_core_max_abs_err"] = max(
        errs["paged_prefill_attention_cuda_core"])
    flash = next(k for k in record["kernels"]
                 if k["name"] == "flash_attention")
    flash["launches_mma"] = sum(n["flash_attention_mma"]
                                for n in by_path.values())
    # every bf16 moe_gmm launch of the main path is the TMA / wgmma
    # kernel's (phase 5); moe_gmm.cu's WMMA kernel is timed beside it
    gmm = next(k for k in record["kernels"] if k["name"] == "moe_gmm")
    gmm["launches_wgmma"] = sum(n["moe_gmm_wgmma"]
                                for n in by_path.values())
    gmm["wmma_max_abs_err"] = max(errs["moe_gmm_wmma"])
    # every ssd_scan call of the main path is the tensor-core kernel's
    # (phase 5); ssd_scan.cu's CUDA-core kernel is timed beside it
    ssd = next(k for k in record["kernels"] if k["name"] == "ssd_scan")
    ssd["launches_mma"] = sum(n["ssd_scan_mma"] for n in by_path.values())
    ssd["cuda_core_max_abs_err"] = max(errs["ssd_scan_cuda_core"])
    # every bf16 rao_scatter_add call of the main path is the on-chip
    # kernel's and every rmsnorm call the row-spread kernel's (phase 5);
    # the kernels they replaced are timed beside them (old_source)
    rao = next(k for k in record["kernels"] if k["name"] == "rao_scatter_add")
    rao["launches_onchip"] = sum(n["rao_scatter_add_onchip"]
                                 for n in by_path.values())
    rao["old_max_abs_err"] = max(errs["rao_scatter_add_old"])
    rms = next(k for k in record["kernels"] if k["name"] == "rmsnorm")
    rms["launches_row"] = sum(n["rmsnorm_row"] for n in by_path.values())
    rms["old_max_abs_err"] = max(errs["rmsnorm_old"])
    print(f"[total] wall {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
