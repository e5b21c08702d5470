"""Chip smoke test of the PyTorch port: builds the hand-written CUDA
kernels from this checkout and drives the serving engine on one card:
the paged plane for the dense family (mistral-nemo-12b) and the moe
family (granite-moe-3b-a800m), each with chunked and with one-shot
prefill, and the dense-cache plane for the hybrid family (zamba2-7b).

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build, kernel checks only
    python3 chip_smoke.py --profile  # also trace the five engines

Phases (each prints its own lines and wall time; any failure raises):
  1. device   — card name, and name + power limit from nvidia-smi;
  2. build    — all seven kernels (flash_attention and moe_gmm as two
                sources each: the bf16 tensor-core kernels
                flash_attention_mma.cu and moe_gmm_wgmma.cu, and the f32
                ones), one nvcc process per source (kernels/build.py),
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
                CENTRAL: every update on one row); flash_attention at the
                three models' head shapes (32/8 x 128, 24/8 x 64, 32/32 x
                112), S in {17, 64, 189, 209, 300} (the main path's 189
                and 209; 17 and 300 no multiple of 16 or 64), B in {1, 4},
                windowed cases, S != T causal and not, and odd head dims
                (8, 40, 200: zero-padded to 16 in the bf16 kernel), each
                in bf16 (tensor-core kernel) and f32 (CUDA-core kernel);
                rmsnorm at D in {64, 1536, 3584, 5120, 7168}, N in
                {1, 8, 1200}; ssd_scan (y and final state) at zamba2's
                heads (h 112, hd 64, S 64) with L a multiple of 128, L
                ragged, one chunk and several, plus odd small shapes.
                Tolerance: the attention kernels |got - plain| <= tol, the
                others |got - plain| <= tol + tol * |plain|, with tol =
                2e-2 in bf16 and 1e-4 in f32 (TF32 off); ssd_scan 1e-3 in
                f32 (the JAX suite's test_ssd_scan_sweep), 2e-2 normwise
                with x in bf16;
  4. tiny     — tiny f32 engines, each on the card (kernels) and on the
                CPU (plain versions) with identical greedy tokens: dense
                and dropless MoE on the chunked plane (a ragged trace),
                dense one-shot with prefill_batch 1 (ragged) and 4,
                capacity-routed MoE one-shot with prefill_batch 4, and a
                5-layer hybrid (2 groups of 2 Mamba2 layers and a tail
                layer) on the dense-cache plane with prefill_batch 4 (a
                trace of equal-length neighbours, so admission groups and
                waves form);
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
                L per chunk tick, paged_attention L per decode tick,
                flash_attention L per group call, rmsnorm 2L + 1 per model
                call, moe_gmm 3L and rao_scatter_add L per model call;
                zamba2: ssd_scan 81 and flash_attention 13 per group call,
                rmsnorm 189 per model call, no paged kernel; every bf16
                flash_attention launch on the tensor-core kernel
                (LAUNCHES["flash_attention_mma"] equal to
                LAUNCHES["flash_attention"]) and every bf16 moe_gmm launch
                on the TMA / wgmma kernel (LAUNCHES["moe_gmm_wgmma"] equal
                to LAUNCHES["moe_gmm"]), neither in the f32 tiny engines;
  6. measure  — on inputs each main path itself produced, each kernel's
                time beside its plain version's, one PyTorch library call
                that computes the same function (never called by the port:
                scaled_dot_product_attention, torch.bmm, index_add_,
                F.rms_norm; none for ssd_scan) and its bound at 3.35 TB/s,
                989 TFLOP/s bf16 (matmul work) and 67 TFLOP/s f32
                (elementwise and SSD scan work); moe_gmm at four calls
                of the granite chunked path (the gate and the down
                projection, each at decode and in the tick with the most
                work) and two of the capacity one-shot path (its largest
                gate and down group calls), the TMA / wgmma kernel beside
                the WMMA kernel called through the library on the same
                inputs, each also timed after an L2 flush that leaves no
                dirty lines.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
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
from repro_torch.runtime.server import (  # noqa: E402
    BatchServer, encode_request,
)

HBM_BYTES_PER_S = H100_HBM_STREAM_GBs * 1e9   # H100 SXM, published
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor peak
F32_FLOPS = 67e12                # H100 SXM f32 peak outside the tensor cores
KERNELS = {
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:132"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        replaces="src/repro/kernels/paged_prefill_attention.py:157"),
    "moe_gmm": dict(
        source="src/repro_torch/kernels/csrc/moe_gmm_wgmma.cu",
        wmma_source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:62"),
    "rao_scatter_add": dict(
        source="src/repro_torch/kernels/csrc/rao_scatter.cu",
        replaces="src/repro/kernels/rao_scatter.py:53"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_mma.cu",
        f32_source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:99"),
    "rmsnorm": dict(
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:29"),
    "ssd_scan": dict(
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:75"),
}
ATTENTION = ("paged_attention", "paged_prefill_attention")
MOE = ("moe_gmm", "rao_scatter_add")
ONESHOT = ("flash_attention", "rmsnorm")
DENSE_ARCH, MOE_ARCH = "mistral-nemo-12b", "granite-moe-3b-a800m"
HYBRID_ARCH = "zamba2-7b"
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
                neg_inside=(), masked=()):
    """Random q / arena / new kv on the card with a shuffled block table
    covering ``lens`` tokens per slot; ``neg_inside`` entries become -1,
    ``masked`` slots get all--1 rows."""
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
        if m:   # the kernel's name, its int template arguments (the bf16
            # flash kernel's padded head dim, moe_gmm_wgmma's tile) and
            # the bf16 mark
            kernel, rest = _last_name(m.group(1))
            args = re.match(r"I((?:Li\d+E)+)E", rest)
            targs = re.findall(r"Li(\d+)E", args.group(1)) if args else []
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
    B, H, K, hd, bt = 8, 32, 8, 128, 16
    nb = 512 // bt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens = [0, 16, 17, 100, 255, 300, 511, 64]       # 0 = masked slot
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for window in (0, 100):
            q, kp, vp, btab, kn, vn = pool_inputs(
                rng, B, H, K, hd, bt, nb, lens, dtype,
                neg_inside=((3, 1), (6, 0)), masked=(0,))
            ln = torch.tensor(lens, dtype=torch.int32, device=DEV)
            got = ops.paged_attention(q, kp, vp, btab, ln, kn, vn,
                                      window=window)
            exp = ref.paged_attention(q, kp, vp, btab, ln, kn, vn,
                                      window=window)
            torch.cuda.synchronize()
            e = max_err(got, exp)
            ok = bool(torch.isfinite(got).all()) and e <= tol
            k_ms = time_ms(lambda: ops.paged_attention(
                q, kp, vp, btab, ln, kn, vn, window=window), 10)
            p_ms = time_ms(lambda: ref.paged_attention(
                q, kp, vp, btab, ln, kn, vn, window=window), 3)
            print(f"[kernels] paged_attention {str(dtype)[6:]} window "
                  f"{window}: max_abs_err {e:.3g} (tol {tol}); kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"paged_attention disagrees: {e}")
            errs["paged_attention"].append(e)
            for C in (8, 64):
                ctx = [0, 0, 16, 37, 128, 200, 300, 448]   # 0,0: masked/new
                q, kp, vp, btab, kn, vn = pool_inputs(
                    rng, B, H, K, hd, bt, nb, [c + C for c in ctx], dtype,
                    C=C, neg_inside=((4, 0), (5, 2)), masked=(0,))
                cx = torch.tensor(ctx, dtype=torch.int32, device=DEV)
                got = ops.paged_prefill_attention(q, kp, vp, btab, cx, kn,
                                                  vn, window=window)
                exp = ref.paged_prefill_attention(q, kp, vp, btab, cx, kn,
                                                  vn, window=window)
                torch.cuda.synchronize()
                e = max_err(got, exp)
                ok = bool(torch.isfinite(got).all()) and e <= tol
                k_ms = time_ms(lambda: ops.paged_prefill_attention(
                    q, kp, vp, btab, cx, kn, vn, window=window), 10)
                p_ms = time_ms(lambda: ref.paged_prefill_attention(
                    q, kp, vp, btab, cx, kn, vn, window=window), 3)
                print(f"[kernels] paged_prefill_attention {str(dtype)[6:]} "
                      f"C {C} window {window}: max_abs_err {e:.3g} (tol "
                      f"{tol}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
                if not ok:
                    raise AssertionError(
                        f"paged_prefill_attention disagrees: {e}")
                errs["paged_prefill_attention"].append(e)
    check_moe_kernels(rng, errs)
    check_oneshot_kernels(rng, errs)
    check_ssd_kernel(rng, errs)


def close_normwise(got, exp, tol):
    """max |got - exp| <= tol * max |exp|, and finite."""
    g, e = got.float(), exp.float()
    return bool(torch.isfinite(g).all()) and \
        float((g - e).abs().max()) <= tol * float(e.abs().max())


def check_ssd_kernel(rng, errs):
    """ssd_scan's y and final state against the plain chunk math: zamba2's
    heads (h 112, hd 64, S 64, chunk 128) with L a multiple of 128 (two
    chunks), L ragged (209: a partial last chunk), one chunk; then small
    odd shapes (hd and S not multiples of 16, chunk not a power of two).
    dt = softplus(randn), as the model's projection gives it, or
    |randn| / 10 as the JAX suite draws it."""
    def rnd(shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(DEV)
    cases = [(2, 256, 112, 64, 64, 128, "softplus"),
             (4, 209, 112, 64, 64, 128, "softplus"),
             (2, 128, 112, 64, 64, 128, "small"),
             (1, 77, 3, 32, 16, 64, "small"),
             (2, 300, 2, 40, 24, 100, "softplus")]
    for B, L, h, hd, S, chunk, dts in cases:
        Bm, Cm = rnd((B, L, S)), rnd((B, L, S))
        raw = rnd((B, L, h))
        dt = torch.nn.functional.softplus(raw) if dts == "softplus" \
            else raw.abs() * 0.1
        A = -(rnd((h,)).abs() + 0.2) if dts == "small" \
            else -torch.exp(rnd((h,), 0.5))
        x32 = rnd((B, L, h, hd))
        for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            x = x32.to(dtype)
            before = ops.LAUNCHES["ssd_scan"]
            y, st = ops.ssd_scan(x, Bm, Cm, dt, A, chunk=chunk)
            ey, est = ref.ssd_scan(x, Bm, Cm, dt, A, chunk=chunk)
            torch.cuda.synchronize()
            e = max(max_err(y, ey), max_err(st, est))
            check = close if dtype == torch.float32 else close_normwise
            ok = check(y, ey, tol) and check(st, est, tol) and \
                ops.LAUNCHES["ssd_scan"] == before + 1
            print(f"[kernels] ssd_scan x {str(dtype)[6:]} B {B} L {L} h {h} "
                  f"hd {hd} S {S} chunk {chunk} dt {dts}: max_abs_err "
                  f"{e:.3g} (y max {float(ey.abs().max()):.3g}, state max "
                  f"{float(est.abs().max()):.3g}; tol {tol} "
                  f"{'abs + rel' if dtype == torch.float32 else 'normwise'})")
            if not ok:
                raise AssertionError(f"ssd_scan disagrees: {e}")
            errs["ssd_scan"].append(e)


def check_oneshot_kernels(rng, errs):
    """flash_attention at both served models' head shapes and rmsnorm at
    their widths (and the q/k-norm width), against the plain versions."""
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
                    (1, 65, 65, 8, 1, 200, 16, True)]
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
            print(f"[kernels] flash_attention{'_mma' if mma else ''} "
                  f"{str(dtype)[6:]} B {B} S {S} T {T} H {H} K {K} hd {hd} "
                  f"window {window} causal {causal}: max_abs_err {e:.3g} "
                  f"(tol {tol}), max|exp| {mag:.4g}")
            if not ok:
                raise AssertionError(f"flash_attention disagrees: {e}")
            errs["flash_attention"].append(e)
        print(f"[kernels] flash_attention {str(dtype)[6:]}: largest |exp| "
              f"over {len(flash_cases)} cases {top:.4g} (tol {tol})")
        for D in (64, 1536, 3584, 5120, 7168):
            for N in (1, 8, 1200):
                x = rnd((N, D), dtype)
                w = rnd((D,), dtype, 0.1)
                before = ops.LAUNCHES["rmsnorm"]
                got = ops.rmsnorm(x, w, 1e-5)
                exp = ref.rmsnorm(x, w, 1e-5)
                torch.cuda.synchronize()
                e = max_err(got, exp)
                ok = close(got, exp, tol) and \
                    ops.LAUNCHES["rmsnorm"] == before + 1
                print(f"[kernels] rmsnorm {str(dtype)[6:]} ({N}, {D}): "
                      f"max_abs_err {e:.3g} (tol {tol} abs + rel)")
                if not ok:
                    raise AssertionError(f"rmsnorm disagrees: {e}")
                errs["rmsnorm"].append(e)


def check_moe_kernels(rng, errs):
    """moe_gmm and rao_scatter_add against their plain versions at
    granite's shapes (E = 40 experts, d_model 1536, d_ff_expert 512)."""
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
        for name, N, M in (("duplicates", 9, 320), ("duplicates", 513, 20480),
                           ("CENTRAL", 513, 20480)):
            if name == "CENTRAL":           # every update on row 0, ones
                idx = torch.zeros(M, dtype=torch.int32, device=DEV)
                vals = torch.ones((M, Dm), dtype=dtype, device=DEV)
            else:
                idx = torch.from_numpy(rng.randint(0, N, size=M)
                                       .astype(np.int32)).to(DEV)
                vals = rnd((M, Dm), dtype)
            table = rnd((N, Dm), dtype)
            exp = ref.rao_scatter_add(table, idx, vals)
            before = ops.LAUNCHES["rao_scatter_add"]
            got = ops.rao_scatter_add(table, idx, vals)
            torch.cuda.synchronize()
            e = max_err(got, exp)
            ok = close(got, exp, tol) and got is table and \
                ops.LAUNCHES["rao_scatter_add"] == before + 1
            print(f"[kernels] rao_scatter_add {str(dtype)[6:]} {name} N {N} "
                  f"M {M} D {Dm}: max_abs_err {e:.3g} (tol {tol} abs + rel)")
            if not ok:
                raise AssertionError(f"rao_scatter_add disagrees: {e}")
            errs["rao_scatter_add"].append(e)


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


def drain_outputs(srv, trace):
    for i, (p, m) in enumerate(trace):
        srv.submit_wire(encode_request(i, p, m))
    out = {}
    for buf in srv.run_until_drained():
        msg = wire.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=128, param_dtype="float32", cache_dtype="float32")
CHUNKED_KERNELS = ("paged_prefill_attention", "paged_attention", "rmsnorm")
ONESHOT_KERNELS = ("flash_attention", "paged_attention", "rmsnorm")
HYBRID_KERNELS = ("ssd_scan", "flash_attention", "rmsnorm")


def leaked(srv):
    """Pages (paged plane) or pool blocks (dense plane) still held after a
    drain."""
    kv = srv.kv_stats()
    if kv["paged_kv"]:
        return kv["paged"]["pages_in_use"]
    return kv["blocks_allocated"] - kv["blocks_freed"]


@phase("tiny")
def phase_tiny():
    """Tiny f32 engines on the card (kernels) and on the CPU (plain):
    dense and dropless MoE (8 experts, top-2) chunked, then dense one-shot
    with prefill_batch 1 and 4, capacity-routed MoE one-shot with
    prefill_batch 4, and the 5-layer hybrid (layout 2 x 2 + 1 tail) on the
    dense-cache plane with prefill_batch 4."""
    dense = reduced(get_config(DENSE_ARCH)).replace(**TINY)
    moe = reduced(get_config(MOE_ARCH)).replace(**TINY)
    hybrid = reduced(get_config(HYBRID_ARCH)).replace(**dict(TINY,
                                                             n_layers=5))
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
    )
    for label, cfg, kw, make_trace, slots, kernels in engines:
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(3), "cpu")
        trace = make_trace(cfg.vocab)
        outs = {}
        for dev in ("cpu", "cuda"):
            p = params if dev == "cpu" else _tree_to(params, DEV)
            before = dict(ops.LAUNCHES)
            srv = BatchServer(model, batch_slots=slots, max_len=32, params=p,
                              device=dev, nic_cost=None, **kw)
            outs[dev] = drain_outputs(srv, trace)
            launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
            if leaked(srv):
                raise AssertionError(f"{label} {dev}: pages leaked")
            if dev == "cuda" and not all(launched[k] for k in kernels):
                raise AssertionError(f"tiny {label} skipped a kernel: "
                                     f"{launched}")
            if launched["flash_attention_mma"] or launched["moe_gmm_wgmma"]:
                raise AssertionError(f"the f32 tiny {label} engine took a "
                                     f"bf16 kernel: {launched}")
            if cfg.family == "hybrid" and \
                    any(launched[k] for k in ATTENTION + MOE):
                raise AssertionError(f"the tiny {label} engine launched a "
                                     f"paged or MoE kernel: {launched}")
            if dev == "cpu" and any(launched.values()):
                raise AssertionError(f"the CPU {label} engine launched a "
                                     f"kernel")
        same = outs["cpu"] == outs["cuda"]
        st = srv.stats
        print(f"[tiny] {label} ({cfg.family}): {len(outs['cuda'])} requests,"
              f" {st['prefills']} prefills, {st['prefill_chunks']} chunk "
              f"ticks; greedy tokens identical card vs CPU: {same}")
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


# the four served paths: (arch, label, moe routing, server options)
PATHS = {
    "mistral chunked": (DENSE_ARCH, "chunked", None, {}),
    "mistral one-shot": (DENSE_ARCH, "one-shot", None,
                         dict(prefill_chunk=0, prefill_batch=4)),
    "granite chunked": (MOE_ARCH, "dropless chunked", "dropless", {}),
    "granite one-shot": (MOE_ARCH, "capacity one-shot", "capacity",
                         dict(prefill_batch=4)),
    "zamba2 dense": (HYBRID_ARCH, "dense", None, dict(prefill_batch=4)),
}


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
           "paged_attention": L * decodes,
           "flash_attention": L * groups, "flash_attention_mma": 0,
           "rmsnorm": norms_per_call(cfg) * calls,
           "moe_gmm": 0, "moe_gmm_wgmma": 0, "rao_scatter_add": 0,
           "ssd_scan": 0}
    if cfg.family == "hybrid":
        exp["paged_attention"] = 0
        exp["flash_attention"] = transformer.hybrid_layout(cfg)[0] * groups
        exp["ssd_scan"] = L * groups
    if cfg.family == "moe":
        exp["moe_gmm"] = 3 * L * calls
        exp["rao_scatter_add"] = L * calls
    if cfg.param_dtype == "bfloat16":   # bf16 runs the tensor-core kernels
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
    srv = BatchServer(model, batch_slots=8, max_len=512, block_tokens=16,
                      params=params, device=DEV, sync_timers=True, **kw)
    del params
    oneshot = srv.prefill_chunk == 0
    rng = np.random.RandomState(seed)
    if not srv.paged:   # 2 waves of 8 equal prompt lengths (groups of 4)
        plens = np.repeat(rng.randint(17, 301, size=2), 8)
    elif oneshot:     # 4 groups of 4 equal prompt lengths, back to back
        plens = np.repeat(rng.randint(17, 301, size=4), 4)
    else:
        plens = rng.randint(17, 301, size=16)
    for i, n in enumerate(plens):
        srv.submit_wire(encode_request(
            i, rng.randint(1, cfg.vocab - 1, size=int(n)).tolist(), 32))
    finite = []
    group_rows = []

    def checked(step, rows=None):
        def run(*a):
            lg, out = step(*a)
            finite.append(torch.isfinite(lg).all())
            if rows is not None:
                rows.append(lg.shape[0])
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
    if srv.paged:
        srv._paged_decode = checked(srv._paged_decode)
        srv._chunk_prefill = checked(srv._chunk_prefill)
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
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with ExitStack() as stack:
        for r in recorders:
            stack.enter_context(r)
        bufs = srv.run_until_drained()
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
    print(f"[serve] {name}: {len(outs)}/16 drained, {st['failed']} failed, "
          f"{st['ticks']} ticks ({groups} group calls of {group_rows} rows, "
          f"{st['prefill_chunks']} chunk ticks, {st['decode_steps']} decode "
          f"ticks) in {wall:.2f} s; peak memory {peak:.2f} GiB [{card}]")
    prompt_toks = int(plens.sum())
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
    expected = expected_launches(cfg, st, groups)
    print(f"[serve] {name} launches {launches}; expected {expected}")
    if len(outs) != 16 or st["failed"] or \
            any(len(v) != 32 for v in outs.values()):
        raise AssertionError(f"requests not drained: {st}")
    if leaked(srv):
        raise AssertionError("pages leaked")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits on the main path")
    if oneshot and group_rows != [4] * 4:
        raise AssertionError(f"admission groups did not form: {group_rows}")
    if cfg.family == "hybrid":
        required = HYBRID_KERNELS
    else:
        required = (ONESHOT_KERNELS if oneshot else CHUNKED_KERNELS) + \
            (MOE if cfg.family == "moe" else ())
    if launches != expected or not all(launches[k] for k in required):
        raise AssertionError(f"launch counts do not match ticks: "
                             f"{launches} vs {expected}")
    return name, launches, recs, srv


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


def dense_inputs(q, kp, vp, btab, lens, kn, vn, *, chunk):
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
        mask = torch.cat([live, own[None].expand(B, C, C)], dim=-1)
        k = torch.cat([kg, kn], dim=1)
        v = torch.cat([vg, vn], dim=1)
        qd = q.transpose(1, 2)                         # (B, H, C, hd)
    else:
        live = pos[None] < L
        mask = torch.cat([live, torch.ones(B, 1, dtype=torch.bool,
                                           device=DEV)], dim=-1)[:, None]
        k = torch.cat([kg, kn[:, None]], dim=1)
        v = torch.cat([vg, vn[:, None]], dim=1)
        qd = q[:, :, None]                             # (B, H, 1, hd)
    k = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    return qd.contiguous(), k, v, mask[:, None]


@phase("measure")
def phase_measure(recs, errs):
    """Time each kernel on the main path's own inputs (the layer-0 call of
    the tick with the most attention work), cold L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in ATTENTION:
        calls = recs[name]
        best, best_w = None, -1
        for args, kw in calls:
            q, kp, vp, btab, lens, kn, vn = args
            l_h = lens.cpu().numpy()
            b_h = btab.cpu().numpy()
            work = (decode_work if name == "paged_attention"
                    else prefill_work)(q, b_h, l_h, kp, kw.get("window", 0))
            if work[1] > best_w:
                best, best_w = (args, kw, b_h, l_h, work), work[1]
        args, kw, b_h, l_h, (nbytes, flops) = best
        fn = getattr(ops, name)
        plain = getattr(ref, name)
        got = fn(*args, **kw)
        exp = plain(*args, **kw)
        torch.cuda.synchronize()
        err = max_err(got, exp)
        if err > 2e-2 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} disagrees on main-path inputs: "
                                 f"{err}")
        errs[name].append(err)
        k_ms = time_ms(lambda: fn(*args, **kw), 20, flush)
        p_ms = time_ms(lambda: plain(*args, **kw), 5, flush)
        qd, k, v, mask = dense_inputs(
            *args, chunk=name == "paged_prefill_attention")
        lib = sdpa(qd, k, v, attn_mask=mask)
        lib = lib.transpose(1, 2) if name == "paged_prefill_attention" \
            else lib[:, :, 0]
        lib_err = max_err(lib, exp)
        l_ms = time_ms(lambda: sdpa(qd, k, v, attn_mask=mask), 20, flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[measure] {name} on main-path inputs q{tuple(args[0].shape)}"
              f" table{tuple(b_h.shape)} lens {l_h.tolist()}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms "
              f"(sdpa vs plain max_abs_err {lib_err:.3g}); bound "
              f"{bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} ms, "
              f"{flops} flops -> {t_ops:.4f} ms); max_abs_err {err:.3g}")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=float(bound),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
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
    tick with the most work; the record keeps the gate's at the latter,
    and moe_gmm's other calls under ``shapes``), cold L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    shapes = measure_gmm(recs, errs, flush, "granite chunked")
    gate_max = next(v for k, v in shapes.items()
                    if k.startswith("granite chunked: gate max"))
    out = {"moe_gmm": dict(
        {k: v for k, v in gate_max.items() if "clean" not in k},
        shapes=shapes)}
    sized = sorted(recs["rao_scatter_add"], key=lambda c: rao_work(*c[0])[1])
    for label, (args, _) in (("decode", sized[0]), ("max", sized[-1])):
        table, idx, vals = args
        nbytes, flops = rao_work(table, idx, vals)
        zero = torch.zeros_like(table)        # the path's input
        exp = ref.rao_scatter_add(zero, idx, vals)
        got = ops.rao_scatter_add(zero.clone(), idx, vals)
        lib = zero.clone().index_add_(0, idx, vals)
        torch.cuda.synchronize()
        err = max_err(got, exp)
        if not close(got, exp, 2e-2):
            raise AssertionError(f"rao_scatter_add disagrees on main-path "
                                 f"inputs: {err}")
        errs["rao_scatter_add"].append(err)
        lib_err = max_err(lib, exp)
        # the kernel and index_add_ accumulate into copies in place
        k_ms = time_ms(partial(ops.rao_scatter_add, zero.clone(), idx,
                               vals), 20, flush)
        p_ms = time_ms(partial(ref.rao_scatter_add, zero, idx, vals), 5,
                       flush)
        l_ms = time_ms(partial(zero.clone().index_add_, 0, idx, vals), 20,
                       flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[measure] rao_scatter_add ({label} tick) on main-path inputs "
              f"table {tuple(table.shape)} idx {tuple(idx.shape)} vals "
              f"{tuple(vals.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms, index_add_ {l_ms:.4f} ms (index_add_ vs plain "
              f"max_abs_err {lib_err:.3g}); bound {bound:.4f} ms ({nbytes} "
              f"bytes -> {t_bytes:.4f} ms, {flops} ops -> {t_ops:.4f} ms); "
              f"max_abs_err {err:.3g}")
        if label == "max":
            out["rao_scatter_add"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=float(bound),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


@phase("measure")
def phase_measure_gmm_oneshot(recs, errs):
    """Time moe_gmm (``measure_gmm``) at the capacity one-shot path's
    largest gate and down calls (a group call), whose shapes take other
    tile widths than the chunked path's, cold L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    return measure_gmm(recs, errs, flush, "granite one-shot", ("max",))


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
    """Time flash_attention and rmsnorm on a one-shot path's own inputs
    (layer 0's call in its smallest and its largest model call), cold L2,
    beside the plain version and one library call the port never makes:
    scaled_dot_product_attention(is_causal, enable_gqa) and F.rms_norm."""
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
        for label, (args, kw) in (("smallest", sized[0]), ("max", sized[-1])):
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
            exp = plain()
            got = run()
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
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            print(f"[measure] {kname} ({name}, {label} call) on main-path "
                  f"inputs {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                  f"ms, {lib_name} {l_ms:.4f} ms (library vs plain "
                  f"max_abs_err {lib_err:.3g}); bound {bound:.4f} ms "
                  f"({nbytes} bytes -> {t_bytes:.4f} ms, {n_ops} ops -> "
                  f"{t_ops:.4f} ms); max_abs_err {err:.3g}")
            if label == "max":
                out[kname] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                  bound_ms=float(bound),
                                  bound_by="bytes" if t_bytes >= t_ops
                                  else "operations")
    return out


def ssd_work(x, Bm, A, chunk):
    """Bytes and f32 operations of one ssd_scan call.  Bytes: x, B, C, dt
    and A read once, y and the final state written once.  Operations,
    counted for this call's L chunk by chunk (Lc steps, P = Lc (Lc + 1) / 2
    causal pairs): C.B^T once per (row, chunk), 2 S per pair, since it does
    not depend on the head; then per (row, head) the decay and dt of each
    pair (3), the intra-chunk product (2 hd per pair), the inter-chunk
    product and its scale (Lc hd (2 S + 1)), the state's weights, update
    and decay (Lc hd + 2 Lc S hd + S hd); an exp counts as one."""
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


@phase("measure")
def phase_measure_ssd(recs, errs):
    """Time ssd_scan on the zamba2 path's own inputs (layer 0's call in
    its smallest and its largest group call), cold L2, beside the plain
    version; no single PyTorch call computes an SSD scan (library: none)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    sized = sorted(recs["ssd_scan"], key=lambda c: c[0][0].shape[1])
    out = {}
    for label, (args, kw) in (("smallest", sized[0]), ("max", sized[-1])):
        x, Bm, Cm, dt, A = args
        nbytes, n_ops = ssd_work(x, Bm, A, kw["chunk"])
        run = partial(ops.ssd_scan, *args, **kw)
        plain = partial(ref.ssd_scan, *args, **kw)
        y, st = run()
        ey, est = plain()
        torch.cuda.synchronize()
        err = max(max_err(y, ey), max_err(st, est))
        if not (close(y, ey, 1e-3) and close(st, est, 1e-3)):
            raise AssertionError(f"ssd_scan disagrees on main-path inputs: "
                                 f"{err}")
        errs["ssd_scan"].append(err)
        k_ms = time_ms(run, 20, flush)
        p_ms = time_ms(plain, 5, flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        print(f"[measure] ssd_scan ({label} group call) on main-path inputs "
              f"x {tuple(x.shape)} {str(x.dtype)[6:]} B/C "
              f"{tuple(Bm.shape)} chunk {kw['chunk']}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, library: none; bound {bound:.4f} ms "
              f"({nbytes} bytes -> {t_bytes:.4f} ms, {n_ops} f32 ops -> "
              f"{t_ops:.4f} ms); max_abs_err {err:.3g}")
        if label == "max":
            out["ssd_scan"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                   bound_ms=float(bound),
                                   bound_by="bytes" if t_bytes >= t_ops
                                   else "operations")
    return out


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
    ("ssd_scan", ("ssd_scan",)),
    ("rao_scatter_add", ("scatter_add_kernel", "widen_kernel",
                         "narrow_kernel")),
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
    errs = {name: [] for name in (*KERNELS, "moe_gmm_wmma")}
    phase_kernels(errs)
    if args.quick:
        return 0
    phase_tiny()
    by_path = {}
    name, by_path[name], recs, srv = phase_serve("mistral chunked", card)
    meas = phase_measure(recs, errs)
    if args.profile:
        phase_profile(srv)
    del srv, recs                      # free the arena and the params
    name, by_path[name], recs, srv = phase_serve("mistral one-shot", card)
    meas.update(phase_measure_oneshot(recs, errs, name))
    if args.profile:
        phase_profile(srv)
    del srv, recs                      # free mistral's 24.5 GB of params
    torch.cuda.empty_cache()
    name, by_path[name], recs, srv = phase_serve("granite chunked", card)
    meas.update(phase_measure_moe(recs, errs))
    if args.profile:
        phase_profile(srv)
    del srv, recs
    name, by_path[name], recs, srv = phase_serve("granite one-shot", card)
    phase_measure_oneshot(recs, errs, name)
    meas["moe_gmm"]["shapes"].update(phase_measure_gmm_oneshot(recs, errs))
    if args.profile:
        phase_profile(srv)
    del srv, recs
    torch.cuda.empty_cache()
    name, by_path[name], recs, srv = phase_serve("zamba2 dense", card)
    meas.update(phase_measure_ssd(recs, errs))
    phase_measure_oneshot(recs, errs, name)
    if args.profile:
        phase_profile(srv)
    del srv, recs
    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=sum(n[name] for n in by_path.values()),
             launches_by_path={a: n[name] for a, n in by_path.items()},
             max_abs_err=max(errs[name]), **meas[name])
        for name in KERNELS]}
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
    print(f"[total] wall {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
