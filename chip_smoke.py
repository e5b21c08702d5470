"""Chip smoke test of the PyTorch port: builds the hand-written CUDA
kernels from this checkout and drives the paged serving engine on one
card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # device, build, kernel checks only

Phases (each prints its own lines and wall time; any failure raises):
  1. device   — card name, and name + power limit from nvidia-smi;
  2. build    — both kernels in one nvcc call (kernels/build.py);
  3. kernels  — each kernel against its plain PyTorch version at
                mistral-nemo-12b's attention shapes (H=32, K=8, hd=128,
                bt=16, B=8, ctx up to 512, C in {8, 64}) with ragged
                lengths, -1 table entries, masked slots and a window:
                bf16 within 2e-2, f32 (TF32 off) within 1e-4;
  4. tiny     — one ragged trace through the tiny f32 engine twice, on the
                card (kernels) and on the CPU (plain versions): identical
                greedy tokens;
  5. serve    — full-width 40-layer mistral-nemo-12b (random bf16 params
                from a seed) serving 16 wire-encoded requests through
                BatchServer (8 slots, max_len 512): every request drains,
                logits stay finite, and each kernel launched exactly
                40 x its chunk or decode ticks;
  6. measure  — on inputs the main path itself produced, each kernel's
                time beside its plain version's, one PyTorch library call
                (scaled_dot_product_attention over the gathered dense KV,
                never called by the port) and its bound at 3.35 TB/s and
                989 TFLOP/s bf16.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import rpc as wire  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.server import (  # noqa: E402
    BatchServer, encode_request,
)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor peak
KERNELS = {
    "paged_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:132"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        replaces="src/repro/kernels/paged_prefill_attention.py:157"),
}
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


def time_ms(fn, reps, flush=None):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events); the
    L2 is flushed before each run when ``flush`` is given.  A device-side
    spin before the start event keeps the card busy while the host
    enqueues ``fn``, so host launch overhead does not count as device
    time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
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
    return float((a.float() - b.float()).abs().max())


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
    for line in (build.build_log or "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")


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


def tiny_trace(vocab):
    rng = np.random.RandomState(4321)
    lens_new = [(4, 4), (9, 1), (16, 3), (1, 5), (27, 4), (5, 2), (13, 3)]
    return [(rng.randint(1, vocab - 1, size=n).tolist(), m)
            for n, m in lens_new]


def drain_outputs(srv, trace):
    for i, (p, m) in enumerate(trace):
        srv.submit_wire(encode_request(i, p, m))
    out = {}
    for buf in srv.run_until_drained():
        msg = wire.decode(buf, {1: "int", 2: "bytes"})
        out[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    return out


@phase("tiny")
def phase_tiny():
    """The tiny f32 engine on the card (kernels) and on the CPU (plain)."""
    cfg = reduced(get_config("mistral-nemo-12b")).replace(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=128, param_dtype="float32", cache_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    trace = tiny_trace(cfg.vocab)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _tree_to(params, DEV)
        before = dict(ops.LAUNCHES)
        srv = BatchServer(model, batch_slots=3, max_len=32, params=p,
                          device=dev, nic_cost=None)
        outs[dev] = drain_outputs(srv, trace)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        if srv.kv_stats()["paged"]["pages_in_use"]:
            raise AssertionError(f"{dev}: pages leaked")
        if dev == "cuda" and not all(launched.values()):
            raise AssertionError(f"tiny engine skipped a kernel: {launched}")
        if dev == "cpu" and any(launched.values()):
            raise AssertionError("the CPU engine launched a kernel")
    same = outs["cpu"] == outs["cuda"]
    print(f"[tiny] {len(outs['cuda'])} requests; greedy tokens identical "
          f"card vs CPU: {same}")
    if not same:
        raise AssertionError(f"tiny engine tokens differ:\n{outs}")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class Recorder:
    """Keeps the arguments of every layer-0 call of a kernel wrapper during
    the main path (a reference, not a copy; no device sync)."""

    def __init__(self, name, n_layers):
        self.name, self.n_layers = name, n_layers
        self.fn = getattr(ops, name)
        self.calls = []
        self.n = 0

    def __call__(self, *args, **kw):
        if self.n % self.n_layers == 0:
            self.calls.append((args, kw))
        self.n += 1
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.fn)


@phase("serve")
def phase_serve(seed=0):
    cfg = get_config("mistral-nemo-12b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed), DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params / 1e9:.2f} B bf16 params initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    srv = BatchServer(model, batch_slots=8, max_len=512, block_tokens=16,
                      params=params, device=DEV, sync_timers=True)
    rng = np.random.RandomState(seed)
    plens = rng.randint(17, 301, size=16)
    for i, n in enumerate(plens):
        srv.submit_wire(encode_request(
            i, rng.randint(1, cfg.vocab - 1, size=int(n)).tolist(), 32))
    finite = []
    decode = srv._paged_decode
    chunk = srv._chunk_prefill

    def decode_checked(*a):
        lg, pg = decode(*a)
        finite.append(torch.isfinite(lg).all())
        return lg, pg

    def chunk_checked(*a):
        lg, pg = chunk(*a)
        finite.append(torch.isfinite(lg).all())
        return lg, pg
    srv._paged_decode, srv._chunk_prefill = decode_checked, chunk_checked

    recs = {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with Recorder("paged_attention", cfg.n_layers) as rd, \
            Recorder("paged_prefill_attention", cfg.n_layers) as rp:
        bufs = srv.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    recs["paged_attention"] = rd.calls
    recs["paged_prefill_attention"] = rp.calls
    st = srv.stats
    outs = {}
    for buf in bufs:
        msg = wire.decode(buf, {1: "int", 2: "bytes"})
        outs[msg[1]] = np.frombuffer(msg[2], np.int32).tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve] {len(outs)}/16 drained, {st['failed']} failed, "
          f"{st['ticks']} ticks ({st['prefill_chunks']} chunk ticks, "
          f"{st['decode_steps']} decode ticks) in {wall:.2f} s")
    prompt_toks = int(plens.sum())
    print(f"[serve] prefill {prompt_toks} tokens in {st['splice_wall_s']:.3f}"
          f" s = {prompt_toks / st['splice_wall_s']:.1f} tok/s; decode "
          f"{st['decode_tokens']} tokens in {st['decode_wall_s']:.3f} s = "
          f"{st['decode_tokens'] / st['decode_wall_s']:.1f} tok/s; peak "
          f"memory {peak:.2f} GiB")
    print(f"[serve] launches {launches}; expected paged_prefill_attention "
          f"{cfg.n_layers * st['prefill_chunks']}, paged_attention "
          f"{cfg.n_layers * st['decode_steps']}")
    if len(outs) != 16 or st["failed"] or \
            any(len(v) != 32 for v in outs.values()):
        raise AssertionError(f"requests not drained: {st}")
    if srv.kv_stats()["paged"]["pages_in_use"]:
        raise AssertionError("pages leaked")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits on the main path")
    if launches["paged_prefill_attention"] != \
            cfg.n_layers * st["prefill_chunks"] or \
            launches["paged_attention"] != cfg.n_layers * st["decode_steps"] \
            or not all(launches.values()):
        raise AssertionError(f"launch counts do not match ticks: {launches}")
    return launches, recs, srv


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
    for name, calls in recs.items():
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


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


@phase("profile")
def phase_profile(srv, seed=1):
    """Device time by kernel, and the device's busy share, over one chunk
    tick (8 slots x 64 tokens) and three decode ticks (8 slots) of the
    full-width engine, traced with torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(seed)
    vocab = srv.model.cfg.vocab
    for i in range(srv.slots):
        srv.submit_wire(encode_request(
            1000 + i, rng.randint(1, vocab - 1, size=200).tolist(), 16))
    srv.step()                              # admit + first 64-token chunk
    torch.cuda.synchronize()
    for label, ticks in (("chunk", 1), ("skip", 2), ("decode", 3)):
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
        attn = sum(_device_us(e) for e in kern if "paged" in e.key) / 1e3
        gemm = sum(_device_us(e) for e in kern
                   if any(w in e.key.lower() for w in
                          ("gemm", "xmma", "cutlass", "nvjet"))) / 1e3
        print(f"[profile] {label} x{ticks}: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms ({busy / wall:.1%}), idle "
              f"{1 - busy / wall:.1%}; paged attention {attn:.3f} ms, "
              f"gemm {gemm:.3f} ms, other {busy - attn - gemm:.3f} ms")
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
                    help="also trace one chunk tick and three decode ticks "
                         "of the full-width engine with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    kind, _ = phase_device()
    phase_build()
    errs = {name: [] for name in KERNELS}
    phase_kernels(errs)
    if args.quick:
        return 0
    phase_tiny()
    launches, recs, srv = phase_serve()
    meas = phase_measure(recs, errs)
    if args.profile:
        phase_profile(srv)
    record = {"kernels": [
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name], max_abs_err=max(errs[name]),
             **meas[name])
        for name in KERNELS]}
    print(f"[total] wall {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
