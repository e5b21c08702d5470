"""Build and load the hand-written CUDA kernels.

Every kernel source (``csrc/paged_attention.cu`` (f32),
``csrc/paged_attention_split.cu`` (bf16, split-KV over a cluster),
``csrc/paged_prefill_attention.cu`` (f32),
``csrc/paged_prefill_attention_mma.cu`` (bf16, tensor cores),
``csrc/moe_gmm.cu`` (f32, and bf16
shapes TMA does not take), ``csrc/moe_gmm_wgmma.cu`` (bf16, TMA and
wgmma), ``csrc/rao_scatter.cu`` (f32), ``csrc/rao_scatter_onchip.cu``
(bf16, one launch, sums on chip), ``csrc/flash_attention.cu`` (f32),
``csrc/flash_attention_mma.cu`` (bf16, tensor cores), ``csrc/rmsnorm.cu``
(one warp a row; comparison only), ``csrc/rmsnorm_row.cu`` (a row
spread over a CTA), ``csrc/ssd_scan.cu`` (CUDA cores),
``csrc/ssd_scan_mma.cu`` (tensor cores)) compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects into a
single shared library with a plain C interface, loaded with ``ctypes`` —
no PyTorch headers, so the build takes seconds, not minutes.  The library
lands in ``kernels/_build/`` (listed in ``.gitignore``; override with
``REPRO_TORCH_BUILD_DIR``) under a name keyed by a hash of the sources and
flags, so an unchanged tree reuses it and a changed one rebuilds.

Nothing here runs at import time: the first CUDA call of a wrapper in
``kernels.ops`` triggers ``load()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "paged_attention_split.cu",
           "paged_prefill_attention.cu",
           "paged_prefill_attention_mma.cu", "moe_gmm.cu",
           "moe_gmm_wgmma.cu", "rao_scatter.cu", "rao_scatter_onchip.cu",
           "flash_attention.cu", "flash_attention_mma.cu", "rmsnorm.cu",
           "rmsnorm_row.cu", "ssd_scan.cu", "ssd_scan_mma.cu")
HEADERS = ("paged_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register / spill lines), how long it
# took, and each source's own nvcc seconds (the processes run together);
# ``None`` / empty when the library came from the cache
build_log: Optional[str] = None
build_seconds: Optional[float] = None
nvcc_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels build only where the toolkit is")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """One nvcc process per source, run in parallel, then one link; the
    library appears atomically."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [Path(tmpdir) / f"{Path(s).stem}.o" for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
        log_paths = [o.with_suffix(".log") for o in objs]
        t0 = time.perf_counter()
        procs = []
        for cmd, path in zip(cmds, log_paths):
            with path.open("w") as f:     # the child keeps its own handle
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT))
        nvcc_seconds.clear()
        while len(nvcc_seconds) < len(procs):
            for s, p in zip(SOURCES, procs):
                if s not in nvcc_seconds and p.poll() is not None:
                    nvcc_seconds[s] = time.perf_counter() - t0
            time.sleep(0.02)
        logs = [path.read_text() for path in log_paths]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        tmp = Path(tmpdir) / out.name
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return "".join(logs) + proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [
        i, p, p, p, p, p, p, p, p,            # dtype, q .. out
        i, i, i, i, i, i, i, f, p]            # B H K hd bt nb window scale stream
    lib.paged_attention_launch.restype = i
    lib.paged_attention_split_launch.argtypes = [
        p, p, p, p, p, p, p, p,               # q .. out (bf16)
        i, i, i, i, i, i, i, f, p]            # B H K hd bt nb window scale stream
    lib.paged_attention_split_launch.restype = i
    lib.paged_attention_split_geometry.argtypes = [
        i, i, i, i, i, ctypes.POINTER(i)]     # H K hd bt nb geometry[4]
    lib.paged_attention_split_geometry.restype = i
    lib.paged_prefill_attention_launch.argtypes = [
        i, p, p, p, p, p, p, p, p,            # dtype, q .. out
        i, i, i, i, i, i, i, i, f, p]         # B C H K hd bt nb window scale stream
    lib.paged_prefill_attention_launch.restype = i
    lib.paged_prefill_attention_mma_launch.argtypes = [
        p, p, p, p, p, p, p, p,               # q .. out (bf16)
        i, i, i, i, i, i, i, i, f, p]         # B C H K hd bt nb window scale stream
    lib.paged_prefill_attention_mma_launch.restype = i
    lib.moe_gmm_launch.argtypes = [i, p, p, p, i, i, i, i, p]
    #                              dtype xe w out E C D F stream
    lib.moe_gmm_launch.restype = i
    lib.moe_gmm_wgmma_launch.argtypes = [p, p, p, i, i, i, i, p]
    #                                    xe w out E C D F stream
    lib.moe_gmm_wgmma_launch.restype = i
    lib.rao_scatter_add_launch.argtypes = [i, p, p, p, p, i, i, i, p]
    #                          dtype table idx vals scratch N M D stream
    lib.rao_scatter_add_launch.restype = i
    lib.rao_scatter_add_onchip_launch.argtypes = [
        p, p, p, i, ctypes.c_longlong, i, i, i, i, i, i, p]
    #   table idx vals N M D vec cols rows split threads stream
    lib.rao_scatter_add_onchip_launch.restype = i
    for name in ("flash_attention_launch", "flash_attention_mma_launch"):
        fn = getattr(lib, name)               # f32 / bf16
        fn.argtypes = [p, p, p, p,            # q k v out
                       i, i, i, i, i, i, i, i, f, p]
        #              B S T H K hd causal window scale stream
        fn.restype = i
    lib.rmsnorm_launch.argtypes = [i, p, p, p, ctypes.c_longlong, i, f, p]
    #                              dtype x w out N D eps stream
    lib.rmsnorm_launch.restype = i
    lib.rmsnorm_row_launch.argtypes = [i, p, p, p, ctypes.c_longlong, i,
                                       i, i, i, i, f, p]
    #               dtype x w out N D vec per tpr rows eps stream
    lib.rmsnorm_row_launch.restype = i
    lib.ssd_scan_launch.argtypes = [i, p, p, p, p, p, p, p,
                                    i, i, i, i, i, i, p]
    #                  dtype x Bm Cm dt A y state B L h hd S chunk stream
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_mma_launch.argtypes = [i, p, p, p, p, p, p, p, p,
                                        ctypes.c_longlong,
                                        i, i, i, i, i, i, p]
    #  dtype x Bm Cm dt A y state scratch scratch_len B L h hd S chunk stream
    lib.ssd_scan_mma_launch.restype = i
    lib.ssd_scan_mma_geometry.argtypes = [i, i, i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_longlong)]
    #                          dtype B L h hd S chunk geometry[9]
    lib.ssd_scan_mma_geometry.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib, build_log, build_seconds
    if _lib is None:
        out = build_dir() / f"librepro_kernels_{_digest()}.so"
        if not out.exists():
            t0 = time.perf_counter()
            build_log = _compile(out)
            build_seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(str(out)))
    return _lib
