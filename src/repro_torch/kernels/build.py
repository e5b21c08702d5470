"""Build and load the hand-written CUDA kernels.

Both attention kernels (``csrc/paged_attention.cu``,
``csrc/paged_prefill_attention.cu``) compile in ONE ``nvcc`` call into a
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so the build takes seconds, not minutes.  The library
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
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "paged_prefill_attention.cu")
HEADERS = ("paged_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register / spill lines) and how long
# it took; ``None`` when the library came from the cache
build_log: Optional[str] = None
build_seconds: Optional[float] = None


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
    """One nvcc call for every source; the library appears atomically."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                      *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [
        i, p, p, p, p, p, p, p, p,            # dtype, q .. out
        i, i, i, i, i, i, i, f, p]            # B H K hd bt nb window scale stream
    lib.paged_attention_launch.restype = i
    lib.paged_prefill_attention_launch.argtypes = [
        i, p, p, p, p, p, p, p, p,            # dtype, q .. out
        i, i, i, i, i, i, i, i, f, p]         # B C H K hd bt nb window scale stream
    lib.paged_prefill_attention_launch.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib, build_log, build_seconds
    if _lib is None:
        out = build_dir() / f"libpaged_attention_{_digest()}.so"
        if not out.exists():
            t0 = time.perf_counter()
            build_log = _compile(out)
            build_seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(str(out)))
    return _lib
