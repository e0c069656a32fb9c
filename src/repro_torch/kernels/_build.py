"""Build ``csrc/*.cu`` into one shared library with ``nvcc`` and bind it.

At first use, every ``.cu`` file is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together), the objects are linked into
``build/repro_torch_kernels_<hash>.so`` at the repository root, and the
library is loaded with ``ctypes``.  The hash covers the sources, the headers
and the flags, so an edited source is rebuilt and an unchanged one is
loaded from ``build/``.

The C entry points take pointers and the stream as ``c_void_p`` and sizes as
``c_int``, launch on the stream they are given (PyTorch's current stream)
and return ``cudaGetLastError()``; :func:`check` raises if it is not 0.
Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # a, b, c, out, ws, batch, m, n, k, sa, sb, sc, so, ab, alpha, beta,
    # tile, chunk, splits, bvec, arows, stream
    "repro_matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                         _P, _F, _F, _I, _I, _I, _I, _I, _P],
    # x, c, out, ws, batch, n, d, tile, tiles, chunk, splits, vec, ab,
    # stream
    "repro_factor_update_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P, _P],
    # x, c, out, ws, b, t, ch, taps, stride, lo, t_out, has_bias, tile,
    # tiles, fold, chunk, splits, vec, ab, stream
    "repro_patch_factor_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # a, b, s, out, ws, batch, m, n, k, sa, sb, ss, so, lam_dev, lam, chunk,
    # splits, vec, arows, stream
    "repro_matmul_rescale_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                 _L, _L, _P, _F, _I, _I, _I, _I, _P],
    # a_inv, t, mom, out, partials, batch, m, n, k, sa, sb, sc, am, vec,
    # arows, stream
    "repro_axpy_momentum_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                _L, _P, _I, _I, _P],
    # q, k, v, lengths, out, ws, b, hq, hkv, hd, s, sb, sh, ss, window, cap,
    # scale, n_split, stream
    "repro_flash_decode_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _I, _F, _F, _I, _P],
    # q, k_pool, v_pool, lengths, page_table, out, ws, b, hq, hkv, hd, page,
    # blocks, window, cap, scale, n_split, stream
    "repro_flash_decode_paged_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _I, _I, _F, _F, _I, _P],
    # q, k, v, out, b, hq, hkv, tq, tk, hd, q/kv/out strides (b, h, t),
    # causal, window, cap, scale, stream
    "repro_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I,
                                  _F, _F, _P],
    # hd, blocks (out: an int)
    "repro_flash_attention_blocks_per_sm": [_I, _P],
}


@dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was loaded
    log: str               # nvcc / ptxas output of the build ("" if cached)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot be "
                           "built")
    return path


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, out: Path, tag: str) -> str:
    """Compile every source (one ``nvcc`` each, all started together) and
    link them into ``out``.  The objects carry this process's id, so two
    processes building the same sources at once never touch each other's
    files, and they are removed whether or not the build succeeds; the
    library is linked under a per-process name and moved into place with
    one atomic ``os.replace``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}_{tag}.{os.getpid()}.o" for s in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([nvcc, *ARCH, *FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [(s, p, p.communicate()[0]) for s, p in zip(sources, procs)]
        for s, p, text in logs:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{text}")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return "\n".join(f"== {s.name}\n{text}" for s, _, text in logs)


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """Build (if needed) and load the kernels' library, once per process."""
    sources = sorted(CSRC.glob("*.cu"))
    tag = _digest(sources + sorted(CSRC.glob("*.cuh")))
    out = BUILD_DIR / f"repro_torch_kernels_{tag}.so"
    t0 = time.perf_counter()
    log = "" if out.exists() else _compile(sources, out, tag)
    seconds = time.perf_counter() - t0 if log else 0.0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return Library(lib, out, seconds, log)


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = load().lib.repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({status}: {msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 operands only, got {t.dtype}")


def scalar_pair(alpha, beta, device) -> torch.Tensor:
    """(alpha, beta) as a 2-float device buffer; 0-d tensors stay on the
    device (no host read), Python numbers are filled in on the device."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32).reshape(())
        return torch.full((), float(v), device=device, dtype=torch.float32)
    return torch.stack([one(alpha), one(beta)])
