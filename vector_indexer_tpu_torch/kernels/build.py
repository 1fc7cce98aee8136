"""Build, load and count the port's CUDA kernels.

All kernel sources live in ``vector_indexer_tpu_torch/csrc``. At first use
they are compiled by ``nvcc`` for Hopper (``sm_90a``) into ONE shared
library with a plain C interface, which is loaded with ``ctypes``. No
PyTorch header is compiled, so the build takes seconds. The library's file
name carries a hash of the sources and flags, so an edited source is never
served by a stale build. The build directory is ``build/torch_kernels`` at
the root of the checkout (listed in ``.gitignore``).

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``; ``launch``
raises when that is not 0. There is no fallback: a failed build, a missing
library or a refused launch raises.

Launch counters: each kernel wrapper calls ``launch`` exactly where it
launches its kernel, which adds one to that kernel's count. A caller resets
the counts before a run and reads them after it to prove which kernels the
run went through.
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

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry point -> argument types (pointers and the stream as void*).
_SIGNATURES = {
    # x, c, c_sq, n, k, d, best_score, best_idx, stream
    "vitorch_assign_argmin": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
    # queries, cent, cid2d, blk2d, bias2d, vecs, norms, nq, t_fixed,
    # chunk, d, is_l2, out, stream
    "vitorch_stream_distances": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
    ),
    # queries, cent, cid2d, blk2d, nval2d, bias2d, vecs, norms, nq,
    # t_fixed, t_sub, chunk, groups, d, is_l2, dist_plane, slot_plane, stream
    "vitorch_stream_fused_plane": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
    ),
    # q, x, norms, mask, nq, n_rows, d, w, c_groups, mcols, is_l2,
    # v1, i1, v2, i2, stream
    "vitorch_flat_sweep_topk_plane": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
    ),
}

# Kernel name (as reported) -> launches since the last reset.
_LAUNCHES: Dict[str, int] = {
    "assign_argmin": 0,
    "stream_distances": 0,
    "stream_fused_plane": 0,
    "flat_sweep_topk_plane": 0,
}

_LIB: Optional[ctypes.CDLL] = None
_BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from vector_indexer_tpu_torch/csrc at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu into the hashed shared library (no-op when it is
    already built). Records the wall seconds and nvcc's report (registers,
    shared memory, spills from ``-Xptxas -v``) in ``build_info()``."""
    out = BUILD_DIR / f"libvitorch_kernels_{_digest()}.so"
    if out.is_file():
        _BUILD_INFO.setdefault("path", str(out))
        _BUILD_INFO.setdefault("seconds", 0.0)
        _BUILD_INFO.setdefault("log", "")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
           *map(str, sources())]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _BUILD_INFO.update(
        path=str(out),
        seconds=time.perf_counter() - t0,
        log=(res.stdout + res.stderr).strip(),
    )
    return out


def build_info() -> dict:
    return dict(_BUILD_INFO)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.vitorch_error_string.argtypes = [ctypes.c_int]
        lib.vitorch_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` (which launches kernel ``kernel``),
    raise on a non-zero cudaGetLastError(), and count the launch."""
    lib = library()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.vitorch_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")
    _LAUNCHES[kernel] += 1


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel wrappers' device check: every operand on one CUDA device and
    contiguous. Raises instead of moving anything."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
