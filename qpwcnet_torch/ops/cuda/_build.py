"""Build and load the port's CUDA kernels.

Every ``qpwcnet_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` (all started together) and linked into ONE shared library
with a plain C interface, at first use, and
loaded with ``ctypes``. The library lives in ``build/qpwcnet_torch/``
beside the package (listed in .gitignore), under a name keyed by the
sources' content, so an edited source rebuilds and an unchanged one is
reused by later processes.

Each C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "qpwcnet_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (restype is int: a cudaError_t).
SIGNATURES = {
    # prv, nxt, out, B, H, W, C, nxt_halo, dtype, stream (H: prv's rows;
    # nxt has H + 2 nxt_halo)
    "qpw_cost_volume": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dacc, nxt, dprv, B, H, W, C, nxt_halo, dtype, stream
    "qpw_cost_volume_bwd_prv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dacc, prv, dnxt, B, H, W, C, out_halo, dtype, stream (dnxt has
    # H + 2 out_halo rows)
    "qpw_cost_volume_bwd_nxt": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # prv, nxt, flow, out, B, H, W, C, warp_window, dtype, stream
    "qpw_warp_cost_volume": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, w1, b1, w2, b2, w3, b3, out, wbuf, tmp, B, H, W, Cin, Cout,
    # dtype, stream
    "qpw_downconv_stage": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
    # x, w, bias, out, wbuf, B, H, W, Ci, Co, dtype, stream
    "qpw_upconv_stage": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, bias, out, n, C, dtype, stream
    "qpw_bias_mish": [_P, _P, _P, _L, _I, _I, _P],
    # x, bias, g, dx, partial, dbias, rows, C, dtype, stream
    "qpw_bias_mish_bwd": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
}
# The wide stages' implicit GEMM (csrc/conv_gemm.cuh) takes its weights
# in a scratch buffer the wrapper allocates, with Cin padded to a
# multiple of this.
GEMM_K = 32


def gemm_cip(cin: int) -> int:
    """Cin rounded up to the GEMM's channel step."""
    return -(-cin // GEMM_K) * GEMM_K

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(Path(__file__).read_bytes())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    Returns the library's path. Writes to a temporary name and renames,
    so a concurrent or interrupted build never leaves a partial file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    lib = BUILD_DIR / f"libqpwcnet_kernels_{digest}.so"
    if lib.exists():
        return lib
    tag = f"{digest}.tmp{os.getpid()}"
    # One nvcc per source, all started together, then one link.
    # -fmad=false: no implicit a*b+c contraction, so elementwise math
    # rounds as eager PyTorch does; the sums use fmaf explicitly.
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
               "-c", "-Xcompiler", "-fPIC", "-lineinfo", "-I", str(CSRC_DIR),
               "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(cmd, proc.communicate(), proc.returncode)
            for cmd, _, proc in jobs]
    for cmd, (out, err), rc in done:
        _require_ok(rc, cmd, out, err)
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    _require_ok(res.returncode, cmd, res.stdout, res.stderr)
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib)
    return lib


def _require_ok(rc: int, cmd: list[str], out: str, err: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n"
                           f"{err}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


@functools.cache
def dtype_code(dtype) -> int:
    """The C entry points' dtype argument: 0 float32, 1 bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


def stream_ptr(device) -> int:
    """The raw handle of ``device``'s current stream (without building a
    ``torch.cuda.Stream``: a few microseconds of host time a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device):
    """The context of a launch on ``device``: ``torch.cuda.device`` only
    where another device is current (entering it costs microseconds)."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def require(t, name: str, shape=None, dtype=None, device=None) -> None:
    """Wrapper-side validation of a tensor handed to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (call .contiguous())")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
