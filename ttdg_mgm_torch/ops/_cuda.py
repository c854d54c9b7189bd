"""Build and load the package's CUDA kernels (``ttdg_mgm_torch/csrc``).

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into an object
file, all at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, never at import: a machine without ``nvcc`` imports the package
and runs its plain PyTorch versions.  The library lands in
``ttdg_mgm_torch/_build/`` (ignored by git), named by a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is reused.
The span ``setup.kernels`` (``utils/profiling.py``) holds the library's
build or load, once per process.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from ttdg_mgm_torch.utils.profiling import span

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None
#: wall seconds of the last build in this process (0.0 when it was reused)
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    heads = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    return srcs, heads


def _build() -> str:
    """Compile every source in parallel and link one library; returns its
    path.  Reuses a library already built from identical sources."""
    global build_seconds
    srcs, heads = _sources()
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in srcs + heads:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libttdg_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        with span("setup.kernels"):
            cdll = ctypes.CDLL(_build())
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # forward and backward pools: 4 level pointers, level count and
        # shapes, C, R, K, the ROIs, 4 strides, min_level, P, the sampling
        # ratio, the element type (0 float32, 1 bfloat16), the output,
        # stream
        pool_args = [P] * 4 + [I] * 9 + [I, I, I] + [P] + [F] * 4 + [I, I, I, I, P, P]
        cdll.ttdg_roi_pool.argtypes = pool_args
        cdll.ttdg_roi_pool.restype = I
        cdll.ttdg_roi_geometry.argtypes = [I] + [F] * 4 + [I] * 4 + [P] * 7
        cdll.ttdg_roi_geometry.restype = I
        # A, W, U0, ms, out, iters, V or null, clocks or null; G, M, Mp, NU;
        # qw, tol^2; mgm_iter, sk_iter, lap_cap, ntaus; taus; stream
        cdll.ttdg_gagm.argtypes = ([P] * 8 + [I, I, I, I, F, F, I, I, I, I,
                                   ctypes.POINTER(F), P])
        cdll.ttdg_gagm.restype = I
        cdll.ttdg_gagm_smem_bytes.argtypes = [I, I, I]
        cdll.ttdg_gagm_smem_bytes.restype = I
        # the backward: the pool's arguments, then the plan scratch, the
        # cotangent and the stream
        cdll.ttdg_roi_pool_backward.argtypes = pool_args[:-2] + [P, P, P]
        cdll.ttdg_roi_pool_backward.restype = I
        # level count and shapes, 4 strides, min_level, P, the sampling
        # ratio, R, the ROIs, the plan, stream
        cdll.ttdg_roi_plan.argtypes = [I] * 9 + [F] * 4 + [I] * 4 + [P, P, P]
        cdll.ttdg_roi_plan.restype = I
        cdll.ttdg_roi_plan_words.argtypes = [I, I]
        cdll.ttdg_roi_plan_words.restype = I
        # s, nrows, ncols, tau; N, n1, n2, max_iter, dummy_row, generic; out,
        # stream
        cdll.ttdg_sinkhorn.argtypes = [P] * 4 + [I] * 6 + [P, P]
        cdll.ttdg_sinkhorn.restype = I
        # masks, boxes; K, M, H, W; the threshold; out, stream
        cdll.ttdg_paste_masks.argtypes = [P, P, I, I, I, I, ctypes.c_double, P, P]
        cdll.ttdg_paste_masks.restype = I
        # q, k, v, rel_h, rel_w; BH, N, Kh, Kw; scale; out, lse, stream
        cdll.ttdg_vit_attn_fwd.argtypes = [P] * 5 + [I] * 4 + [F, P, P, P]
        cdll.ttdg_vit_attn_fwd.restype = I
        # q, k, v, out, its gradient, lse, rel_h, rel_w; BH, N, Kh, Kw;
        # scale; dq, dk, dv, drel_h, drel_w, delta, stream
        cdll.ttdg_vit_attn_bwd.argtypes = [P] * 8 + [I] * 4 + [F] + [P] * 7
        cdll.ttdg_vit_attn_bwd.restype = I
        _lib = cdll
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError_t {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Validate a tensor handed to a kernel: on ``device``, of ``dtype``,
    contiguous.  A wrong dtype raises: nothing is cast silently."""
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda_f32(name: str, t: torch.Tensor, device: torch.device) -> None:
    """:func:`require_cuda` for float32."""
    require_cuda(name, t, device, torch.float32)
