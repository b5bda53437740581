"""Wrapper of the hand-written Hopper CUDA kernel for the batched block cyclic
reduction (`csrc/cr_solve.cu`).

Replaces the TPU kernel `ctdirect_tpu/solver/pallas_cr.py::cr_solve_lanes_pallas`
(same lane-minor contract: a pre-padded power-of-two chain with the batch axis
last), in float32 and float64. The kernel source notes its design and what
bounds it on the card.

`cr_solve_batched(A, Bp, E, F, r, rb)`:
- CPU tensors run the plain PyTorch version `lanes.cr_solve_lanes`;
- CUDA tensors launch the kernel on the current stream, or raise. There is no
  fallback to the plain version and nothing moves to the CPU.

The kernel is built from the repository's source with `nvcc` at first use
into `ctdirect_tpu_torch/_build/` (a plain-C shared library loaded with
ctypes); nothing CUDA-related happens at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cr_solve.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
MAX_WIDTH = 48  # cap on bs + wb (the kernel's per-thread working arrays)
CAPS = (16, 32, MAX_WIDTH)  # the kernel's instantiations (csrc/cr_solve.cu: launch)

_ENTRY = {torch.float32: "cr_solve_f32", torch.float64: "cr_solve_f64"}


def cap(bs: int, wb: int) -> int:
    """The instantiation (working-array cap) that a chain of width bs + wb
    launches; raises above MAX_WIDTH."""
    for c in CAPS:
        if bs + wb <= c:
            return c
    raise ValueError(f"CR kernel: bs + wb = {bs + wb} exceeds the cap {MAX_WIDTH}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CR kernel")


def build(verbose: bool = False):
    """Compile csrc/cr_solve.cu into BUILD_DIR (cached by source hash).

    Returns (library path, build seconds, compiler log); seconds is 0.0 and
    the log empty when a cached library is reused. verbose adds
    `-Xptxas -v` (registers, stack frame, spills) to the log."""
    src = SOURCE.read_bytes()
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcr_solve-{key}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.cr_workspace_elems.argtypes = [i32] * 4
    lib.cr_workspace_elems.restype = ctypes.c_size_t
    return lib


class CRKernel:
    """Callable wrapper of the CR kernel with plain-int launch counts:
    `launches` grows by one per kernel launch and nowhere else, and
    `launches_by_cap` splits the same launches by the instantiation (16, 32
    or 48) that ran."""

    def __init__(self):
        self.launches = 0
        self.launches_by_cap = dict.fromkeys(CAPS, 0)
        self._lib = None

    def reset_counts(self):
        self.launches = 0
        self.launches_by_cap = dict.fromkeys(CAPS, 0)

    def library(self, verbose: bool = False):
        """Build (if needed) and load the kernel library; returns the build
        (path, seconds, log) of this call."""
        info = build(verbose=verbose)
        if self._lib is None:
            self._lib = _load(info[0])
        return info

    def __call__(self, A, Bp, E, F, r, rb):
        if A.device.type == "cpu":
            return cr_solve_lanes(A, Bp, E, F, r, rb)
        if A.device.type != "cuda":
            raise RuntimeError(f"CR kernel: unsupported device {A.device}")
        P, bs, _, B = A.shape
        wb = E.shape[-2]
        dtype, device = A.dtype, A.device
        if dtype not in _ENTRY:
            raise TypeError(f"CR kernel: dtype {dtype} (float32 or float64 only)")
        if P < 1 or P & (P - 1):
            raise ValueError(f"CR kernel: chain length {P} is not a power of two")
        instantiation = cap(bs, wb)
        shapes = {
            "A": (A, (P, bs, bs, B)),
            "Bp": (Bp, (P, bs, bs, B)),
            "E": (E, (P, bs, wb, B)),
            "F": (F, (wb, wb, B)),
            "r": (r, (P, bs, B)),
            "rb": (rb, (wb, B)),
        }
        for name, (x, shape) in shapes.items():
            if tuple(x.shape) != shape:
                raise ValueError(f"CR kernel: {name} has shape {tuple(x.shape)}, want {shape}")
            if x.device != device or x.dtype != dtype:
                raise ValueError(f"CR kernel: {name} is {x.dtype} on {x.device}, want {dtype} on {device}")
            if not x.is_contiguous():
                raise ValueError(f"CR kernel: {name} is not contiguous")
        if self._lib is None:
            self.library()
        lib = self._lib
        X = torch.empty((P, bs, B), dtype=dtype, device=device)
        xb = torch.empty((wb, B), dtype=dtype, device=device)
        work = torch.empty(lib.cr_workspace_elems(P, bs, wb, B), dtype=dtype, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, _ENTRY[dtype])(
                A.data_ptr(), Bp.data_ptr(), E.data_ptr(), F.data_ptr(),
                r.data_ptr(), rb.data_ptr(), X.data_ptr(), xb.data_ptr(),
                work.data_ptr(), P, bs, wb, B, stream,
            )
        if rc != 0:
            raise RuntimeError(f"CR kernel launch failed: cudaError {rc}")
        self.launches += 1
        self.launches_by_cap[instantiation] += 1
        return X, xb


cr_solve_batched = CRKernel()
