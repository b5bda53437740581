"""Wrapper of the hand-written Hopper CUDA kernel for the batched block cyclic
reduction (`csrc/cr_solve.cu`).

Replaces the TPU kernel `ctdirect_tpu/solver/pallas_cr.py::cr_solve_lanes_pallas`
(same lane-minor contract: a pre-padded power-of-two chain with the batch axis
last), in float32 and float64. The kernel is level-parallel: one solve call
issues 3 + 3 log2(P) launches on the current stream, a warp per block
elimination. The launch plan and the workspace size are the library's own
(`cr_plan`, `cr_workspace_elems`); the kernel source notes its design and
what bounds it on the card.

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
from typing import NamedTuple

import torch

from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes

# NVIDIA's H100 SXM data sheet: the HBM3 rate; 67 TFLOP/s is its f32 rate outside
# the tensor cores and its f64 rate on them (DMMA, which the small matrix
# products of the reduction could use)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 67e12}


class Cost(NamedTuple):
    """The least time the card could take for some work: bytes over
    PEAK_BYTES_S or flops over PEAK_FLOP_S, whichever is larger."""

    bound_ms: float
    bound_by: str  # "bytes" or "operations"
    bytes: float
    flops: float


def cost(dtype, nbytes, flops) -> Cost:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOP_S[dtype] * 1e3
    if t_bytes >= t_ops:
        return Cost(t_bytes, "bytes", nbytes, flops)
    return Cost(t_ops, "operations", nbytes, flops)


def solve_cost(dtype, P, bs, wb, nb) -> Cost:
    """The cost of one solve of nb chains of P blocks: each input read once
    and each output written once; the operations the reduction needs. Per
    odd block: the inverse of A_o (2 bs^3), the five bs x bs products of the
    couplings and Schur updates (10 bs^3), the three products with E_o (6
    bs^2 wb), the border term (2 bs wb^2), the right-hand sides and the
    down-sweep step (12 bs^2 + 4 bs wb); then one dense LU solve of the
    root, n = bs + wb (2n^3/3 + 2n^2)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * nb * (P * (2 * bs * bs + bs * wb + 2 * bs) + wb * wb + 2 * wb)
    per_odd = 12 * bs**3 + 6 * bs * bs * wb + 2 * bs * wb * wb + 12 * bs * bs + 4 * bs * wb
    n = bs + wb
    return cost(dtype, nbytes, nb * ((P - 1) * per_odd + 2 * n**3 / 3 + 2 * n * n))


_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cr_solve.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_ENTRY = {torch.float32: "cr_solve_f32", torch.float64: "cr_solve_f64"}

MAX_WIDTH = 64  # cap on bs + wb (kMaxWidth in the source)
KINDS = ("pack", "up_odd", "up_even", "root", "down", "unpack")  # the launch kinds of `cr_plan`


def check_chain(A, Bp, E, F, r, rb):
    """Validate a chain for the kernel (the lane-minor contract, one dtype and
    device, contiguous, P a power of two, bs + wb within the cap); returns
    (P, bs, wb, B). Raises before any launch."""
    P, bs, _, B = A.shape
    wb = E.shape[-2]
    dtype, device = A.dtype, A.device
    if dtype not in _ENTRY:
        raise TypeError(f"CR kernel: dtype {dtype} (float32 or float64 only)")
    if P < 1 or P & (P - 1):
        raise ValueError(f"CR kernel: chain length {P} is not a power of two")
    if bs + wb > MAX_WIDTH:
        raise ValueError(f"CR kernel: bs + wb = {bs + wb} exceeds the cap {MAX_WIDTH}")
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
    return P, bs, wb, B


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the kernels")


def _flags(verbose: bool, extra=()):
    return NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ()) + tuple(extra)


def artifact(verbose: bool = False, source: Path = SOURCE, extra=()) -> Path:
    """The cached library of `source` and the flags (its compiler log is
    kept beside it with the suffix .log)."""
    key = hashlib.sha256(source.read_bytes() + " ".join(_flags(verbose, extra)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{key}.so"


def build(verbose: bool = False, source: Path = SOURCE, extra=()):
    """Compile `source` (a kernel of csrc/ with a plain C interface; by
    default csrc/cr_solve.cu) into BUILD_DIR, cached by source and flags.

    Returns (library path, build seconds, compiler log); seconds is 0.0 when a
    cached library is reused, and the log is then the one its build kept.
    verbose adds `-Xptxas -v` (registers, stack frame, spills) to the log;
    extra, more nvcc flags (part of the cache key)."""
    lib = artifact(verbose, source, extra)
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, 0.0, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp, log_tmp = (lib.with_suffix(f".{os.getpid()}.{kind}") for kind in ("tmp", "logtmp"))
    cmd = [_nvcc(), *_flags(verbose, extra), "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)  # the log first: a library found in the cache has its log
    os.replace(tmp, lib)
    return lib, seconds, log


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr, ptr]
        fn.restype = i32
    lib.cr_workspace_elems.argtypes = [i32] * 4
    lib.cr_workspace_elems.restype = ctypes.c_size_t
    lib.cr_plan.argtypes = [i32] * 5 + [ptr, i32]
    lib.cr_plan.restype = i32
    return lib


class CRKernel:
    """Callable wrapper of the CR kernel with plain-int counts: `launches`
    grows by one per solve call on the card and nowhere else;
    `grid_launches` by the CUDA launches that call issued (`plan`)."""

    def __init__(self):
        self.launches = 0
        self.grid_launches = 0
        self._lib = None

    def reset_counts(self):
        self.launches = 0
        self.grid_launches = 0

    def library(self, verbose: bool = False):
        """Build (if needed) and load the kernel library; returns the build
        (path, seconds, log) of this call."""
        info = build(verbose=verbose)
        if self._lib is None:
            self._lib = _load(info[0])
        return info

    def plan(self, P, bs, wb, B, itemsize):
        """The library's launch plan of one solve (`cr_plan`): (kind, blocks,
        threads per block, dynamic shared bytes) per CUDA launch, in order."""
        if self._lib is None:
            self.library()
        out = (ctypes.c_longlong * (4 * 128))()
        count = self._lib.cr_plan(P, bs, wb, B, itemsize, ctypes.cast(out, ctypes.c_void_p), 128)
        if count < 0:
            raise ValueError(f"CR kernel: the library takes no plan for P={P} bs={bs} wb={wb} B={B}")
        return [(KINDS[out[4 * i]], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]) for i in range(count)]

    def __call__(self, A, Bp, E, F, r, rb):
        if A.device.type == "cpu":
            return cr_solve_lanes(A, Bp, E, F, r, rb)
        if A.device.type != "cuda":
            raise RuntimeError(f"CR kernel: unsupported device {A.device}")
        P, bs, wb, B = check_chain(A, Bp, E, F, r, rb)
        dtype, device = A.dtype, A.device
        if self._lib is None:
            self.library()
        X = torch.empty((P, bs, B), dtype=dtype, device=device)
        xb = torch.empty((wb, B), dtype=dtype, device=device)
        work = torch.empty(self._lib.cr_workspace_elems(P, bs, wb, B), dtype=dtype, device=device)
        launched = ctypes.c_int(0)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(self._lib, _ENTRY[dtype])(
                A.data_ptr(), Bp.data_ptr(), E.data_ptr(), F.data_ptr(),
                r.data_ptr(), rb.data_ptr(), X.data_ptr(), xb.data_ptr(),
                work.data_ptr(), P, bs, wb, B, stream, ctypes.byref(launched),
            )
        self.grid_launches += launched.value
        if rc != 0:
            raise RuntimeError(f"CR kernel launch failed: cudaError {rc}")
        self.launches += 1
        return X, xb


cr_solve_batched = CRKernel()
