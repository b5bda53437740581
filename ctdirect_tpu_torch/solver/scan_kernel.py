"""Wrapper of the hand-written Hopper CUDA kernel for the batched sequential
block elimination of the structured KKT system (`csrc/scan_solve.cu`).

It replaces no Pallas kernel: it is the card form of the JAX package's
native solver (`ctdirect_tpu/native` over `csrc/blocktri.cpp`) and of the
`lax.scan` loops of `ctdirect_tpu/solver/structured_kkt.py::_scan_solve`,
the block solve of the default `kkt_mode="structured"`. One solve is one
launch on the current stream, two warps a chain, up to four chains a CTA;
the kernel source notes its design and what bounds it on the card.

`scan_solve_batched(A, B_, E, F, r, rb)`, batch axis leading: A (Bt, N, bs,
bs), B_ (Bt, N-1, bs, bs), E (Bt, N, bs, wb), F (Bt, wb, wb), r (Bt, N, bs),
rb (Bt, wb) -> X (Bt, N, bs), xb (Bt, wb):
- CPU tensors run the plain version, `structured_kkt._scan_solve` applied per
  instance (`scan_solve_plain`);
- CUDA tensors launch the kernel on the current stream, or raise. There is no
  fallback to the plain version and nothing moves to the CPU.

`scan_solve` is the dispatch `StructuredKKT` calls: a `torch.autograd.Function`
whose `vmap` rule hands the whole batch to one `scan_solve_batched` call
(unbatched calls run it at Bt=1), as `lanes.cr_solve` does for the CR.

The kernel is built from the repository's source with `nvcc` at first use
into `ctdirect_tpu_torch/_build/` (`cr_kernel.build`: a plain-C shared
library loaded with ctypes), one library per width: bs = 1 .. EXACT_MAX
each its own (`-DSCAN_WIDTH=bs`: the kernel specialised to that bs), the
wider ones together (`-DSCAN_WIDTH=0`). Nothing CUDA-related happens at
import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
from pathlib import Path

import torch

from ctdirect_tpu_torch.solver import cr_kernel

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "scan_solve.cu"

_ENTRY = {torch.float32: "scan_solve_f32", torch.float64: "scan_solve_f64"}

MAX_WIDTH = 64  # cap on bs + wb (kMaxWidth in the source)
EXACT_MAX = 16  # widths built one library each (kExactMax in the source)
SM_COUNT = 132  # the H100 SXM's SMs: the kernel walks a chain on one of them


def _chain_flops(N, bs, wb):
    """The operations of one chain's block elimination. Per block: the
    inverse (2 bs^3), Ainv E and Ainv r (2 bs^2 wb + 2 bs^2), the border
    terms (2 bs wb^2 + 2 bs wb), the back sweep (4 bs^2 + 2 bs wb); per block
    after the first, C and the Schur updates of A, E and r (4 bs^3 + 2 bs^2
    wb + 2 bs^2); then the border solve (2 wb^3/3 + 2 wb^2)."""
    return (N * (2 * bs**3 + 2 * bs * bs * wb + 2 * bs * wb * wb + 6 * bs * bs + 4 * bs * wb)
            + (N - 1) * (4 * bs**3 + 2 * bs * bs * wb + 2 * bs * bs) + 2 * wb**3 / 3 + 2 * wb * wb)


def solve_cost(dtype, N, bs, wb, nb) -> cr_kernel.Cost:
    """The cost of one solve of nb chains of N blocks (`cr_kernel.Cost`):
    each input read once and each output written once; the operations of
    the block elimination (`_chain_flops`)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * nb * (N * (bs * bs + bs * wb + 2 * bs) + (N - 1) * bs * bs + wb * wb + 2 * wb)
    return cr_kernel.cost(dtype, nbytes, nb * _chain_flops(N, bs, wb))


def latency_floor_ms(dtype, N, bs, wb):
    """One chain's operations at one SM's share of the peak: its N steps
    run in order on one SM."""
    return _chain_flops(N, bs, wb) / (cr_kernel.PEAK_FLOP_S[dtype] / SM_COUNT) * 1e3


def width_key(bs):
    """The SCAN_WIDTH of the library that solves chains of block width bs."""
    return bs if bs <= EXACT_MAX else 0


# every library of the kernel, by SCAN_WIDTH
WIDTH_KEYS = (*range(1, EXACT_MAX + 1), 0)


def check_chain(A, B_, E, F, r, rb):
    """Validate a batch of chains for the kernel (one dtype and device,
    contiguous, the shapes of the contract, bs + wb within the cap); returns
    (Bt, N, bs, wb). Raises before any launch."""
    if A.ndim != 4:
        raise ValueError(f"scan kernel: A has shape {tuple(A.shape)}, want (Bt, N, bs, bs)")
    Bt, N, bs, _ = A.shape
    wb = E.shape[-1]
    dtype, device = A.dtype, A.device
    if dtype not in _ENTRY:
        raise TypeError(f"scan kernel: dtype {dtype} (float32 or float64 only)")
    if N < 1 or bs < 1:
        raise ValueError(f"scan kernel: empty chain (N={N}, bs={bs})")
    if bs + wb > MAX_WIDTH:
        raise ValueError(f"scan kernel: bs + wb = {bs + wb} exceeds the cap {MAX_WIDTH}")
    shapes = {
        "A": (A, (Bt, N, bs, bs)),
        "B": (B_, (Bt, N - 1, bs, bs)),
        "E": (E, (Bt, N, bs, wb)),
        "F": (F, (Bt, wb, wb)),
        "r": (r, (Bt, N, bs)),
        "rb": (rb, (Bt, wb)),
    }
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"scan kernel: {name} has shape {tuple(x.shape)}, want {shape}")
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"scan kernel: {name} is {x.dtype} on {x.device}, want {dtype} on {device}")
        if not x.is_contiguous():
            raise ValueError(f"scan kernel: {name} is not contiguous")
    return Bt, N, bs, wb


def scan_solve_plain(A, B_, E, F, r, rb):
    """The plain version: `structured_kkt._scan_solve` per instance of a
    batch-leading chain (`torch.func.vmap` of it; at Bt=1 one call, which
    keeps the unbatched structured solve's numbers on the CPU)."""
    from ctdirect_tpu_torch.solver.structured_kkt import _scan_solve

    if A.shape[0] == 1:
        X, xb = _scan_solve(*(x[0] for x in (A, B_, E, F, r, rb)))
        return X[None], xb[None]
    return torch.func.vmap(_scan_solve)(A, B_, E, F, r, rb)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.scan_workspace_elems.argtypes = [i32] * 4
    lib.scan_workspace_elems.restype = ctypes.c_size_t
    lib.scan_smem_bytes.argtypes = [i32] * 3
    lib.scan_smem_bytes.restype = ctypes.c_longlong
    lib.scan_launch_shape.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 2
    lib.scan_launch_shape.restype = i32
    return lib


class ScanKernel:
    """Callable wrapper of the scan kernel with a plain-int count:
    `launches` grows by one per solve call on the card (one CUDA launch
    each) and nowhere else."""

    def __init__(self):
        self.launches = 0
        self._libs = {}

    def reset_counts(self):
        self.launches = 0

    def library(self, key: int = 0):
        """Build (if needed) and load the library of SCAN_WIDTH `key`
        (`width_key(bs)`); returns the build (path, seconds, log) of this
        call. Every build keeps ptxas's report (`-Xptxas -v`), so that one
        cached library serves every process. The builds of several keys may
        run in parallel threads."""
        info = cr_kernel.build(verbose=True, source=SOURCE, extra=(f"-DSCAN_WIDTH={key}",))
        if key not in self._libs:
            self._libs[key] = _load(info[0])
        return info

    def build_all(self):
        """Build and load every library (WIDTH_KEYS), one nvcc each, as many
        at once as the host has cores; returns their (path, seconds, log)."""
        with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            return list(pool.map(self.library, WIDTH_KEYS))

    def _lib(self, bs):
        key = width_key(bs)
        if key not in self._libs:
            self.library(key=key)
        return self._libs[key]

    def smem_bytes(self, bs, wb, itemsize):
        """The dynamic shared memory of one chain (the library's)."""
        return self._lib(bs).scan_smem_bytes(bs, wb, itemsize)

    def launch_shape(self, bs, wb, B, itemsize):
        """(chains a CTA holds, chains resident on one SM) at a batch of B
        chains on the current device (the library's scan_launch_shape)."""
        per_cta, resident = ctypes.c_int(), ctypes.c_int()
        if self._lib(bs).scan_launch_shape(bs, wb, B, itemsize, ctypes.byref(per_cta), ctypes.byref(resident)):
            raise RuntimeError(f"scan kernel: no launch shape for bs={bs} wb={wb} B={B}")
        return per_cta.value, resident.value

    def __call__(self, A, B_, E, F, r, rb):
        if A.device.type == "cpu":
            return scan_solve_plain(A, B_, E, F, r, rb)
        if A.device.type != "cuda":
            raise RuntimeError(f"scan kernel: unsupported device {A.device}")
        Bt, N, bs, wb = check_chain(A, B_, E, F, r, rb)
        dtype, device = A.dtype, A.device
        lib = self._lib(bs)
        X = torch.empty((Bt, N, bs), dtype=dtype, device=device)
        xb = torch.empty((Bt, wb), dtype=dtype, device=device)
        work = torch.empty(lib.scan_workspace_elems(N, bs, wb, Bt), dtype=dtype, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, _ENTRY[dtype])(
                A.data_ptr(), B_.data_ptr(), E.data_ptr(), F.data_ptr(), r.data_ptr(), rb.data_ptr(),
                X.data_ptr(), xb.data_ptr(), work.data_ptr(), N, bs, wb, Bt, stream,
            )
        if rc != 0:
            raise RuntimeError(f"scan kernel launch failed: cudaError {rc}")
        self.launches += 1
        return X, xb


scan_solve_batched = ScanKernel()


class _ScanSolve(torch.autograd.Function):
    """The vmap-aware call of `scan_solve_batched`: unbatched, the batched
    solve at Bt=1; under vmap, the rule moves each operand's batch axis
    first and solves the whole batch in one call."""

    generate_vmap_rule = False

    @staticmethod
    def forward(A, B_, E, F, r, rb):
        X, xb = scan_solve_batched(*(x[None].contiguous() for x in (A, B_, E, F, r, rb)))
        return X[0], xb[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, A, B_, E, F, r, rb):
        def lead(x, d):
            if d is None:
                return x[None].expand(info.batch_size, *x.shape).contiguous()
            return x.movedim(d, 0).contiguous()

        X, xb = scan_solve_batched(*(lead(x, d) for x, d in zip((A, B_, E, F, r, rb), in_dims)))
        return (X, xb), (0, 0)


def scan_solve(A, B_, E, F, r, rb):
    """Block-tridiagonal + arrowhead solve by sequential block elimination.

    Single instance: A (N, bs, bs), B_ (N-1, bs, bs), E (N, bs, wb),
    F (wb, wb), r (N, bs), rb (wb) -> (X (N, bs), xb (wb)). Under
    `torch.func.vmap` the whole batch goes to one `scan_solve_batched` call:
    one kernel launch on the card."""
    return _ScanSolve.apply(A, B_, E, F, r, rb)
