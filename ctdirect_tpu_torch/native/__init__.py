"""The port's counterpart of `ctdirect_tpu.native`: the block-tridiagonal +
arrowhead KKT solve as a hand-written kernel.

The JAX package keeps a host-side C++ solver (`csrc/blocktri.cpp`, built with
g++ and OpenMP-batched over instances) as an independent oracle for its
solvers and as a fallback that runs without the accelerator. On the card
the counterpart of that hand-written native solver is the hand-written CUDA
kernel `csrc/scan_solve.cu` (`solver/scan_kernel.py`): the same block
elimination, one CTA per instance. Here it takes torch tensors; CUDA tensors
launch the kernel, CPU tensors run its plain version (the structured solve's
`_scan_solve`). The C++ library stays the JAX package's own; this module
neither builds nor loads it."""

from __future__ import annotations

from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched


def available() -> bool:
    """Whether the kernel builds and loads (nvcc and the CUDA runtime are
    there). It picks no device."""
    try:
        scan_solve_batched.library()
        return True
    except Exception:  # noqa: BLE001 -- no nvcc, no CUDA runtime, a failed build
        return False


def blocktri_solve(A, B, E, F, r, rb):
    """Solve one block-tridiagonal + border system on the tensors' device.

    Shapes: A (N,bs,bs), B (N-1,bs,bs), E (N,bs,wb), F (wb,wb), r (N,bs),
    rb (wb,), one dtype (float32 or float64). Returns (X (N,bs), xb (wb,))."""
    X, xb = scan_solve_batched(*(x[None].contiguous() for x in (A, B, E, F, r, rb)))
    return X[0], xb[0]


def blocktri_solve_batch(A, B, E, F, r, rb):
    """Batched solve: a leading batch axis on every argument; one kernel
    launch for the whole batch on the card."""
    return scan_solve_batched(*(x.contiguous() for x in (A, B, E, F, r, rb)))
