"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Every test feeds the same numpy inputs, made from a seed, to the JAX package
and to its PyTorch port (on the CPU, in float64 unless stated) and compares
the outputs. One intra-op thread per test worker: the suite runs under
pytest-xdist with several workers on a shared machine."""

import numpy as np
import torch

torch.set_num_threads(1)

DI = "double_integrator_minenergy"


def jax_docp(name=DI, grid_size=12, scheme="trapeze"):
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem

    return transcribe(get_problem(name).ocp, grid_size=grid_size, scheme=scheme)


def torch_docp(name=DI, grid_size=12, scheme="trapeze", dtype=torch.float64):
    from ctdirect_tpu_torch import transcribe
    from ctdirect_tpu_torch.problems import get_problem

    return transcribe(
        get_problem(name).ocp, grid_size=grid_size, scheme=scheme, device="cpu", dtype=dtype
    )


def t(x, dtype=torch.float64):
    """numpy (or jax) array -> CPU tensor."""
    return torch.tensor(np.array(x), dtype=dtype)


def n(x):
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def random_chain_lanes(P, bs, wb, B, seed=0, dtype=np.float64):
    """Random well-conditioned padded block chain, lane-minor, numpy.

    A and F are SYMMETRIC: the CR recurrences exploit the KKT system's
    symmetry. Same construction as tests/test_pallas.py."""
    rng = np.random.default_rng(seed)

    def rnd(*s):
        return rng.standard_normal(s).astype(dtype)

    A = rnd(P, bs, bs, B) * 0.3
    A = A + np.swapaxes(A, 1, 2) + np.eye(bs, dtype=dtype)[None, :, :, None] * 4.0
    Bp = rnd(P, bs, bs, B) * 0.3
    Bp[-1] = 0.0
    E = rnd(P, bs, wb, B) * 0.2
    F = rnd(wb, wb, B) * 0.2
    F = F + np.swapaxes(F, 0, 1) + np.eye(wb, dtype=dtype)[:, :, None] * (4.0 + P)
    r = rnd(P, bs, B)
    rb = rnd(wb, B)
    return A, Bp, E, F, r, rb


def dense_lane_system(chain, lane):
    """Reassemble one lane of a lane-minor chain (arrays or tensors on any
    device) as a dense float64 (K, rhs)."""
    A, Bp, E, F, r, rb = (n(x).astype(np.float64)[..., lane] for x in chain)
    P, bs, wb = A.shape[0], A.shape[1], E.shape[2]
    size = P * bs + wb
    K = np.zeros((size, size))
    rhs = np.zeros(size)
    for i in range(P):
        sl = slice(i * bs, (i + 1) * bs)
        K[sl, sl] = A[i]
        if i + 1 < P:
            sl1 = slice((i + 1) * bs, (i + 2) * bs)
            K[sl, sl1] = Bp[i]
            K[sl1, sl] = Bp[i].T
        K[sl, P * bs :] = E[i]
        K[P * bs :, sl] = E[i].T
        rhs[sl] = r[i]
    K[P * bs :, P * bs :] = F
    rhs[P * bs :] = rb
    return K, rhs


def relative_residual(chain, X, xb, lane):
    """|K x - rhs| / (|K| |x| + |rhs|) of one lane's reassembled dense system,
    for a lane-minor solution X (P, bs, B), xb (wb, B)."""
    K, rhs = dense_lane_system(chain, lane)
    X, xb = n(X).astype(np.float64), n(xb).astype(np.float64)
    x = np.concatenate([X[:, :, lane].reshape(-1), xb[:, lane]])
    scale = np.abs(K).sum(axis=1).max() * np.abs(x).max() + np.abs(rhs).max()
    return float(np.abs(K @ x - rhs).max() / scale)
