"""DOCP structure reports (PyTorch port of `ctdirect_tpu.utils.structure`).

The KKT system is block-banded by construction (structured_kkt.py assembles
per-step blocks directly), so instead of hand-kept sparsity patterns this
module

- computes the true Jacobian/Hessian occupancy by AD (`torch.func.jacfwd` /
  `torch.func.hessian` of the DOCP's own callbacks, on its device) at a
  generic point,
- predicts the block-band envelope from the layout arithmetic (numpy), and
- checks containment (`verify_structure`), a machine-checkable regression
  gate for layout bugs;

plus `structure_report` (dims / nnz bookkeeping) and `plot_pattern` for the
visual.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ctdirect_tpu_torch.transcription.docp import DOCP, to_numpy


def _generic_point(docp: DOCP, seed: int = 0) -> torch.Tensor:
    """A generic (non-symmetric, interior) evaluation point on the DOCP's
    device: the 0.1-fill guess perturbed by deterministic noise, so
    structural zeros do not alias accidental ones."""
    rng = np.random.default_rng(seed)
    z = docp.initial_guess(None) + 0.05 * rng.standard_normal(docp.nz)
    return docp.tensor(np.asarray(z, dtype=np.float64))


def jacobian_occupancy(docp: DOCP, seed: int = 0, tol: float = 0.0) -> np.ndarray:
    """(nc, nz) boolean: true Jacobian nonzeros of the constraint program."""
    J = torch.func.jacfwd(docp.constraints)(_generic_point(docp, seed))
    return to_numpy(torch.abs(J) > tol)


def hessian_occupancy(docp: DOCP, seed: int = 0, tol: float = 0.0) -> np.ndarray:
    """(nz, nz) boolean: true Lagrangian-Hessian nonzeros (unit multipliers)."""
    z = _generic_point(docp, seed)
    lam = torch.ones((docp.nc,), dtype=z.dtype, device=z.device)

    def lag(zz):
        return docp.nlp_objective(zz) + torch.dot(lam, docp.constraints(zz))

    return to_numpy(torch.abs(torch.func.hessian(lag)(z)) > tol)


def predicted_jacobian_envelope(docp: DOCP) -> np.ndarray:
    """(nc, nz) boolean envelope implied by the step layout: constraint block i
    touches step-variable block i, the leading interface of block i+1 (or the
    tail), and v; final-path touches the last step + tail + v; boundary touches
    x0 + tail + v. This is exactly the structure StructuredKKT assembles."""
    N, bw, cw, iw, n = docp.N, docp.bw, docp.cw, docp.tail_w, docp.n
    npath, nb = docp.n_path, docp.n_boundary
    env = np.zeros((docp.nc, docp.nz), dtype=bool)
    tail0 = N * bw
    v0 = tail0 + iw
    for i in range(N):
        r0 = i * cw
        env[r0 : r0 + cw, i * bw : (i + 1) * bw] = True
        if i + 1 < N:
            env[r0 : r0 + cw, (i + 1) * bw : (i + 1) * bw + iw] = True
        else:
            env[r0 : r0 + cw, tail0 : tail0 + iw] = True
        env[r0 : r0 + cw, v0:] = True
    r_fp = N * cw
    if npath:
        env[r_fp : r_fp + npath, (N - 1) * bw : N * bw] = True
        env[r_fp : r_fp + npath, tail0 : tail0 + iw] = True
        env[r_fp : r_fp + npath, v0:] = True
    if nb:
        r_bc = r_fp + npath
        env[r_bc : r_bc + nb, 0:n] = True
        env[r_bc : r_bc + nb, tail0 : tail0 + iw] = True
        env[r_bc : r_bc + nb, v0:] = True
    return env


def verify_structure(docp: DOCP, seed: int = 0) -> bool:
    """True iff every actual Jacobian nonzero lies inside the predicted
    block-band envelope (i.e. the structured solver's assembly is lossless)."""
    occ = jacobian_occupancy(docp, seed)
    env = predicted_jacobian_envelope(docp)
    return bool(np.all(env | ~occ))


def structure_report(docp: DOCP) -> dict:
    """Dims + nnz bookkeeping (computed, not hand-stored)."""
    occ_j = jacobian_occupancy(docp)
    return {
        "name": docp.ocp.name,
        "scheme": docp.scheme.name,
        "N": docp.N,
        "nz": docp.nz,
        "nc": docp.nc,
        "step_block_width": docp.bw,
        "step_cons_rows": docp.cw,
        "tail_width": docp.tail_w,
        "super_block": docp.bw + docp.cw,
        "border_width": docp.tail_w + docp.q + docp.n_path + docp.n_boundary,
        "nnz_jacobian": int(occ_j.sum()),
        "jacobian_density": float(occ_j.mean()),
        "envelope_contains_jacobian": verify_structure(docp),
    }


def plot_pattern(
    docp: DOCP, which: str = "jacobian", ax=None, save: Optional[str] = None
):
    """Render the true occupancy (spy plot). Requires matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    M = jacobian_occupancy(docp) if which == "jacobian" else hessian_occupancy(docp)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    ax.spy(M, markersize=1)
    ax.set_title(f"{docp.ocp.name} {which} ({docp.scheme.name}, N={docp.N})")
    if save:
        ax.figure.savefig(save, dpi=120, bbox_inches="tight")
    return ax
