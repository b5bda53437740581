"""ctdirect_tpu_torch — the PyTorch / CUDA port of ctdirect_tpu.

Direct-transcription optimal control: an OCP is transcribed into a
finite-dimensional NLP (DOCP) and solved by a structure-exploiting
interior-point method; a batched warm-started MPC tick advances many
controllers at once. Derivatives come from `torch.func`; the batched block
cyclic-reduction KKT solve is a hand-written CUDA kernel on the card
(csrc/cr_solve.cu) with a plain PyTorch version on the CPU.

Every public entry point (`transcribe`, `discretize`, `solve`,
`MPCController`, `BatchSolver`) takes an explicit `device=` and `dtype=`
(default torch.float64). User callables are written in torch and must be
traceable by `torch.func` transforms (build vectors with `torch.stack`). This
package imports neither jax nor ctdirect_tpu.
"""

from ctdirect_tpu_torch.model import InitialGuess, OCP, PreOCP, Solution, define
from ctdirect_tpu_torch.solver import IPMOptions, solve, solve_docp
from ctdirect_tpu_torch.transcription import (
    DOCP,
    Collocation,
    DirectShooting,
    discretize,
    transcribe,
)

__all__ = [
    "OCP",
    "PreOCP",
    "define",
    "InitialGuess",
    "Solution",
    "DOCP",
    "transcribe",
    "Collocation",
    "DirectShooting",
    "discretize",
    "IPMOptions",
    "solve",
    "solve_docp",
]

__version__ = "0.1.0"
