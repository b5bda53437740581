"""The least time the H100 could take for a block solve of the KKT chain:
a frozen copy of the program's `solver/cr_kernel.py::solve_cost` and `cost`,
counted at the chain's own block count rather than the power of two that the
cyclic reduction pads it to (the padding is the implementation's choice, so
the count stays the same whatever implements the solve).

Peaks: NVIDIA's H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of HBM3,
67 TFLOP/s in float32 outside the tensor cores and in float64 on them."""

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """max(bytes / PEAK_BYTES_S, flops / PEAK_FLOP_S), in seconds."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S)


def block_solve(itemsize: int, P: int, bs: int, wb: int, nb: int) -> tuple:
    """(bytes, flops) of one solve of nb chains of P blocks of width bs with
    a border of width wb: each input read once and each output written once;
    per eliminated block the inverse (2 bs^3), five bs x bs products (10
    bs^3), three products with the border coupling (6 bs^2 wb), the border
    term (2 bs wb^2), the right-hand sides and the back substitution (12 bs^2
    + 4 bs wb); then one dense LU solve of the root, n = bs + wb (2n^3/3 +
    2n^2)."""
    nbytes = itemsize * nb * (P * (2 * bs * bs + bs * wb + 2 * bs) + wb * wb + 2 * wb)
    per_block = 12 * bs**3 + 6 * bs * bs * wb + 2 * bs * wb * wb + 12 * bs * bs + 4 * bs * wb
    n = bs + wb
    return nbytes, nb * ((P - 1) * per_block + 2 * n**3 / 3 + 2 * n * n)


def trapeze_chain(n: int, m: int, N: int) -> tuple:
    """(P, bs, wb) of the KKT chain of a trapezoidal transcription with n
    states, m controls and N steps, no path constraints, x(0) and x(N)
    fixed: N step blocks, each a node's n + m variables and its step's n
    defect rows; the border the last node's n + m variables and the 2n
    boundary rows."""
    return N, (n + m) + n, (n + m) + 2 * n
