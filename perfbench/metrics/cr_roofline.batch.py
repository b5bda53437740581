"""cr_roofline.batch: the least time the H100 could take for the block
solves of one traced graphed BatchSolver call (perfbench/cost.py at the
chain's own block count, bs, wb, B and dtype, times the call's KKT solves)
over the device time of the CR group's kernels in it, in %."""


def read(run):
    r = run["rec"]
    if run["kind"] != "cold_batch" or not r.get("block_solve_ms"):
        return None
    return 100.0 * r["block_solve_bound_ms"] / r["block_solve_ms"]
