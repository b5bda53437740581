"""cr_roofline.tick: the least time the H100 could take for a tick's block
solves (perfbench/cost.py at the chain's own block count, bs, wb, B and the
solve's dtype, times the Newton steps) over their device time (the kernels
of the CR group, perfbench/kernels/cr.txt, and the rest of the range around
StructuredKKT._block_solve), in %, over the traced ticks run op by op."""


def read(run):
    r = run["rec"]
    if run["kind"] != "closed_loop_tick" or not r.get("block_solve_ms"):
        return None
    return 100.0 * r["block_solve_bound_ms"] / r["block_solve_ms"]
