"""host_syncs_per_iter: the batched IPM's flag reads (BatchStats.host_syncs)
over its outer iterations (BatchStats.iterations), over the window's calls."""


def read(run):
    r = run["rec"]
    if run["kind"] != "cold_batch" or not r.get("iterations"):
        return None
    return r["host_syncs"] / r["iterations"]
