"""converged_pct.batch: the share of the window's instances that the batched
IPM brought to its tolerance within the configuration's iteration cap
(status 0 or 4), in %. A change that makes a call faster by converging
fewer instances shows here beside cold_solves_per_s."""


def read(run):
    r = run["rec"]
    if run["kind"] != "cold_batch" or not r.get("attempted"):
        return None
    return 100.0 * r["converged"] / r["attempted"]
