"""kkt_prepare_ms: device ms a tick inside the benchmark's range around the
KKT operator's prepare (StructuredKKT.prepare: the Hessian and Jacobian
blocks), over the traced ticks run op by op."""


def read(run):
    return run["rec"].get("stage_ms", {}).get("kkt.prepare")
