"""kkt_assemble_ms: device ms a tick inside the benchmark's range around the
KKT operator's assembly (StructuredKKT._assemble: the chain's blocks), over
the traced ticks run op by op."""


def read(run):
    return run["rec"].get("stage_ms", {}).get("kkt.assemble")
