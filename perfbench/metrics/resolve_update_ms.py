"""resolve_update_ms: device ms a tick outside every KKT range and the CR
kernel, over the traced ticks run op by op: the shift, x0 into the boundary
rows, the resolve's derivatives (grad f, J^T lam), barrier terms, residuals,
the step to the boundary, the state update and the exit norms."""


def read(run):
    return run["rec"].get("stage_ms", {}).get("update")
