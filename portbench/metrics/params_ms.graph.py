"""``params_ms.graph``: the host ms per step of the program's
``graph.params`` spans, the executor's copies of a node's new design to the
device (a cache miss: the filter re-designed at each cutoff)."""


def read(r, trace):
    from audian_torch.utils import trace as log

    ms = log.summary().get("graph.params", {}).get("ms")
    steps = len(r.calls.get("graph", ()))
    return ms / steps if ms is not None and steps else None
