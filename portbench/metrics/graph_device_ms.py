"""``graph_device_ms``: the device time, per step, of the work launched
inside the generator's ``portbench.graph`` range around the cutoff update
(the window's recompute on the graph)."""


def read(r, trace):
    t = trace.range_s("graph")
    return 1e3 * sum(t) / len(t) if t else None
