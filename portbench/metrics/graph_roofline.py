"""``graph_roofline``: the share of their roofline that the kernels a
cutoff step launches reach: the least time of the configuration's design
count for one recompute of the window (:mod:`portbench.work`; the graph's
longer FIR kernels count as excess, not as work) over the device time
launched inside the step's ``portbench.graph`` range."""

from portbench import work


def read(r, trace):
    steps = r.calls.get("graph")
    seconds = sum(trace.range_s("graph"))
    if not steps or not seconds:
        return None
    least = sum(work.bound_s(*work.graph_count(r.config, *s))[0]
                for s in steps)
    return 100.0 * least / seconds
