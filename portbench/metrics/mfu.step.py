"""``mfu.step``: the share of the card's fixed peak that the scrub's steps
reach, the design count of each step's recompute (:mod:`portbench.work`)
over the traced window's length at the peak."""

from portbench import work


def read(r, trace):
    steps = r.calls.get("graph")
    if not steps:
        return None
    flop = sum(work.graph_count(r.config, *s)[0] for s in steps)
    return 100.0 * flop / (trace.window_s * work.PEAKS["flop_per_s"])
