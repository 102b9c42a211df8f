"""``mfu.batch``: the share of the card's fixed peak that the batch
window's work reaches, the configuration's operations of every call in the
traced window (:mod:`portbench.work`) over the window's length at the
peak.  It bounds the kernels' roofline shares from below whatever kernels
run."""

from portbench import work


def read(r, trace):
    flop = sum(work.chain_count(r.config, m)[0]
               for m in r.calls.get("chain", ()))
    flop += sum(work.envdet_count(r.config, *c)[0]
                for c in r.calls.get("envdet", ()))
    if not flop:
        return None
    return 100.0 * flop / (trace.window_s * work.PEAKS["flop_per_s"])
