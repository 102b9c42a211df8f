"""``enqueue_us.chain``: the median host time of one ``chain_cf`` call of
the traced window, timed around the call by the generator."""

import statistics


def read(r, trace):
    t = r.host.get("enqueue.chain")
    return 1e6 * statistics.median(t) if t else None
