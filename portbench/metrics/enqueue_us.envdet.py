"""``enqueue_us.envdet``: the median host time of one call of the
detector's envelope kernel in the traced window, timed around the call by
the generator."""

import statistics


def read(r, trace):
    t = r.host.get("enqueue.envdet")
    return 1e6 * statistics.median(t) if t else None
