"""``envdet_roofline``: the detector's envelope kernel's share of its
roofline, the least time of the configuration's work in the traced window
(:mod:`portbench.work`) over the device time of the kernels named
``envdet_kernel``."""

from portbench import work


def read(r, trace):
    calls = r.calls.get("envdet")
    seconds, _ = trace.kernel_s("envdet_kernel")
    if not calls or not seconds:
        return None
    least = sum(work.bound_s(*work.envdet_count(r.config, *c))[0]
                for c in calls)
    return 100.0 * least / seconds
