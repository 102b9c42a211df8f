"""``stages_roofline``: window_matmul's share of its roofline on the chain's
per-stage route, the least time of the configuration's work in the traced
window (:mod:`portbench.work`: its design's taps and the DFT at the card's
fixed peaks, over every ``chain_cf`` call of the route) over the device
time of the kernels named ``window_matmul_kernel``."""

from portbench import work


def read(r, trace):
    sizes = r.calls.get("chain")
    seconds, _ = trace.kernel_s("window_matmul_kernel")
    if not sizes or not seconds:
        return None
    least = sum(work.bound_s(*work.chain_count(r.config, m))[0]
                for m in sizes)
    return 100.0 * least / seconds
