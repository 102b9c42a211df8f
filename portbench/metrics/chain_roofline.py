"""``chain_roofline``: the chain kernel's share of its roofline, the least
time of the configuration's work in the traced window (:mod:`portbench.work`:
its design's taps and the DFT at the card's fixed peaks) over the device
time of the kernels named ``chain_kernel``."""

from portbench import work


def read(r, trace):
    sizes = r.calls.get("chain")
    seconds, _ = trace.kernel_s("chain_kernel")
    if not sizes or not seconds:
        return None
    least = sum(work.bound_s(*work.chain_count(r.config, m))[0]
                for m in sizes)
    return 100.0 * least / seconds
