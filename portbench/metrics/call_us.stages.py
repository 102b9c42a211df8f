"""``call_us.stages``: the mean host microseconds of one ``chain_cf`` call on
the per-stage route in the window, the program's ``stages.call`` span."""


def read(r, trace):
    from audian_torch.utils import trace as log

    a = log.summary().get("stages.call", {})
    return 1e3 * a["ms"] / a["count"] if a.get("count") else None
