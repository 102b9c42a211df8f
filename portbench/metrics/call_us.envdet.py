"""``call_us.envdet``: the mean host microseconds of one call of the detector's
decimating envelope in the window, the program's ``envdet.call`` span
(inside the generator's timer of ``enqueue_us.envdet``)."""


def read(r, trace):
    from audian_torch.utils import trace as log

    a = log.summary().get("envdet.call", {})
    return 1e3 * a["ms"] / a["count"] if a.get("count") else None
