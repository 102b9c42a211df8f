"""``call_us.chain``: the mean host microseconds of one ``chain_cf`` call in the
window, the program's ``chain.call`` span (inside the generator's timer of
``enqueue_us.chain``)."""


def read(r, trace):
    from audian_torch.utils import trace as log

    a = log.summary().get("chain.call", {})
    return 1e3 * a["ms"] / a["count"] if a.get("count") else None
