"""``call_device_ms.chain``: the mean device ms of one ``chain_cf`` call in
the window: the ``device_ms`` of the program's ``chain.call`` span (CUDA
events around the call: the chain kernel and the statistics' reductions)."""


def read(r, trace):
    from audian_torch.utils import trace as log

    a = log.summary().get("chain.call", {})
    return (a["device_ms"] / a["count"] if a.get("count")
            and "device_ms" in a else None)
