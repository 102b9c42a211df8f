"""``pull_ms.tiles``: the host ms per step of the program's ``render.pull``
spans, the tilers' pulls of computed tiles to the host (each ends in the
copy, so it holds the wait for the tile's device work)."""


def read(r, trace):
    from audian_torch.utils import trace as log

    ms = log.summary().get("render.pull", {}).get("ms")
    steps = len(r.calls.get("graph", ()))
    return ms / steps if ms is not None and steps else None
