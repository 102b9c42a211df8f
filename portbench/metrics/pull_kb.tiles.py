"""``pull_kb.tiles``: the kB per step that the tilers pull to the host, the
``bytes`` of the program's ``render.pull`` spans."""


def read(r, trace):
    from audian_torch.utils import trace as log

    b = log.summary().get("render.pull", {}).get("bytes")
    steps = len(r.calls.get("graph", ()))
    return b / steps / 1e3 if b is not None and steps else None
