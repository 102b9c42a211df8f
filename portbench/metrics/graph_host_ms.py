"""``graph_host_ms``: the program's ``graph.run`` span (the executor's host
time over a window's nodes; tracing on in the traced run only), per step."""


def read(r, trace):
    ms = r.spans.get("graph.run")
    return sum(ms) / len(ms) if ms else None
