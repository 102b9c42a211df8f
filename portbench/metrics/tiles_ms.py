"""``tiles_ms``: the host time of a step's refresh, its tiles computed and
pulled to the host, timed by the generator, per step."""


def read(r, trace):
    t = r.host.get("tiles")
    return 1e3 * sum(t) / len(t) if t else None
