"""``idle_pct.step``: the share of the traced window of a scrub cell in
which no operation ran on the device."""


def read(r, trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
