"""The port's benchmark: the harness that measures ``audian_torch`` on the
card."""
