"""The port's FIR lengths on the JAX package's graph nodes.

The port designs each FIR node of its graph at the design's own decay
length (``FilterDesign.from_sos``).  The JAX package's nodes keep a budget
that starts at four times it and only grows, and their taps lead with the
port's.  Tests that hold the port's graph to the JAX package's wrap the
JAX nodes with :func:`at_port_lengths`, so both plan and compute the same
geometry.
"""

from audian_torch.ops.design import FilterDesign


def at_port_lengths(*nodes):
    """Have each JAX FIR node of ``nodes`` (a node with a ``_kernel_len``
    budget) design at the port's length on every redesign; returns
    ``nodes``."""
    for node in nodes:
        if hasattr(node, "_kernel_len"):
            node._redesign = _port_redesign(node, node._redesign)
    return nodes


def _port_redesign(node, redesign):
    def port_redesign():
        changed = redesign()
        if node.design is not None:
            node._kernel_len = FilterDesign.from_sos(node._sos).fir.length
            redesign()
        return changed
    return port_redesign
