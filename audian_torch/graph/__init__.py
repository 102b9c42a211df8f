"""The lazy, chunked trace DAG of the port: immutable specs, nodes with
host-side geometry and tensor compute, and an eager chunk executor
(counterpart of ``audian_tpu/graph``)."""

from .executor import GraphExecutor
from .graph import RAW, MissingSourceError, TraceGraph
from .nodes import EnvelopeNode, FilterNode, Node, SpectrogramNode
from .spec import TraceSpec

__all__ = [
    "EnvelopeNode",
    "FilterNode",
    "GraphExecutor",
    "MissingSourceError",
    "Node",
    "RAW",
    "SpectrogramNode",
    "TraceGraph",
    "TraceSpec",
]
