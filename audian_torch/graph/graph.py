"""The derived-trace DAG (a copy of ``audian_tpu/graph/graph.py``).

Functional twin of the reference's ``Data.setup_traces`` /
``Data.open`` plumbing: topological ordering of nodes by their
``source_name`` (`src/audian/data.py:121-147`), backward folding of halo
times through the chain so the raw window is over-fetched exactly enough
(`src/audian/data.py:154-166`), and visibility-driven laziness
(`src/audian/buffereddata.py:131-146`, `src/audian/data.py:213-222`) as a
pure set computation instead of mutable ``need_update`` flags.
"""

from __future__ import annotations

from .spec import TraceSpec

RAW = "data"


class MissingSourceError(KeyError):
    """A node references a source that is not in the graph
    (`src/audian/data.py:139-146` reports this on stdout; we raise)."""

    def __init__(self, node_name, source_name, available):
        self.node_name = node_name
        self.source_name = source_name
        self.available = list(available)
        super().__init__(
            f'source "{source_name}" for trace "{node_name}" not found! '
            f"available sources: {', '.join(self.available)}"
        )


class TraceGraph:
    """DAG of derived-trace nodes over one raw recording.

    Nodes are added by name; :meth:`open` orders them topologically from
    the raw source, folds halos backward, and opens each node against its
    source spec.  The graph itself is host-side bookkeeping — all compute
    goes through :class:`audian_torch.graph.executor.GraphExecutor`.
    """

    def __init__(self, nodes=()):
        self.nodes = []
        self.raw_spec = None
        self._order = None  # topo-ordered node list (post-open)
        self._halo = (0.0, 0.0)  # raw halo requirement in seconds
        for n in nodes:
            self.add(n)

    # -- construction ---------------------------------------------------------

    def add(self, node):
        if any(n.name.lower() == node.name.lower() for n in self.nodes):
            raise ValueError(f"duplicate trace name: {node.name}")
        if node.name.lower() == RAW:
            raise ValueError(f'"{RAW}" is reserved for the raw trace')
        self.nodes.append(node)
        self._order = None
        return node

    def remove(self, name):
        node = self[name]
        if node is not None:
            self.nodes.remove(node)
            self._order = None
        return node

    def clear(self):
        self.nodes = []
        self._order = None

    # -- dict-like access (reference `data.py:57-100`) -------------------------

    def __len__(self):
        return len(self.nodes)

    def __iter__(self):
        return iter(self.order if self._order is not None else self.nodes)

    def __getitem__(self, key):
        for n in self.nodes:
            if n.name.lower() == key.lower():
                return n
        return None

    def __contains__(self, key):
        return self[key] is not None

    def keys(self):
        return [n.name for n in (self._order or self.nodes)]

    def get_nodes(self, cls):
        """Names of nodes of a given class
        (`src/audian/data.py:74-80` analog)."""
        return [n.name for n in self.nodes if isinstance(n, cls)]

    # -- ordering / opening -----------------------------------------------------

    @property
    def order(self):
        if self._order is None:
            self._order = self._topo_sort()
        return self._order

    def _topo_sort(self):
        ordered = []
        names = {RAW}
        pending = list(self.nodes)
        progress = True
        while pending and progress:
            progress = False
            for n in list(pending):
                if n.source_name.lower() in {s.lower() for s in names}:
                    ordered.append(n)
                    names.add(n.name)
                    pending.remove(n)
                    progress = True
        if pending:
            raise MissingSourceError(
                pending[0].name, pending[0].source_name,
                [RAW] + [n.name for n in ordered],
            )
        return ordered

    def open(self, raw_spec: TraceSpec):
        """Open every node against its source's spec in topological order
        and fold halo requirements backward to the raw trace.

        Returns the raw halo ``(tbefore, tafter)`` in seconds — how much
        the raw fetch window must be extended
        (`src/audian/data.py:154-169`)."""
        self.raw_spec = raw_spec
        specs = {RAW: raw_spec}
        for n in self.order:
            specs[n.name.lower()] = n.open(specs[n.source_name.lower()])
        return self.refold()

    def refold(self):
        """Re-fold halo requirements (cheap).  Call after a node update
        changes its design-dependent halos — unlike :meth:`open` this does
        not reset node parameters."""
        # need[name] = extra seconds the node's OUTPUT must be extended by
        # for downstream consumers
        need = {n.name.lower(): [0.0, 0.0] for n in self.order}
        need[RAW] = [0.0, 0.0]
        for n in reversed(self.order):
            nb, na = need[n.name.lower()]
            hb, ha = n.halo_seconds()
            src = need[n.source_name.lower()]
            src[0] = max(src[0], hb + nb)
            src[1] = max(src[1], ha + na)
        self._need = {k: tuple(v) for k, v in need.items()}
        self._halo = self._need[RAW]
        return self._halo

    def source_of(self, node):
        """Spec of a node's source."""
        if node.source_name.lower() == RAW:
            return self.raw_spec
        return self[node.source_name].spec

    @property
    def raw_halo(self):
        """Raw-window halo (tbefore, tafter) in seconds, as folded by
        :meth:`open`."""
        return self._halo

    def output_halo(self, name):
        """Extra seconds of this node's output that downstream consumers
        need (0 for leaves)."""
        return self._need[name.lower()]

    # -- laziness ---------------------------------------------------------------

    def active_set(self, visible):
        """All node names that must be computed so every *visible* trace is
        up to date: the visible set plus every ancestor.  Functional
        replacement for the reference's ``set_need_update`` flag cascade
        (`src/audian/buffereddata.py:131-146`)."""
        visible = {v.lower() for v in visible}
        active = set()

        def pull(name):
            name = name.lower()
            if name == RAW:
                active.add(RAW)
                return
            node = self[name]
            if node is None:
                return
            active.add(name)
            pull(node.source_name)

        for v in visible:
            pull(v)
        return active
