"""Frontends of the port: matplotlib (:mod:`.mpl`, :mod:`.songplot`) and
Qt/pyqtgraph (:mod:`.qt`), both optional and imported lazily; the
counterpart of ``audian_tpu/gui``."""
