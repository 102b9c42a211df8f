"""Example audian plugin file for the PyTorch port (``audian_torch``).

Drop a file matching ``audian*.py`` into the directory you start
``audian-torch`` from and every callable named ``audian_*traces`` or
``audian_*analyzer`` is picked up automatically (the reference's plugin
contract, `src/audian/plugins.py:45-62`).  This is the port's twin of
``examples/audianplugins.py``: the same trace and analyzer, built on
``audian_torch`` alone.

Trace factories receive the browser and add derived-trace nodes; their
compute runs on the browser's device (the CUDA card by default) in the
same graph run as the built-in filter/spectrogram chain.  Analyzer
factories receive the browser and return an
:class:`audian_torch.analysis.Analyzer` whose ``analyze`` runs on every
selected region, on host (numpy) arrays.
"""

import numpy as np

from audian_torch.analysis import Analyzer
from audian_torch.graph import EnvelopeNode


def audian_envelope_traces(browser):
    """Add a 500 Hz envelope of the filtered trace (shown in the trace
    panel, computed on the device with exact two-sided halos)."""
    browser.add_trace(EnvelopeNode("envelope", "filtered",
                                   envelope_cutoff=500.0))


class ZeroCrossingAnalyzer(Analyzer):
    """Rate of sign changes of the filtered trace in the region — a
    cheap pitch proxy."""

    def __init__(self, browser):
        super().__init__(browser, "zerocrossings", "filtered")
        self.make_column("rate", "Hz", "%.1f")
        self.make_trace_events("crossings", "filtered", "x", "orange", 6)

    def analyze(self, t0, t1, channel, traces):
        t, y = traces["filtered"]
        signs = np.signbit(y)
        flips = np.nonzero(signs[1:] != signs[:-1])[0]
        self.store(len(flips) / max(t1 - t0, 1e-9) / 2.0)
        self.set_events("crossings", channel, t[flips[:50]],
                        np.zeros(min(len(flips), 50)))


def audian_zerocrossing_analyzer(browser):
    return ZeroCrossingAnalyzer(browser)
