"""Example audian plugin for the PyTorch port (drop into your working
directory; discovered as `audian*.py` with `audian_*traces` /
`audian_*analyzer` factories, exactly like the reference's plugin
protocol, `src/audian/plugins.py:45-62`).  The port's twin of
``examples/audianexample.py``: a custom derived trace computed with torch
on the browser's device, and a peak analyzer."""

import numpy as np
import torch

from audian_torch.analysis import Analyzer
from audian_torch.graph import EnvelopeNode, Node


class DifferenceNode(Node):
    """A custom derived trace: first difference of its source."""

    color = "#cc44cc"

    def compute(self, source, lead, n_out, params):
        # ``source`` is a tensor on the browser's device; it stays there
        d = torch.diff(source, dim=0, prepend=source[:1])
        return d[lead : lead + n_out]


def audian_example_traces(browser):
    browser.add_trace(EnvelopeNode("envelope", "filtered"))
    browser.add_trace(DifferenceNode("difference", "filtered"))


class PeakAnalyzer(Analyzer):
    def __init__(self, browser):
        super().__init__(browser, "peaks", "filtered")
        self.make_column("time", "s", "%.4f")
        self.make_column("peak", "", "%.4f")
        self.make_trace_events("peaks", "filtered", "o", "red", 8)

    def analyze(self, t0, t1, channel, traces):
        time, y = traces["filtered"]
        i = int(np.argmax(np.abs(y)))
        self.store(float(time[i]), float(y[i]))
        self.set_events("peaks", channel, [time[i]], [y[i]])


def audian_peak_analyzer(browser):
    PeakAnalyzer(browser)
