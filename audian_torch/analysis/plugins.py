"""User plugin discovery.

Reference-compatible (`src/audian/plugins.py:16-72`): scans the current
working directory for ``audian*.py`` modules and registers every callable
named ``audian_*traces`` (derived-trace factory, called with the browser)
or ``audian_*analyzer`` (analyzer factory).  The default trace factory
installs the filter + spectrogram chain, exactly like the reference's
``default_setup_traces`` (`plugins.py:11-13`) — the envelope trace is a
plugin/CLI opt-in.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

from ..graph import FilterNode, SpectrogramNode

__all__ = ["Plugins", "default_setup_traces"]


def default_setup_traces(browser):
    browser.add_trace(FilterNode())
    browser.add_trace(SpectrogramNode())


class Plugins:

    def __init__(self):
        self.plugins = {}
        self.trace_factories = [default_setup_traces]
        self.analyzer_factories = []
        self._loaded_paths = set()  # dedup by file, not stem

    def add_plugin(self, name, module):
        self.plugins[name] = module

    def snapshot(self):
        """An independent Plugins with the same registered factories.

        Background sessions use this instead of sharing the live
        instance: the factory lists are copied, so a
        concurrent ``add_*_factory`` on the UI thread cannot mutate a
        list the clone is iterating, and the clone never reruns plugin
        module top-level code.  Factory *functions* are shared — they
        construct fresh trace/analyzer objects per session, so they must
        be re-entrant (they already are called once per open file)."""
        snap = Plugins()
        snap.plugins = dict(self.plugins)
        snap.trace_factories = list(self.trace_factories)
        snap.analyzer_factories = list(self.analyzer_factories)
        snap._loaded_paths = set(self._loaded_paths)
        return snap

    def add_trace_factory(self, factory_func):
        self.trace_factories.append(factory_func)

    def clear_trace_factories(self):
        self.trace_factories = []

    def add_analyzer_factory(self, factory_func):
        self.analyzer_factories.append(factory_func)

    def clear_analyzer_factories(self):
        self.analyzer_factories = []

    def load_plugins(self, directory=None, verbose=True):
        """Scan ``directory`` (CWD by default) for ``audian*.py`` and
        register the factories found.

        Files load by PATH (not ``import_module`` by stem): stem imports
        resolve through sys.modules and the whole sys.path, so a second
        directory's ``audianfoo.py`` would silently get the first one's
        cached module, and a stem shadowing an installed package would
        import that package instead.  A broken plugin is reported and
        skipped — one stray file in the launch directory must not make
        the app unlaunchable.  Already-loaded stems are skipped so a
        repeated scan cannot register duplicate factories.
        """
        cwd = Path(directory) if directory else Path.cwd()
        for module in sorted(cwd.glob("audian*.py")):
            path = module.resolve()
            if path in self._loaded_paths:
                continue  # re-scan: factories are already registered
            try:
                spec = importlib.util.spec_from_file_location(
                    module.stem, module)
                x = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(x)
            except Exception as e:
                # NOT recorded as loaded: a failed exec registered no
                # factories, so a later rescan (after the user fixes the
                # file) can retry instead of blacklisting it for the
                # session
                print(f"cannot load plugin {module}: {e}",
                      file=sys.stderr)
                continue
            self._loaded_paths.add(path)
            called = False
            for k in dir(x):
                attr = getattr(x, k)
                if k.startswith("audian_") and callable(attr):
                    if k.endswith("traces"):
                        self.add_trace_factory(attr)
                        called = True
                    elif k.endswith("analyzer"):
                        self.add_analyzer_factory(attr)
                        called = True
            if called:
                self.add_plugin(module.stem, x)
                if verbose:
                    print(f"loaded audian plugins from {module.stem}")

    def setup_traces(self, browser):
        for f in self.trace_factories:
            f(browser)

    def setup_analyzers(self, browser):
        for f in self.analyzer_factories:
            f(browser)

    # reference spelling (`plugins.py:70-72`)
    setup_analyzer = setup_analyzers
