"""Sectioned, typed configuration files.

Stand-in for thunderlab's ``ConfigFile`` as the reference's songdetector
uses it (`songdetector.py:703-743`): named values with unit and doc
strings grouped in sections, cascade-loaded from the working directory and
the data file's parent directories, dumpable to a commented ``.cfg`` file.
A copy of ``audian_tpu/config.py`` (pure Python), so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import sys
from pathlib import Path

__all__ = ["ConfigFile"]


class ConfigFile:

    def __init__(self):
        self._values = {}    # name -> value
        self._units = {}
        self._docs = {}
        self._sections = []  # (section, [names])

    def add_section(self, name):
        self._sections.append((name, []))

    def add(self, name, value, unit="", doc=""):
        if not self._sections:
            self.add_section("Settings:")
        self._sections[-1][1].append(name)
        self._values[name] = value
        self._units[name] = unit
        self._docs[name] = doc

    def value(self, name):
        return self._values[name]

    def set(self, name, value):
        if name not in self._values:
            raise KeyError(name)
        old = self._values[name]
        if isinstance(old, bool):
            if isinstance(value, str):
                value = value.strip().lower() in ("true", "yes", "1", "on")
        elif isinstance(old, (int, float)) and isinstance(value, str):
            value = type(old)(float(value))
        self._values[name] = value

    def __contains__(self, name):
        return name in self._values

    def keys(self):
        return list(self._values)

    # -- persistence ------------------------------------------------------------

    def dump(self, path):
        lines = []
        for section, names in self._sections:
            lines.append(f"# {section}")
            for name in names:
                doc = self._docs[name]
                if doc:
                    lines.append(f"# {doc}")
                unit = self._units[name]
                lines.append(f"{name}: {self._values[name]}"
                             + (unit if unit else ""))
            lines.append("")
        Path(path).write_text("\n".join(lines))
        return path

    def load(self, path):
        for raw in Path(path).read_text().splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            name, _, value = line.partition(":")
            name = name.strip()
            if name not in self._values:
                continue
            value = value.partition("#")[0].strip()  # inline comments
            unit = self._units[name]
            if unit and value.endswith(unit):
                value = value[: -len(unit)].strip()
            try:
                self.set(name, value)
            except (ValueError, TypeError) as e:
                # a hand-edited bad value must not kill the whole batch
                # run (thunderlab's ConfigFile warns and skips too)
                print(f"{path}: ignoring invalid value for "
                      f"{name}: {value!r} ({e})", file=sys.stderr)

    def load_files(self, cfgfile, filepath, max_level=3, verbose=0):
        """Cascade-load ``cfgfile`` from the CWD and up to ``max_level``
        parent directories of ``filepath`` (deepest wins, like the
        reference's thunderlab call at `songdetector.py:735`)."""
        candidates = [Path.cwd() / Path(cfgfile).name]
        if filepath:
            d = Path(filepath).resolve().parent
            chain = []
            for _ in range(max_level):
                chain.append(d / Path(cfgfile).name)
                if d.parent == d:
                    break
                d = d.parent
            candidates.extend(reversed(chain))
        for cand in candidates:
            if cand.is_file():
                if verbose:
                    print(f"loading configuration {cand}")
                self.load(cand)
