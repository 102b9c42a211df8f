"""Result tables for analyzers.

Minimal, dependency-free stand-in for ``thunderlab.tabledata.TableData``
as the reference's analyzers use it (`src/audian/analyzer.py:10,86,170-183`
and the results-table consumption at `src/audian/databrowser.py:1777-1857`):
labeled/united/formatted columns, row-wise appends, CSV export and a
pandas ``DataFrame``.  A copy of ``audian_tpu/analysis/table.py`` (pure
Python; pandas is imported only by :meth:`ResultTable.to_dataframe`), so
that the port imports nothing of the JAX package and loads without
pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path

__all__ = ["ResultTable"]


class ResultTable:
    """Columns with label, unit, and printf format; rows of values."""

    def __init__(self):
        self.labels = []
        self.units = []
        self.formats = []
        self.rows = []

    def append(self, label, unit=None, formats=None):
        """Add a column (thunderlab ``TableData.append`` call shape used by
        ``Analyzer.make_column``).  Columns appended after rows exist pad
        the existing rows (the reference merges tables by appending
        columns, `databrowser.py:1852-1855`)."""
        self.labels.append(label)
        self.units.append(unit or "")
        self.formats.append(formats or "%g")
        for row in self.rows:
            row.append(None)
        return len(self.labels) - 1

    def add(self, values, start_column=0):
        """Append one row starting at ``start_column``; short rows are
        padded with ``None`` to the column count, and EXTRA values raise
        ``ValueError`` (they would otherwise be stored but silently
        dropped from every export — call :meth:`make_column` first)."""
        row = [None] * start_column + list(values)
        if len(row) > len(self.labels):
            raise ValueError(
                f"{len(row)} values for {len(self.labels)} columns "
                f"({self.labels}) — call make_column() for each value")
        if len(row) < len(self.labels):
            row += [None] * (len(self.labels) - len(row))
        self.rows.append(row)

    def clear_data(self):
        self.rows = []

    def keys(self):
        return list(self.labels)

    def __len__(self):
        return len(self.rows)

    @property
    def shape(self):
        return (len(self.rows), len(self.labels))

    def __getitem__(self, key):
        if isinstance(key, str):
            j = self.labels.index(key)
            return [r[j] for r in self.rows]
        return self.rows[key]

    def formatted(self, row):
        """Row values rendered with each column's format string."""
        out = []
        for fmt, v in zip(self.formats, self.rows[row]):
            if v is None:
                out.append("")
            elif isinstance(v, str):
                out.append(v)
            else:
                try:
                    out.append(fmt % v)
                except (TypeError, ValueError):
                    out.append(str(v))
        return out

    def header(self, with_units=True):
        if not with_units:
            return list(self.labels)
        return [f"{l}/{u}" if u else l for l, u in zip(self.labels, self.units)]

    def write(self, path, with_units=True):
        """CSV export (the reference saves analysis tables to CSV,
        `src/audian/databrowser.py:1834-1857`)."""
        path = Path(path)
        with path.open("w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.header(with_units))
            for i in range(len(self.rows)):
                w.writerow(self.formatted(i))
        return path

    def to_dataframe(self):
        """The rows as a ``pandas.DataFrame``, a column per label."""
        import pandas as pd

        return pd.DataFrame(
            {l: [r[j] for r in self.rows]
             for j, l in enumerate(self.labels)}
        )
