"""
A small column table: the port's one representation of the tabular
products that the JAX package keeps in pandas DataFrames (the pipeline's
peak, cluster and candidate rows, a candidate's member peaks, rseek's
peak table), so that the search path runs where pandas is not
installed.

It keeps what those products need and nothing more:

* :meth:`Table.to_csv` writes the bytes of pandas'
  ``to_csv(path, sep=",", index=False, float_format=...)`` for columns
  of numbers, booleans and strings;
* :meth:`Table.to_string` gives the text of pandas'
  ``to_string(columns=..., formatters=..., index=False)`` for columns
  that have a formatter or hold integers;
* :mod:`riptide_tpu_torch.serialization` writes a table in the JSON
  form of a DataFrame (``{"__type__": "pandas.DataFrame", "values",
  "columns"}``) and reads that form back as a table, so candidate files
  load in either package;
* :meth:`Table.to_dataframe` imports pandas, for users who want one.

A column is a 1-D numpy array. It is built like pandas builds one from
Python values: integers give int64, any float gives float64 (``None``
among numbers becomes NaN), numpy scalars keep their dtype.
"""
import csv
import io
import numbers

import numpy as np

__all__ = ["Table"]


def _column(values):
    """A 1-D numpy array of ``values`` (see the module docstring)."""
    if isinstance(values, np.ndarray):
        if values.ndim != 1:
            raise ValueError("a table column must be one-dimensional")
        return values
    values = list(values)
    if any(v is None for v in values) and all(
            v is None or (isinstance(v, numbers.Number)
                          and not isinstance(v, bool)) for v in values):
        return np.array([np.nan if v is None else v for v in values],
                        dtype=np.float64)
    out = np.asarray(values)
    if out.dtype.kind == "U":
        out = out.astype(object)
    return out


class Table:
    """Named, equal-length columns in insertion order."""

    def __init__(self, columns=None):
        self._cols = {}
        for name, values in (columns or {}).items():
            self[name] = values

    @classmethod
    def from_records(cls, records):
        """One row per dict, columns in order of first appearance (as
        ``pandas.DataFrame.from_dict`` of a list of dicts); a key that a
        row lacks is None there."""
        records = list(records)
        names = {}
        for rec in records:
            names.update(dict.fromkeys(rec))
        return cls({k: [rec.get(k) for rec in records] for k in names})

    @classmethod
    def from_values(cls, values, columns):
        """From a 2-D (rows, columns) array, the inverse of
        :attr:`values`."""
        values = np.asarray(values)
        columns = list(columns)
        if values.size == 0:
            values = values.reshape(0, len(columns))
        if values.ndim != 2 or values.shape[1] != len(columns):
            raise ValueError(f"values of shape {values.shape} do not fit "
                             f"{len(columns)} columns")
        return cls({c: values[:, j].copy() for j, c in enumerate(columns)})

    # -- access -------------------------------------------------------------

    @property
    def columns(self):
        return list(self._cols)

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, key):
        """A column's array for a name; a new table of those columns for
        a list of names."""
        if isinstance(key, (list, tuple)):
            return Table({k: self._cols[k] for k in key})
        return self._cols[key]

    def __setitem__(self, name, values):
        col = _column(values)
        if self._cols and name not in self._cols and len(col) != len(self):
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {len(self)}")
        self._cols[name] = col

    def row(self, i):
        """Row ``i`` as a dict of numpy scalars."""
        return {k: v[i] for k, v in self._cols.items()}

    @property
    def values(self):
        """The (rows, columns) array of all columns, in their common
        dtype (as ``DataFrame.values``)."""
        if not self._cols:
            return np.empty((0, 0))
        dtype = np.result_type(*self._cols.values())
        return np.stack([c.astype(dtype, copy=False)
                         for c in self._cols.values()], axis=1)

    def __eq__(self, other):
        return (isinstance(other, Table) and self.columns == other.columns
                and all(np.array_equal(self._cols[k], other._cols[k],
                                       equal_nan=self._cols[k].dtype.kind == "f")
                        for k in self._cols))

    def __repr__(self):
        return f"Table({len(self)} rows, columns={self.columns})"

    # -- output -------------------------------------------------------------

    def to_csv(self, path=None, sep=",", float_format="%.9f"):
        """Write the table as CSV, header first, no index column: floats
        with ``float_format`` (NaN as an empty field), integers and
        booleans as Python prints them, None as an empty field. Returns
        the text when ``path`` is None."""
        cells = [[_csv_cell(v, col.dtype.kind, float_format) for v in col]
                 for col in self._cols.values()]
        buf = io.StringIO()
        writer = csv.writer(buf, delimiter=sep, lineterminator="\n",
                            quoting=csv.QUOTE_MINIMAL)
        writer.writerow(self.columns)
        writer.writerows(zip(*cells))
        text = buf.getvalue()
        if path is None:
            return text
        with open(path, "w", newline="") as fobj:
            fobj.write(text)
        return None

    def to_string(self, columns=None, formatters=None):
        """Fixed-width text: a header line, then one line per row, the
        columns right-justified and one space apart. A column with a
        formatter shows ``formatter(value)``; an integer column without
        one shows the integer, under its name with one leading space."""
        formatters = formatters or {}
        lines = []
        for name in columns or self.columns:
            col = self._cols[name]
            fmt = formatters.get(name)
            if fmt is not None:
                head, cells = str(name), [fmt(v) for v in col]
            elif col.dtype.kind in "iu":
                head, cells = " " + str(name), [f"{v:d}" for v in col]
            else:
                raise ValueError(f"column {name!r} needs a formatter")
            width = max([len(head), *map(len, cells)])
            lines.append([head.rjust(width)] + [c.rjust(width) for c in cells])
        return "\n".join(" ".join(row) for row in zip(*lines))

    def to_dataframe(self):
        """The table as a pandas DataFrame (imports pandas)."""
        import pandas

        return pandas.DataFrame(dict(self._cols), columns=self.columns)


def _csv_cell(value, kind, float_format):
    if kind == "f":
        return "" if np.isnan(value) else float_format % value
    if kind in "iu":
        return str(int(value))
    if kind == "b":
        return str(bool(value))
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return ""
    if isinstance(value, float):
        return float_format % value
    return str(value)
