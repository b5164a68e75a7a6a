"""A copy of `deeplearning4j_tpu/datavec/records.py`, with its imports on the
port's modules. DataVec equivalents (≡ datavec-api :: records.reader.RecordReader,
CSVRecordReader, transform.TransformProcess, and the
RecordReaderDataSetIterator bridge in deeplearning4j-datavec-iterators).

Schema-driven columnar ETL on the host; the accelerator never sees this
code (same division of labor as the reference)."""
from __future__ import annotations

import csv
import io
import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


# -- readers -------------------------------------------------------------
class RecordReader:
    def initialize(self, split):
        raise NotImplementedError

    def hasNext(self):
        raise NotImplementedError

    def next(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


class CollectionRecordReader(RecordReader):
    """In-memory list of records (≡ CollectionRecordReader)."""

    def __init__(self, records):
        self._records = [list(r) for r in records]
        self._i = 0

    def initialize(self, split=None):
        self.reset()

    def hasNext(self):
        return self._i < len(self._records)

    def next(self):
        r = self._records[self._i]
        self._i += 1
        return list(r)

    def reset(self):
        self._i = 0


class CSVRecordReader(RecordReader):
    """≡ datavec CSVRecordReader(skipLines, delimiter).

    All-numeric files additionally parse through the native C++ runtime in
    one pass (runtime/native :: dl4j_csv_parse — the hot path the
    reference keeps in datavec's native loaders); `numeric_matrix()` then
    hands the whole float32 table to RecordReaderDataSetIterator without
    the per-field Python float() loop. Record-level semantics (lists of
    stripped strings from `next()`) are unchanged."""

    def __init__(self, skipNumLines=0, delimiter=","):
        self.skip = int(skipNumLines)
        self.delimiter = delimiter
        self._text = ""
        self._rows = None    # parsed lazily: the bulk path never needs them
        self._i = 0
        self._matrix = None

    def initialize(self, path_or_text):
        if isinstance(path_or_text, str) and os.path.exists(path_or_text):
            with open(path_or_text, newline="") as f:
                text = f.read()
        else:
            text = path_or_text
        self._text = text
        self._rows = None
        self._i = 0
        self._matrix = None
        # native bulk parse is only trusted when it provably matches the
        # record-level view: no interior blank lines after the skip (the
        # native pass drops them; csv.reader yields [] rows), every field
        # numeric (a single NaN falls back to the Python path)
        body = text.split("\n")[self.skip:]
        while body and not body[-1].strip():
            body.pop()
        # every row must have the SAME column count: the native parser
        # truncates long rows / NaN-pads short ones, but the Python path
        # raises on ragged tables — ragged input must take the strict path
        widths = {l.count(self.delimiter) for l in body}
        if body and len(widths) == 1 and all(l.strip() for l in body):
            try:
                from deeplearning4j_tpu_torch.runtime.native_lib import \
                    csv_to_floats
                import numpy as _np
                m = csv_to_floats(text.encode(), self.delimiter, self.skip)
                if (m is not None and m.size and m.shape[0] == len(body)
                        and not _np.isnan(m).any()):
                    self._matrix = m
            except Exception:
                self._matrix = None
        return self

    def _ensure_rows(self):
        if self._rows is None:
            self._rows = list(csv.reader(
                io.StringIO(self._text),
                delimiter=self.delimiter))[self.skip:]
        return self._rows

    def numeric_matrix(self):
        """float32 (rows, cols) for all-numeric files, else None. Only
        valid on an unconsumed reader — after any next() the bulk view
        would disagree with the remaining records."""
        return self._matrix if self._i == 0 else None

    def hasNext(self):
        return self._i < len(self._ensure_rows())

    def next(self):
        r = self._ensure_rows()[self._i]
        self._i += 1
        return [c.strip() for c in r]

    def reset(self):
        self._i = 0


class LineRecordReader(RecordReader):
    def __init__(self):
        self._lines = []
        self._i = 0

    def initialize(self, path_or_text):
        if isinstance(path_or_text, str) and os.path.exists(path_or_text):
            with open(path_or_text) as f:
                self._lines = [l.rstrip("\n") for l in f]
        else:
            self._lines = path_or_text.splitlines()
        self._i = 0
        return self

    def hasNext(self):
        return self._i < len(self._lines)

    def next(self):
        l = self._lines[self._i]
        self._i += 1
        return [l]

    def reset(self):
        self._i = 0


# -- schema & transforms -------------------------------------------------
class Schema:
    """≡ datavec transform.schema.Schema.Builder."""

    def __init__(self, columns=None):
        self.columns = list(columns or [])  # [(name, kind, meta)]

    class Builder:
        def __init__(self):
            self._cols = []

        def addColumnDouble(self, name):
            self._cols.append((name, "double", None))
            return self

        def addColumnsDouble(self, *names):
            for n in names:
                self.addColumnDouble(n)
            return self

        def addColumnInteger(self, name):
            self._cols.append((name, "integer", None))
            return self

        def addColumnString(self, name):
            self._cols.append((name, "string", None))
            return self

        def addColumnCategorical(self, name, *categories):
            if len(categories) == 1 and isinstance(categories[0], (list, tuple)):
                categories = categories[0]
            self._cols.append((name, "categorical", list(categories)))
            return self

        def build(self):
            return Schema(self._cols)

    def names(self):
        return [c[0] for c in self.columns]

    def indexOf(self, name):
        return self.names().index(name)

    def kind(self, name):
        return self.columns[self.indexOf(name)][1]

    def meta(self, name):
        return self.columns[self.indexOf(name)][2]


class TransformProcess:
    """≡ datavec transform.TransformProcess.Builder — an ordered pipeline of
    schema-aware column transforms executed on host records."""

    def __init__(self, schema, steps):
        self.initial_schema = schema
        self.steps = steps

    class Builder:
        def __init__(self, schema):
            self._schema = schema
            self._steps = []

        def removeColumns(self, *names):
            self._steps.append(("remove", names))
            return self

        def removeAllColumnsExceptFor(self, *names):
            self._steps.append(("keep", names))
            return self

        def filter(self, predicate):
            """predicate(record_dict) -> True to DROP (≡ ConditionFilter)."""
            self._steps.append(("filter", predicate))
            return self

        def categoricalToInteger(self, *names):
            self._steps.append(("cat2int", names))
            return self

        def categoricalToOneHot(self, *names):
            self._steps.append(("cat2onehot", names))
            return self

        def integerToCategorical(self, name, categories):
            self._steps.append(("int2cat", (name, list(categories))))
            return self

        def stringToCategorical(self, name, categories):
            self._steps.append(("str2cat", (name, list(categories))))
            return self

        def doubleMathOp(self, name, op, value):
            self._steps.append(("math", (name, op, float(value))))
            return self

        def normalize(self, name, kind, *stats):
            self._steps.append(("normalize", (name, kind, stats)))
            return self

        def renameColumn(self, old, new):
            self._steps.append(("rename", (old, new)))
            return self

        def build(self):
            return TransformProcess(self._schema, self._steps)

    # -- execution -------------------------------------------------------
    def execute(self, records):
        """records: list of lists (strings or numbers) matching the initial
        schema. Returns (new_records, final_schema)."""
        schema = self.initial_schema
        rows = [list(r) for r in records]
        for kind, arg in self.steps:
            rows, schema = self._apply(kind, arg, rows, schema)
        return rows, schema

    @staticmethod
    def _apply(kind, arg, rows, schema):
        names = schema.names()
        if kind == "remove":
            keep_idx = [i for i, n in enumerate(names) if n not in arg]
            new_cols = [schema.columns[i] for i in keep_idx]
            return ([[r[i] for i in keep_idx] for r in rows],
                    Schema(new_cols))
        if kind == "keep":
            keep_idx = [i for i, n in enumerate(names) if n in arg]
            new_cols = [schema.columns[i] for i in keep_idx]
            return ([[r[i] for i in keep_idx] for r in rows],
                    Schema(new_cols))
        if kind == "filter":
            pred = arg
            kept = [r for r in rows
                    if not pred(dict(zip(names, r)))]
            return kept, schema
        if kind == "rename":
            old, new = arg
            cols = [(new if n == old else n, k, m)
                    for n, k, m in schema.columns]
            return rows, Schema(cols)
        if kind == "cat2int":
            out_cols = list(schema.columns)
            for name in arg:
                i = schema.indexOf(name)
                cats = schema.meta(name)
                for r in rows:
                    r[i] = cats.index(r[i])
                out_cols[i] = (name, "integer", None)
            return rows, Schema(out_cols)
        if kind == "cat2onehot":
            for name in arg:
                i = schema.indexOf(name)
                cats = schema.meta(name)
                new_cols = (schema.columns[:i]
                            + [(f"{name}[{c}]", "double", None) for c in cats]
                            + schema.columns[i + 1:])
                new_rows = []
                for r in rows:
                    onehot = [1.0 if r[i] == c else 0.0 for c in cats]
                    new_rows.append(r[:i] + onehot + r[i + 1:])
                rows, schema = new_rows, Schema(new_cols)
            return rows, schema
        if kind == "int2cat":
            name, cats = arg
            i = schema.indexOf(name)
            for r in rows:
                r[i] = cats[int(r[i])]
            cols = list(schema.columns)
            cols[i] = (name, "categorical", cats)
            return rows, Schema(cols)
        if kind == "str2cat":
            name, cats = arg
            i = schema.indexOf(name)
            cols = list(schema.columns)
            cols[i] = (name, "categorical", cats)
            return rows, Schema(cols)
        if kind == "math":
            name, op, val = arg
            i = schema.indexOf(name)
            import operator
            ops = {"add": operator.add, "subtract": operator.sub,
                   "multiply": operator.mul, "divide": operator.truediv}
            f = ops[op.lower()]
            for r in rows:
                r[i] = f(float(r[i]), val)
            return rows, schema
        if kind == "normalize":
            name, norm_kind, stats = arg
            i = schema.indexOf(name)
            vals = np.array([float(r[i]) for r in rows])
            if norm_kind == "minmax":
                lo, hi = (stats if stats else (vals.min(), vals.max()))
                rng = max(hi - lo, 1e-12)
                for r in rows:
                    r[i] = (float(r[i]) - lo) / rng
            elif norm_kind == "standardize":
                mu, sd = (stats if stats else (vals.mean(), vals.std() or 1.0))
                for r in rows:
                    r[i] = (float(r[i]) - mu) / sd
            return rows, schema
        raise ValueError(f"Unknown transform {kind}")


class RecordReaderDataSetIterator(DataSetIterator):
    """≡ deeplearning4j RecordReaderDataSetIterator(reader, batch,
    labelIndex, numClasses) — bridges DataVec records to DataSets."""

    def __init__(self, reader, batch_size, labelIndex=None, numClasses=None,
                 regression=False):
        super().__init__(batch_size)
        mat = getattr(reader, "numeric_matrix", lambda: None)()
        if mat is not None and mat.size:
            # native bulk path: one C++ pass + numpy slicing, no per-field
            # Python float() loop
            if labelIndex is None:
                feats, labels = mat, []
            else:
                feats = np.delete(mat, labelIndex, axis=1)
                labels = mat[:, labelIndex].tolist()
            self.features = np.ascontiguousarray(feats, np.float32)
        else:
            rows = [r for r in reader]
            feats, labels = [], []
            for r in rows:
                vals = [float(v) for v in r]
                if labelIndex is None:
                    feats.append(vals)
                else:
                    feats.append(vals[:labelIndex] + vals[labelIndex + 1:])
                    labels.append(vals[labelIndex])
            self.features = np.asarray(feats, np.float32)
        if labelIndex is None:
            self.labels = np.zeros((len(feats), 0), np.float32)
        elif regression:
            self.labels = np.asarray(labels, np.float32)[:, None]
        else:
            lab = np.asarray(labels, np.int64)
            self.labels = np.zeros((len(lab), numClasses), np.float32)
            self.labels[np.arange(len(lab)), lab] = 1.0

    def numExamples(self):
        return len(self.features)

    def totalOutcomes(self):
        return int(self.labels.shape[-1])

    def inputColumns(self):
        return int(self.features.shape[-1])

    def next(self, num=None):
        n = num or self._batch
        f = self.features[self._cursor:self._cursor + n]
        l = self.labels[self._cursor:self._cursor + n]
        self._cursor += len(f)
        return self._maybe_preprocess(DataSet(f, l))
