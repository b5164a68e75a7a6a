"""A copy of `deeplearning4j_tpu/datavec/sequence.py`, with its imports on the
port's modules. Sequence DataVec breadth (round-3 VERDICT item 10: ≡ datavec-api ::
records.reader.impl.csv.CSVSequenceRecordReader, deeplearning4j ::
SequenceRecordReaderDataSetIterator, datavec transform.join.Join,
AnalyzeLocal column analysis).

Host-side ETL; ragged sequences pad to the batch maximum with (B, T)
masks — exactly the mask convention the recurrent layers consume."""
from __future__ import annotations

import csv
import io
import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.datavec.records import RecordReader, Schema


class SequenceRecordReader(RecordReader):
    """A reader whose next() yields one SEQUENCE: a list of timestep rows."""

    def nextSequence(self):
        return self.next()


class CSVSequenceRecordReader(SequenceRecordReader):
    """≡ CSVSequenceRecordReader(skipNumLines, delimiter) — ONE SEQUENCE PER
    FILE: each CSV file (or text blob) is a whole time-series, one timestep
    per line. initialize() takes a list of paths/texts (or a single one)."""

    def __init__(self, skipNumLines=0, delimiter=","):
        self.skip = int(skipNumLines)
        self.delimiter = delimiter
        self._seqs = []
        self._i = 0

    def _parse(self, path_or_text):
        if isinstance(path_or_text, str) and os.path.exists(path_or_text):
            with open(path_or_text, newline="") as f:
                rows = list(csv.reader(f, delimiter=self.delimiter))
        else:
            rows = list(csv.reader(io.StringIO(path_or_text),
                                   delimiter=self.delimiter))
        return [[c.strip() for c in r] for r in rows[self.skip:] if r]

    def initialize(self, sources):
        if isinstance(sources, str):
            sources = [sources]
        self._seqs = [self._parse(s) for s in sources]
        self._i = 0
        return self

    def hasNext(self):
        return self._i < len(self._seqs)

    def next(self):
        s = self._seqs[self._i]
        self._i += 1
        return [list(r) for r in s]

    def reset(self):
        self._i = 0


class CollectionSequenceRecordReader(SequenceRecordReader):
    """In-memory sequences: list of list-of-timestep-rows
    (≡ CollectionSequenceRecordReader)."""

    def __init__(self, sequences):
        self._seqs = [[list(r) for r in s] for s in sequences]
        self._i = 0

    def initialize(self, split=None):
        self.reset()
        return self

    def hasNext(self):
        return self._i < len(self._seqs)

    def next(self):
        s = self._seqs[self._i]
        self._i += 1
        return [list(r) for r in s]

    def reset(self):
        self._i = 0


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """≡ deeplearning4j SequenceRecordReaderDataSetIterator.

    Two modes:
    - two readers (features, labels): aligned sequences, same lengths;
    - one reader + labelIndex: the label column is split out per timestep.

    Ragged sequences pad to the batch max length; featuresMask/labelsMask
    carry the per-example valid lengths. Classification labels one-hot to
    (B, T, numClasses); regression keeps (B, T, 1). alignmentMode
    'equal_length' (default) or 'align_end' (labels at sequence ends,
    e.g. seq-to-one)."""

    def __init__(self, featureReader, labelReaderOrBatch=None, batch_size=None,
                 numClasses=None, regression=False, labelIndex=None,
                 alignmentMode="equal_length"):
        if isinstance(labelReaderOrBatch, int):
            label_reader, batch_size = None, labelReaderOrBatch
        else:
            label_reader = labelReaderOrBatch
        super().__init__(batch_size or 1)
        self.numClasses = numClasses
        self.regression = regression
        self.alignmentMode = alignmentMode
        fseqs = [s for s in featureReader]
        if label_reader is not None:
            lseqs = [s for s in label_reader]
            if len(lseqs) != len(fseqs):
                raise ValueError(
                    f"feature reader has {len(fseqs)} sequences, label "
                    f"reader {len(lseqs)}")
            self._feats = [np.asarray(s, np.float32) for s in fseqs]
            self._labels = [np.asarray(s, np.float32) for s in lseqs]
        elif labelIndex is not None:
            self._feats, self._labels = [], []
            for s in fseqs:
                arr = np.asarray(s, np.float32)
                self._feats.append(np.delete(arr, labelIndex, axis=1))
                self._labels.append(arr[:, labelIndex:labelIndex + 1])
        else:
            self._feats = [np.asarray(s, np.float32) for s in fseqs]
            self._labels = [np.zeros((len(s), 0), np.float32) for s in fseqs]

    def numExamples(self):
        return len(self._feats)

    def inputColumns(self):
        return int(self._feats[0].shape[-1]) if self._feats else 0

    def totalOutcomes(self):
        if self.regression or self.numClasses is None:
            return int(self._labels[0].shape[-1]) if self._labels else 0
        return int(self.numClasses)

    def _onehot(self, lab):
        """(T, 1) class ids -> (T, C)."""
        t = lab.shape[0]
        out = np.zeros((t, int(self.numClasses)), np.float32)
        out[np.arange(t), lab[:, 0].astype(np.int64)] = 1.0
        return out

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        feats = self._feats[self._cursor:self._cursor + n]
        labs = self._labels[self._cursor:self._cursor + n]
        self._cursor += len(feats)
        if not self.regression and self.numClasses is not None:
            labs = [self._onehot(l) for l in labs]
        tmax = max(f.shape[0] for f in feats)
        ltmax = max(l.shape[0] for l in labs)
        b = len(feats)
        fdim, ldim = feats[0].shape[1], labs[0].shape[1]
        f_arr = np.zeros((b, tmax, fdim), np.float32)
        l_arr = np.zeros((b, ltmax, ldim), np.float32)
        f_mask = np.zeros((b, tmax), np.float32)
        l_mask = np.zeros((b, ltmax), np.float32)
        for i, (f, l) in enumerate(zip(feats, labs)):
            f_arr[i, :f.shape[0]] = f
            f_mask[i, :f.shape[0]] = 1.0
            if self.alignmentMode == "align_end":
                # labels packed at the END of the padded window (seq-to-one
                # alignment: the label scores against the last valid step)
                l_arr[i, ltmax - l.shape[0]:] = l
                l_mask[i, ltmax - l.shape[0]:] = 1.0
            else:
                l_arr[i, :l.shape[0]] = l
                l_mask[i, :l.shape[0]] = 1.0
        ds = DataSet(f_arr, l_arr)
        ds.featuresMask = f_mask
        ds.labelsMask = l_mask
        return self._maybe_preprocess(ds)


# -- joins ----------------------------------------------------------------
class Join:
    """≡ datavec transform.join.Join — key-equality join of two record
    collections. Builder mirror: Join.Builder(type).setJoinColumns(...)
    .setSchemas(left, right).build(); execute(left_rows, right_rows)."""

    INNER, LEFT_OUTER, RIGHT_OUTER, FULL_OUTER = (
        "inner", "leftouter", "rightouter", "fullouter")

    def __init__(self, join_type, key_columns, left_schema, right_schema):
        self.join_type = str(join_type).lower().replace("_", "")
        self.keys = list(key_columns)
        self.left_schema = left_schema
        self.right_schema = right_schema

    class Builder:
        def __init__(self, joinType="inner"):
            self._type = joinType
            self._keys = []
            self._ls = self._rs = None

        def setJoinColumns(self, *names):
            self._keys = list(names)
            return self

        def setSchemas(self, left, right):
            self._ls, self._rs = left, right
            return self

        def build(self):
            if not self._keys or self._ls is None or self._rs is None:
                raise ValueError("Join needs join columns and both schemas")
            return Join(self._type, self._keys, self._ls, self._rs)

    def outSchema(self):
        right_extra = [c for c in self.right_schema.columns
                       if c[0] not in self.keys]
        return Schema(list(self.left_schema.columns) + right_extra)

    def execute(self, left_rows, right_rows):
        lnames = self.left_schema.names()
        rnames = self.right_schema.names()
        lkey = [lnames.index(k) for k in self.keys]
        rkey = [rnames.index(k) for k in self.keys]
        r_extra_idx = [i for i, n in enumerate(rnames) if n not in self.keys]
        index = {}
        for r in right_rows:
            index.setdefault(tuple(r[i] for i in rkey), []).append(r)
        out, matched_right = [], set()
        n_right_extra = len(r_extra_idx)
        for l in left_rows:
            key = tuple(l[i] for i in lkey)
            matches = index.get(key, [])
            if matches:
                matched_right.add(key)
                for r in matches:
                    out.append(list(l) + [r[i] for i in r_extra_idx])
            elif self.join_type in ("leftouter", "fullouter"):
                out.append(list(l) + [None] * n_right_extra)
        if self.join_type in ("rightouter", "fullouter"):
            lnone = [None] * len(lnames)
            for key, rows in index.items():
                if key in matched_right:
                    continue
                for r in rows:
                    row = list(lnone)
                    for ki, i in enumerate(lkey):
                        row[i] = r[rkey[ki]]
                    out.append(row + [r[i] for i in r_extra_idx])
        return out


# -- analysis -------------------------------------------------------------
class ColumnAnalysis:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        body = ", ".join(f"{k}={v}" for k, v in self.__dict__.items())
        return f"ColumnAnalysis({body})"


class DataAnalysis:
    def __init__(self, schema, columns):
        self.schema = schema
        self._cols = columns  # name -> ColumnAnalysis

    def getColumnAnalysis(self, name):
        return self._cols[name]

    def __str__(self):
        lines = [f"{'Column':<18}{'Type':<12}Analysis"]
        for n, _, _ in self.schema.columns:
            lines.append(f"{n:<18}{self.schema.kind(n):<12}{self._cols[n]}")
        return "\n".join(lines)


class AnalyzeLocal:
    """≡ datavec-local :: AnalyzeLocal.analyze(schema, reader) — single-pass
    per-column summary statistics on the host."""

    @staticmethod
    def analyze(schema, reader_or_rows):
        rows = [r for r in reader_or_rows]
        cols = {}
        for idx, (name, kind, meta) in enumerate(schema.columns):
            values = [r[idx] for r in rows]
            missing = sum(1 for v in values
                          if v is None or (isinstance(v, str) and not v))
            present = [v for v in values
                       if not (v is None or (isinstance(v, str) and not v))]
            if kind in ("double", "integer"):
                arr = np.asarray([float(v) for v in present], np.float64)
                cols[name] = ColumnAnalysis(
                    count=len(present), countMissing=missing,
                    min=float(arr.min()) if arr.size else None,
                    max=float(arr.max()) if arr.size else None,
                    mean=float(arr.mean()) if arr.size else None,
                    sampleStdev=float(arr.std(ddof=1)) if arr.size > 1
                    else 0.0,
                    countZero=int(np.sum(arr == 0.0)),
                    countNegative=int(np.sum(arr < 0)),
                    countPositive=int(np.sum(arr > 0)))
            elif kind == "categorical":
                counts = {}
                for v in present:
                    counts[v] = counts.get(v, 0) + 1
                cols[name] = ColumnAnalysis(
                    count=len(present), countMissing=missing,
                    uniqueCount=len(counts), categoryCounts=counts)
            else:  # string
                lens = [len(str(v)) for v in present]
                cols[name] = ColumnAnalysis(
                    count=len(present), countMissing=missing,
                    uniqueCount=len(set(map(str, present))),
                    minLength=min(lens) if lens else 0,
                    maxLength=max(lens) if lens else 0,
                    meanLength=float(np.mean(lens)) if lens else 0.0)
        return DataAnalysis(schema, cols)
