"""DataSetIterators: a copy of `deeplearning4j_tpu/datasets/iterators.py`,
which is numpy only (≡ deeplearning4j-datasets :: iterator.impl.* and the
nd4j DataSetIterator protocol).

No network: the IDX/bin parsers read real files when present (MNIST at
~/.deeplearning4j/mnist or a given path); otherwise the iterators make
DETERMINISTIC synthetic datasets of the same shapes and types, so training
code and tests behave the same either way. The JAX package's optional
native parser and batch assembly (runtime/native_lib.py) are replaced by
their numpy forms, which compute the same arrays.

`asyncSupported()` is True on the DataSetIterator base, so `fit` and the
evaluation loop stage its batches on a background thread
(runtime/pipeline.maybe_prefetch); ListMultiDataSetIterator opts out.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.runtime.pipeline import PrefetchIterator


class DataSetIterator:
    """Protocol base: python iteration + the reference's next/hasNext/reset."""

    def __init__(self, batch_size):
        self._batch = int(batch_size)
        self._cursor = 0

    # reference surface
    def batch(self):
        return self._batch

    def hasNext(self):
        return self._cursor < self.numExamples()

    def _check_has_next(self):
        if not self.hasNext():
            # ≡ the reference's NoSuchElementException on exhausted iterator
            raise StopIteration("DataSetIterator exhausted; call reset()")

    def next(self, num=None):
        raise NotImplementedError

    def reset(self):
        self._cursor = 0

    def resetSupported(self):
        return True

    def asyncSupported(self):
        return True

    def numExamples(self):
        raise NotImplementedError

    def totalOutcomes(self):
        raise NotImplementedError

    def inputColumns(self):
        raise NotImplementedError

    def setPreProcessor(self, pp):
        self._preprocessor = pp

    def getPreProcessor(self):
        return getattr(self, "_preprocessor", None)

    def _maybe_preprocess(self, ds):
        pp = getattr(self, "_preprocessor", None)
        if pp is not None:
            pp.preProcess(ds)
        return ds

    # python iteration
    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.hasNext():
            raise StopIteration
        return self.next()


class ArrayDataSetIterator(DataSetIterator):
    """Iterate an in-memory (features, labels) pair (≡ ListDataSetIterator)."""

    def __init__(self, features, labels, batch_size, shuffle=False, seed=123):
        super().__init__(batch_size)
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(self.features))

    def numExamples(self):
        return len(self.features)

    def totalOutcomes(self):
        return int(self.labels.shape[-1])

    def inputColumns(self):
        return int(np.prod(self.features.shape[1:]))

    def reset(self):
        super().reset()
        if self._shuffle:
            self._rng.shuffle(self._order)

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        idx = self._order[self._cursor:self._cursor + n]
        self._cursor += len(idx)
        return self._maybe_preprocess(
            DataSet(self.features[idx], self.labels[idx]))


def _read_idx(path):
    """Parse an IDX (MNIST) file, gzipped or raw."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        data = f.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
             13: np.float32, 14: np.float64}[dtype_code]
    return np.frombuffer(data, dtype=dtype, offset=4 + 4 * ndim).reshape(dims)


def _one_hot(y, n):
    out = np.zeros((len(y), n), np.float32)
    out[np.arange(len(y)), y.astype(np.int64)] = 1.0
    return out


def _synthetic_images(n, h, w, c, n_classes, seed):
    """Deterministic, linearly-separable-ish synthetic image set: each class
    has a characteristic frequency pattern plus noise (so LeNet-class models
    reach high accuracy, exercising the real training dynamics).

    Pattern parameters use independent x/y frequencies plus a golden-angle
    phase, so classes stay visually distinct up to hundreds of classes
    (the old freq=cls%5 form aliased classes 45 apart — indistinguishable
    under the noise). Noise is generated float32 per class slice: peak
    memory stays O(dataset), not O(dataset) x2 in float64."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.zeros((n, h, w, c), np.float32)
    for cls in range(n_classes):
        m = y == cls
        if not m.any():
            continue
        fx = 1 + cls % 6
        fy = 1 + (cls // 6) % 6
        phase = cls * 2.39996323   # golden angle: no periodic aliasing
        pattern = 0.5 + 0.5 * np.sin(fx * 2 * np.pi * xx / w + phase) \
            * np.cos(fy * 2 * np.pi * yy / h + 0.5 * phase)
        imgs[m] = pattern[None, :, :, None] + 0.15 * rng.standard_normal(
            (int(m.sum()), h, w, c), dtype=np.float32)
    np.clip(imgs, 0, 1, out=imgs)
    return (imgs * 255).astype(np.uint8), y


class MnistDataSetIterator(DataSetIterator):
    """≡ deeplearning4j-datasets :: MnistDataSetIterator.

    Emits (B, 784) float features in [0,1] + one-hot(10) labels, matching
    the reference's flattened-row convention (use
    InputType.convolutionalFlat(28,28,1) for CNNs). Reads real IDX files
    from `root` when present, else deterministic synthetic digits.
    """

    H = W = 28
    NUM_CLASSES = 10

    def __init__(self, batch_size, train=True, seed=123, root=None,
                 num_examples=None):
        super().__init__(batch_size)
        root = root or os.path.expanduser("~/.deeplearning4j/mnist")
        kind = "train" if train else "t10k"
        img_path = None
        for suffix in ("-images-idx3-ubyte.gz", "-images-idx3-ubyte"):
            p = os.path.join(root, kind + suffix)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is not None:
            lbl_path = img_path.replace("images-idx3", "labels-idx1")
            images = _read_idx(img_path)
            labels = _read_idx(lbl_path)
            self._images = images.reshape(len(images), self.H, self.W, 1)
            self._labels = labels
        else:
            n = num_examples or (6000 if train else 1000)
            self._images, self._labels = _synthetic_images(
                n, self.H, self.W, 1, self.NUM_CLASSES,
                seed if train else seed + 1)
        if num_examples:
            self._images = self._images[:num_examples]
            self._labels = self._labels[:num_examples]

    def numExamples(self):
        return len(self._images)

    def totalOutcomes(self):
        return self.NUM_CLASSES

    def inputColumns(self):
        return self.H * self.W

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        end = min(self._cursor + n, len(self._images))
        idx = np.arange(self._cursor, end)
        self._cursor = end
        # gather + u8→f32 scale + one-hot (the JAX package's native
        # batch assembly, in numpy)
        images = self._images.reshape(len(self._images), -1)
        feats = images[idx].astype(np.float32) * (1.0 / 255.0)
        labels = np.zeros((len(idx), self.NUM_CLASSES), np.float32)
        labels[np.arange(len(idx)),
               np.asarray(self._labels, np.uint8)[idx].astype(np.int64)] = 1.0
        return self._maybe_preprocess(DataSet(feats, labels))


class EmnistDataSetIterator(MnistDataSetIterator):
    """≡ EmnistDataSetIterator (letters split: 26 classes)."""
    NUM_CLASSES = 26

    def __init__(self, batch_size, split="letters", train=True, seed=123,
                 num_examples=None):
        super().__init__(batch_size, train=train, seed=seed + 17,
                         num_examples=num_examples)


class CifarDataSetIterator(DataSetIterator):
    """≡ Cifar10DataSetIterator — (B, 32, 32, 3) NHWC in [0,1]."""

    H = W = 32
    NUM_CLASSES = 10

    def __init__(self, batch_size, train=True, seed=123, root=None,
                 num_examples=None):
        super().__init__(batch_size)
        root = root or os.path.expanduser("~/.deeplearning4j/cifar10")
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [os.path.join(root, "cifar-10-batches-bin", f) for f in files]
        if all(os.path.exists(p) for p in paths):
            imgs, labels = [], []
            for p in paths:
                raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0])
                # stored CHW; convert to NHWC
                imgs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            self._images = np.concatenate(imgs)
            self._labels = np.concatenate(labels)
        else:
            n = num_examples or (5000 if train else 1000)
            self._images, self._labels = _synthetic_images(
                n, self.H, self.W, 3, self.NUM_CLASSES,
                seed if train else seed + 1)
        if num_examples:
            self._images = self._images[:num_examples]
            self._labels = self._labels[:num_examples]

    def numExamples(self):
        return len(self._images)

    def totalOutcomes(self):
        return self.NUM_CLASSES

    def inputColumns(self):
        return self.H * self.W * 3

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        img = self._images[self._cursor:self._cursor + n]
        lab = self._labels[self._cursor:self._cursor + n]
        self._cursor += len(img)
        return self._maybe_preprocess(
            DataSet(img.astype(np.float32) / 255.0,
                    _one_hot(lab, self.NUM_CLASSES)))


class Cifar100DataSetIterator(CifarDataSetIterator):
    """≡ deeplearning4j-datasets :: Cifar100DataSetIterator —
    (B, 32, 32, 3) NHWC in [0,1]; fine (100) or coarse (20) labels.
    Parses the real cifar-100-binary layout when files exist (one coarse
    + one fine label byte, then 3072 CHW pixels per record);
    deterministic synthetic otherwise (zero-egress policy)."""

    def __init__(self, batch_size, train=True, useCoarseLabels=False,
                 seed=222, root=None, num_examples=None):
        DataSetIterator.__init__(self, batch_size)
        self.NUM_CLASSES = 20 if useCoarseLabels else 100
        root = root or os.path.expanduser("~/.deeplearning4j/cifar100")
        path = os.path.join(root, "cifar-100-binary",
                            "train.bin" if train else "test.bin")
        if os.path.exists(path):
            raw = np.fromfile(path, np.uint8).reshape(-1, 3074)
            self._labels = raw[:, 0 if useCoarseLabels else 1].copy()
            self._images = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1)
        else:
            n = num_examples or (4000 if train else 800)
            self._images, self._labels = _synthetic_images(
                n, self.H, self.W, 3, self.NUM_CLASSES,
                seed if train else seed + 1)
        if num_examples:
            self._images = self._images[:num_examples]
            self._labels = self._labels[:num_examples]


class LFWDataSetIterator(CifarDataSetIterator):
    """≡ deeplearning4j-datasets :: LFWDataSetIterator — Labeled Faces
    in the Wild-shaped face-identification batches: (B, H, W, C) NHWC in
    [0,1] with one class per identity (reference defaults 250x250x3).
    Zero-egress environment: deterministic synthetic faces with the
    requested geometry/identity count (the reference downloads the
    tarball)."""

    def __init__(self, batch_size, num_examples=None, imgDim=(250, 250, 3),
                 numLabels=40, train=True, seed=542):
        DataSetIterator.__init__(self, batch_size)
        h, w, c = (int(d) for d in imgDim)
        self.H, self.W, self.C = h, w, c
        self.NUM_CLASSES = int(numLabels)
        # modest default at the 250x250 reference geometry (200 examples
        # ≈ 150 MB float32); pass num_examples for more
        n = num_examples or (200 if train else 50)
        self._images, self._labels = _synthetic_images(
            n, h, w, c, self.NUM_CLASSES, seed if train else seed + 1)

    def inputColumns(self):
        return self.H * self.W * self.C


class IrisDataSetIterator(DataSetIterator):
    """≡ IrisDataSetIterator — the classic 150×4, deterministic synthetic
    replica (three gaussian clusters with the reference's class structure)."""

    def __init__(self, batch_size=150, num=150, seed=6):
        super().__init__(batch_size)
        rng = np.random.default_rng(seed)
        n_per = num // 3
        centers = np.array([[5.0, 3.4, 1.5, 0.2],
                            [5.9, 2.8, 4.3, 1.3],
                            [6.6, 3.0, 5.6, 2.0]], np.float32)
        scales = np.array([[0.35, 0.38, 0.17, 0.10],
                           [0.52, 0.31, 0.47, 0.20],
                           [0.64, 0.32, 0.55, 0.27]], np.float32)
        feats, labels = [], []
        for c in range(3):
            feats.append(centers[c] + scales[c] * rng.standard_normal((n_per, 4)).astype(np.float32))
            labels.append(np.full(n_per, c))
        self.features = np.concatenate(feats)
        self.labels = _one_hot(np.concatenate(labels), 3)
        perm = rng.permutation(len(self.features))
        self.features, self.labels = self.features[perm], self.labels[perm]

    def numExamples(self):
        return len(self.features)

    def totalOutcomes(self):
        return 3

    def inputColumns(self):
        return 4

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        f = self.features[self._cursor:self._cursor + n]
        l = self.labels[self._cursor:self._cursor + n]
        self._cursor += len(f)
        return self._maybe_preprocess(DataSet(f, l))


class SyntheticImageNetIterator(DataSetIterator):
    """ImageNet-shaped synthetic data for zoo/bench (224×224×3, 1000
    classes) — the bench harness's data source (no egress)."""

    def __init__(self, batch_size, num_examples=1024, height=224, width=224,
                 channels=3, num_classes=1000, seed=7, dtype=np.float32):
        super().__init__(batch_size)
        self._n = num_examples
        self._shape = (height, width, channels)
        self._classes = num_classes
        self._rng = np.random.default_rng(seed)
        self._dtype = dtype

    def numExamples(self):
        return self._n

    def totalOutcomes(self):
        return self._classes

    def inputColumns(self):
        return int(np.prod(self._shape))

    def next(self, num=None):
        self._check_has_next()
        n = min(num or self._batch, self._n - self._cursor)
        self._cursor += n
        h, w, c = self._shape
        x = self._rng.random((n, h, w, c), np.float32).astype(self._dtype)
        y = _one_hot(self._rng.integers(0, self._classes, n), self._classes)
        return self._maybe_preprocess(DataSet(x, y))


class AsyncDataSetIterator(PrefetchIterator):
    """≡ AsyncDataSetIterator — background-thread prefetch so host batch
    prep overlaps device compute (the reference uses a workspace-backed
    prefetch thread; same shape here).

    Built on runtime/pipeline.PrefetchIterator, which fixes two failure
    modes of the original hand-rolled worker: a raising `base.next()` is
    re-raised in the consumer with its original traceback instead of
    masquerading as clean end-of-stream (silently truncating the epoch),
    and `hasNext` polls with a timeout + worker-liveness check so a dead
    worker thread surfaces as an error instead of deadlocking forever."""

    def __init__(self, base, queue_size=4):
        super().__init__(base, depth=queue_size)


class ListDataSetIterator(DataSetIterator):
    """≡ ListDataSetIterator(list<DataSet>, batch) — re-batches a list of
    DataSets into batches of exactly `batch` examples (merging across list
    entries like the reference; all entries must share shapes/mask layout).
    Default batch = the whole list as one batch."""

    def __init__(self, datasets, batch_size=None):
        datasets = list(datasets)
        self._merged = (DataSet.merge(datasets) if len(datasets) > 1
                        else datasets[0]) if datasets else None
        n = self._merged.numExamples() if self._merged is not None else 0
        super().__init__(batch_size if batch_size is not None else max(n, 1))

    def numExamples(self):
        return 0 if self._merged is None else self._merged.numExamples()

    def totalOutcomes(self):
        if self._merged is None or self._merged.labels is None:
            return 0
        return int(np.asarray(self._merged.labels).shape[-1])

    def inputColumns(self):
        if self._merged is None:
            return 0
        return int(np.prod(np.asarray(self._merged.features).shape[1:]))

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        m = self._merged
        sl = slice(self._cursor, min(self._cursor + n, m.numExamples()))
        self._cursor = sl.stop
        pick = lambda a: None if a is None else a[sl]
        ds = DataSet(m.features[sl], pick(m.labels), pick(m.featuresMask),
                     pick(m.labelsMask))
        return self._maybe_preprocess(ds)


class ListMultiDataSetIterator:
    """MultiDataSet iterator over an in-memory list (≡ nd4j-api ::
    dataset.api.iterator.MultiDataSetIterator implementations such as
    IteratorMultiDataSetIterator): yields the stored MultiDataSets in
    order without re-batching (multi-input batches cannot be merged
    generically — input arities/shapes differ per entry)."""

    def __init__(self, multidatasets):
        self._sets = list(multidatasets)
        self._cursor = 0
        self._preprocessor = None

    def setPreProcessor(self, pp):
        self._preprocessor = pp

    def reset(self):
        self._cursor = 0

    def resetSupported(self):
        return True

    def asyncSupported(self):
        return False

    def hasNext(self):
        return self._cursor < len(self._sets)

    def next(self):
        if not self.hasNext():
            raise StopIteration
        mds = self._sets[self._cursor]
        self._cursor += 1
        if self._preprocessor is not None:
            # preprocessors mutate in place (DataNormalization convention);
            # hand them a fresh shell so the stored sets never accumulate
            # repeated normalization across epochs
            from deeplearning4j_tpu_torch.datasets.dataset import \
                MultiDataSet
            mds = MultiDataSet(mds.features, mds.labels, mds.featuresMasks,
                               mds.labelsMasks)
            self._preprocessor.preProcess(mds)
        return mds

    def __iter__(self):
        self.reset()
        while self.hasNext():
            yield self.next()


class SingletonMultiDataSetIterator(ListMultiDataSetIterator):
    """≡ nd4j :: SingletonMultiDataSetIterator — iterates exactly one
    MultiDataSet."""

    def __init__(self, mds):
        super().__init__([mds])


class SvhnDataSetIterator(CifarDataSetIterator):
    """≡ deeplearning4j-datasets :: SvhnDataSetIterator — Street View
    House Numbers, (B, 32, 32, 3) NHWC in [0,1], 10 classes. Zero-egress
    environment: parses nothing from disk (the reference downloads .mat
    files); deterministic synthetic data with the SVHN shape/classes."""

    def __init__(self, batch_size, train=True, seed=321, num_examples=None):
        DataSetIterator.__init__(self, batch_size)
        n = num_examples or (4000 if train else 1000)
        self._images, self._labels = _synthetic_images(
            n, self.H, self.W, 3, self.NUM_CLASSES,
            seed if train else seed + 1)


class TinyImageNetDataSetIterator(CifarDataSetIterator):
    """≡ deeplearning4j-datasets :: TinyImageNetDataSetIterator —
    (B, 64, 64, 3) NHWC in [0,1], 200 classes; synthetic under zero
    egress. Shares CifarDataSetIterator's batch/next machinery (only the
    shape constants and the synthetic source differ)."""

    H = W = 64
    NUM_CLASSES = 200

    def __init__(self, batch_size, train=True, seed=777, num_examples=None):
        DataSetIterator.__init__(self, batch_size)
        n = num_examples or (2000 if train else 500)
        self._images, self._labels = _synthetic_images(
            n, self.H, self.W, 3, self.NUM_CLASSES,
            seed if train else seed + 1)


class UciSequenceDataSetIterator(DataSetIterator):
    """≡ deeplearning4j-datasets :: UciSequenceDataSetIterator — the UCI
    synthetic-control time-series classification set: 600 univariate
    sequences of length 60, 6 classes. The real set IS synthetic
    (Alcock & Manolopoulos generators); we generate the same six pattern
    families deterministically (normal / cyclic / increasing / decreasing
    / upward-shift / downward-shift), so training behaves like the
    reference's. Yields (B, 60, 1) features + one-hot labels."""

    SEQ_LEN = 60
    NUM_CLASSES = 6

    def __init__(self, batch_size, train=True, seed=1066):
        super().__init__(batch_size)
        rng = np.random.default_rng(seed if train else seed + 1)
        per = 80 if train else 20
        xs, ys = [], []
        t = np.arange(self.SEQ_LEN, dtype=np.float32)
        for cls in range(self.NUM_CLASSES):
            for _ in range(per):
                base = 30.0 + 2.0 * rng.standard_normal(self.SEQ_LEN).astype(np.float32)
                if cls == 1:    # cyclic
                    amp, period = rng.uniform(10, 15), rng.uniform(10, 15)
                    base += amp * np.sin(2 * np.pi * t / period)
                elif cls == 2:  # increasing trend
                    base += rng.uniform(0.2, 0.5) * t
                elif cls == 3:  # decreasing trend
                    base -= rng.uniform(0.2, 0.5) * t
                elif cls in (4, 5):  # up/down shift at a random time
                    at = rng.integers(self.SEQ_LEN // 3, 2 * self.SEQ_LEN // 3)
                    shift = rng.uniform(7.5, 20)
                    base[at:] += shift if cls == 4 else -shift
                xs.append(base)
                ys.append(cls)
        order = rng.permutation(len(xs))
        self._x = np.stack(xs)[order][:, :, None].astype(np.float32)
        self._y = np.asarray(ys)[order]

    def numExamples(self):
        return len(self._x)

    def totalOutcomes(self):
        return self.NUM_CLASSES

    def inputColumns(self):
        return 1

    def next(self, num=None):
        self._check_has_next()
        n = num or self._batch
        x = self._x[self._cursor:self._cursor + n]
        y = self._y[self._cursor:self._cursor + n]
        self._cursor += len(x)
        return self._maybe_preprocess(
            DataSet(x, _one_hot(y, self.NUM_CLASSES)))
