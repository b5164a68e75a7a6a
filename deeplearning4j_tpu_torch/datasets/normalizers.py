"""Data normalizers, copied from `deeplearning4j_tpu/datasets/normalizers.py`,
which has no jax in it (≡ nd4j-api :: dataset.api.preprocessor.*:
NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler,
VGG16ImagePreProcessor). fit(iterator) accumulates statistics; set as a
DataSetIterator preprocessor to apply on the fly, exactly like the
reference."""
from __future__ import annotations

import numpy as np


class DataNormalization:
    def fit(self, iterator_or_dataset):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        if isinstance(iterator_or_dataset, DataSet):
            self._fit_batches([iterator_or_dataset.features])
        else:
            it = iterator_or_dataset
            it.reset()
            self._fit_batches(ds.features for ds in it)
            it.reset()
        return self

    def _fit_batches(self, batches):
        pass

    def preProcess(self, dataset):
        dataset.features = self.transform_array(dataset.features)
        return dataset

    def transform(self, x_or_dataset):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        if isinstance(x_or_dataset, DataSet):
            return self.preProcess(x_or_dataset)
        return self.transform_array(np.asarray(x_or_dataset))

    def revert(self, dataset):
        dataset.features = self.revert_array(dataset.features)
        return dataset

    def transform_array(self, x):
        raise NotImplementedError

    def revert_array(self, x):
        raise NotImplementedError

    # serialization
    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, d):
        self.__dict__.update(d)
        return self


class NormalizerStandardize(DataNormalization):
    """Per-feature zero-mean unit-variance (column-wise over feature dim)."""

    def __init__(self):
        self.mean = None
        self.std = None

    def _fit_batches(self, batches):
        n, s, ss = 0, None, None
        for f in batches:
            f = f.reshape(len(f), -1).astype(np.float64)
            if s is None:
                s, ss = f.sum(0), (f ** 2).sum(0)
            else:
                s += f.sum(0)
                ss += (f ** 2).sum(0)
            n += len(f)
        self.mean = (s / n).astype(np.float32)
        var = ss / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)

    def transform_array(self, x):
        shape = x.shape
        flat = x.reshape(len(x), -1)
        return ((flat - self.mean) / self.std).reshape(shape).astype(np.float32)

    def revert_array(self, x):
        shape = x.shape
        flat = x.reshape(len(x), -1)
        return (flat * self.std + self.mean).reshape(shape).astype(np.float32)

    def getMean(self):
        return self.mean

    def getStd(self):
        return self.std


class NormalizerMinMaxScaler(DataNormalization):
    def __init__(self, minRange=0.0, maxRange=1.0):
        self.lo, self.hi = float(minRange), float(maxRange)
        self.data_min = None
        self.data_max = None

    def _fit_batches(self, batches):
        mn = mx = None
        for f in batches:
            f = f.reshape(len(f), -1)
            bmn, bmx = f.min(0), f.max(0)
            mn = bmn if mn is None else np.minimum(mn, bmn)
            mx = bmx if mx is None else np.maximum(mx, bmx)
        self.data_min, self.data_max = mn.astype(np.float32), mx.astype(np.float32)

    def transform_array(self, x):
        shape = x.shape
        flat = x.reshape(len(x), -1)
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        scaled = (flat - self.data_min) / rng
        return (self.lo + scaled * (self.hi - self.lo)).reshape(shape).astype(np.float32)

    def revert_array(self, x):
        shape = x.shape
        flat = x.reshape(len(x), -1)
        rng = self.data_max - self.data_min
        return (((flat - self.lo) / (self.hi - self.lo)) * rng + self.data_min) \
            .reshape(shape).astype(np.float32)


class ImagePreProcessingScaler(DataNormalization):
    """uint8 [0,255] → [minRange,maxRange] (default [0,1]); stateless."""

    def __init__(self, minRange=0.0, maxRange=1.0, maxPixelVal=255.0):
        self.lo, self.hi, self.maxPixel = float(minRange), float(maxRange), float(maxPixelVal)

    def fit(self, *_):
        return self

    def transform_array(self, x):
        return (self.lo + (x.astype(np.float32) / self.maxPixel) * (self.hi - self.lo))

    def revert_array(self, x):
        return ((x - self.lo) / (self.hi - self.lo) * self.maxPixel)


class VGG16ImagePreProcessor(DataNormalization):
    """Subtract ImageNet channel means (RGB), NHWC; stateless."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def fit(self, *_):
        return self

    def transform_array(self, x):
        return x.astype(np.float32) - self.MEANS

    def revert_array(self, x):
        return x + self.MEANS


class _MultiNormalizer:
    """Base for MultiDataSet normalizers (≡ nd4j
    preprocessor.MultiNormalizerStandardize / MultiNormalizerMinMaxScaler):
    one independent per-input normalizer, fit jointly from a
    MultiDataSetIterator, applied via preProcess like the reference's
    MultiDataNormalization."""

    _single_cls = None

    def __init__(self):
        self._normalizers = None

    def fit(self, iterator_or_mds):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        if isinstance(iterator_or_mds, MultiDataSet):
            n_inputs = iterator_or_mds.numFeatureArrays()
            self._normalizers = [self._single_cls()
                                 for _ in range(n_inputs)]
            for i, norm in enumerate(self._normalizers):
                norm._fit_batches([iterator_or_mds.features[i]])
            return self
        # iterator: one STREAMING pass per input (like the single-input
        # normalizer) instead of materializing the whole dataset
        it = iterator_or_mds
        it.reset()
        first = next(iter(it), None)
        if first is None:
            raise ValueError("empty MultiDataSet iterator")
        n_inputs = first.numFeatureArrays()
        self._normalizers = [self._single_cls() for _ in range(n_inputs)]
        for i, norm in enumerate(self._normalizers):
            it.reset()
            norm._fit_batches(mds.features[i] for mds in it)
        it.reset()
        return self

    def _check_fit(self, mds):
        if self._normalizers is None:
            raise ValueError("call fit() first")
        if mds.numFeatureArrays() != len(self._normalizers):
            raise ValueError(
                f"MultiDataSet has {mds.numFeatureArrays()} inputs, "
                f"normalizer was fit on {len(self._normalizers)}")

    def preProcess(self, mds):
        self._check_fit(mds)
        mds.features = [n.transform_array(f)
                        for n, f in zip(self._normalizers, mds.features)]
        return mds

    transform = preProcess

    def revert(self, mds):
        self._check_fit(mds)
        mds.features = [n.revert_array(f)
                        for n, f in zip(self._normalizers, mds.features)]
        return mds

    def getInputNormalizer(self, i):
        return self._normalizers[i]

    # serialization (ModelSerializer normalizer slot / pickle)
    def state_dict(self):
        return {"per_input": [n.state_dict() for n in self._normalizers]
                if self._normalizers is not None else None}

    def load_state_dict(self, d):
        per = d.get("per_input")
        if per is None:
            self._normalizers = None
        else:
            self._normalizers = []
            for nd in per:
                n = self._single_cls()
                n.load_state_dict(nd)
                self._normalizers.append(n)
        return self


class MultiNormalizerStandardize(_MultiNormalizer):
    _single_cls = NormalizerStandardize


class MultiNormalizerMinMaxScaler(_MultiNormalizer):
    _single_cls = NormalizerMinMaxScaler
