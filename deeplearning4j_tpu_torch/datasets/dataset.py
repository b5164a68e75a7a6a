"""DataSet (≡ nd4j-api :: org.nd4j.linalg.dataset.DataSet) — features,
labels, optional feature/label masks, plus the reference's utility surface
(merge/split/shuffle/batchBy): a copy of
`deeplearning4j_tpu/datasets/dataset.py`. The arrays are numpy; the
accessors wrap them in NDArrays over host tensors (sharing their
memory), and tensors or NDArrays given to the constructors are copied to
the host."""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _nd(a):
    """A host array as an NDArray on the host (the data lives there; the
    network moves it to its device)."""
    from deeplearning4j_tpu_torch.ops.ndarray import NDArray
    return NDArray(torch.from_numpy(np.ascontiguousarray(a)))


class DataSet:
    def __init__(self, features=None, labels=None, featuresMask=None,
                 labelsMask=None):
        self.features = _np(features)
        self.labels = _np(labels)
        self.featuresMask = _np(featuresMask)
        self.labelsMask = _np(labelsMask)

    # -- accessors (reference names) -------------------------------------
    def getFeatures(self):
        return _nd(self.features)

    def getLabels(self):
        return _nd(self.labels)

    def getFeaturesMaskArray(self):
        return None if self.featuresMask is None else _nd(self.featuresMask)

    def getLabelsMaskArray(self):
        return None if self.labelsMask is None else _nd(self.labelsMask)

    def setFeatures(self, f):
        self.features = _np(f)

    def setLabels(self, l):
        self.labels = _np(l)

    def numExamples(self):
        return 0 if self.features is None else int(self.features.shape[0])

    def numInputs(self):
        return int(np.prod(self.features.shape[1:]))

    def numOutcomes(self):
        return int(self.labels.shape[-1])

    def hasMaskArrays(self):
        return self.featuresMask is not None or self.labelsMask is not None

    # -- utilities --------------------------------------------------------
    def copy(self):
        return DataSet(None if self.features is None else self.features.copy(),
                       None if self.labels is None else self.labels.copy(),
                       None if self.featuresMask is None else self.featuresMask.copy(),
                       None if self.labelsMask is None else self.labelsMask.copy())

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.numExamples())
        self.features = self.features[perm]
        if self.labels is not None:
            self.labels = self.labels[perm]
        if self.featuresMask is not None:
            self.featuresMask = self.featuresMask[perm]
        if self.labelsMask is not None:
            self.labelsMask = self.labelsMask[perm]
        return self

    def splitTestAndTrain(self, fraction_or_n):
        n = self.numExamples()
        n_train = (int(round(fraction_or_n * n)) if isinstance(fraction_or_n, float)
                   else int(fraction_or_n))

        def cut(arr, sl):
            return None if arr is None else arr[sl]

        train = DataSet(self.features[:n_train], cut(self.labels, slice(None, n_train)),
                        cut(self.featuresMask, slice(None, n_train)),
                        cut(self.labelsMask, slice(None, n_train)))
        test = DataSet(self.features[n_train:], cut(self.labels, slice(n_train, None)),
                       cut(self.featuresMask, slice(n_train, None)),
                       cut(self.labelsMask, slice(n_train, None)))
        return SplitTestAndTrain(train, test)

    def batchBy(self, batch_size):
        n = self.numExamples()
        return [DataSet(self.features[i:i + batch_size],
                        None if self.labels is None else self.labels[i:i + batch_size],
                        None if self.featuresMask is None else self.featuresMask[i:i + batch_size],
                        None if self.labelsMask is None else self.labelsMask[i:i + batch_size])
                for i in range(0, n, batch_size)]

    def asList(self):
        return self.batchBy(1)

    @staticmethod
    def merge(datasets):
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            None if datasets[0].labels is None else np.concatenate([d.labels for d in datasets]),
            None if datasets[0].featuresMask is None else np.concatenate([d.featuresMask for d in datasets]),
            None if datasets[0].labelsMask is None else np.concatenate([d.labelsMask for d in datasets]))

    def sample(self, n, seed=None):
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.numExamples(), size=n, replace=False)
        pick = lambda a: None if a is None else a[idx]
        return DataSet(self.features[idx], pick(self.labels),
                       pick(self.featuresMask), pick(self.labelsMask))

    def scale(self):
        mx = np.abs(self.features).max()
        if mx > 0:
            self.features = self.features / mx
        return self


class MultiDataSet:
    """≡ nd4j MultiDataSet — multiple feature/label arrays for
    ComputationGraph multi-input/multi-output training."""

    def __init__(self, features, labels, featuresMasks=None, labelsMasks=None):
        def aslist(v):
            if v is None:
                return None
            if isinstance(v, (list, tuple)):
                return [(_np(x) if x is not None else None) for x in v]
            return [_np(v)]
        self.features = aslist(features)
        self.labels = aslist(labels)
        self.featuresMasks = aslist(featuresMasks)
        self.labelsMasks = aslist(labelsMasks)

    def getFeatures(self, i=None):
        return [_nd(f) for f in self.features] if i is None \
            else _nd(self.features[i])

    def getLabels(self, i=None):
        return [_nd(l) for l in self.labels] if i is None \
            else _nd(self.labels[i])

    def numFeatureArrays(self):
        return len(self.features)

    def numLabelsArrays(self):
        return len(self.labels)


class SplitTestAndTrain:
    def __init__(self, train, test):
        self._train, self._test = train, test

    def getTrain(self):
        return self._train

    def getTest(self):
        return self._test
