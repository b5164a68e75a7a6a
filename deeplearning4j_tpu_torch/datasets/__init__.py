"""DataSet, MultiDataSet and the DataSetIterators of the port (numpy)."""
from deeplearning4j_tpu_torch.datasets.dataset import (DataSet, MultiDataSet,
                                                       SplitTestAndTrain)
from deeplearning4j_tpu_torch.datasets.iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, Cifar100DataSetIterator,
    CifarDataSetIterator, DataSetIterator, EmnistDataSetIterator,
    IrisDataSetIterator, LFWDataSetIterator, ListDataSetIterator,
    ListMultiDataSetIterator, MnistDataSetIterator,
    SingletonMultiDataSetIterator, SvhnDataSetIterator,
    SyntheticImageNetIterator, TinyImageNetDataSetIterator,
    UciSequenceDataSetIterator)

__all__ = [
    "DataSet", "MultiDataSet", "SplitTestAndTrain", "ArrayDataSetIterator",
    "AsyncDataSetIterator", "Cifar100DataSetIterator",
    "CifarDataSetIterator", "DataSetIterator", "EmnistDataSetIterator",
    "IrisDataSetIterator", "LFWDataSetIterator", "ListDataSetIterator",
    "ListMultiDataSetIterator", "MnistDataSetIterator",
    "SingletonMultiDataSetIterator", "SvhnDataSetIterator",
    "SyntheticImageNetIterator", "TinyImageNetDataSetIterator",
    "UciSequenceDataSetIterator",
]
