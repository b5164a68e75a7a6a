"""DataSet, MultiDataSet, the DataSetIterators and the normalizers of the
port (numpy)."""
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
from deeplearning4j_tpu_torch.datasets.normalizers import (
    DataNormalization, ImagePreProcessingScaler, MultiNormalizerMinMaxScaler,
    MultiNormalizerStandardize, NormalizerMinMaxScaler,
    NormalizerStandardize, VGG16ImagePreProcessor)

__all__ = [
    "DataSet", "MultiDataSet", "SplitTestAndTrain", "ArrayDataSetIterator",
    "AsyncDataSetIterator", "Cifar100DataSetIterator",
    "CifarDataSetIterator", "DataSetIterator", "EmnistDataSetIterator",
    "IrisDataSetIterator", "LFWDataSetIterator", "ListDataSetIterator",
    "ListMultiDataSetIterator", "MnistDataSetIterator",
    "SingletonMultiDataSetIterator", "SvhnDataSetIterator",
    "SyntheticImageNetIterator", "TinyImageNetDataSetIterator",
    "UciSequenceDataSetIterator", "DataNormalization",
    "ImagePreProcessingScaler", "MultiNormalizerMinMaxScaler",
    "MultiNormalizerStandardize", "NormalizerMinMaxScaler",
    "NormalizerStandardize", "VGG16ImagePreProcessor",
]
