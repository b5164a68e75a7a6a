"""DataVec (≡ datavec-api, datavec-data-image and the DataVec iterators):
the port of `deeplearning4j_tpu/datavec/`, host-side ETL."""
from deeplearning4j_tpu_torch.datavec.image_records import (
    ColorConversionTransform, CropImageTransform, FlipImageTransform,
    ImageRecordDataSetIterator, ImageRecordReader, NativeImageLoader,
    ParentPathLabelGenerator, PipelineImageTransform, RandomCropTransform,
    ResizeImageTransform, RotateImageTransform)
from deeplearning4j_tpu_torch.datavec.sequence import (
    AnalyzeLocal, CollectionSequenceRecordReader, CSVSequenceRecordReader,
    DataAnalysis, Join, SequenceRecordReader,
    SequenceRecordReaderDataSetIterator)
from deeplearning4j_tpu_torch.datavec.records import (
    CollectionRecordReader, CSVRecordReader, LineRecordReader, RecordReader,
    RecordReaderDataSetIterator, Schema, TransformProcess)

__all__ = [
    "AnalyzeLocal", "CollectionSequenceRecordReader",
    "CSVSequenceRecordReader", "DataAnalysis", "Join",
    "SequenceRecordReader", "SequenceRecordReaderDataSetIterator",
    "CollectionRecordReader", "CSVRecordReader", "LineRecordReader",
    "RecordReader", "RecordReaderDataSetIterator", "Schema",
    "TransformProcess", "FlipImageTransform", "ImageRecordDataSetIterator",
    "ImageRecordReader", "NativeImageLoader", "ParentPathLabelGenerator",
    "PipelineImageTransform", "ResizeImageTransform",
    "ColorConversionTransform", "CropImageTransform",
    "RandomCropTransform", "RotateImageTransform"]
