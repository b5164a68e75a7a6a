"""The port's `nn/`: the builder DSL, every layer and vertex of the JAX
package's `nn/conf/` (the convolutional, 1-D and 3-D families, the YOLOv2
head and the center loss, the recurrent, sequence and attention layers,
the locally connected layers, the autoencoders, the capsules, weight
noise, the custom SameDiff layers and the frozen wrappers
`layers.FrozenLayer`, `layers.FrozenLayerWithBackprop` and
`graph_vertices.FrozenVertex`), the conv1x1+BN fusion pass,
`ComputationGraph`, `MultiLayerNetwork` and the training surface they
share: updaters, schedules, losses, dropout objects, constraints and
gradient accumulation."""
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.builders import (BackpropType,
                                                       MultiLayerConfiguration,
                                                       NeuralNetConfiguration,
                                                       WorkspaceMode)
from deeplearning4j_tpu_torch.nn.conf.attention import (
    AttentionVertex, LearnedSelfAttentionLayer, RecurrentAttentionLayer,
    SelfAttentionLayer)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    DuplicateToTimeSeriesVertex, ElementWiseVertex, GraphVertex,
    L2NormalizeVertex, L2Vertex, LastTimeStepVertex, MergeVertex,
    PreprocessorVertex, ReshapeVertex, ReverseTimeSeriesVertex, ScaleVertex,
    ShiftVertex, SpaceToDepthVertex, StackVertex, SubsetVertex,
    UnstackVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, Convolution1DLayer,
    ConvolutionLayer, Cropping2D, DenseLayer, DepthwiseConvolution2D,
    DropoutLayer, EmbeddingLayer, EmbeddingSequenceLayer, GlobalPoolingLayer,
    LossLayer, OutputLayer, PReLULayer, SeparableConvolution2D,
    Subsampling1DLayer, SubsamplingLayer, TimeDistributed, Upsampling1D,
    Upsampling2D, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.objdetect import (DetectedObject,
                                                        Yolo2OutputLayer,
                                                        YoloUtils)
from deeplearning4j_tpu_torch.nn.conf.recurrent import (
    LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep,
    RnnOutputLayer, SimpleRnn)
from deeplearning4j_tpu_torch.nn.conf.sequence_layers import (MaskLayer,
                                                              MaskZeroLayer,
                                                              RnnLossLayer)
from deeplearning4j_tpu_torch.nn.conf.special_layers import (
    AutoEncoder, CenterLossOutputLayer, LocallyConnected1D,
    LocallyConnected2D, VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.constraints import (MaxNormConstraint,
                                                     MinMaxNormConstraint,
                                                     NonNegativeConstraint,
                                                     UnitNormConstraint)
from deeplearning4j_tpu_torch.nn.convert import (graph_params_from_numpy,
                                                 graph_params_to_numpy,
                                                 multilayer_params_from_numpy,
                                                 multilayer_params_to_numpy)
from deeplearning4j_tpu_torch.nn.dropout import (AlphaDropout, Dropout,
                                                 GaussianDropout,
                                                 GaussianNoise, IDropout,
                                                 SpatialDropout)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.losses import (LossBinaryXENT, LossFMeasure,
                                                LossFunction, LossMCXENT,
                                                LossMixtureDensity, LossMSE,
                                                LossMultiLabel,
                                                LossNegativeLogLikelihood,
                                                LossWasserstein)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.schedules import (CycleSchedule,
                                                   ExponentialSchedule,
                                                   FixedSchedule,
                                                   InverseSchedule,
                                                   MapSchedule, PolySchedule,
                                                   Schedule, SigmoidSchedule,
                                                   StepSchedule)
from deeplearning4j_tpu_torch.nn.updaters import (AdaDelta, AdaGrad, Adam,
                                                  AdaMax, AMSGrad,
                                                  GradientNormalization,
                                                  Nadam, Nesterovs, NoOp,
                                                  RmsProp, Sgd, Updater)
from deeplearning4j_tpu_torch.nn.weights_init import WeightInit

__all__ = [
    "Activation", "BackpropType", "NeuralNetConfiguration",
    "MultiLayerConfiguration", "WorkspaceMode", "InputType", "layers",
    "ActivationLayer", "BatchNormalization", "ConvolutionLayer",
    "DenseLayer", "DropoutLayer", "GlobalPoolingLayer", "OutputLayer",
    "SubsamplingLayer", "EmbeddingLayer", "EmbeddingSequenceLayer",
    "TimeDistributed", "DepthwiseConvolution2D", "SeparableConvolution2D",
    "Upsampling2D", "LossLayer", "Yolo2OutputLayer", "YoloUtils",
    "DetectedObject", "CenterLossOutputLayer", "Convolution1DLayer",
    "Cropping2D", "PReLULayer", "Subsampling1DLayer", "Upsampling1D",
    "ZeroPaddingLayer", "AutoEncoder", "LocallyConnected1D",
    "LocallyConnected2D", "VariationalAutoencoder", "ScaleVertex", "ShiftVertex",
    "L2NormalizeVertex", "L2Vertex", "PreprocessorVertex", "ReshapeVertex",
    "SpaceToDepthVertex", "SubsetVertex", "StackVertex", "UnstackVertex",
    "LSTM", "GravesLSTM", "SimpleRnn",
    "Bidirectional", "GravesBidirectionalLSTM", "LastTimeStep",
    "RnnOutputLayer", "MaskLayer", "MaskZeroLayer", "RnnLossLayer",
    "SelfAttentionLayer", "LearnedSelfAttentionLayer",
    "RecurrentAttentionLayer", "AttentionVertex", "LastTimeStepVertex",
    "DuplicateToTimeSeriesVertex", "ReverseTimeSeriesVertex",
    "GraphVertex", "MergeVertex", "ElementWiseVertex",
    "ComputationGraph", "MultiLayerNetwork", "graph_params_from_numpy",
    "graph_params_to_numpy", "multilayer_params_from_numpy",
    "multilayer_params_to_numpy", "LossFunction", "LossBinaryXENT",
    "LossFMeasure", "LossMCXENT", "LossMixtureDensity", "LossMSE",
    "LossMultiLabel", "LossNegativeLogLikelihood", "LossWasserstein",
    "Updater", "Sgd", "Nesterovs", "Adam", "AdaMax", "Nadam", "AMSGrad",
    "RmsProp", "AdaGrad", "AdaDelta", "NoOp", "GradientNormalization",
    "Schedule", "FixedSchedule", "StepSchedule", "ExponentialSchedule",
    "InverseSchedule", "PolySchedule", "SigmoidSchedule", "MapSchedule",
    "CycleSchedule", "IDropout", "Dropout", "GaussianDropout",
    "GaussianNoise", "AlphaDropout", "SpatialDropout", "MaxNormConstraint",
    "MinMaxNormConstraint", "UnitNormConstraint", "NonNegativeConstraint",
    "WeightInit",
]
