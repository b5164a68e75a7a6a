"""The port's `nn/`: the builder DSL, the layers ResNet-50 needs, the
conv1x1+BN fusion pass and `ComputationGraph`'s inference forward."""
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.builders import (BackpropType,
                                                       MultiLayerConfiguration,
                                                       NeuralNetConfiguration,
                                                       WorkspaceMode)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
    ElementWiseVertex, GraphVertex, MergeVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                     BatchNormalization,
                                                     ConvolutionLayer,
                                                     DenseLayer, DropoutLayer,
                                                     GlobalPoolingLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.convert import (graph_params_from_numpy,
                                                 graph_params_to_numpy)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.losses import LossFunction
from deeplearning4j_tpu_torch.nn.updaters import (Adam, Nesterovs, Sgd,
                                                  Updater)
from deeplearning4j_tpu_torch.nn.weights_init import WeightInit

__all__ = [
    "Activation", "BackpropType", "NeuralNetConfiguration",
    "MultiLayerConfiguration", "WorkspaceMode", "InputType", "layers",
    "ActivationLayer", "BatchNormalization", "ConvolutionLayer",
    "DenseLayer", "DropoutLayer", "GlobalPoolingLayer", "OutputLayer",
    "SubsamplingLayer", "GraphVertex", "MergeVertex", "ElementWiseVertex",
    "ComputationGraph", "graph_params_from_numpy", "graph_params_to_numpy",
    "LossFunction", "Adam", "Nesterovs", "Sgd", "Updater", "WeightInit",
]
