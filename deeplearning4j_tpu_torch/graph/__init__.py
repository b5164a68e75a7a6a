"""Graph embeddings (≡ deeplearning4j-graph): the port of
`deeplearning4j_tpu/graph/`, with the same public names."""
from deeplearning4j_tpu_torch.graph.deepwalk import (DeepWalk, GraphVectors,
                                                     GraphVectorsSerializer)
from deeplearning4j_tpu_torch.graph.graph import (Edge, Graph,
                                                  RandomWalkIterator, Vertex,
                                                  WeightedRandomWalkIterator)

__all__ = ["Graph", "Vertex", "Edge", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "DeepWalk", "GraphVectors",
           "GraphVectorsSerializer"]
