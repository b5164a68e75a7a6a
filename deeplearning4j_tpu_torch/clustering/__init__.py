"""Clustering / manifold / nearest-neighbors: the port of
`deeplearning4j_tpu/clustering/` (≡ deeplearning4j-clustering,
deeplearning4j-nearestneighbors, org.deeplearning4j.plot)."""
from deeplearning4j_tpu_torch.clustering.kmeans import (Cluster, ClusterSet,
                                                  KMeansClustering, Point,
                                                  PointClassification)
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.nn_server import NearestNeighborsServer
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne, Tsne
from deeplearning4j_tpu_torch.clustering.vptree import DataPoint, VPTree, knn

__all__ = ["KMeansClustering", "Point", "Cluster", "ClusterSet",
           "PointClassification", "BarnesHutTsne", "Tsne", "VPTree",
           "DataPoint", "knn", "NearestNeighborsServer", "KDTree"]
