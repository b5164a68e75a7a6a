"""Unsupervised analysis toolchain (≡ dl4j-examples usage of
deeplearning4j-clustering KMeansClustering, VPTree nearest neighbors,
BarnesHutTsne visualization, and deeplearning4j-graph DeepWalk): the
twin of `examples/unsupervised_analysis.py` on the port. Cluster a
feature set, find nearest neighbors, project to 2-D, and embed a graph's
vertices — on the device (the Lloyd loop, the kNN distance matrix, the
t-SNE descent and DeepWalk's skip-gram steps).

One setting differs: DeepWalk's learning rate. Its skip-gram step sums
over a batch's pairs, and on 16 vertices the script's 0.5 overflows to
nan similarities; the twin runs at 0.01, the rate of the JAX package's
DeepWalk tests.

Run: `python -m deeplearning4j_tpu_torch.examples.unsupervised_analysis`
(the card; `main(device="cpu")` runs it on the CPU).
"""
import numpy as np

from deeplearning4j_tpu_torch.clustering import (BarnesHutTsne,
                                                 KMeansClustering, Point,
                                                 VPTree, knn)
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph


def make_blobs(n_per=60, seed=0):
    rng = np.random.RandomState(seed)
    centers = np.array([[0, 0, 0, 0], [6, 6, 0, 0], [0, 0, 6, 6]], np.float32)
    x = np.concatenate([rng.randn(n_per, 4).astype(np.float32) * 0.6 + c
                        for c in centers])
    return x, np.repeat(np.arange(3), n_per)


def main(device=None):
    x, true_labels = make_blobs()
    out = {}

    # 1. KMeans: the Lloyd refinement runs on the device
    kmc = KMeansClustering.setup(3, maxIterationCount=50,
                                 useKMeansPlusPlus=True, device=device)
    cluster_set = kmc.applyTo(Point.toPoints(x))
    out["cluster_sizes"] = []
    for cl in cluster_set.getClusters():
        out["cluster_sizes"].append(len(cl.getPoints()))
        print(f"cluster {cl.getId()}: {len(cl.getPoints())} points, "
              f"center {np.round(cl.getCenter(), 1)}")
    pc = cluster_set.classifyPoint(Point([6.1, 5.8, 0.2, -0.1]))
    out["query_center"] = np.asarray(pc.getCluster().getCenter())
    print(f"query point -> cluster {pc.getCluster().getId()} "
          f"(distance {pc.getDistanceFromCenter():.2f})")

    # 2. Nearest neighbors: batched exact kNN = one GEMM + top-k on device
    idx, dist = knn(x[:5], x, k=4, device=device)
    print("kNN of point 0 (self first):", idx[0], np.round(dist[0], 2))
    # ... and the API-parity host-side VPTree for trickle queries
    tree = VPTree(x, "euclidean")
    results, dists = tree.search(x[0], 4)
    out["knn_0"] = [int(i) for i in idx[0]]
    out["vptree_0"] = [r.getIndex() for r in results]
    assert out["vptree_0"] == out["knn_0"]

    # 3. t-SNE: exact O(N^2) gradients, the descent on the device
    tsne = (BarnesHutTsne.Builder().setMaxIter(400).perplexity(20)
            .learningRate(200).seed(0).build())
    emb = tsne.fit(x, device=device).getData()
    d = np.sqrt(((emb[:, None] - emb[None, :]) ** 2).sum(-1))
    same = d[true_labels[:, None] == true_labels[None, :]].mean()
    diff = d[true_labels[:, None] != true_labels[None, :]].mean()
    out["tsne_intra"], out["tsne_inter"] = float(same), float(diff)
    print(f"t-SNE 2-D embedding: intra-blob dist {same:.2f} "
          f"vs inter-blob {diff:.2f}")

    # 4. DeepWalk: random walks host-side, skip-gram updates on device
    g = Graph(16)
    for base in (0, 8):                      # two 8-cliques + one bridge
        for i in range(8):
            for j in range(i + 1, 8):
                g.addEdge(base + i, base + j)
    g.addEdge(7, 8)
    dw = (DeepWalk.Builder().vectorSize(16).windowSize(4)
          .learningRate(0.01).epochs(40).batchSize(256).seed(1)
          .device(device).build())
    dw.fit(g, walk_length=10)
    out["dw_same"], out["dw_across"] = dw.similarity(0, 3), \
        dw.similarity(0, 12)
    out["dw_nearest_0"] = [int(v) for v in dw.verticesNearest(0, top=4)]
    print(f"DeepWalk: sim(0,3) same community = {out['dw_same']:.2f}, "
          f"sim(0,12) across bridge = {out['dw_across']:.2f}")
    print("nearest to vertex 0:", dw.verticesNearest(0, top=4))
    return out


if __name__ == "__main__":
    main()
