"""NearestNeighborsServer: the port of
`deeplearning4j_tpu/clustering/nn_server.py` (≡
deeplearning4j-nearestneighbors-server ::
org.deeplearning4j.nearestneighbor.server.NearestNeighborsServer +
client model NearestNeighborRequest/NearestNeighborsResult).

Reference shape: a REST service loaded with a serialized INDArray corpus,
answering `POST /knn` (k nearest of an indexed corpus point) and
`POST /knnnew` (k nearest of a posted vector) via a VPTree.

Queries are answered by the batched exact-kNN path
(`clustering.vptree.knn` — a (Q, N) GEMM + top-k on the server's device,
the card unless `device="cpu"`; the corpus stays there), not tree
traversal; the VPTree remains available for host-only deployments
(`useVpTree=True`). Dependency-free stdlib http.server, like the UI
dashboard.

Endpoints (JSON):
- POST /knn     {"index": i, "k": k}            → {"results": [...]}
- POST /knnnew  {"arr": [[...]] | [...], "k": k} → {"results": [[...]]}
  (a single flat vector returns one result list, batched input a list
  per query — batching is free on the GEMM path)
- GET  /status  → {"points": N, "dim": D, "similarity": "..."}

Each result entry is {"index": i, "distance": d} sorted nearest-first.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.vptree import VPTree, knn
from deeplearning4j_tpu_torch.device import resolve

__all__ = ["NearestNeighborsServer"]


class NearestNeighborsServer:
    def __init__(self, points, similarity_function="euclidean", port=9000,
                 useVpTree=False, host="127.0.0.1", device=None):
        self.points = np.asarray(points, np.float32)
        self.fn = str(similarity_function).lower()
        self.port = int(port)
        self.host = str(host)    # "0.0.0.0" to serve non-local clients
        # VPTree refuses 'dot' (not a metric — tree pruning would be
        # inexact); degrade to the exact batched GEMM path instead of
        # failing server construction.
        if useVpTree and self.fn == "dot":
            import sys
            print("NearestNeighborsServer: useVpTree ignored for 'dot' "
                  "(not a metric); serving via the exact batched knn path",
                  file=sys.stderr, flush=True)
            useVpTree = False
        self._tree = (VPTree(self.points, self.fn) if useVpTree else None)
        # the corpus lives on the device once, for every knn query
        self._items = (None if useVpTree else torch.as_tensor(
            self.points, device=resolve(device)))
        self._httpd = None
        self._thread = None

    # -- query core (usable without the HTTP layer) ----------------------
    def query_index(self, index, k):
        """k nearest of corpus point `index` (excluding itself)."""
        index = int(index)
        if not -self.points.shape[0] <= index < self.points.shape[0]:
            raise IndexError(f"index {index} out of range for "
                             f"{self.points.shape[0]} points")
        index %= self.points.shape[0]      # normalize so self-exclusion works
        idx, dist = self._query(self.points[index][None, :], k + 1)
        out = [{"index": int(i), "distance": float(d)}
               for i, d in zip(idx[0], dist[0]) if int(i) != index]
        return out[:k]

    def query_vectors(self, arr, k):
        arr = np.asarray(arr, np.float32)
        single = arr.ndim == 1
        idx, dist = self._query(arr[None, :] if single else arr, k)
        res = [[{"index": int(i), "distance": float(d)}
                for i, d in zip(row_i, row_d)]
               for row_i, row_d in zip(idx, dist)]
        return res[0] if single else res

    def _query(self, q, k):
        k = min(int(k), self.points.shape[0])
        if self._tree is not None:
            idx, dist = [], []
            for row in q:
                results, ds = self._tree.search(row, k)
                idx.append([r.getIndex() for r in results])
                dist.append(ds)
            return np.asarray(idx), np.asarray(dist)
        return knn(q, self._items, k, self.fn, device=self._items.device)

    # -- HTTP layer ------------------------------------------------------
    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/status":
                    self._send(200, {"points": int(server.points.shape[0]),
                                     "dim": int(server.points.shape[1]),
                                     "similarity": server.fn})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    k = int(req.get("k", 1))
                    if self.path == "/knn":
                        self._send(200, {"results": server.query_index(
                            req["index"], k)})
                    elif self.path == "/knnnew":
                        self._send(200, {"results": server.query_vectors(
                            req["arr"], k)})
                    else:
                        self._send(404, {"error": "unknown path"})
                except Exception as e:  # noqa: BLE001 — report to client
                    self._send(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolves port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None
