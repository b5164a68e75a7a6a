"""t-SNE: the port of `deeplearning4j_tpu/clustering/tsne.py` (≡
deeplearning4j :: org.deeplearning4j.plot.BarnesHutTsne / Tsne + its
Builder surface).

Reference shape: Barnes-Hut approximated gradients via a quad-tree
(``theta`` trades accuracy for CPU time), perplexity-calibrated input
affinities, early exaggeration, momentum switch, optional AdaGrad.

As in the JAX package, the gradients are EXACT: the O(N²) pairwise term
is blocked (rowBlock, N) GEMMs per iteration on the device (the card
unless ``fit(x, device="cpu")``); perplexity calibration is a per-row
bisection over a row block, 50 steps, all rows at once; ``theta`` is
accepted for API parity and ignored (exact ≡ theta=0). Every O(N²) pass
is ROW-BLOCKED: peak device memory is the stored conditional-P matrix
(Npad² f32) plus O(rowBlock·Npad) temporaries; the symmetrized P is never
materialized (each block reads P rows + P columns and symmetrizes on the
fly). The start is ``1e-4·N(0, 1)`` from the port's threefry stream at
``PRNGKey(seed)``, the JAX package's draw to 1e-6.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.kmeans import _pairwise
from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.ops.random import normal, seed_key

__all__ = ["BarnesHutTsne", "Tsne"]


def _calibrated_p_rows(x, perplexity, n, block, iters=50):
    """UNsymmetrized conditional P (Npad, Npad), one row-block at a time:
    per block, a (block, Npad) distance GEMM + per-row bisection on the
    Gaussian precision so each row's conditional distribution has entropy
    log(perplexity). Rows/cols ≥ n (padding) are zero."""
    npad = x.shape[0]
    dev = x.device
    log_u = torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                   device=dev))
    cols = torch.arange(npad, device=dev)
    col_valid = cols < n
    out = torch.empty((npad, npad), dtype=torch.float32, device=dev)
    for r0 in range(0, npad, block):
        xb = x[r0:r0 + block]
        d2 = _pairwise(xb, x, "sqeuclidean")          # (block, Npad)
        rows = r0 + torch.arange(block, device=dev)
        dead = (cols[None, :] == rows[:, None]) | ~col_valid[None, :]

        def row_entropy(beta):
            logits = torch.where(dead, -torch.inf, -d2 * beta)
            p = torch.softmax(logits, dim=-1)
            h = -torch.sum(torch.where(p > 0, p * torch.log(p), 0.0), -1)
            return h, p

        beta = torch.ones((block, 1), dtype=torch.float32, device=dev)
        lo = torch.full((block, 1), -torch.inf, device=dev)
        hi = torch.full((block, 1), torch.inf, device=dev)
        for _ in range(iters):
            h, _ = row_entropy(beta)
            too_high = (h > log_u)[:, None]   # entropy too high -> raise
            lo = torch.where(too_high, beta, lo)
            hi = torch.where(too_high, hi, beta)
            beta = torch.where(torch.isinf(hi), beta * 2.0,
                               torch.where(torch.isinf(lo), beta / 2.0,
                                           (lo + hi) / 2.0))
        _, p = row_entropy(beta)
        out[r0:r0 + block] = torch.where((rows < n)[:, None], p, 0.0)
    return out


def _descend(p_cond, y0, n, block, max_iter, stop_lying, switch_momentum,
             lr, momentum, final_momentum, use_adagrad):
    """Blocked exact descent. Per iteration: pass 1 accumulates the
    student-t partition Z block-by-block; pass 2 emits gradient rows per
    block, symmetrizing P on the fly from the stored conditional matrix
    (P rows + P columns — the (Npad, Npad) symmetric P never exists)."""
    npad = y0.shape[0]
    dev = y0.device
    cols = torch.arange(npad, device=dev)
    valid = cols < n
    inv2n = 1.0 / (2.0 * float(np.float32(n)))

    def num_block(y, r0):
        yb = y[r0:r0 + block]
        d2 = _pairwise(yb, y, "sqeuclidean")          # (block, Npad)
        rows = r0 + torch.arange(block, device=dev)
        mask = ((cols[None, :] != rows[:, None])
                & valid[None, :] & (rows < n)[:, None])
        return torch.where(mask, 1.0 / (1.0 + d2), 0.0)  # student-t kernel

    y = y0
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    hist = torch.zeros_like(y0)
    for it in range(max_iter):
        z = torch.zeros((), dtype=torch.float32, device=dev)
        for r0 in range(0, npad, block):
            z = z + num_block(y, r0).sum()
        z = torch.clamp(z, min=1e-12)
        exag = 12.0 if it < stop_lying else 1.0
        grads = []
        for r0 in range(0, npad, block):
            num = num_block(y, r0)
            p_rows = p_cond[r0:r0 + block]
            p_cols = p_cond[:, r0:r0 + block]
            p = torch.clamp((p_rows + p_cols.T) * inv2n, min=1e-12)
            q = torch.clamp(num / z, min=1e-12)
            pq = (exag * p - q) * num                 # (block, Npad)
            yb = y[r0:r0 + block]
            grads.append(4.0 * (torch.sum(pq, -1, keepdim=True) * yb
                                - pq @ y))
        grad = torch.cat(grads)
        mom = momentum if it < switch_momentum else final_momentum
        if use_adagrad:
            hist = hist + grad * grad
            step = lr * grad / torch.sqrt(hist + 1e-8)
            vel = mom * vel - step
        else:
            # classic vdM adaptive gains
            same_sign = torch.sign(grad) == torch.sign(vel)
            gains = torch.clamp(
                torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
            vel = mom * vel - lr * gains * grad
        y = y + vel
        center = torch.sum(torch.where(valid[:, None], y, 0.0), 0,
                           keepdim=True) / n
        y = torch.where(valid[:, None], y - center, 0.0)
    return y


class BarnesHutTsne:
    """Builder-built (≡ BarnesHutTsne.Builder). ``theta`` accepted and
    ignored — gradients are exact (see module docstring)."""

    class Builder:
        def __init__(self):
            self._max_iter = 1000
            self._theta = 0.5
            self._normalize = True
            self._lr = 200.0
            self._use_adagrad = False
            self._perplexity = 30.0
            self._num_dim = 2
            self._stop_lying = 250
            self._switch_momentum = 250
            self._momentum = 0.5
            self._final_momentum = 0.8
            self._seed = 42
            self._row_block = 4096

        def setMaxIter(self, v):
            self._max_iter = int(v); return self

        def theta(self, v):
            self._theta = float(v); return self

        def normalize(self, v):
            self._normalize = bool(v); return self

        def learningRate(self, v):
            self._lr = float(v); return self

        def useAdaGrad(self, v):
            self._use_adagrad = bool(v); return self

        def perplexity(self, v):
            self._perplexity = float(v); return self

        def numDimension(self, v):
            self._num_dim = int(v); return self

        def stopLyingIteration(self, v):
            self._stop_lying = int(v); return self

        def setMomentum(self, v):
            self._momentum = float(v); return self

        def setFinalMomentum(self, v):
            self._final_momentum = float(v); return self

        def setSwitchMomentumIteration(self, v):
            self._switch_momentum = int(v); return self

        def seed(self, v):
            self._seed = int(v); return self

        def rowBlockSize(self, v):
            """Rows per O(N²)-pass block — caps peak temporaries at
            O(rowBlock · N) (no reference equivalent; a device memory
            knob)."""
            self._row_block = int(v); return self

        def build(self):
            return BarnesHutTsne(self)

    def __init__(self, b):
        self._b = b
        self._y = None

    def fit(self, x, device=None):
        x = np.asarray(x, np.float32)
        b = self._b
        if b._normalize:
            x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-12)
        n = x.shape[0]
        block = max(1, min(b._row_block, n))
        npad = -(-n // block) * block
        if npad != n:
            x = np.pad(x, ((0, npad - n), (0, 0)))
        dev = resolve(device)
        perp = min(b._perplexity, max((n - 1) / 3.0, 1.0))
        p_cond = _calibrated_p_rows(torch.as_tensor(x, device=dev),
                                    float(perp), n, block)
        y0 = 1e-4 * normal(seed_key(b._seed), (npad, b._num_dim), dev)
        y = _descend(p_cond, y0, n, block, b._max_iter, b._stop_lying,
                     b._switch_momentum, float(np.float32(b._lr)),
                     float(np.float32(b._momentum)),
                     float(np.float32(b._final_momentum)), b._use_adagrad)
        self._y = y[:n].cpu().numpy()
        return self

    def getData(self):
        return self._y

    def saveAsFile(self, labels, path):
        """≡ saveAsFile: one "y0 y1 ... label" line per point."""
        with open(path, "w") as f:
            for row, lab in zip(self._y, labels):
                f.write(" ".join(f"{v:.6f}" for v in row) + f" {lab}\n")


Tsne = BarnesHutTsne  # ≡ plot.Tsne — same surface, exact solver
