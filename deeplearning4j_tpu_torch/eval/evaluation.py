"""Evaluation classes: a copy of `deeplearning4j_tpu/eval/evaluation.py`,
which is numpy only (≡ nd4j-api :: org.nd4j.evaluation.classification.
Evaluation / EvaluationBinary / ROC, regression.RegressionEvaluation).

Accumulator-style: call eval(labels, predictions) per batch (numpy, on the
host: evaluation is not on the card's hot path), then read the metrics.
`MultiLayerNetwork.evaluate*` and `ComputationGraph.evaluate*` feed them
from their evaluation loop.
"""
from __future__ import annotations

import numpy as np


def _to2d(labels, preds, mask=None):
    labels, preds = np.asarray(labels), np.asarray(preds)
    if labels.ndim == 3:  # (B, T, C): fold time into batch, apply mask
        b, t, c = labels.shape
        labels = labels.reshape(b * t, c)
        preds = preds.reshape(b * t, -1)
        if mask is not None:
            m = np.asarray(mask).reshape(b * t).astype(bool)
            labels, preds = labels[m], preds[m]
    return labels, preds


class Evaluation:
    def __init__(self, num_classes=None, top_n=1):
        self.num_classes = num_classes
        self.top_n = top_n
        self._cm = None
        self._top_n_correct = 0
        self._count = 0

    # -- accumulate ------------------------------------------------------
    def eval(self, labels, predictions, mask=None):
        labels, predictions = _to2d(labels, predictions, mask)
        n_cls = labels.shape[-1]
        if self._cm is None:
            self.num_classes = self.num_classes or n_cls
            self._cm = np.zeros((self.num_classes, self.num_classes), np.int64)
        actual = labels.argmax(-1)
        pred = predictions.argmax(-1)
        np.add.at(self._cm, (actual, pred), 1)
        if self.top_n > 1:
            topn = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self._top_n_correct += int((topn == actual[:, None]).any(-1).sum())
        self._count += len(actual)

    # -- metrics ---------------------------------------------------------
    def accuracy(self):
        return float(np.trace(self._cm)) / max(1, self._cm.sum())

    def topNAccuracy(self):
        if self.top_n <= 1:
            return self.accuracy()
        return self._top_n_correct / max(1, self._count)

    def truePositives(self, cls):
        return int(self._cm[cls, cls])

    def falsePositives(self, cls):
        return int(self._cm[:, cls].sum() - self._cm[cls, cls])

    def falseNegatives(self, cls):
        return int(self._cm[cls, :].sum() - self._cm[cls, cls])

    def precision(self, cls=None):
        if cls is not None:
            denom = self._cm[:, cls].sum()
            return float(self._cm[cls, cls]) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)
                if self._cm[:, c].sum() or self._cm[c, :].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls=None):
        if cls is not None:
            denom = self._cm[cls, :].sum()
            return float(self._cm[cls, cls]) / denom if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)
                if self._cm[c, :].sum() or self._cm[:, c].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls=None):
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        vals = [self.f1(c) for c in range(self.num_classes)
                if self._cm[c, :].sum() or self._cm[:, c].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def confusionMatrix(self):
        return self._cm.copy()

    def getConfusionMatrix(self):
        return self._cm.copy()

    def trueNegatives(self, cls):
        return int(self._cm.sum() - self._cm[cls, :].sum()
                   - self._cm[:, cls].sum() + self._cm[cls, cls])

    def matthewsCorrelation(self, cls=None):
        """Per-class MCC from the binarised confusion counts; cls=None
        averages over classes with support (≡ Evaluation.matthewsCorrelation
        / averageMatthewsCorrelation)."""
        if cls is not None:
            tp, fp = self.truePositives(cls), self.falsePositives(cls)
            fn, tn = self.falseNegatives(cls), self.trueNegatives(cls)
            denom = np.sqrt(float(tp + fp) * (tp + fn)
                            * (tn + fp) * (tn + fn))
            return (tp * tn - fp * fn) / denom if denom else 0.0
        vals = [self.matthewsCorrelation(c) for c in range(self.num_classes)
                if self._cm[c, :].sum() or self._cm[:, c].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def gMeasure(self, cls=None):
        """√(precision·recall) (≡ Evaluation.gMeasure)."""
        if cls is not None:
            return float(np.sqrt(self.precision(cls) * self.recall(cls)))
        vals = [self.gMeasure(c) for c in range(self.num_classes)
                if self._cm[c, :].sum() or self._cm[:, c].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def falseAlarmRate(self, cls=None):
        """(FPR + FNR)/2 per reference definition."""
        if cls is None:
            vals = [self.falseAlarmRate(c) for c in range(self.num_classes)
                    if self._cm[c, :].sum() or self._cm[:, c].sum()]
            return float(np.mean(vals)) if vals else 0.0
        fp, tn = self.falsePositives(cls), self.trueNegatives(cls)
        fn, tp = self.falseNegatives(cls), self.truePositives(cls)
        fpr = fp / (fp + tn) if (fp + tn) else 0.0
        fnr = fn / (fn + tp) if (fn + tp) else 0.0
        return (fpr + fnr) / 2

    def stats(self, suppressWarnings=False, includeConfusion=True):
        """≡ Evaluation.stats(): headline metrics + the per-class
        precision/recall/F1/MCC table + confusion matrix."""
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes:    {self.num_classes}",
                 f" Accuracy:        {self.accuracy():.4f}",
                 f" Precision:       {self.precision():.4f}",
                 f" Recall:          {self.recall():.4f}",
                 f" F1 Score:        {self.f1():.4f}",
                 f" MCC:             {self.matthewsCorrelation():.4f}",
                 f" G-Measure:       {self.gMeasure():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.topNAccuracy():.4f}")
        lines.append("")
        lines.append(f" {'Class':>6} {'TP':>6} {'FP':>6} {'FN':>6} "
                     f"{'Precision':>10} {'Recall':>8} {'F1':>8} {'MCC':>8}")
        for c in range(self.num_classes):
            if not (self._cm[c, :].sum() or self._cm[:, c].sum()):
                continue
            lines.append(
                f" {c:>6d} {self.truePositives(c):>6d} "
                f"{self.falsePositives(c):>6d} {self.falseNegatives(c):>6d} "
                f"{self.precision(c):>10.4f} {self.recall(c):>8.4f} "
                f"{self.f1(c):>8.4f} {self.matthewsCorrelation(c):>8.4f}")
        if includeConfusion:
            lines.append("=========================Confusion Matrix=========================")
            lines.append(str(self._cm))
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output independent binary evaluation (sigmoid multi-label)."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold
        self._tp = self._fp = self._tn = self._fn = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _to2d(labels, predictions, mask)
        pred = (predictions >= self.threshold).astype(np.int64)
        lab = (labels >= 0.5).astype(np.int64)
        tp = ((pred == 1) & (lab == 1)).sum(0)
        fp = ((pred == 1) & (lab == 0)).sum(0)
        tn = ((pred == 0) & (lab == 0)).sum(0)
        fn = ((pred == 0) & (lab == 1)).sum(0)
        if self._tp is None:
            self._tp, self._fp, self._tn, self._fn = tp, fp, tn, fn
        else:
            self._tp += tp; self._fp += fp; self._tn += tn; self._fn += fn

    def accuracy(self, out=None):
        tp, fp, tn, fn = self._tp, self._fp, self._tn, self._fn
        acc = (tp + tn) / np.maximum(1, tp + fp + tn + fn)
        return float(acc.mean() if out is None else acc[out])

    def precision(self, out=None):
        p = self._tp / np.maximum(1, self._tp + self._fp)
        return float(p.mean() if out is None else p[out])

    def recall(self, out=None):
        r = self._tp / np.maximum(1, self._tp + self._fn)
        return float(r.mean() if out is None else r[out])

    def f1(self, out=None):
        p, r = self.precision(out), self.recall(out)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self):
        return (f"EvaluationBinary(acc={self.accuracy():.4f}, "
                f"precision={self.precision():.4f}, recall={self.recall():.4f}, "
                f"f1={self.f1():.4f})")


class ROC:
    """Binary ROC/AUC. threshold_steps=0 → exact (all unique scores)."""

    def __init__(self, threshold_steps=0):
        self.threshold_steps = threshold_steps
        self._scores = []
        self._labels = []

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _to2d(labels, predictions, mask)
        if labels.shape[-1] == 2:  # [P(neg), P(pos)] convention
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        self._scores.append(np.asarray(predictions).ravel())
        self._labels.append(np.asarray(labels).ravel())

    def _roc_points(self):
        scores = np.concatenate(self._scores)
        labels = np.concatenate(self._labels) >= 0.5
        order = np.argsort(-scores)
        scores, labels = scores[order], labels[order]
        tps = np.cumsum(labels)
        fps = np.cumsum(~labels)
        # tie handling: one ROC point per DISTINCT threshold (all tied
        # scores flip together), else constant scores would fake AUC=1
        distinct = np.where(np.diff(scores))[0]
        idx = np.r_[distinct, len(scores) - 1]
        P, N = max(1, labels.sum()), max(1, (~labels).sum())
        tpr = np.concatenate([[0.0], tps[idx] / P])
        fpr = np.concatenate([[0.0], fps[idx] / N])
        return fpr, tpr

    def calculateAUC(self):
        fpr, tpr = self._roc_points()
        return float(np.trapezoid(tpr, fpr))

    def getRocCurve(self):
        return self._roc_points()


class ROCMultiClass:
    def __init__(self, threshold_steps=0):
        self._rocs = {}

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _to2d(labels, predictions, mask)
        for c in range(labels.shape[-1]):
            roc = self._rocs.setdefault(c, ROC())
            roc._scores.append(predictions[:, c])
            roc._labels.append(labels[:, c])

    def calculateAUC(self, cls):
        return self._rocs[cls].calculateAUC()

    def calculateAverageAUC(self):
        return float(np.mean([r.calculateAUC() for r in self._rocs.values()]))


class ROCBinary:
    """≡ evaluation.classification.ROCBinary — an independent binary ROC
    per output column (multi-label sigmoid heads), unlike ROCMultiClass's
    one-vs-rest over a softmax. Supports a per-output (N, C) mask."""

    def __init__(self, threshold_steps=0):
        self._rocs = {}

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                mask = np.asarray(mask)
                mask = (mask.reshape(b * t, c) if mask.ndim == 3
                        else mask.reshape(b * t))
        m = None if mask is None else np.asarray(mask)
        if m is not None and m.ndim == 2 and m.shape[1] == 1:
            m = m[:, 0]          # (N, 1) = per-example column convention
        if m is not None and m.ndim == 2 and m.shape[1] != labels.shape[-1]:
            raise ValueError(
                f"mask has {m.shape[1]} columns but labels have "
                f"{labels.shape[-1]} outputs; pass (N,), (N, 1) for "
                f"per-example or (N, C) for per-output masking")
        for c in range(labels.shape[-1]):
            if m is None:
                sel = slice(None)
            elif m.ndim == 1:
                sel = m.astype(bool)
            else:  # per-output mask
                sel = m[:, c].astype(bool)
            roc = self._rocs.setdefault(c, ROC())
            roc._scores.append(predictions[sel, c])
            roc._labels.append(labels[sel, c])

    def numLabels(self):
        return len(self._rocs)

    def calculateAUC(self, outputNum):
        return self._rocs[outputNum].calculateAUC()

    def calculateAverageAUC(self):
        return float(np.mean([r.calculateAUC() for r in self._rocs.values()]))

    def stats(self):
        aucs = ", ".join(f"{c}: {r.calculateAUC():.4f}"
                         for c, r in sorted(self._rocs.items()))
        return f"ROCBinary(avgAUC={self.calculateAverageAUC():.4f}; {aucs})"


class EvaluationCalibration:
    """≡ evaluation.calibration.EvaluationCalibration — reliability
    diagrams + prediction-probability histograms per class."""

    def __init__(self, reliabilityDiagNumBins=10, histogramNumBins=10):
        self.n_bins = int(reliabilityDiagNumBins)
        self.hist_bins = int(histogramNumBins)
        self._labels = []
        self._preds = []

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _to2d(labels, predictions, mask)
        self._labels.append(np.asarray(labels))
        self._preds.append(np.asarray(predictions))

    def _cls(self, classIdx):
        labels = np.concatenate(self._labels)[:, classIdx]
        preds = np.concatenate(self._preds)[:, classIdx]
        return labels >= 0.5, preds

    def getReliabilityDiagram(self, classIdx):
        """(mean predicted prob per bin, observed fraction positive per
        bin, counts per bin) over equal-width probability bins — points on
        the diagonal = perfectly calibrated."""
        y, p = self._cls(classIdx)
        bins = np.clip((p * self.n_bins).astype(int), 0, self.n_bins - 1)
        mean_pred = np.zeros(self.n_bins)
        frac_pos = np.zeros(self.n_bins)
        counts = np.zeros(self.n_bins, dtype=np.int64)
        for b in range(self.n_bins):
            sel = bins == b
            counts[b] = sel.sum()
            if counts[b]:
                mean_pred[b] = p[sel].mean()
                frac_pos[b] = y[sel].mean()
        return mean_pred, frac_pos, counts

    def getProbabilityHistogram(self, classIdx):
        """Histogram of predicted probabilities for the class."""
        _, p = self._cls(classIdx)
        counts, edges = np.histogram(p, bins=self.hist_bins,
                                     range=(0.0, 1.0))
        return counts, edges

    def expectedCalibrationError(self, classIdx):
        mean_pred, frac_pos, counts = self.getReliabilityDiagram(classIdx)
        total = max(1, counts.sum())
        return float(np.sum(counts / total * np.abs(mean_pred - frac_pos)))


class RegressionEvaluation:
    def __init__(self, n_columns=None):
        self._sse = None
        self._sae = None
        self._n = 0
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None

    def eval(self, labels, predictions, mask=None):
        labels, predictions = _to2d(labels, predictions, mask)
        err = predictions - labels
        if self._sse is None:
            ncol = labels.shape[-1]
            z = lambda: np.zeros(ncol)
            self._sse, self._sae = z(), z()
            self._sum_label, self._sum_label_sq = z(), z()
            self._sum_pred, self._sum_pred_sq = z(), z()
            self._sum_label_pred = z()
        self._sse += (err ** 2).sum(0)
        self._sae += np.abs(err).sum(0)
        self._sum_label += labels.sum(0)
        self._sum_label_sq += (labels ** 2).sum(0)
        self._sum_pred += predictions.sum(0)
        self._sum_pred_sq += (predictions ** 2).sum(0)
        self._sum_label_pred += (labels * predictions).sum(0)
        self._n += labels.shape[0]

    def meanSquaredError(self, col=None):
        mse = self._sse / max(1, self._n)
        return float(mse.mean() if col is None else mse[col])

    def meanAbsoluteError(self, col=None):
        mae = self._sae / max(1, self._n)
        return float(mae.mean() if col is None else mae[col])

    def rootMeanSquaredError(self, col=None):
        return float(np.sqrt(self.meanSquaredError(col)))

    def rSquared(self, col=None):
        n = max(1, self._n)
        ss_tot = self._sum_label_sq - self._sum_label ** 2 / n
        r2 = 1.0 - self._sse / np.maximum(ss_tot, 1e-12)
        return float(r2.mean() if col is None else r2[col])

    def pearsonCorrelation(self, col=None):
        n = max(1, self._n)
        cov = self._sum_label_pred - self._sum_label * self._sum_pred / n
        vl = self._sum_label_sq - self._sum_label ** 2 / n
        vp = self._sum_pred_sq - self._sum_pred ** 2 / n
        pc = cov / np.maximum(np.sqrt(vl * vp), 1e-12)
        return float(pc.mean() if col is None else pc[col])

    def stats(self):
        return (f"RegressionEvaluation(MSE={self.meanSquaredError():.6f}, "
                f"MAE={self.meanAbsoluteError():.6f}, "
                f"RMSE={self.rootMeanSquaredError():.6f}, "
                f"R2={self.rSquared():.6f})")
