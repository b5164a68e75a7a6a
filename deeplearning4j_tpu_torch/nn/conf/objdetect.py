"""Object detection head: the port of
`deeplearning4j_tpu/nn/conf/objdetect.py` (≡ deeplearning4j-nn ::
conf.layers.objdetect.Yolo2OutputLayer + util.YoloUtils).

The YOLOv2 loss as tensor code over the whole batch: predictions
(B, H, W, A·(5+C)) reshape to (B, H, W, A, 5+C) = (tx, ty, tw, th, to,
class logits). The box decode is sigmoid(tx, ty) plus the cell and the
anchor scaled by exp(tw, th); the anchor responsible for a ground-truth
box is the best shape-prior IoU (argmax over A). Loss = λcoord·the
coordinate MSE of the responsible anchors (sqrt of w and h) + the
confidence MSE toward the live decoded IoU (a target under `detach`) +
λnoobj·conf² elsewhere + the class cross-entropy of the responsible
anchors, each term divided as the JAX package divides it.

Labels are NHWC: (B, H, W, 4+C) — (x, y, w, h) in GRID units (center
x ∈ [0, W), y ∈ [0, H), w and h in cells), then a one-hot class vector;
an all-zero class vector means no object in that cell.

`getPredictedObjects` decodes on the tensor's device and forms there the
IoU of every pair of boxes of an example and the suppress matrix (IoU
above the threshold and the same class). Those, the confidences and the
decoded boxes cross to the host once, where the greedy sweep runs in
numpy over the candidates in a stable descending order of confidence: a
taken box suppresses every same-class overlap, as the JAX package's
`_nms_keep` does, so the keep set is the same.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import ConvolutionalType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer


class DetectedObject:
    """One final detection (≡ deeplearning4j :: nn.layers.objdetect.
    DetectedObject): center and size in GRID units and the class
    distribution. `exampleNumber` is the row in the minibatch."""

    __slots__ = ("exampleNumber", "centerX", "centerY", "width", "height",
                 "confidence", "classPredictions")

    def __init__(self, exampleNumber, centerX, centerY, width, height,
                 confidence, classPredictions):
        self.exampleNumber = int(exampleNumber)
        self.centerX = float(centerX)
        self.centerY = float(centerY)
        self.width = float(width)
        self.height = float(height)
        self.confidence = float(confidence)
        self.classPredictions = np.asarray(classPredictions, np.float32)

    def getPredictedClass(self):
        return int(np.argmax(self.classPredictions))

    def getCenterXY(self):
        return (self.centerX, self.centerY)

    def getTopLeftXY(self):
        return (self.centerX - self.width / 2, self.centerY - self.height / 2)

    def getBottomRightXY(self):
        return (self.centerX + self.width / 2,
                self.centerY + self.height / 2)

    def getConfidence(self):
        return self.confidence

    def __repr__(self):
        return (f"DetectedObject(example={self.exampleNumber}, "
                f"xy=({self.centerX:.2f},{self.centerY:.2f}), "
                f"wh=({self.width:.2f},{self.height:.2f}), "
                f"conf={self.confidence:.3f}, "
                f"cls={self.getPredictedClass()})")


def _greedy_keep(suppress, conf, conf_threshold):
    """The keep mask (N,) of one example's greedy per-class NMS: the
    candidates at or above the threshold, in a stable descending order of
    confidence; a taken box suppresses every box of its row of `suppress`
    (N, N). A box under the threshold is never taken, so it suppresses
    nothing and the sweep skips it."""
    order = np.argsort(-conf, kind="stable")
    keep = np.zeros(conf.shape, bool)
    alive = np.ones(conf.shape, bool)
    for idx in order[conf[order] >= conf_threshold]:
        if alive[idx]:
            keep[idx] = True
            alive &= ~suppress[idx]
    return keep


class YoloUtils:
    """≡ deeplearning4j :: nn.layers.objdetect.YoloUtils — the final
    detections: a confidence threshold and per-class greedy NMS."""

    @staticmethod
    def getPredictedObjects(boundingBoxPriors, networkOutput,
                            confThreshold=0.5, nmsThreshold=0.4):
        """The raw head output (B, H, W, A*(5+C)) decoded to a list of
        `DetectedObject` per example."""
        layer = Yolo2OutputLayer(
            boundingBoxes=[list(map(float, b)) for b in
                           np.asarray(boundingBoxPriors, np.float32)])
        return layer.getPredictedObjects(networkOutput, confThreshold,
                                         nmsThreshold)

    @staticmethod
    def nms(objects, iouThreshold=0.4):
        """Greedy per-class NMS over a DetectedObject list, on the host."""
        kept = []
        for o in sorted(objects, key=lambda d: -d.confidence):
            c = o.getPredictedClass()
            if all(k.exampleNumber != o.exampleNumber
                   or k.getPredictedClass() != c
                   or _iou_np(k, o) <= iouThreshold for k in kept):
                kept.append(o)
        return kept


def _iou_np(a, b):
    ax1, ay1 = a.getTopLeftXY()
    ax2, ay2 = a.getBottomRightXY()
    bx1, by1 = b.getTopLeftXY()
    bx2, by2 = b.getBottomRightXY()
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    ua = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / max(ua, 1e-9)


class Yolo2OutputLayer(Layer):
    """A loss-only head (no parameters; it follows the 1×1 conv that makes
    A·(5+C) channels)."""

    def __init__(self, boundingBoxes=None, lambdaCoord=5.0, lambdaNoObj=0.5,
                 **kw):
        kw.setdefault("activation", "identity")
        super().__init__(**kw)
        # anchors (A, 2) in grid units (≡ boundingBoxPriors)
        self.boundingBoxes = [list(map(float, b)) for b in (
            boundingBoxes or [[1.0, 1.0], [2.0, 2.0], [3.3, 3.3]])]
        self.lambdaCoord = float(lambdaCoord)
        self.lambdaNoObj = float(lambdaNoObj)
        self._anchor_tensors = {}   # (device, dtype) -> (A, 2)

    @property
    def numBoxes(self):
        return len(self.boundingBoxes)

    def output_type(self, input_type):
        return input_type

    def initialize(self, generator, input_type):
        if isinstance(input_type, ConvolutionalType):
            a = self.numBoxes
            if input_type.channels % a:
                raise ValueError(
                    f"Yolo2OutputLayer: input channels {input_type.channels}"
                    f" not divisible by {a} anchors")
            if input_type.channels // a < 5:
                raise ValueError("Yolo2OutputLayer: need A*(5+C) channels")
        return {}, {}, input_type

    def pre_activation(self, params, x):
        return x

    def apply(self, params, state, x, train=False, generator=None,
              mask=None):
        return x, state

    # -- decode (≡ YoloUtils.getPredictedObjects, batched) ---------------
    def _anchors(self, like):
        """The priors (A, 2) on `like`'s device and dtype, made once for
        each: a copy from the host cannot run inside a CUDA graph capture,
        and the warm-up run before a capture makes them."""
        key = (like.device, like.dtype)
        if key not in self._anchor_tensors:
            self._anchor_tensors[key] = torch.tensor(
                self.boundingBoxes, dtype=like.dtype, device=like.device)
        return self._anchor_tensors[key]

    def decode(self, preact):
        """(B, H, W, A*(5+C)) → {"xy", "wh" (B, H, W, A, 2), "confidence"
        (B, H, W, A), "classes" (B, H, W, A, C)} in grid units."""
        b, h, w, _ = preact.shape
        a = self.numBoxes
        p = preact.reshape(b, h, w, a, -1)
        anchors = self._anchors(preact)
        cx = torch.arange(w, dtype=preact.dtype,
                          device=preact.device)[None, None, :, None]
        cy = torch.arange(h, dtype=preact.dtype,
                          device=preact.device)[None, :, None, None]
        x = torch.sigmoid(p[..., 0]) + cx
        y = torch.sigmoid(p[..., 1]) + cy
        bw = anchors[:, 0] * torch.exp(p[..., 2].clamp(-8, 8))
        bh = anchors[:, 1] * torch.exp(p[..., 3].clamp(-8, 8))
        conf = torch.sigmoid(p[..., 4])
        cls = torch.softmax(p[..., 5:], dim=-1)
        return {"xy": torch.stack([x, y], -1), "wh": torch.stack([bw, bh], -1),
                "confidence": conf, "classes": cls}

    def getPredictedObjects(self, networkOutput, confThreshold=0.5,
                            nmsThreshold=0.4):
        """≡ YoloUtils.getPredictedObjects: decode → confidence threshold
        → per-class greedy NMS → List[List[DetectedObject]] (an inner list
        per example, by descending confidence). The decode and the IoU and
        suppress matrices are computed on the output's device; they cross
        to the host once, for the sweep and the objects."""
        pre = torch.as_tensor(networkOutput).float()
        b, h, w, _ = pre.shape
        n = h * w * self.numBoxes
        with torch.no_grad():
            dec = self.decode(pre)
            xy = dec["xy"].reshape(b, n, 2)
            wh = dec["wh"].reshape(b, n, 2)
            conf = dec["confidence"].reshape(b, n)
            cls = dec["classes"].reshape(b, n, -1)
            cls_id = cls.argmax(-1)
            iou = self._iou_xywh(xy[:, :, None, :], wh[:, :, None, :],
                                 xy[:, None, :, :], wh[:, None, :, :])
            suppress = (iou > nmsThreshold) & (cls_id[:, :, None]
                                               == cls_id[:, None, :])
            suppress, xy, wh, conf, cls = (
                t.cpu().numpy() for t in (suppress, xy, wh, conf, cls))
        thr = np.float32(confThreshold)
        out = []
        for i in range(b):
            idx = np.nonzero(_greedy_keep(suppress[i], conf[i], thr))[0]
            idx = idx[np.argsort(-conf[i][idx])]
            out.append([DetectedObject(i, xy[i, j, 0], xy[i, j, 1],
                                       wh[i, j, 0], wh[i, j, 1],
                                       conf[i, j], cls[i, j])
                        for j in idx])
        return out

    @staticmethod
    def _iou_xywh(xy1, wh1, xy2, wh2):
        """IoU of center-format boxes; broadcasts over leading dims."""
        lo1, hi1 = xy1 - wh1 / 2, xy1 + wh1 / 2
        lo2, hi2 = xy2 - wh2 / 2, xy2 + wh2 / 2
        inter = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp_min(
            0.0)
        ia = inter[..., 0] * inter[..., 1]
        a1 = (wh1[..., 0] * wh1[..., 1]).clamp_min(1e-9)
        a2 = (wh2[..., 0] * wh2[..., 1]).clamp_min(1e-9)
        return ia / (a1 + a2 - ia + 1e-9)

    def compute_loss(self, labels, preact, mask=None):
        b, h, w, _ = preact.shape
        a = self.numBoxes
        p = preact.float().reshape(b, h, w, a, -1)
        anchors = self._anchors(p)                        # (A, 2)
        labels = labels.float()
        gt_xy = labels[..., 0:2]                      # (B,H,W,2) grid units
        gt_wh = labels[..., 2:4]
        gt_cls = labels[..., 4:]
        obj = (gt_cls.sum(-1) > 0).float()            # (B,H,W)

        # responsible anchor: the best shape-prior IoU (w, h only, aligned
        # at the origin)
        inter = (torch.minimum(gt_wh[..., None, 0], anchors[:, 0])
                 * torch.minimum(gt_wh[..., None, 1], anchors[:, 1]))
        union = (gt_wh[..., 0:1] * gt_wh[..., 1:2]
                 + anchors[:, 0] * anchors[:, 1] - inter)
        prior_iou = inter / union.clamp_min(1e-9)      # (B,H,W,A)
        resp = F.one_hot(prior_iou.argmax(-1), a).float() \
            * obj[..., None]                           # (B,H,W,A)

        # the decode inference uses, so the training target is the
        # deployed box decode
        dec = self.decode(p.reshape(b, h, w, -1))
        pred_xy, pred_wh, pred_conf = (dec["xy"], dec["wh"],
                                       dec["confidence"])

        n_obj = obj.sum().clamp_min(1.0)
        d_xy = ((pred_xy - gt_xy[..., None, :]) ** 2).sum(-1)
        d_wh = ((torch.sqrt(pred_wh.clamp_min(1e-9))
                 - torch.sqrt(gt_wh[..., None, :].clamp_min(1e-9))) ** 2
                ).sum(-1)
        coord = self.lambdaCoord * (resp * (d_xy + d_wh)).sum() / n_obj

        # confidence: the target is the live decoded IoU of the
        # responsible anchors
        live_iou = self._iou_xywh(pred_xy, pred_wh, gt_xy[..., None, :],
                                  gt_wh[..., None, :]).detach()
        conf_obj = (resp * (pred_conf - live_iou) ** 2).sum() / n_obj
        conf_noobj = self.lambdaNoObj * (
            (1.0 - resp) * pred_conf ** 2).sum() / (b * h * w * a)

        # the class loss at object cells: softmax cross-entropy over the
        # responsible anchor's class logits
        logp = torch.log_softmax(p[..., 5:], dim=-1)
        ce = -(gt_cls[..., None, :] * logp).sum(-1)       # (B,H,W,A)
        cls_loss = (resp * ce).sum() / n_obj

        return coord + conf_obj + conf_noobj + cls_loss
