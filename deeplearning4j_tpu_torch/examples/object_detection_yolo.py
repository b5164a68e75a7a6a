"""Object detection end to end (≡ dl4j-examples :: TinyYoloHouseNumber
style): the twin of `examples/object_detection_yolo.py` on the port —
train a YOLOv2 head on a synthetic scene, then extract final detections
with confidence threshold + per-class NMS (`getPredictedObjects`). The
script's check (the first detection is class 1) stays.

Run: `python -m deeplearning4j_tpu_torch.examples.object_detection_yolo`
(the card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.nn import (Adam, InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer

GRID, N_CLS = 8, 3
ANCHORS = [[1.0, 1.0], [3.0, 3.0]]


def scene():
    """One image: a bright square; gt box centered on it, class 1."""
    x = np.zeros((1, GRID, GRID, 3), np.float32)
    x[0, 2:5, 3:6, :] = 1.0
    lab = np.zeros((1, GRID, GRID, 4 + N_CLS), np.float32)
    lab[0, 3, 4, :4] = [4.5, 3.5, 2.0, 2.0]    # (x, y, w, h) grid units
    lab[0, 3, 4, 4 + 1] = 1.0
    return x, lab


def main(device=None):
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(0).updater(Adam(5e-3))
        .weightInit("relu").list()
        .layer(ConvolutionLayer(kernelSize=(3, 3), nOut=32,
                                convolutionMode="same", activation="relu"))
        .layer(ConvolutionLayer(kernelSize=(1, 1),
                                nOut=len(ANCHORS) * (5 + N_CLS),
                                convolutionMode="same",
                                activation="identity"))
        .layer(Yolo2OutputLayer(boundingBoxes=ANCHORS))
        .setInputType(InputType.convolutional(GRID, GRID, 3))
        .build()).init(device)
    x, lab = scene()
    losses = []
    for i in range(150):
        net.fit(x, lab)
        if i % 50 == 49:
            losses.append(float(net.score()))
            print(f"iter {i + 1}: loss {losses[-1]:.4f}")
    dets = net.getPredictedObjects(x, confThreshold=0.3, nmsThreshold=0.4)
    print(f"{len(dets[0])} detection(s):")
    for d in dets[0]:
        tl, br = d.getTopLeftXY(), d.getBottomRightXY()
        print(f"  class={d.getPredictedClass()} conf={d.confidence:.2f} "
              f"box=({tl[0]:.1f},{tl[1]:.1f})-({br[0]:.1f},{br[1]:.1f})")
    if not (dets[0] and dets[0][0].getPredictedClass() == 1):
        raise AssertionError(f"YOLO: detections {dets[0]}")
    return {"losses": losses, "detections": len(dets[0]),
            "first_class": dets[0][0].getPredictedClass(),
            "first_confidence": float(dets[0][0].confidence)}


if __name__ == "__main__":
    main()
