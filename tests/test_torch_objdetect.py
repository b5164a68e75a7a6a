"""The port's YOLOv2 head (nn/conf/objdetect.py) against the JAX package on
the CPU: the loss and its gradient, the decode, and the detections of
`getPredictedObjects` (the same keep set in the same order, ties in
confidence included) on the same raw outputs, through the layer,
`YoloUtils` and both network classes; the greedy sweep against a numpy
oracle (the one of tests/test_objdetect.py). Tolerances: loss, gradient
and decode 1e-5 relative to max(1, max |JAX|); a detection's box and
confidence 1e-5; the kept boxes and their order exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.nn.conf.objdetect import (Yolo2OutputLayer as JYolo,
                                                  YoloUtils as JYoloUtils)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.nn.conf.objdetect import (DetectedObject,
                                                        Yolo2OutputLayer,
                                                        YoloUtils, _iou_np)

from test_torch_multilayer import _close, _np_tree
from test_torch_zoo_graph import yolo_labels

TOL = 1e-5
COCO = [[0.57273, 0.677385], [1.87446, 2.06253], [3.33843, 5.47434],
        [7.88282, 3.52778], [9.77052, 9.16828]]


def _pre(b, h, w, a, c, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(
        (b, h, w, a * (5 + c))) * scale).astype(np.float32)


@pytest.mark.parametrize("b,h,w,c,scale", [(4, 2, 2, 4, 1.0),
                                           (3, 5, 5, 3, 3.0),
                                           (2, 13, 13, 80, 1.0)])
def test_yolo_loss_and_gradient_match_the_jax_package(b, h, w, c, scale):
    """The loss on the same raw output and labels, and its gradient to the
    raw output (the live-IoU target detached in both)."""
    pre = _pre(b, h, w, 5, c, seed=1, scale=scale)
    lab = yolo_labels(b, h, w, c, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JYolo(boundingBoxes=COCO).compute_loss(jnp.asarray(lab),
                                                         p)))(
        jnp.asarray(pre))
    tp = torch.tensor(pre, requires_grad=True)
    tl = Yolo2OutputLayer(boundingBoxes=COCO).compute_loss(torch.tensor(lab),
                                                           tp)
    tl.backward()
    _close(tl, float(jl), TOL, "loss")
    _close(tp.grad, np.asarray(jg), TOL, "gradient")


def test_yolo_loss_with_no_object_is_the_no_object_term():
    pre = _pre(2, 3, 3, 2, 2, seed=4)
    layer = Yolo2OutputLayer(boundingBoxes=[[1, 1], [2, 2]], lambdaNoObj=0.7)
    got = layer.compute_loss(torch.zeros(2, 3, 3, 6), torch.tensor(pre))
    conf = torch.sigmoid(torch.tensor(pre).reshape(2, 3, 3, 2, 7)[..., 4])
    _close(got, float(0.7 * (conf ** 2).mean()), 1e-6, "no-object loss")


def test_decode_matches_the_jax_package():
    pre = _pre(2, 4, 5, 3, 4, seed=2, scale=4.0)   # past exp's clip too
    boxes = [[1, 1], [2, 3], [3.3, 1.5]]
    jd = JYolo(boundingBoxes=boxes).decode(jnp.asarray(pre))
    td = Yolo2OutputLayer(boundingBoxes=boxes).decode(torch.tensor(pre))
    assert set(td) == set(jd) == {"xy", "wh", "confidence", "classes"}
    for k in jd:
        _close(td[k], np.asarray(jd[k]), TOL, k)
    xy = td["xy"].numpy()
    assert (xy[..., 0] >= 0).all() and (xy[..., 0] <= 5).all()
    assert (xy[..., 1] >= 0).all() and (xy[..., 1] <= 4).all()


def test_channel_validation():
    with pytest.raises(ValueError, match="anchors"):
        tnn.MultiLayerNetwork(
            tnn.NeuralNetConfiguration.Builder().list()
            .layer(tnn.ConvolutionLayer(kernelSize=(1, 1), nOut=17,
                                        convolutionMode="same"))
            .layer(Yolo2OutputLayer(boundingBoxes=[[1, 1], [2, 2]]))
            .setInputType(tnn.InputType.convolutional(4, 4, 3))
            .build()).init("cpu")


def _same_detections(got, want):
    """Two List[List[DetectedObject]]: the same boxes, kept in the same
    order, each box and confidence within TOL."""
    assert len(got) == len(want)
    for g_ex, w_ex in zip(got, want):
        assert len(g_ex) == len(w_ex), ([repr(d) for d in g_ex],
                                        [repr(d) for d in w_ex])
        for g, w in zip(g_ex, w_ex):
            assert g.exampleNumber == w.exampleNumber
            assert g.getPredictedClass() == w.getPredictedClass()
            for a, b in ((g.centerX, w.centerX), (g.centerY, w.centerY),
                         (g.width, w.width), (g.height, w.height),
                         (g.confidence, w.confidence)):
                assert abs(a - b) <= TOL * max(1.0, abs(b)), (g, w)
            np.testing.assert_allclose(g.classPredictions,
                                       w.classPredictions, atol=TOL)


def _plant(p, i, ci, cj, a, conf_logit, cls_idx, n_cls, tw=0.0, th=0.0):
    row = [0.0, 0.0, tw, th, conf_logit] + [0.0] * n_cls
    row[5 + cls_idx] = 5.0
    p[i, ci, cj, a, :] = row


def _planted_scene(ties):
    """tests/test_objdetect.py's scene (a same-class duplicate, an
    overlapping box of another class, one under the threshold, a second
    example); with `ties`, every planted box has the same confidence."""
    b, h, w, a, c = 2, 4, 4, 2, 3
    p = np.full((b, h, w, a, 5 + c), -10.0, np.float32)
    hi, lo = (6.0, 6.0) if ties else (6.0, 4.0)
    _plant(p, 0, 1, 1, 0, hi, 0, c)
    _plant(p, 0, 1, 1, 1, lo, 0, c, tw=float(np.log(0.5)),
           th=float(np.log(0.5)))
    _plant(p, 0, 2, 2, 0, hi, 1, c)
    _plant(p, 0, 3, 3, 0, -2.0, 2, c)
    _plant(p, 1, 0, 0, 0, hi, 2, c)
    if ties:   # a row of equal, overlapping same-class boxes
        for j in range(4):
            _plant(p, 1, 3, j, 1, hi, 1, c, tw=0.3, th=0.3)
    return p.reshape(b, h, w, -1)


TWO = [[1, 1], [2, 2]]
#: scene -> (raw output, anchors)
SCENES = {
    "planted": lambda: (_planted_scene(False), TWO),
    "planted, tied confidences": lambda: (_planted_scene(True), TWO),
    "random 6x6x2": lambda: (_pre(1, 6, 6, 2, 4, seed=7, scale=2.0), TWO),
    "random 13x13x5, 80 classes": lambda: (_pre(3, 13, 13, 5, 80, seed=8),
                                           COCO),
    "all equal": lambda: (np.zeros((2, 3, 3, 2 * 7), np.float32), TWO),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("thresholds", [(0.5, 0.4), (0.3, 0.5), (0.0, 0.3)])
def test_predicted_objects_match_the_jax_package(scene, thresholds):
    pre, boxes = SCENES[scene]()
    want = JYolo(boundingBoxes=boxes).getPredictedObjects(pre, *thresholds)
    got = Yolo2OutputLayer(boundingBoxes=boxes).getPredictedObjects(
        torch.tensor(pre), *thresholds)
    _same_detections(got, want)
    _same_detections(YoloUtils.getPredictedObjects(boxes, pre, *thresholds),
                     JYoloUtils.getPredictedObjects(boxes, pre,
                                                    *thresholds))


def test_planted_scene_keeps_one_box_per_object():
    """The reference test's expectations: the duplicate goes, the other
    class stays, the dim box vanishes, examples do not mix."""
    dets = Yolo2OutputLayer(boundingBoxes=[[1, 1], [2, 2]]) \
        .getPredictedObjects(_planted_scene(False), 0.5, 0.4)
    assert [len(d) for d in dets] == [2, 1]
    assert {d.getPredictedClass() for d in dets[0]} == {0, 1}
    d0 = dets[0][0]
    assert abs(d0.centerX - 1.5) < 1e-4 and abs(d0.centerY - 1.5) < 1e-4
    assert abs(d0.width - 1.0) < 1e-4 and d0.confidence > 0.99
    assert d0.getTopLeftXY() == pytest.approx((1.0, 1.0), abs=1e-4)
    assert d0.getBottomRightXY() == pytest.approx((2.0, 2.0), abs=1e-4)
    assert dets[1][0].exampleNumber == 1
    assert dets[1][0].getPredictedClass() == 2


@pytest.mark.parametrize("seed", [7, 11])
def test_greedy_sweep_matches_a_host_nms_oracle(seed):
    """The keep set equals the host greedy NMS (YoloUtils.nms, IoU of
    _iou_np) over the candidates at or above the threshold."""
    rng = np.random.default_rng(seed)
    layer = Yolo2OutputLayer(boundingBoxes=[[1, 1], [3, 3]])
    pre = rng.normal(0, 2, size=(1, 6, 6, 2 * 9)).astype(np.float32)
    dets = layer.getPredictedObjects(pre, 0.3, 0.5)[0]
    dec = layer.decode(torch.tensor(pre))
    xy = dec["xy"].reshape(-1, 2).numpy()
    wh = dec["wh"].reshape(-1, 2).numpy()
    conf = dec["confidence"].reshape(-1).numpy()
    cls = dec["classes"].reshape(-1, 4).numpy()
    cand = [DetectedObject(0, xy[i, 0], xy[i, 1], wh[i, 0], wh[i, 1],
                           conf[i], cls[i])
            for i in np.nonzero(conf >= 0.3)[0]]
    expect = YoloUtils.nms(cand, 0.5)
    key = lambda d: (round(d.centerX, 4), round(d.centerY, 4),  # noqa
                     round(d.confidence, 4))
    assert {key(d) for d in dets} == {key(d) for d in expect}
    assert len(dets) == len(expect) > 1
    assert 0.0 <= _iou_np(dets[0], dets[1]) <= 1.0


def _tiny(ns, graph, anchors=((1., 1.), (3., 3.)), n_cls=3):
    b = (ns.NeuralNetConfiguration.Builder().seed(0).updater(ns.Adam(1e-3))
         .weightInit("relu"))
    conv = ns.ConvolutionLayer(kernelSize=(3, 3), nOut=8,
                               convolutionMode="same", activation="relu")
    head = ns.ConvolutionLayer(kernelSize=(1, 1),
                               nOut=len(anchors) * (5 + n_cls),
                               convolutionMode="same", activation="identity")
    yolo = (JYolo if ns is jnn else Yolo2OutputLayer)(
        boundingBoxes=[list(a) for a in anchors])
    if not graph:
        return (b.list().layer(conv).layer(head).layer(yolo)
                .setInputType(ns.InputType.convolutional(8, 8, 3)).build())
    g = (b.graphBuilder().addInputs("in")
         .setInputTypes(ns.InputType.convolutional(8, 8, 3)))
    g.addLayer("c", conv, "in").addLayer("head", head, "c")
    g.addLayer("out", yolo, "head").setOutputs("out")
    return g.build()


@pytest.mark.parametrize("graph", [False, True])
def test_network_detections_and_fit_match_the_jax_package(graph):
    """getPredictedObjects on a MultiLayerNetwork and a ComputationGraph
    with a Yolo2OutputLayer head equals the JAX network's on the same
    weights; two Adam steps leave the same parameters; a network without
    the head raises TypeError."""
    jnet = (JGraph if graph else jnn.MultiLayerNetwork)(_tiny(jnn, graph))
    jnet.init()
    tconf = _tiny(tnn, graph)
    convert = (tnn.graph_params_from_numpy if graph
               else tnn.multilayer_params_from_numpy)
    tnet = convert((tnn.ComputationGraph if graph
                    else tnn.MultiLayerNetwork)(tconf),
                   _np_tree(jnet._params), _np_tree(jnet._state),
                   device="cpu")
    rng = np.random.default_rng(5)
    x = rng.random((3, 8, 8, 3), np.float32)
    for thr in ((0.5, 0.4), (0.0, 0.3)):
        _same_detections(tnet.getPredictedObjects(x, *thr),
                         jnet.getPredictedObjects(x, *thr))
    lab = yolo_labels(3, 8, 8, 3, seed=2)
    for _ in range(2):
        jnet.fit(x, lab)
        tnet.fit(x, lab)
    _close(tnet.score(), float(jnet.score()), TOL, "loss")
    for n, d in _np_tree(jnet._params).items():
        for k, v in d.items():
            _close(tnet._params[n][k], v, TOL, f"{n}/{k}")
    out = tnet.getOutputLayer() if not graph else tnet.getOutputLayer(0)
    assert isinstance(out, Yolo2OutputLayer)


def test_predicted_objects_need_a_yolo_head():
    net = tnn.MultiLayerNetwork(
        tnn.NeuralNetConfiguration.Builder().list()
        .layer(tnn.OutputLayer(nOut=3))
        .setInputType(tnn.InputType.feedForward(4)).build()).init("cpu")
    with pytest.raises(TypeError, match="Yolo2OutputLayer"):
        net.getPredictedObjects(np.zeros((1, 4), np.float32))
