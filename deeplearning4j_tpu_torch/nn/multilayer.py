"""MultiLayerNetwork (≡ deeplearning4j-nn :: multilayer.MultiLayerNetwork):
the port of `deeplearning4j_tpu/nn/multilayer.py`.

A stack of layers built by `NeuralNetConfiguration.Builder()...list()`.
Parameters and state are dicts of tensors keyed "0".."n-1" (the layer's
index) and then by name ({"W", "b", "gamma", "beta"}, {"mean", "var"}),
the JAX package's trees, so weights carry across as numpy
(`nn/convert.py`'s `multilayer_params_from_numpy`). Outputs are tensors on
the network's device (wrapped as NDArrays by the public entry points).

`init(device=None)` draws the parameters from `conf.seed` on the CPU, in
layer order from one generator, and moves them to the card (or to
`device`). Training and evaluation are `nn/_network.py`'s, shared with
ComputationGraph: `fit` in the array, DataSet and iterator forms (epochs,
`stepsPerDispatch`, `prefetch`, `cudaGraphs`), any updater and schedule,
constraints, dropout objects and `.gradientAccumulation(G)`; on the card
the step replays one CUDA graph per batch signature (`fit_status()`);
`evaluate`, `evaluateROC`, `evaluateRegression`, `evaluateROCMultiClass`
and `evaluateCalibration` feed the `eval/` evaluators.

Recurrent networks: feature masks (B, T) flow through `output(fmask=)`,
`fit` and the evaluation loop, each layer handing the next its
`feed_forward_mask`. `rnnTimeStep` threads the recurrent layers' carries
across calls (`rnnClearPreviousState` / `rnnGetPreviousState`). With
`backpropType(TruncatedBPTT)`, a batch longer than `tBPTTForwardLength`
trains segment by segment: each segment is one update, and the carries
thread from one segment into the next, detached at the boundary (the JAX
package's segment step; like it, the backward runs over the whole
segment), whatever `.gradientAccumulation(G)` says. On the card a
segment runs through its CUDA graph: the carries are static inputs that
the graph overwrites with the segment's final carries, so every full
segment replays one graph and a shorter last segment is a second batch
signature. A last layer whose loss reads its input features
(`needs_features`: CenterLossOutputLayer) gets the layer before's
activation; `getPredictedObjects` decodes a Yolo2OutputLayer head's
output into detections.

`pretrain` / `pretrainLayer` train the layers that define a
`pretrain_loss` (the VAE, the AutoEncoder) layer by layer; a layer's
`weightNoise` (WeightNoise, DropConnect) noises its parameters in every
training forward (`nn._network.hook_params`); `save` / `load` / `toJson`
write and read the JAX package's archive and JSON formats
(`util/model_serializer.py`, `util/serde.py`).

Outputs, parameters and activations come back as NDArrays (`ops/`). A
layer with `remat` (every layer under `rematPolicy("layers")`) recomputes
its activations in the backward (`nn._network.apply_layer`). With a
`TrainingGuardian` installed every step, accumulation step and TBPTT
segment runs its guarded variant (`fit_status()` keys "fit_guarded",
"fit_accum_guarded", "fit_tbptt_guarded"); the fit loop fires the
`train.dispatch` and `data.next` fault sites and beats the stall
watchdog. A frozen layer (FrozenLayer; transfer learning) runs in
inference mode during training, as in the JAX package: no dropout, BN
running statistics pinned.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn._network import (Network, apply_layer,
                                                  as_tensor, batch_sig,
                                                  compute_dtype,
                                                  copy_into, hook_params,
                                                  mask_key,
                                                  pre_activation, to_device)
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.builders import BackpropType
from deeplearning4j_tpu_torch.nn.updaters import (apply_updates,
                                                  build_optimizer)
from deeplearning4j_tpu_torch.ops.ndarray import NDArray
from deeplearning4j_tpu_torch.resilience import guardian as _guardian

__all__ = ["MultiLayerNetwork"]


class MultiLayerNetwork(Network):
    def __init__(self, conf):
        self.conf = conf
        self.layers = conf.layers
        self._params = None
        self._state = None
        self._device = None
        self._compute_dtype = compute_dtype(conf)
        self._fused_pairs = {}   # no fusion pass: read by model_fingerprint
        self._rnn_carries = None  # rnnTimeStep's state
        self._reset_training()

    _input_names = ("input",)
    _kind = "multilayer"     # the stall watchdog's heartbeat name

    def _layer_items(self):
        return [(str(i), layer) for i, layer in enumerate(self.layers)]

    # -- lifecycle -------------------------------------------------------
    def _draw(self):
        """(params, state) on the CPU, drawn in layer order from one
        generator seeded with conf.seed."""
        if self.conf.input_type is None:
            raise ValueError("setInputType(...) (or explicit nIn on every "
                             "layer) is required before init()")
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        ps, ss = {}, {}
        for i, layer in enumerate(self.layers):
            p, s, _ = layer.initialize(gen, self.conf.input_types[i])
            if p:
                ps[str(i)] = p
            if s:
                ss[str(i)] = s
        return ps, ss

    def init(self, device=None, params=None):
        """Draw the parameters and state from conf.seed and place them on
        `device` (default: the card; raises without one unless the caller
        passes device='cpu'). `params`: a flat vector for setParams."""
        dev = resolve(device)
        ps, ss = self._draw()
        self._params, self._state = to_device(ps, dev), to_device(ss, dev)
        self._device = dev
        if params is not None:
            self.setParams(params)
        return self

    def clone(self):
        """A copy with its own parameter and state tensors and an optimizer
        of its own (fresh state, built at its first fit)."""
        m = MultiLayerNetwork(self.conf)
        m._device = self._device
        if self._params is not None:
            m._params = {n: {k: v.clone() for k, v in d.items()}
                         for n, d in self._params.items()}
            m._state = {n: {k: v.clone() for k, v in d.items()}
                        for n, d in self._state.items()}
        return m

    # -- parameters (≡ Model.params / numParams / paramTable) ------------
    def setParams(self, flat):
        """Write a flat vector (in `params()` order) into the parameters,
        in place."""
        flat = as_tensor(flat, self._device).reshape(-1)
        leaves = self._leaves()
        n = sum(v.numel() for v in leaves)
        if flat.numel() != n:
            raise ValueError(f"setParams: expected {n} values, got "
                             f"{flat.numel()}")
        off = 0
        with torch.no_grad():
            for v in leaves:
                v.copy_(flat[off:off + v.numel()].reshape(v.shape))
                off += v.numel()
        return self

    def getParam(self, key):
        """The parameter "<layer>_<name>" as an NDArray over the live
        tensor."""
        li, name = key.split("_", 1)
        return NDArray(self._params[li][name])

    def setParam(self, key, value):
        li, name = key.split("_", 1)
        with torch.no_grad():
            self._params[li][name].copy_(as_tensor(value, self._device))

    # -- forward ---------------------------------------------------------
    def _forward(self, params, state, x, train, generator=None,
                 collect=False, mask=None, carries=None):
        """(output, the output layer's pre-activation or None, new state,
        every layer's activation when `collect`, and the new carries when
        `carries` is given). `mask`: the (B, T) feature mask. `carries`
        {layer index: carry} (missing entries start at zero) drives each
        recurrent layer through `scan_apply`, as rnnTimeStep and truncated
        BPTT do."""
        x = x.to(self._compute_dtype)
        acts = []
        new_state = dict(state)
        new_carries = None if carries is None else {}
        preact = None
        for i, layer in enumerate(self.layers):
            # frozen layers (transfer learning) always run inference-mode
            ltrain = train and not getattr(layer, "frozen", False)
            pp = self.conf.preprocessors.get(i)
            if pp is not None:
                x = pp.preProcess(x)
            p = hook_params(layer, params.get(str(i), {}), ltrain, generator)
            s = state.get(str(i), {})
            if i == len(self.layers) - 1 and hasattr(layer, "compute_loss") \
                    and hasattr(layer, "pre_activation"):
                xd = layer._dropout_in(x, ltrain, generator)
                preact = pre_activation(layer, p, xd, mask)
                x = get_activation(layer.activation)(preact)
            elif carries is not None and getattr(layer, "is_recurrent",
                                                 False):
                if not hasattr(layer, "scan_apply"):
                    raise ValueError(
                        f"rnnTimeStep/tbptt: {type(layer).__name__} (layer "
                        f"{i}) cannot run step-by-step (no carried state "
                        "protocol); use fit/output on whole sequences")
                x = layer._dropout_in(x, ltrain, generator)
                x, new_carries[str(i)] = layer.scan_apply(
                    p, x, carries.get(str(i)), mask)
            else:
                x, ns = apply_layer(layer, p, s, x, ltrain, generator, mask)
                if ns:
                    new_state[str(i)] = ns
            if mask is not None:
                mask = layer.feed_forward_mask(mask)
            if collect:
                acts.append(x)
        if carries is not None:
            return x, preact, new_state, acts, new_carries
        return x, preact, new_state, acts

    def _input(self, x):
        if self._params is None:
            raise ValueError("init() (or multilayer_params_from_numpy) "
                             "first")
        return as_tensor(x, self._device)

    def output(self, x, train=False, fmask=None, generator=None):
        """The last layer's activation for `x` (array, tensor or NDArray)
        under the (B, T) feature mask `fmask`, as an NDArray. `train` runs
        dropout (from `generator`) and batch-statistics BN, without
        touching the stored state."""
        return NDArray(self._output(x, train, fmask, generator))

    def _output(self, x, train=False, fmask=None, generator=None):
        """`output` as a tensor (what the port's own callers read)."""
        fmask = None if fmask is None else as_tensor(fmask, self._device)
        y, _, _, _ = self._forward(self._params, self._state, self._input(x),
                                   train, generator, mask=fmask)
        return y

    def _eval_output(self, features, fmask):
        return self._output(features, fmask=fmask)

    def feedForward(self, x, train=False, generator=None):
        """Every layer's activation, in order (NDArrays)."""
        _, _, _, acts = self._forward(self._params, self._state,
                                      self._input(x), train, generator,
                                      collect=True)
        return [NDArray(a) for a in acts]

    def activateSelectedLayers(self, from_idx, to_idx, x):
        """Layers [from_idx, to_idx] inclusive applied, in inference mode,
        to `x`, which must already be layer from_idx's input."""
        x = self._input(x).to(self._compute_dtype)
        for i in range(int(from_idx), int(to_idx) + 1):
            pp = self.conf.preprocessors.get(i)
            if pp is not None:
                x = pp.preProcess(x)
            x, _ = self.layers[i].apply(self._params.get(str(i), {}),
                                        self._state.get(str(i), {}), x,
                                        train=False)
        return x

    def getOutputLayer(self):
        return self.layers[-1]

    def getPredictedObjects(self, x, confThreshold=0.5, nmsThreshold=0.4):
        """The detections of a Yolo2OutputLayer head (≡
        YoloUtils.getPredictedObjects over this network's output):
        forward, decode, threshold and per-class NMS. Returns
        List[List[DetectedObject]], an inner list per example."""
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "getPredictedObjects"):
            raise TypeError(
                f"output layer {type(out_layer).__name__} has no detection "
                "decode — getPredictedObjects needs a Yolo2OutputLayer head")
        with torch.no_grad():
            y = self._output(x)
        return out_layer.getPredictedObjects(y, confThreshold, nmsThreshold)

    def predict(self, x):
        """≡ Classifier.predict: the argmax class index per example."""
        if isinstance(x, DataSet):
            x = x.features
        return self._output(x).argmax(-1).cpu().numpy()

    def f1Score(self, data, labels=None):
        """≡ Classifier.f1Score(DataSet | (examples, labels)): the
        macro-averaged F1 (Evaluation.f1()'s default) of one forward."""
        mask = None
        if isinstance(data, DataSet):
            feats, labels, mask = data.features, data.labels, data.labelsMask
        else:
            feats = data
        ev = Evaluation()
        ev.eval(np.asarray(labels), self._output(feats).float().cpu().numpy(),
                mask)
        return ev.f1()

    # -- loss and gradients ----------------------------------------------
    def _loss(self, params, state, inputs, labels, lmasks=None,
              generator=None, train=True, carries=None):
        """(the scalar loss, the new state): the output layer's loss on its
        pre-activation in f32, plus the L1/L2 penalty. With `carries`,
        (the loss, (the new state, the new carries))."""
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "compute_loss"):
            raise ValueError("Last layer must be an OutputLayer/LossLayer "
                             "to fit()")
        needs_feats = getattr(out_layer, "needs_features", False)
        if needs_feats and carries is not None:
            raise ValueError(
                f"{type(out_layer).__name__} (feature-dependent loss) is "
                "not supported with truncated BPTT")
        x = inputs["input"]
        out = self._forward(params, state, x, train, generator,
                            mask=inputs.get(mask_key("input")),
                            collect=needs_feats, carries=carries)
        preact, new_state = out[1], out[2]
        y = labels[0].to(torch.float32)
        lm = None if lmasks is None else lmasks[0]
        if needs_feats:
            # the loss reads the last layer's input (CenterLossOutputLayer)
            acts = out[3]
            feats = acts[-2] if len(acts) >= 2 else x.to(self._compute_dtype)
            pp = self.conf.preprocessors.get(len(self.layers) - 1)
            if pp is not None:
                feats = pp.preProcess(feats)
            data_loss = out_layer.compute_loss_with_features(
                params.get(str(len(self.layers) - 1), {}), y, preact.float(),
                feats.float(), lm)
        else:
            data_loss = out_layer.compute_loss(y, preact.float(), lm)
        loss = data_loss + self._penalty(params)
        if carries is not None:
            return loss, (new_state, out[4])
        return loss, new_state

    def computeGradients(self, x, y, fmask=None, lmask=None):
        """Gradients of the full regularized loss at the current
        parameters ({key: {name: tensor}}; ≡ GradientCheckUtil's use)."""
        ins, labels, lmasks = self._unpack(DataSet(x, y, fmask, lmask))
        _, grads, _ = self._value_and_grad(ins, labels, lmasks)
        return grads

    # -- truncated BPTT ----------------------------------------------------
    def _zero_carries(self, batch):
        return {str(i): layer.zero_carry(batch, self._compute_dtype,
                                         self._device)
                for i, layer in enumerate(self.layers)
                if getattr(layer, "is_recurrent", False)
                and hasattr(layer, "zero_carry")}

    def _tbptt_step_in_place(self, ins, labels, lmasks, carries):
        """One segment's update written into the live tensors, and the
        segment's final carries written (detached) into `carries`; returns
        the loss. What the segment's CUDA graph captures."""
        loss, grads, (state, new_carries) = self._grads_of(
            lambda: self._grad_tree(lambda p: self._loss(
                p, self._state, ins, labels, lmasks, self._generator,
                train=True, carries=carries)))
        self._update_in_place(grads, state)
        copy_into(carries, new_carries)
        return loss

    def _guarded_tbptt_step_in_place(self, ins, labels, lmasks, carries):
        """`_tbptt_step_in_place` under the guardian's verdict: the
        parameters, optimizer and BN state AND the carries keep their old
        values on an unhealthy segment (a NaN forward must not poison the
        hidden state the next segment reads)."""
        loss, grads, (state, new_carries) = self._grads_of(
            lambda: self._grad_tree(lambda p: self._loss(
                p, self._state, ins, labels, lmasks, self._generator,
                train=True, carries=carries)))
        return self._guarded_update(loss, grads, state,
                                    extra=((new_carries, carries),))

    def _tbptt_segment(self, args, graphs):
        """One segment (ins, labels, lmasks, carries) through its graph on
        the card; returns (loss, the carries after it). On the card these
        are the graph's static carries, overwritten by the next replay of
        that graph, which reads them first. Under a guardian each segment
        reports its verdict as not retryable: the batch's earlier healthy
        segments already updated the parameters."""
        g = _guardian.ACTIVE
        fn = self._tbptt_step_in_place if g is None \
            else self._guarded_tbptt_step_in_place
        if g is not None:
            self._set_guard(g)
        if graphs and self._device.type == "cuda":
            key = (self._tbptt_name(), batch_sig(*args[:3]))
            out = self._graph_step(key, args)
            carries = self._fit_store.args(key)[3]
            if g is None:
                return out.clone(), carries
            loss, stats = out
            g.on_step(loss, stats, retryable=False)
            return loss.clone(), carries
        out = fn(*args)
        if g is None:
            return out, args[3]
        loss, stats = out
        g.on_step(loss, stats, retryable=False)
        return loss, args[3]

    def _tbptt_name(self):
        """The fit store name of a segment's update."""
        name = "fit_tbptt" if _guardian.ACTIVE is None \
            else "fit_tbptt_guarded"
        return name if self._dp is None else "dp_" + name

    def _tbptt_segments(self, batch):
        """(ins, labels, lmasks) of each tBPTTForwardLength segment of an
        unpacked batch."""
        ins, labels, lmasks = batch
        tlen = int(self.conf.tbptt_fwd_length)
        for t0 in range(0, ins["input"].shape[1], tlen):
            seg = slice(t0, t0 + tlen)
            yield ({k: v[:, seg] for k, v in ins.items()},
                   [y[:, seg] if y.ndim == 3 else y for y in labels],
                   None if lmasks is None else [
                       None if m is None else m[:, seg] for m in lmasks])

    def _step_keys(self, batches):
        if len(batches) != 1 or not self._is_tbptt(batches[0]):
            return super()._step_keys(batches)
        return [(self._tbptt_name(), batch_sig(*seg))
                for seg in self._tbptt_segments(batches[0])]

    def _fit_store_for(self):
        store = super()._fit_store_for()
        for prefix in ("", "dp_"):
            store.register(prefix + "fit_tbptt", self._tbptt_step_in_place)
            store.register(prefix + "fit_tbptt_guarded",
                           self._guarded_tbptt_step_in_place)
        return store

    def _is_tbptt(self, batch):
        x = batch[0]["input"]
        return (self.conf.backprop_type == BackpropType.TruncatedBPTT
                and x.ndim == 3
                and x.shape[1] > int(self.conf.tbptt_fwd_length))

    def _accum_group_size(self):
        """1 under truncated BPTT, whatever `.gradientAccumulation(G)` says:
        the segment loop owns the updates, one a segment (the JAX
        package's rule)."""
        if self.conf.backprop_type == BackpropType.TruncatedBPTT:
            return 1
        return super()._accum_group_size()

    def _run_step(self, batches, graphs):
        """A batch longer than tBPTTForwardLength under truncated BPTT:
        one update a segment; returns the mean segment loss."""
        if len(batches) != 1 or not self._is_tbptt(batches[0]):
            return super()._run_step(batches, graphs)
        carries = self._zero_carries(batches[0][0]["input"].shape[0])
        total, nseg = None, 0
        for sins, slabels, slm in self._tbptt_segments(batches[0]):
            loss, carries = self._tbptt_segment(
                (sins, slabels, slm, carries), graphs)
            total = loss if total is None else total + loss
            nseg += 1
        return total / nseg

    # -- misc parity -------------------------------------------------------
    def getnLayers(self):
        return len(self.layers)

    def getLayer(self, idx):
        return self.layers[idx]

    def summary(self):
        lines = ["=" * 72,
                 f"{'Idx':<4}{'Layer':<28}{'Out':<22}{'nParams':>10}",
                 "-" * 72]
        total = 0
        for i, l in enumerate(self.layers):
            p = self._params.get(str(i), {}) if self._params else {}
            n = sum(v.numel() for v in p.values())
            total += n
            out = self.conf.input_types[i]
            out_str = str(l.output_type(out).shape()) if out is not None \
                else "?"
            lines.append(f"{i:<4}{type(l).__name__:<28}{out_str:<22}"
                         f"{n:>10,}")
        lines += ["-" * 72, f"Total params: {total:,}", "=" * 72]
        return "\n".join(lines)

    # -- stateful RNN inference (≡ rnnTimeStep / rnnClearPreviousState) --
    @torch.no_grad()
    def rnnTimeStep(self, x):
        """The network's output for the next step(s) `x`, (B, F) or
        (B, T, F), continuing from the carries the last call left (zeros
        after `rnnClearPreviousState`). A (B, F) input gives (B, C)."""
        x = self._input(x)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, :]
        y, _, _, _, self._rnn_carries = self._forward(
            self._params, self._state, x, False,
            carries=self._rnn_carries or {})
        return y[:, -1, :] if squeeze and y.ndim == 3 else y

    def rnnClearPreviousState(self):
        self._rnn_carries = None

    def rnnGetPreviousState(self, layer_idx):
        """The carry (a tuple of (B, nOut) tensors) layer `layer_idx` left,
        or None."""
        return (self._rnn_carries or {}).get(str(layer_idx))

    # -- layerwise unsupervised pretraining (≡ pretrain / pretrainLayer) -
    def pretrainLayer(self, layer_idx, data, epochs=1):
        """Train one layer that defines `pretrain_loss` (the VAE's negative
        ELBO, the AutoEncoder's reconstruction loss) on the activations
        that feed it, with its own optimizer of the configuration's updater
        (the layer's, else the global one); other layers are skipped, as
        in the reference. `data`: an iterator of DataSets, a DataSet or a
        features array. The noise (ε, corruption) comes from the network's
        generator. The network's own optimizer starts afresh afterwards,
        as the JAX package's does."""
        layer = self.layers[int(layer_idx)]
        if not hasattr(layer, "pretrain_loss"):
            return self
        if self._params is None:
            self.init()
        if self._generator is None:
            self._generator = torch.Generator(device=self._device)
            self._generator.manual_seed(int(self.conf.seed))
        d = self.conf.defaults
        key = str(layer_idx)
        tx = build_optimizer(layer.updater or d.get("updater"),
                             d.get("gradientNormalization"),
                             d.get("gradientNormalizationThreshold", 1.0),
                             d.get("weightDecay", 0.0) or 0.0)
        params = {key: self._params[key]}
        opt_state = tx.init(params)

        def batches():
            if hasattr(data, "reset"):
                data.reset()
                for ds in data:
                    yield ds.features
            else:
                yield data.features if isinstance(data, DataSet) else data

        for _ in range(int(epochs)):
            for feats in batches():
                x = self._input(feats).to(self._compute_dtype)
                with torch.no_grad():
                    if int(layer_idx) > 0:
                        x = self.activateSelectedLayers(0, int(layer_idx) - 1,
                                                        x)
                    pp = self.conf.preprocessors.get(int(layer_idx))
                    if pp is not None:
                        x = pp.preProcess(x)
                leaves = {k: v.detach().requires_grad_()
                          for k, v in params[key].items()}
                loss = layer.pretrain_loss(leaves, x, self._generator)
                names = list(leaves)
                grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                            allow_unused=True)
                grads = {key: {k: torch.zeros_like(leaves[k]) if g is None
                               else g for k, g in zip(names, grads)}}
                with torch.no_grad():
                    updates, opt_state = tx.update(grads, opt_state, params)
                    copy_into(params, apply_updates(params, updates))
                self._score = loss.detach()
        self._tx = self._opt_state = None   # rebuilt at the next fit
        return self

    def pretrain(self, data, epochs=1):
        """≡ pretrain(iterator): pretrainLayer over every layer, in order."""
        for i in range(len(self.layers)):
            self.pretrainLayer(i, data, epochs)
        return self

    @staticmethod
    def load(path, loadUpdater=True, device=None):
        """A MultiLayerNetwork restored from an archive of either package,
        on `device` (default: the card)."""
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer
        return ModelSerializer.restoreMultiLayerNetwork(path, loadUpdater,
                                                        device)
