"""The training step and the evaluation loop that MultiLayerNetwork and
ComputationGraph share (the JAX package shares its step helpers between
its two network classes the same way: they must never diverge).

`Network` holds the machinery; a network class supplies its layers as
(key, config) pairs (`_layer_items`), its loss (`_loss`), the unpacking of
a batch into (inputs {name: tensor}, labels [tensor], label masks or None)
(`_unpack`) and its first output for the evaluation loop (`_eval_output`).
Parameters, optimizer state and BN state are trees {key: {name: tensor}};
a training step writes its results into the live tensors in place.

One step: the loss (the output layers' losses plus the L1/L2 penalty),
`backward`, the optimizer of `build_optimizer` (per-layer updater
overrides included), the layers' constraints on the new parameters, and
the new BN state. A batch's feature masks ride in its inputs dict under
`<input name>#mask` (`mask_key`; present only when given), so a masked
batch is a batch signature of its own and its mask a static input of the
step's graph. With `.gradientAccumulation(G)` a group of G batches
runs through `nn.accum.accumulate` and one update. On the card each step
(or group) runs through a CUDA graph per batch signature
(`runtime.executables.FunctionStore`): the first batch of a signature runs
eagerly and is captured after, later ones copy into the graph's static
inputs and replay it. The dropout generator, seeded from conf.seed, is
registered with the graph. The graphs are bound to the parameter,
optimizer and state tensors they were captured with: after `init` or a
weight load rebinds them, the next step captures again.

Every layer's parameters reach its forward through `hook_params`, which at
train time noises them with the layer's `weightNoise` (drawn from the same
generator, so a replay draws fresh noise). `save` and `toJson` write the
JAX package's archive and JSON formats (`util/model_serializer.py`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.eval.evaluation import (Evaluation,
                                                      EvaluationCalibration,
                                                      RegressionEvaluation,
                                                      ROC, ROCMultiClass)
from deeplearning4j_tpu_torch.nn.accum import accumulate
from deeplearning4j_tpu_torch.nn.constraints import apply_layer_constraints
from deeplearning4j_tpu_torch.ops.ndarray import NDArray
from deeplearning4j_tpu_torch.nn.updaters import (apply_updates,
                                                  build_optimizer,
                                                  multi_transform,
                                                  same_updater)
from deeplearning4j_tpu_torch.monitoring import profiler as _prof
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import guardian as _guardian
from deeplearning4j_tpu_torch.resilience import watchdog as _watchdog
from deeplearning4j_tpu_torch.runtime.executables import (FunctionStore,
                                                          model_fingerprint,
                                                          tensor_leaves)
from deeplearning4j_tpu_torch.runtime.pipeline import (StagedBatch,
                                                       StagedMultiBatch,
                                                       materialize_score,
                                                       maybe_prefetch,
                                                       stage_for_eval)

_DTYPES = {"float": torch.float32, "float32": torch.float32,
           "double": torch.float64, "float64": torch.float64,
           "half": torch.float16, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def compute_dtype(conf):
    """The torch dtype of the configuration's `dataType`."""
    dt = str(conf.data_type).lower()
    if dt not in _DTYPES:
        raise ValueError(f"dataType {conf.data_type!r} is not a float "
                         f"type the port computes in: {sorted(_DTYPES)}")
    return _DTYPES[dt]


def mask_key(name):
    """The key of input `name`'s feature mask in an unpacked inputs dict."""
    return f"{name}#mask"


def split_inputs(ins):
    """(features {name: tensor}, feature masks {name: tensor}) of an
    unpacked inputs dict."""
    feats = {n: t for n, t in ins.items() if not n.endswith("#mask")}
    return feats, {n: ins[mask_key(n)] for n in feats if mask_key(n) in ins}


def hook_params(layer, params, train, generator):
    """A layer's parameters as its forward sees them; both network classes
    call it for every layer (≡ the JAX package's `_hook_params`): the
    parameters of a layer with `frozen_params` (FrozenLayerWithBackprop)
    are detached, so no gradient and no regularization reaches them while
    gradients still flow through the layer's outputs; at train time with a
    generator, a layer's `weightNoise` (WeightNoise, DropConnect) replaces
    them by noised ones drawn from the generator."""
    if getattr(layer, "frozen_params", False):
        params = _detached(params)
    wn = getattr(layer, "weightNoise", None)
    if wn is not None and train and generator is not None:
        return wn.apply_to_params(params, generator)
    return params


def pre_activation(layer, params, x, mask):
    """An output layer's pre-activation; a custom loss head
    (`pre_activation_takes_mask`: SameDiffOutputLayer) gets the feature
    mask too."""
    if getattr(layer, "pre_activation_takes_mask", False):
        return layer.pre_activation(params, x, mask=mask)
    return layer.pre_activation(params, x)


class _DrawTape(TorchFunctionMode):
    """Records every torch call that draws from a generator (a call given
    `generator=`) and, on a replay, returns the recorded draws in order
    instead of drawing again. A dropout draw is seen as one
    `nn.dropout.keep_mask` call, so the tape keeps its boolean mask (the
    tensor plain autograd keeps for the dropout's backward too); a
    Gaussian noise draw is kept as drawn, in the activations' dtype."""

    def __init__(self, tape, replay):
        super().__init__()
        self.tape, self.replay, self.i = tape, replay, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if kwargs.get("generator") is None:
            return func(*args, **kwargs)
        if self.replay:
            self.i += 1
            return self.tape[self.i - 1]
        out = func(*args, **kwargs)
        self.tape.append(out)
        return out


def remat_call(fn, *args, draws=True):
    """`fn(*args)` under `torch.utils.checkpoint` (≡ `jax.checkpoint`):
    only the inputs are kept, and the backward runs `fn` again. The
    recompute must see the forward's dropout and weight-noise draws:
    with `draws`, the forward's draws are recorded (kept with the
    checkpoint) and the recompute reads them back, so the network's
    generator advances once, exactly as without remat, and its state is
    never read or set, which a CUDA graph capture forbids. What `fn`
    returns besides its activations (a BN layer's new running state)
    reaches the caller from the forward only; the recompute's copy is
    dropped."""
    if not draws:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    tape, calls = [], [0]

    def run(*a):
        replay = calls[0] > 0
        calls[0] += 1
        with _DrawTape(tape, replay):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def apply_layer(layer, params, state, x, train, generator, mask):
    """One layer's `apply`, honouring its `remat` flag at train time (≡
    the JAX package's `_apply_layer`, which both network classes use):
    remat=True recomputes the layer's activations in the backward
    instead of keeping them."""
    if train and getattr(layer, "remat", False):
        return remat_call(
            lambda x_: layer.apply(params, state, x_, train=True,
                                   generator=generator, mask=mask),
            x, draws=generator is not None)
    return layer.apply(params, state, x, train=train, generator=generator,
                       mask=mask)


def to_device(tree, device):
    return {n: {k: v.to(device) for k, v in d.items()}
            for n, d in tree.items()}


def clone_tree(tree):
    """A copy of a tree of dicts, lists and tuples with every tensor
    cloned."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone() if torch.is_tensor(tree) else tree


def _detached(tree):
    """A tree of dicts, lists and tuples with every tensor detached."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if torch.is_tensor(tree) else tree


def copy_into(dst, src):
    """Write every tensor of tree `src` into its place in `dst`."""
    d, s = tensor_leaves(dst), tensor_leaves(src)
    if len(d) != len(s):
        raise ValueError(f"trees differ: {len(d)} vs {len(s)} tensors")
    if d:
        torch._foreach_copy_(d, s)


def batch_sig(ins, labels, lmasks):
    """The shapes and dtypes of one unpacked batch."""
    def sig(t):
        return None if t is None else (tuple(t.shape), str(t.dtype))
    return (tuple((n, sig(ins[n])) for n in sorted(ins)),
            tuple(sig(t) for t in labels),
            None if lmasks is None else tuple(sig(t) for t in lmasks))


def l1l2_penalty(layers, params):
    """≡ the reference's score regularization: l1·Σ|W| + 0.5·l2·‖W‖² over
    the weight tensors of each layer (biases, β, γ excluded), in f32.
    `params` is a list parallel to `layers`."""
    total = 0.0
    for layer, p in zip(layers, params):
        l1, l2 = layer.regularization_terms()
        if not l1 and not l2:
            continue
        for name, v in p.items():
            # a wrapper's names carry a prefix ("fwd_b" of Bidirectional)
            if name.rsplit("_", 1)[-1] in ("b", "beta", "gamma", "alpha",
                                           "centers"):
                continue
            v = v.float()
            if l1:
                total = total + l1 * v.abs().sum()
            if l2:
                total = total + 0.5 * l2 * (v * v).sum()
    return total


class Network:
    """What both network classes share; see the module docstring."""

    def _reset_training(self):
        self._tx = None          # the optimizer, built at the first fit
        self._opt_state = None
        self._generator = None   # dropout masks, from conf.seed
        self._fit_store = None   # CUDA graphs of the training step
        self._guard_t = None     # the guarded step's (lr_scale, max_gnorm)
        self._guard_host = None  # ... as the host last wrote them
        self._dp = None          # parallel.ParallelWrapper's dp context
        self._listeners = []
        self._last_features = None   # the last training batch's features
        self._score = None
        self._iteration = 0
        self._epoch = 0

    # -- what a network class supplies ------------------------------------
    def _layer_items(self):
        """[(key, layer config)] of the layers in forward order."""
        raise NotImplementedError

    def _loss(self, params, state, inputs, labels, lmasks=None,
              generator=None, train=True):
        raise NotImplementedError

    @property
    def _input_names(self):
        """The names of the inputs, in the order a batch's features come."""
        raise NotImplementedError

    def _unpack(self, ds):
        """(inputs {name: tensor}, labels [tensor], label masks or None) of
        a DataSet or MultiDataSet, or of one that the prefetch thread
        staged, on the network's device; a feature mask joins the inputs
        under `mask_key(name)`."""
        staged = isinstance(ds, (StagedBatch, StagedMultiBatch))
        if staged and ds.event is not None:
            torch.cuda.current_stream(self._device).wait_event(ds.event)

        def tensor(a):
            if a is None:
                return None
            if staged:
                if a.is_cuda:
                    # made on the prefetch stream, read on this one
                    a.record_stream(torch.cuda.current_stream(a.device))
                return a
            return torch.as_tensor(np.asarray(a), device=self._device)

        if isinstance(ds, (MultiDataSet, StagedMultiBatch)):
            fmasks, lmasks = ds.featuresMasks, ds.labelsMasks
            ins = {n: tensor(f) for n, f in zip(self._input_names,
                                                ds.features)}
            labels = [tensor(l) for l in ds.labels]
        elif isinstance(ds, (DataSet, StagedBatch)):
            fmasks = None if ds.featuresMask is None else [ds.featuresMask]
            lmasks = None if ds.labelsMask is None else [ds.labelsMask]
            ins = {self._input_names[0]: tensor(ds.features)}
            labels = [tensor(ds.labels)]
        else:
            raise TypeError(f"Cannot fit on {type(ds)}")
        for n, m in zip(self._input_names, fmasks or ()):
            if m is not None:
                ins[mask_key(n)] = tensor(m)
        if lmasks is not None:
            lmasks = [tensor(m) for m in lmasks]
        return ins, labels, lmasks

    def _eval_output(self, features, fmask):
        """The first output for a batch's features (and feature mask)."""
        raise NotImplementedError

    # -- parameters (≡ Model.params / numParams / paramTable) ---------------
    def _leaves(self):
        """Parameter tensors in the JAX package's tree order (keys sorted
        as strings, then names sorted)."""
        return [self._params[n][k] for n in sorted(self._params)
                for k in sorted(self._params[n])]

    def numParams(self):
        return sum(v.numel() for v in self._leaves())

    def params(self):
        """Every parameter, flattened into one vector (an NDArray)."""
        leaves = self._leaves()
        if not leaves:
            return NDArray(torch.zeros((0,), device=self._device))
        return NDArray(torch.cat([v.detach().reshape(-1) for v in leaves]))

    def paramTable(self):
        """{"<key>_<name>": NDArray} of every parameter, each over the live
        tensor (an in-place NDArray method writes the parameter)."""
        return {f"{key}_{k}": NDArray(v)
                for key, p in (self._params or {}).items()
                for k, v in p.items()}

    # -- score ------------------------------------------------------------
    def _penalty(self, params):
        items = self._layer_items()
        return l1l2_penalty([layer for _, layer in items],
                            [params.get(key, {}) for key, _ in items])

    def score(self, dataset=None):
        """The loss of the last training step (None before the first), or
        the inference-mode loss of `dataset` (≡ the reference's
        score(DataSet)). `fit` leaves the loss on the device; the first
        read floats it (one counted sync, `dl4j.pipeline.syncs{site=
        "score"}`) and caches the float."""
        if dataset is None:
            return materialize_score(self)
        ins, labels, lmasks = self._unpack(dataset)
        with torch.no_grad():
            loss, _ = self._loss(self._params, self._state, ins, labels,
                                 lmasks, None, train=False)
        return float(loss)

    # -- the optimizer ----------------------------------------------------
    def _build_optimizer(self):
        """The optimizer of the configuration: the global updater, and
        each layer whose own updater differs from it gets its own, all
        behind the same gradient normalization and weight decay."""
        defaults = self.conf.defaults
        glob = defaults.get("updater")
        gn = defaults.get("gradientNormalization")
        thr = defaults.get("gradientNormalizationThreshold", 1.0)
        wd = defaults.get("weightDecay", 0.0) or 0.0
        overrides = {k: layer.updater for k, layer in self._layer_items()
                     if layer.updater is not None
                     and not same_updater(layer.updater, glob)}
        tx = build_optimizer(glob, gn, thr, wd)
        if overrides:
            opts = {"__global__": tx}
            opts.update({k: build_optimizer(u, gn, thr, wd)
                         for k, u in overrides.items()})
            tx = multi_transform(opts, {k: k for k in overrides})
        self._tx = tx
        self._opt_state = tx.init(self._params)

    def _apply_constraints(self, params):
        """The layers' constraints on freshly updated parameters (none
        declared: the parameters as they are)."""
        items = self._layer_items()
        if not any(getattr(layer, "constraints", None)
                   for _, layer in items):
            return params
        return apply_layer_constraints(items, params)

    # -- one step ---------------------------------------------------------
    def _grad_tree(self, loss_fn):
        """(loss, gradients {key: {name: tensor}}, aux) of `loss_fn(params)
        -> (loss, aux)` at the current parameters, every tensor of aux
        detached. A parameter the loss does not reach gets a zero gradient,
        as `jax.grad` gives it."""
        leaves = {n: {k: v.detach().requires_grad_() for k, v in d.items()}
                  for n, d in self._params.items()}
        loss, aux = loss_fn(leaves)
        if self._dp is not None:
            # data parallel: this rank's share of the global batch's loss,
            # so the gradients (BN's global sums included) are the global
            # loss's and the dp step sums them
            loss = loss * self._dp.weight
        flat = [(n, k, v) for n, d in leaves.items() for k, v in d.items()]
        grads = torch.autograd.grad(loss, [v for _, _, v in flat],
                                    allow_unused=True)
        tree = {}
        for (n, k, v), g in zip(flat, grads):
            tree.setdefault(n, {})[k] = torch.zeros_like(v) if g is None \
                else g
        return loss.detach(), tree, _detached(aux)

    def _value_and_grad(self, ins, labels, lmasks=None, generator=None,
                        state=None):
        """(loss, gradients {key: {name: tensor}}, new state) of one
        training-mode forward and backward at the current parameters,
        from `state` (default: the live state)."""
        return self._grad_tree(lambda p: self._loss(
            p, self._state if state is None else state, ins, labels, lmasks,
            generator, train=True))

    def _grads_of(self, fn):
        """(loss, gradients, new state) of fn(). Under data parallelism
        (`_dp`, set by parallel.ParallelWrapper) the batch statistics are
        the global batch's and the loss and gradients are reduced over
        the dp ranks."""
        dp = self._dp
        if dp is None:
            if getattr(self._opt_state, "sharded_over_dp", False):
                raise RuntimeError(
                    "the updater state holds this rank's ZeRO-1 blocks "
                    "(ParallelWrapper.shardOptimizerState): train it "
                    "through the wrapper's fit")
            return fn()
        with dp.batch_stats():
            loss, grads, state = fn()
        loss, grads = dp.reduce(loss, grads)
        return loss, grads, state

    def _update_in_place(self, grads, state):
        """The optimizer's update, then the constraints, written into the
        live parameter and optimizer-state tensors; `state` into the live
        BN state."""
        if self._dp is not None and self._dp.zero:
            self._dp.update(self, grads, state)
            return
        updates, opt_state = self._tx.update(grads, self._opt_state,
                                             self._params)
        params = self._apply_constraints(apply_updates(self._params,
                                                       updates))
        copy_into(self._params, params)
        copy_into(self._opt_state, opt_state)
        copy_into(self._state, state)

    def _step_in_place(self, ins, labels, lmasks):
        """One training step written into the live tensors; returns the
        loss. What a CUDA graph of the step captures, so it reads no
        device value on the host."""
        loss, grads, state = self._grads_of(lambda: self._value_and_grad(
            ins, labels, lmasks, self._generator))
        self._update_in_place(grads, state)
        return loss

    def _accum_step_in_place(self, group):
        """One update from the G batches of `group` ((ins, labels,
        lmasks) each): `accumulate`'s mean gradients, one optimizer step;
        returns the mean loss."""
        loss, grads, state = self._grads_of(lambda: self._accumulate(group))
        self._update_in_place(grads, state)
        return loss

    def _accumulate(self, group):
        """(mean loss, mean gradients, final state) of an accumulation
        group."""
        grads, loss, state = accumulate(
            lambda s, b: self._value_and_grad(*b, self._generator, state=s),
            self._state, group)
        return loss, grads, state

    # -- the guarded step (a TrainingGuardian is installed) ----------------
    def _guarded_update(self, loss, grads, state, extra=()):
        """`resilience.guardian.guarded_apply` into the live tensors:
        the update (scaled by the guardian's lr_scale) lands only where
        the step is healthy. Returns (loss, (gnorm, ok) stacked)."""
        lr_scale, max_gnorm = self._guard_t
        if self._dp is not None and self._dp.zero:
            gnorm, ok = self._dp.update(self, grads, state, loss, lr_scale,
                                        max_gnorm)
            return loss, torch.stack([gnorm, ok.to(gnorm.dtype)])
        gnorm, ok = _guardian.guarded_apply(
            self._tx, grads, loss, self._params, self._opt_state, lr_scale,
            max_gnorm, constraints=self._apply_constraints,
            extra=((state, self._state),) + tuple(extra))
        return loss, torch.stack([gnorm, ok.to(gnorm.dtype)])

    def _guarded_step_in_place(self, ins, labels, lmasks):
        """`_step_in_place` under the guardian's verdict."""
        loss, grads, state = self._grads_of(lambda: self._value_and_grad(
            ins, labels, lmasks, self._generator))
        return self._guarded_update(loss, grads, state)

    def _guarded_accum_step_in_place(self, group):
        """`_accum_step_in_place` under one verdict for the accumulated
        update (a NaN in any microbatch poisons the mean loss and the
        summed gradients, so it fails the verdict)."""
        loss, grads, state = self._grads_of(lambda: self._accumulate(group))
        return self._guarded_update(loss, grads, state)

    def _alloc_guard(self):
        """The guarded step's device scalars (lr_scale, max_gnorm),
        allocated once: the fit store binds them with the parameters."""
        if self._guard_t is None:
            self._guard_t = [
                torch.ones((), dtype=torch.float32, device=self._device),
                torch.full((), float("inf"), dtype=torch.float32,
                           device=self._device)]
            self._guard_host = (1.0, float("inf"))

    def _set_guard(self, g):
        """Write the guardian's lr_scale and max_gnorm into the step's
        device scalars when they changed (a fill between replays: the
        graphs read them, so a change never recaptures)."""
        self._alloc_guard()
        want = (float(g.lr_scale), float(g.max_gnorm))
        if want != self._guard_host:
            with torch.no_grad():
                for t, v in zip(self._guard_t, want):
                    t.fill_(v)
            self._guard_host = want

    def _fit_store_for(self):
        store = self._fit_store
        if store is None:
            self._alloc_guard()
            # directory="": no manifest, whatever $DL4J_EXEC_CACHE says
            # (the training step's keys are not a serving vocabulary)
            store = FunctionStore(
                f"{model_fingerprint(self)}-fit", self._device,
                directory="", bindings=lambda: (self._params, getattr(
                    self._opt_state, "state", self._opt_state), self._state,
                    self._guard_t,
                    None if self._dp is None else self._dp.bound()))
            for prefix in ("", "dp_"):
                # dp_: the same steps under data parallelism (their graphs
                # hold the collectives)
                store.register(prefix + "fit", self._step_in_place)
                store.register(prefix + "fit_accum",
                               self._accum_step_in_place)
                store.register(prefix + "fit_guarded",
                               self._guarded_step_in_place)
                store.register(prefix + "fit_accum_guarded",
                               self._guarded_accum_step_in_place)
            self._fit_store = store
        return store

    def _graph_step(self, key, args):
        """`key`'s function through its CUDA graph: the first call of a
        key runs eagerly and is captured after, with static copies of
        `args` as the graph's inputs; a later one copies `args` into them
        and replays the graph."""
        store = self._fit_store_for()
        if key not in store:
            out = store.add(key, clone_tree(args),
                            generators=[self._generator])
            if store.capture:
                return out
        else:
            copy_into(store.args(key), args)
        return store.run(key)   # a store that does not capture: eagerly

    def _step_plan(self, batches):
        """(fit store key, function, arguments) of one update from one
        batch or from an accumulation group (a list of unpacked batches).
        With a guardian installed, the guarded variant (its own key)."""
        g = _guardian.ACTIVE
        if len(batches) == 1:
            name, args = "fit", batches[0]
            sig = batch_sig(*batches[0])
            fn = self._guarded_step_in_place if g is not None \
                else self._step_in_place
        else:
            name, args = "fit_accum", (tuple(batches),)
            sig = tuple(batch_sig(*b) for b in batches)
            fn = self._guarded_accum_step_in_place if g is not None \
                else self._accum_step_in_place
        if g is not None:
            name += "_guarded"
        if self._dp is not None:
            name = "dp_" + name
        return (name, sig), fn, args

    def _step_keys(self, batches):
        """The fit store keys the update from `batches` runs."""
        return [self._step_plan(batches)[0]]

    def _captures_next(self, batches, graphs):
        """Whether the update from `batches` captures a CUDA graph: a key
        the fit store does not hold yet, or weights rebound since the
        captures."""
        if not (graphs and self._device.type == "cuda"):
            return False
        return self._fit_store_for().will_capture(self._step_keys(batches))

    def _run_step(self, batches, graphs):
        """One update from one batch or from an accumulation group (a list
        of unpacked batches), through its CUDA graph on the card when
        `graphs`; returns the loss. With a guardian installed, the
        guarded variant runs (its own store key) and its verdict goes to
        the guardian."""
        g = _guardian.ACTIVE
        key, fn, args = self._step_plan(batches)
        if g is not None:
            self._set_guard(g)
        if graphs and self._device.type == "cuda":
            out = self._graph_step(key, args)
        else:
            out = fn(*args)
        if g is None:
            return out
        loss, stats = out
        g.on_step(loss, stats)   # device scalars; read at its cadence
        return loss

    def _ensure_training(self):
        """Build the optimizer and the dropout generator if the first
        step has not yet."""
        if self._tx is None:
            self._build_optimizer()
        if self._generator is None:
            self._generator = torch.Generator(device=self._device)
            self._generator.manual_seed(int(self.conf.seed))

    def _train_step(self, batches, graphs=True):
        """`_run_step`, after building the optimizer and the dropout
        generator on the first call; then the last batch's features
        (`_last_features`), the counters and the listeners. The dispatch's
        fault site and watchdog heartbeat fire first; an armed
        ProfileSession's step hooks bracket the update. Its window opens
        at the first step that captures no CUDA graph, so the set-up, the
        eager warm-up and the capture of a fresh network stay outside."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.TRAIN_DISPATCH)
        if _watchdog.ACTIVE is not None:
            _watchdog.ACTIVE.beat(self._beat_name())
        self._ensure_training()
        # an armed ProfileSession: the dispatch (one batch or an
        # accumulation group) is one step
        _ps = _prof.ACTIVE
        if (_ps is not None and _ps.state == "armed"
                and not self._captures_next(batches, graphs)):
            _ps.step_start()
        self._score = self._run_step(batches, graphs)
        # the batch itself (never a graph's static input, which the next
        # replay overwrites), for listeners that run a forward over it
        # (StatsListener's activation histograms)
        feats, _ = split_inputs(batches[-1][0])
        self._last_features = feats if self._kind == "graph" \
            else feats["input"]
        self._iteration += 1
        for listener in self._listeners:
            listener.iterationDone(self, self._iteration, self._epoch)
        _ps = _prof.ACTIVE
        if _ps is not None:
            _ps.step_end()

    def _beat_name(self):
        """This network's heartbeat name for the stall watchdog."""
        return f"{self._kind}@{id(self):x}"

    def _retire(self):
        if _watchdog.ACTIVE is not None:
            _watchdog.ACTIVE.retire(self._beat_name())

    def _fit_batch(self, ds, graphs=True):
        """One batch (a DataSet or MultiDataSet) through one training
        step: what FaultTolerantTrainer drives."""
        self._train_step([self._unpack(ds)], graphs)

    # -- fit --------------------------------------------------------------
    def fit(self, data, labels=None, epochs=None, stepsPerDispatch=1,
            prefetch=None, cudaGraphs=True):
        """Train on one batch — a DataSet, a MultiDataSet, fit(features,
        labels) or a (features, labels) pair — or on each batch of an
        iterable (an iterator with `reset` is reset at each epoch) for
        `epochs` epochs.

        `prefetch`: the depth of the background staging queue for an
        iterator that opts in (`asyncSupported()`; None:
        runtime.pipeline.DEFAULT_PREFETCH, 0: copy each batch when its
        step starts). `cudaGraphs`: on the card, replay a CUDA graph of
        the step per batch signature (False: run it eagerly, the
        reference the graphs are held to). `stepsPerDispatch` k groups k
        batches into one dispatch in the JAX package, numerically
        identical to k sequential steps; the port runs the k steps (graph
        replays on the card) back to back, with no host sync between
        them. With `.gradientAccumulation(G)` on the configuration, each
        G consecutive batches of one signature of an iterable make one
        update (a shorter tail runs batch by batch; under truncated BPTT
        each batch runs its segments, one update a segment)."""
        if self._params is None:
            self.init()
        if int(stepsPerDispatch) < 1:
            raise ValueError(f"stepsPerDispatch must be >= 1, got "
                             f"{stepsPerDispatch}")
        graphs = bool(cudaGraphs)
        one = None
        if labels is not None:
            one = DataSet(data, labels)
        elif isinstance(data, (DataSet, MultiDataSet)):
            one = data
        elif (isinstance(data, tuple) and len(data) == 2
              and not isinstance(data[0], (DataSet, MultiDataSet))):
            one = DataSet(*data)
        if one is not None:
            try:
                self._train_step([self._unpack(one)], graphs)
            finally:
                # a fit that ended (or raised) is not a wedged one
                self._retire()
            return self
        accum = self._accum_group_size()
        it, prefetcher = maybe_prefetch(data, prefetch, self._device)
        try:
            for _ in range(int(epochs) if epochs is not None else 1):
                if hasattr(it, "reset"):
                    it.reset()
                group = []
                for ds in it:
                    if _faults.ACTIVE is not None:
                        _faults.ACTIVE.fire(_faults.DATA_NEXT)
                    batch = self._unpack(ds)
                    if accum == 1:
                        self._train_step([batch], graphs)
                        continue
                    if group and batch_sig(*batch) != batch_sig(*group[0]):
                        for b in group:
                            self._train_step([b], graphs)
                        group = []
                    group.append(batch)
                    if len(group) == accum:
                        self._train_step(group, graphs)
                        group = []
                for b in group:
                    self._train_step([b], graphs)
                self._epoch += 1
                for listener in self._listeners:
                    if hasattr(listener, "onEpochEnd"):
                        listener.onEpochEnd(self)
        finally:
            self._retire()
            if prefetcher is not None:
                prefetcher.close()
        return self

    def _accum_group_size(self):
        """G of `.gradientAccumulation(G)`: the batches of an iterable that
        make one update."""
        return int(self.conf.defaults.get("gradientAccumulation", 1) or 1)

    def fit_status(self):
        """The training step's executable store: keys, captures, replays
        and eager degradations with their reasons (None before the first
        step on the card with CUDA graphs)."""
        return None if self._fit_store is None else self._fit_store.status()

    # -- evaluation -------------------------------------------------------
    def _eval_loop(self, iterator, evaluator, prefetch=None):
        """Each batch's first output into `evaluator`; the features of an
        iterator that opts in are staged onto the device in the
        background while the batch before runs (labels stay on the
        host)."""
        it, prefetcher = maybe_prefetch(iterator, prefetch, self._device,
                                        stage=stage_for_eval)
        try:
            if hasattr(it, "reset"):
                it.reset()
            for ds in it:
                if _faults.ACTIVE is not None:
                    _faults.ACTIVE.fire(_faults.EVAL_FORWARD)
                feats = ds.features
                if isinstance(ds, StagedBatch) and ds.event is not None:
                    cur = torch.cuda.current_stream(self._device)
                    cur.wait_event(ds.event)
                    feats.record_stream(cur)
                with torch.no_grad():
                    out = self._eval_output(feats, ds.featuresMask)
                evaluator.eval(ds.labels, out.detach().float().cpu().numpy(),
                               mask=ds.labelsMask)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        return evaluator

    def evaluate(self, iterator, prefetch=None):
        """≡ evaluate(DataSetIterator): classification metrics."""
        return self._eval_loop(iterator, Evaluation(), prefetch)

    def evaluateROC(self, iterator, threshold_steps=0, prefetch=None):
        return self._eval_loop(iterator, ROC(threshold_steps), prefetch)

    def evaluateRegression(self, iterator, prefetch=None):
        return self._eval_loop(iterator, RegressionEvaluation(), prefetch)

    def evaluateROCMultiClass(self, iterator, threshold_steps=0,
                              prefetch=None):
        return self._eval_loop(iterator, ROCMultiClass(threshold_steps),
                               prefetch)

    def evaluateCalibration(self, iterator, reliabilityDiagNumBins=10,
                            histogramNumBins=10, prefetch=None):
        return self._eval_loop(
            iterator, EvaluationCalibration(reliabilityDiagNumBins,
                                            histogramNumBins), prefetch)

    # -- persistence (≡ ModelSerializer.writeModel, toJson) ---------------
    def toJson(self):
        """The configuration's JSON (the JAX package's format)."""
        return self.conf.toJson()

    def save(self, path, saveUpdater=True, normalizer=None):
        """Write the network to a zip archive the JAX package reads too
        (`util/model_serializer.py`)."""
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer
        ModelSerializer.writeModel(self, path, saveUpdater, normalizer)
        return path

    # -- listeners / counters ---------------------------------------------
    def setListeners(self, *listeners):
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = listeners[0]
        self._listeners = list(listeners)
        return self

    def addListeners(self, *listeners):
        self._listeners.extend(listeners)
        return self

    def getListeners(self):
        return list(self._listeners)

    def getIterationCount(self):
        return self._iteration

    def getEpochCount(self):
        return self._epoch


def as_tensor(v, device):
    """An array, tensor or NDArray as a tensor on `device`."""
    if isinstance(v, NDArray):
        v = v.tensor
    if torch.is_tensor(v):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)
