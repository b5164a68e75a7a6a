"""ModelSerializer: the port of `deeplearning4j_tpu/util/model_serializer.py`
(≡ deeplearning4j-core :: util.ModelSerializer).

The JAX package's zip format, so either package restores the other's
archives. A zip holding (the text entries deflated; the arrays stored, as
deflate spends seconds on a model's weights to save a few percent, and
either package reads both):

- `modeltype.txt`: "MultiLayerNetwork" or "ComputationGraph";
- `configuration.json`: the configuration's JSON (`util/serde.py`);
- `coefficients.npz`, `state.npz`: the parameter and state trees, keyed
  "<node>/<name>" in the JAX package's nesting ("0/fwd/W" for a
  Bidirectional layer the port keeps flat as "fwd_W": `nn/convert.py`);
- `updaterState.bin` (with `saveUpdater`): the pickled list of the
  optimizer state's leaves, as numpy arrays, in the order optax's
  `tree_leaves` gives them for the same configuration (every updater,
  and `multi_transform` for per-layer updaters); a restore writes them
  into the optimizer state the restored network builds, which has the
  same structure;
- `normalizer.bin` (optional): a pickled normalizer;
- `generatorState.bin` (the port's, once the network has trained): the
  state of the network's dropout generator, so a resumed run draws what
  the uninterrupted one would. The JAX package ignores the entry, and an
  archive without it restarts the generator from the configuration's
  seed, as the JAX package does.

The port writes bf16 leaves (`momentumDtype="bfloat16"`) widened to f32,
exactly; a JAX archive stores its bf16 leaves through `ml_dtypes` (raw
2-byte data in the npz, an `ml_dtypes.bfloat16` dtype in the pickle),
which the port reads as raw bits viewed as `torch.bfloat16`, without
`ml_dtypes`. The pickles are read by unpicklers that accept only numpy's
array globals (and, for a normalizer, the normalizer classes): a JAX
archive's normalizer of `deeplearning4j_tpu.datasets.normalizers` becomes
the port's `datasets/normalizers.py` one, and any other global of the JAX
package is refused, so reading an archive never imports that package.

A restored network lands on the card unless `device` says otherwise; a
graph takes its conv1x1+BN fusion decision again, as `init` does, and its
training step captures its CUDA graphs anew.
"""
from __future__ import annotations

import io
import pickle
import zipfile

import numpy as np
import torch

CONFIG_JSON = "configuration.json"
PARAMS_NPZ = "coefficients.npz"
STATE_NPZ = "state.npz"
UPDATER_PKL = "updaterState.bin"
NORMALIZER_PKL = "normalizer.bin"
KIND_TXT = "modeltype.txt"
GENERATOR_BIN = "generatorState.bin"

#: the module of the JAX package's normalizers, as its pickles name it
_REF_NORMALIZERS = "deeplearning4j_tpu.datasets.normalizers"
_NORMALIZERS = "deeplearning4j_tpu_torch.datasets.normalizers"
#: numpy's globals in a pickled array or scalar (numpy 1 and 2 names)
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (m, n) for m in ("numpy.core.multiarray", "numpy._core.multiarray")
    for n in ("_reconstruct", "scalar")}


class _BF16:
    """Stands for `ml_dtypes.bfloat16` in a JAX pickle."""


def _dtype(obj, align=False, copy=False):
    """numpy.dtype as an unpickler builds it: bf16 as raw uint16 bits."""
    if obj is _BF16:
        return np.dtype("<u2").newbyteorder("=")
    return np.dtype(obj, align, copy)


class _ArrayUnpickler(pickle.Unpickler):
    """Accepts numpy arrays and scalars only (bf16 as raw uint16 bits)."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BF16
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"archive pickle names {module}.{name}: only numpy arrays are "
            "read from an updater state")


class _NormalizerUnpickler(_ArrayUnpickler):
    """Numpy arrays and the normalizer classes; a JAX normalizer becomes
    the port's, any other global of the JAX package is refused."""

    def find_class(self, module, name):
        if module in (_REF_NORMALIZERS, _NORMALIZERS):
            from deeplearning4j_tpu_torch.datasets import normalizers
            cls = getattr(normalizers, name, None)
            if not isinstance(cls, type):
                raise pickle.UnpicklingError(
                    f"archive normalizer names {module}.{name}: no such "
                    "normalizer")
            return cls
        if module == "deeplearning4j_tpu" or module.startswith(
                "deeplearning4j_tpu."):
            raise pickle.UnpicklingError(
                f"archive normalizer names {module}.{name}: only the "
                "normalizers of the JAX package are read")
        return super().find_class(module, name)


def _to_numpy(t):
    """A tensor as numpy for the archive; bf16 widened to f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _from_numpy(a):
    """An archive's array as a tensor: a 2-byte void (the JAX package's
    bf16 in an npz) or uint16 (its bf16 through `_ArrayUnpickler`) entry
    is raw bf16 bits."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2 or a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _into(dst, src):
    """`src` (a tensor from the archive) written into `dst`, in `dst`'s
    dtype."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"updater state: expected a leaf of shape "
                         f"{tuple(dst.shape)}, got {tuple(src.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.dtype))


def _tree_to_npz_bytes(tree):
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = _to_numpy(node)

    walk("", tree or {})
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _npz_bytes_to_tree(data):
    """{node: {name: tensor}} with a nested path joined into the port's
    flat name ("0/fwd/W" → "0": {"fwd_W"})."""
    loaded = np.load(io.BytesIO(data))
    tree = {}
    for key in loaded.files:
        node, *path = key.split("/")
        tree.setdefault(node, {})["_".join(path)] = _from_numpy(loaded[key])
    return tree


def _optax_leaves(net):
    """The tensors of `net`'s optimizer state in optax's `tree_leaves`
    order for the same configuration: labels sorted (multi_transform's
    dict), each label's chain in order, and within a per-parameter list
    the parameters in the JAX package's tree order (nodes sorted, then the
    nested names; `nn/convert.py`'s `jax_path`)."""
    from deeplearning4j_tpu_torch.nn.convert import jax_path
    tx, state = net._tx, net._opt_state
    layers = dict(net._layer_items())
    out = []
    for label in sorted(state):
        keys = tx._groups(net._params)[label]
        order = sorted(range(len(keys)), key=lambda i: (
            keys[i][0],) + jax_path(layers.get(keys[i][0]), keys[i][1]))

        def walk(node):
            if torch.is_tensor(node):
                out.append(node)
            elif isinstance(node, list):       # one tensor per parameter
                if len(node) != len(keys):
                    raise ValueError(f"optimizer state: a list of "
                                     f"{len(node)} for {len(keys)} "
                                     "parameters")
                out.extend(node[i] for i in order)
            elif isinstance(node, tuple):
                for sub in node:
                    walk(sub)
            else:
                raise TypeError(f"optimizer state holds {type(node)}")

        walk(state[label])
    return out


class ModelSerializer:
    @staticmethod
    def writeModel(model, path, saveUpdater=True, normalizer=None):
        from deeplearning4j_tpu_torch.nn.convert import jax_tree
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        kind = ("MultiLayerNetwork" if isinstance(model, MultiLayerNetwork)
                else "ComputationGraph")
        if model._params is None:
            raise ValueError("writeModel: init() the network first")
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(KIND_TXT, kind)
            zf.writestr(CONFIG_JSON, model.conf.toJson())
            zf.writestr(PARAMS_NPZ, _tree_to_npz_bytes(
                jax_tree(model, model._params)), zipfile.ZIP_STORED)
            zf.writestr(STATE_NPZ, _tree_to_npz_bytes(
                jax_tree(model, model._state)), zipfile.ZIP_STORED)
            if saveUpdater and model._opt_state is not None:
                zf.writestr(UPDATER_PKL, pickle.dumps(
                    [_to_numpy(t) for t in _optax_leaves(model)]),
                    zipfile.ZIP_STORED)
            if normalizer is not None:
                zf.writestr(NORMALIZER_PKL, pickle.dumps(normalizer))
            if saveUpdater and model._generator is not None:
                zf.writestr(GENERATOR_BIN, model._generator.get_state()
                            .numpy().tobytes())
        return path

    @staticmethod
    def _restore(path, loadUpdater, expected_kind, device):
        with zipfile.ZipFile(path, "r") as zf:
            names = set(zf.namelist())
            kind = zf.read(KIND_TXT).decode()
            conf_json = zf.read(CONFIG_JSON).decode()
            params = _npz_bytes_to_tree(zf.read(PARAMS_NPZ))
            state = _npz_bytes_to_tree(zf.read(STATE_NPZ))
            updater_blob = (zf.read(UPDATER_PKL)
                            if loadUpdater and UPDATER_PKL in names
                            else None)
            generator_blob = (zf.read(GENERATOR_BIN)
                              if loadUpdater and GENERATOR_BIN in names
                              else None)
        if expected_kind and kind != expected_kind:
            raise ValueError(f"Model in {path} is a {kind}, expected "
                             f"{expected_kind}")
        from deeplearning4j_tpu_torch.nn.convert import (
            graph_params_from_numpy, multilayer_params_from_numpy)
        if kind == "MultiLayerNetwork":
            from deeplearning4j_tpu_torch.nn.conf.builders import \
                MultiLayerConfiguration
            from deeplearning4j_tpu_torch.nn.multilayer import \
                MultiLayerNetwork
            model = MultiLayerNetwork(
                MultiLayerConfiguration.fromJson(conf_json))
            multilayer_params_from_numpy(model, params, state, device)
        elif kind == "ComputationGraph":
            from deeplearning4j_tpu_torch.nn.conf.graph_builder import \
                ComputationGraphConfiguration
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
            model = ComputationGraph(
                ComputationGraphConfiguration.fromJson(conf_json))
            # takes the fusion decision as init() does
            graph_params_from_numpy(model, params, state, device)
        else:
            raise ValueError(f"{path}: unknown model type {kind!r}")
        if updater_blob is not None:
            leaves = _ArrayUnpickler(io.BytesIO(updater_blob)).load()
            # archives of an early JAX format stored (leaves, treedef)
            if isinstance(leaves, tuple):
                leaves = leaves[0]
            model._build_optimizer()
            fresh = _optax_leaves(model)
            if len(fresh) != len(leaves):
                raise ValueError(
                    f"{path}: the updater state holds {len(leaves)} leaves, "
                    f"the configuration's optimizer {len(fresh)}")
            for dst, src in zip(fresh, leaves):
                _into(dst, _from_numpy(src))
        if generator_blob is not None:
            gen = torch.Generator(device=model._device)
            saved = torch.frombuffer(bytearray(generator_blob),
                                     dtype=torch.uint8)
            if saved.numel() == gen.get_state().numel():
                gen.set_state(saved)
                model._generator = gen
        return model

    @staticmethod
    def restoreMultiLayerNetwork(path, loadUpdater=True, device=None):
        return ModelSerializer._restore(path, loadUpdater,
                                        "MultiLayerNetwork", device)

    @staticmethod
    def restoreComputationGraph(path, loadUpdater=True, device=None):
        return ModelSerializer._restore(path, loadUpdater,
                                        "ComputationGraph", device)

    @staticmethod
    def restoreModel(path, loadUpdater=True, device=None):
        return ModelSerializer._restore(path, loadUpdater, None, device)

    @staticmethod
    def addNormalizerToModel(path, normalizer):
        with zipfile.ZipFile(path, "a") as zf:
            zf.writestr(NORMALIZER_PKL, pickle.dumps(normalizer))

    @staticmethod
    def restoreNormalizerFromFile(path):
        with zipfile.ZipFile(path, "r") as zf:
            if NORMALIZER_PKL not in zf.namelist():
                return None
            return _NormalizerUnpickler(
                io.BytesIO(zf.read(NORMALIZER_PKL))).load()
