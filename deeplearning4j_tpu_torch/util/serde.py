"""Config JSON serde: the port of `deeplearning4j_tpu/util/serde.py` (≡
MultiLayerConfiguration.toJson/fromJson; the reference persists configs as
Jackson JSON inside model zips).

The file format is the JAX package's, so either package reads the other's
configurations. An object of a config module encodes as {"@class": name,
...its public fields}; decode resolves the class by name from a registry
of the port's config modules, listed in the JAX package's order. Since the
port's config classes keep the JAX package's names, fields and defaults,
the JSON of a port configuration equals the JSON of the same JAX
configuration key for key.

A class outside the registry also records its defining module
("@module"). The port writes a module of its own package under the JAX
package's name (`deeplearning4j_tpu.nn.dropout` for the port's
`nn/dropout.py`: the name is part of the file format, not an import) and
reads such a name back as its own module; a user's custom layer records
its own module. Decode never imports a module the restoring process has
not imported already, unless `registerCustomModule` trusts it: a
configuration file cannot trigger an import.

The registry holds the quantized configurations too (`quantize.policy`'s
PrecisionPolicy on a QAT layer, `quantize.infer`'s layers in a network
that `quantize_network` rewrote), in the JAX package's order.
"""
from __future__ import annotations

import importlib
import sys
import types

#: the JAX package's name in the file format, and the port's
_REF = "deeplearning4j_tpu"
_PORT = "deeplearning4j_tpu_torch"

_CONFIG_MODULES = [
    "deeplearning4j_tpu_torch.nn.conf.layers",
    "deeplearning4j_tpu_torch.nn.conf.special_layers",
    "deeplearning4j_tpu_torch.nn.conf.variational",
    "deeplearning4j_tpu_torch.nn.conf.weightnoise",
    "deeplearning4j_tpu_torch.nn.conf.objdetect",
    "deeplearning4j_tpu_torch.nn.losses",
    "deeplearning4j_tpu_torch.nn.conf.inputs",
    "deeplearning4j_tpu_torch.nn.conf.preprocessors",
    "deeplearning4j_tpu_torch.nn.conf.builders",
    "deeplearning4j_tpu_torch.nn.conf.recurrent",
    "deeplearning4j_tpu_torch.nn.conf.attention",
    "deeplearning4j_tpu_torch.nn.conf.samediff_layers",
    "deeplearning4j_tpu_torch.nn.conf.layers3d",
    "deeplearning4j_tpu_torch.nn.conf.sequence_layers",
    "deeplearning4j_tpu_torch.nn.conf.capsules",
    "deeplearning4j_tpu_torch.nn.conf.graph_vertices",
    "deeplearning4j_tpu_torch.nn.updaters",
    "deeplearning4j_tpu_torch.nn.schedules",
    # precision policies ride on layer confs (QAT), and quantized layer
    # confs replace trained layers after quantize_network()
    "deeplearning4j_tpu_torch.quantize.policy",
    "deeplearning4j_tpu_torch.quantize.infer",
]

#: modules explicitly trusted for custom-class restore (beyond ones the
#: restoring process has ALREADY imported) — see registerCustomModule
_TRUSTED_CUSTOM_MODULES = set()


def registerCustomModule(module_name):
    """Trust `module_name` for custom-layer restore. Without registration,
    decode only resolves custom classes from modules the restoring process
    has already imported: config JSON can never trigger an import (the
    Jackson polymorphic-deserialization gadget the reference's ObjectMapper
    locks down with subtype registration)."""
    _TRUSTED_CUSTOM_MODULES.add(str(module_name))


def _file_module(module):
    """A module's name as the file format records it: the port's own
    modules under the JAX package's name."""
    if module == _PORT or module.startswith(_PORT + "."):
        return _REF + module[len(_PORT):]
    return module


def _own_module(module):
    """The port's module for a name the file format records under the JAX
    package's name, else None."""
    if module == _REF or module.startswith(_REF + "."):
        return _PORT + module[len(_REF):]
    return None


def _resolve_custom(name, module):
    """Resolve a config class recorded with its module path. A name under
    the JAX package's is the port's own module (any of its classes, once
    the module is imported). Any other module must already be imported
    (the class was defined somewhere in this process, the normal case) or
    trusted via registerCustomModule, and the class must subclass Layer,
    GraphVertex or InputPreProcessor."""
    own = _own_module(module)
    if own is not None:
        m = sys.modules.get(own)
        if m is None or not isinstance(getattr(m, name, None), type):
            raise ValueError(f"Cannot restore '{module}.{name}': the port "
                             f"has no class '{name}' in '{own}'")
        return getattr(m, name)
    m = sys.modules.get(module)
    if m is None:
        if module not in _TRUSTED_CUSTOM_MODULES:
            raise ValueError(
                f"Cannot restore custom layer '{name}': its defining module "
                f"'{module}' is not imported. Import it first (or call "
                f"util.serde.registerCustomModule({module!r})) — config "
                "files cannot trigger imports themselves.")
        try:
            m = importlib.import_module(module)
        except ImportError as e:
            raise ValueError(
                f"Cannot restore custom layer '{name}': trusted module "
                f"'{module}' failed to import ({e}).") from e
    if not hasattr(m, name):
        raise ValueError(
            f"Cannot restore custom layer: module '{module}' has no class "
            f"'{name}'")
    cls = getattr(m, name)
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertex
    from deeplearning4j_tpu_torch.nn.conf.layers import Layer
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
        InputPreProcessor
    if not (isinstance(cls, type) and issubclass(
            cls, (Layer, GraphVertex, InputPreProcessor))):
        raise ValueError(
            f"Cannot restore '{module}.{name}': custom config classes must "
            "subclass Layer, GraphVertex or InputPreProcessor")
    return cls


def _resolve(name):
    for mod in _CONFIG_MODULES:
        m = importlib.import_module(mod)
        if hasattr(m, name):
            return getattr(m, name)
    raise ValueError(f"Cannot resolve config class '{name}'")


def encode(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (list, tuple)):
        return {"@tuple": [encode(o) for o in obj]} if isinstance(obj, tuple) \
            else [encode(o) for o in obj]
    if isinstance(obj, dict):
        return {"@dict": {str(k): encode(v) for k, v in obj.items()}}
    # config object: class + public fields; a class outside the registry
    # (a custom SameDiffLayer subclass, a dropout object) also records its
    # defining module
    d = {"@class": type(obj).__name__}
    mod = type(obj).__module__
    if mod not in _CONFIG_MODULES:
        d["@module"] = _file_module(mod)
    for k, v in obj.__dict__.items():
        # skip functions/methods, but keep callable CONFIG OBJECTS
        # (e.g. LossMCXENT instances): they encode via @class like any
        # other config value
        if k.startswith("_") or isinstance(
                v, (types.FunctionType, types.MethodType,
                    types.BuiltinFunctionType, type)):
            continue
        d[k] = encode(v)
    return d


def decode(obj):
    if isinstance(obj, list):
        return [decode(o) for o in obj]
    if isinstance(obj, dict):
        if "@tuple" in obj:
            return tuple(decode(o) for o in obj["@tuple"])
        if "@dict" in obj:
            return {k: decode(v) for k, v in obj["@dict"].items()}
        if "@class" in obj:
            if "@module" in obj:
                cls = _resolve_custom(obj["@class"], obj["@module"])
            else:
                cls = _resolve(obj["@class"])
            inst = cls.__new__(cls)
            for k, v in obj.items():
                if k not in ("@class", "@module"):
                    # object.__setattr__ so frozen dataclasses (InputType)
                    # decode too
                    object.__setattr__(inst, k, decode(v))
            return inst
        return {k: decode(v) for k, v in obj.items()}
    return obj


def config_to_dict(conf):
    return {
        "format": "deeplearning4j_tpu/MultiLayerConfiguration/v1",
        "defaults": encode({k: v for k, v in conf.defaults.items()}),
        "layers": [encode(l) for l in conf.layers],
        "input_type": encode(conf.input_type),
        "preprocessors": {str(k): encode(v)
                          for k, v in conf.preprocessors.items()},
        "backprop_type": conf.backprop_type,
        "tbptt_fwd_length": conf.tbptt_fwd_length,
        "tbptt_back_length": conf.tbptt_back_length,
        "data_type": conf.data_type,
        "seed": conf.seed,
    }


def config_from_dict(d):
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        MultiLayerConfiguration
    defaults = decode(d["defaults"])
    return MultiLayerConfiguration(
        defaults if isinstance(defaults, dict) else {},
        [decode(l) for l in d["layers"]],
        decode(d["input_type"]),
        {int(k): decode(v) for k, v in d.get("preprocessors", {}).items()},
        d.get("backprop_type", "standard"),
        d.get("tbptt_fwd_length", 20),
        d.get("tbptt_back_length", 20),
        d.get("data_type", "float32"),
        d.get("seed", 0))
