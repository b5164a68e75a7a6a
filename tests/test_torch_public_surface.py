"""The port's public surface against the JAX package's, one case per module
of `deeplearning4j_tpu`: the port module at the same path imports, every
name of the module's `__all__` exists there (where the module has none:
every public class and function it defines, and for a package every
public name of the package it binds), and every public attribute of a
same-named class exists on the port's class. The only names allowed to be
missing are those of NOT_OWED, each of which ROADMAP.md lists under "Not
owed" with its reason."""
import importlib
import inspect
import re
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = "deeplearning4j_tpu"
PORT = "deeplearning4j_tpu_torch"

#: name -> why the port has no counterpart (a module path, a module-level
#: name, or an attribute name of a class); each also stands under ROADMAP's
#: "Not owed"
NOT_OWED = {
    "deeplearning4j_tpu.util.hostkey": "keys XLA's persistent compile "
                                       "cache by the host's CPU flags",
    "unpin_cpu": "undoes the JAX package's TPU attach guard",
    "to_optax": "an optax transform; the port's updaters build torch "
                "optimizers",
    "jax": "NDArray.jax hands out a jax array",
    "as_jax": "converts to a jax array",
    "configure_persistent_cache": "wires jax's persistent compilation cache",
    "persistent_cache_stats": "counts jax's persistent compilation cache",
    "load_or_compile": "the AOT tiers' deserialize-or-compile; a CUDA graph "
                       "cannot be serialized",
    "as_unaliasable": "defeats jax's zero-copy aliasing of numpy memory",
    "xla_owned_copy": "defeats jax's zero-copy aliasing of numpy memory",
    "release": "StagingRing.release frees a slot whose buffers an XLA "
               "executable took by donation; the port's ring frees a slot "
               "when the event behind its copy completes",
}


def _modules():
    """Every module of the JAX package, from its files (nothing imported
    at collection)."""
    root = REPO / REF
    out = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


MODULES = _modules()


def _home(v):
    m = getattr(v, "__module__", None)
    return m if isinstance(m, str) else type(v).__module__


def _public_names(mod, name):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    package = hasattr(mod, "__path__")
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and ((inspect.isclass(v) or inspect.isfunction(v))
                 and _home(v) == name
                 or package and _home(v).startswith(REF + "."))]


def test_the_walk_covers_the_package():
    assert len(MODULES) > 150 and REF in MODULES
    assert f"{REF}.runtime.executables" in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_every_public_name_of_the_jax_module_exists_in_the_port(name):
    ref = importlib.import_module(name)
    port_name = PORT + name[len(REF):]
    if name in NOT_OWED:
        with pytest.raises(ImportError):
            importlib.import_module(port_name)
        return
    port = importlib.import_module(port_name)
    missing = []
    for n in _public_names(ref, name):
        if not hasattr(port, n):
            if n not in NOT_OWED:
                missing.append(n)
            continue
        rv, pv = getattr(ref, n), getattr(port, n)
        if inspect.isclass(rv) and inspect.isclass(pv):
            missing += [f"{n}.{a}" for a in dir(rv)
                        if not a.startswith("_") and not hasattr(pv, a)
                        and a not in NOT_OWED]
    assert not missing, f"{port_name} lacks {missing}"


def test_every_name_not_owed_stands_in_the_roadmap():
    text = (REPO / "ROADMAP.md").read_text()
    start = text.index("**Not owed**")
    section = text[start:text.index("\n### ", start)]
    absent = [n for n in NOT_OWED
              if not re.search(r"\b" + re.escape(n.rsplit(".", 1)[-1])
                               + r"\b", section)]
    assert not absent, absent
