"""The executable store of the port: CUDA-graph steps, the bucket ladder
and the staging ring. The port of `deeplearning4j_tpu/runtime/
executables.py`.

The JAX package closes the set of shapes that a server dispatches, and
compiles one executable per shape ahead of time, so that steady-state
serving never traces. The port's executable is a `torch.cuda.CUDAGraph`:
one launch on the host replays every kernel of a decode block, a training
step or a forward.

- `FunctionStore`: named functions, one graph per key. `add(key, args)`
  runs the function once eagerly on a side stream (cuBLAS and cuDNN pick
  their algorithms there, and the port's kernels set their shared-memory
  attributes), then captures it into a graph. Every graph of a store draws
  its memory from one shared pool. A key's `args` are its static inputs:
  a caller copies new inputs into them (through a `StagingRing`) and
  `run(key)` replays the graph, whose outputs are static tensors too,
  valid until the store replays another key. On the CPU, or with
  `capture=False`, `add` runs nothing and `run` calls the function
  eagerly on the same static inputs, under the same keys and counters, so
  the CPU tests drive the store's whole bookkeeping.
- `ExecutableStore`: a `FunctionStore` of one model's inference forward,
  one graph per bucketed input signature (`ParallelInference`).
- `BucketLadder`: the closed shape vocabulary; oversized batches split
  across max-bucket chunks.
- `StagingRing`: pinned host buffers through which host arrays enter a
  graph's static inputs with `non_blocking` copies. A device input never
  aliases the caller's numpy memory (the reference's `xla_owned_copy`
  contract).

Launch accounting: the kernel wrappers count `<wrapper>.launches` in
Python, and a replay runs no Python. So the store takes each capture's
launches back off the counters (a capture launches nothing) and adds them
again at every replay.

Disk tier: a CUDA graph cannot be serialized. What a cold start costs is
`nvcc`, whose libraries `build/kernels/` already caches by hash
(`kernels/_build.py`), and finding the key set. A store with a
`directory` keeps a manifest of the keys it holds at

    <directory>/v1/<device flavour>/<fingerprint>/manifest.json

A later store on the same directory reads it back (`recorded_keys`): an
`ExecutableStore` captures every signature the manifest lists at
`warmup`, those served live by an earlier process included, and each key
the manifest lists counts `from_disk` (`compiled` otherwise). A manifest
that does not parse or whose meta does not match counts
`manifest_failures`, is treated as absent and is rewritten: it never
stops a store.

A graph reads the addresses it was captured with. Static inputs and the
decode state stay allocated for the life of the store, and nothing
outside a graph may keep an address taken during its capture. Tensors
that a store's functions read besides their inputs, such as a model's
parameters, are its `bindings`: when a weight load or `init` rebinds
them to other tensors, the next `run` captures every graph again against
the live ones (`rebinds`), so a graph never reads stale weights.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import COUNTED, _build

__all__ = ["BucketLadder", "ExecutableStore", "FunctionStore",
           "StagingRing", "device_flavour", "model_fingerprint",
           "tensor_leaves", "torch_dtype"]

#: bump to invalidate every manifest on disk at once
LAYOUT_VERSION = "v1"
MANIFEST = "manifest.json"


# -- identity --------------------------------------------------------------
def tensor_leaves(tree):
    """The tensors of a tree of dicts (keys sorted), lists and tuples."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def device_flavour(device):
    """Where a capture is valid: the CUDA device's name and compute
    capability with the CUDA and torch versions, or the CPU with torch's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"cpu-torch{torch.__version__}"
    major, minor = torch.cuda.get_device_capability(dev)
    name = torch.cuda.get_device_name(dev).replace(" ", "_").replace("/", "_")
    return (f"cuda-{name}-sm{major}{minor}-cuda{torch.version.cuda}"
            f"-torch{torch.__version__}")


def _identity(v, depth=0):
    """A plain, address-free description of a configuration object."""
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if depth > 8:
        return type(v).__name__
    if isinstance(v, (list, tuple)):
        return [_identity(x, depth + 1) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(repr(_identity(x, depth + 1)) for x in v)
    if isinstance(v, dict):
        return [[str(k), _identity(x, depth + 1)]
                for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))]
    if isinstance(v, torch.dtype):
        return str(v)
    d = getattr(v, "__dict__", None)
    if d is not None:
        return [type(v).__name__, _identity(d, depth + 1)]
    return type(v).__name__


def _addresses(tree, out):
    """Append the data pointers of a tree's tensors to `out`, in the
    tree's own order: a cheap walk, run before every replay of a store
    with bindings."""
    if isinstance(tree, dict):
        for v in tree.values():
            _addresses(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _addresses(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree.data_ptr())


def _shape_tree(tree):
    """The shapes and dtypes of a tree of tensors, as plain lists."""
    if isinstance(tree, dict):
        return [[str(k), _shape_tree(v)] for k, v in sorted(tree.items())]
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    if torch.is_tensor(tree):
        return [list(tree.shape), str(tree.dtype)]
    return repr(tree)


def _digest(parts):
    return hashlib.sha256(json.dumps(parts, default=str).encode()
                          ).hexdigest()[:16]


def model_fingerprint(model):
    """Identity of what a graph of `model` captures: the configuration,
    the fusion decision, the compute dtype, the shapes and dtypes of the
    parameters and the state, and the torch version. Parameter values are
    read at replay, so a retrained model of the same architecture keeps
    its fingerprint."""
    return _digest((type(model).__name__, _identity(model.conf),
                    str(model._compute_dtype),
                    sorted(model._fused_pairs.items()),
                    _shape_tree(model._params), _shape_tree(model._state),
                    torch.__version__))


# -- bucket ladder ---------------------------------------------------------
class BucketLadder:
    """The serving shape vocabulary: batch buckets + optional sequence
    length buckets. `bucket(n)` → smallest batch bucket admitting n
    rows (None: oversized, split via `chunks(n)`); `length_bucket(t)`
    → smallest length bucket ≥ t. A sequence LONGER than the top rung
    serves at its native length; the batch axis can split across
    dispatches, the time axis cannot."""

    def __init__(self, batch=(1, 2, 4, 8, 16, 32), length=None):
        self.batch = tuple(sorted({int(b) for b in batch}))
        if not self.batch or self.batch[0] < 1:
            raise ValueError(f"batch buckets must be >= 1: {batch}")
        self.length = (None if length is None
                       else tuple(sorted({int(t) for t in length})))
        if self.length is not None and self.length[0] < 1:
            raise ValueError(f"length buckets must be >= 1: {length}")

    @property
    def max_batch(self):
        return self.batch[-1]

    def bucket(self, n):
        for b in self.batch:
            if n <= b:
                return b
        return None

    def chunks(self, n):
        """Row counts of the dispatches serving an n-row batch: greedy
        max-bucket chunks + one bucketed remainder (never a novel
        shape)."""
        out = []
        while n > self.max_batch:
            out.append(self.max_batch)
            n -= self.max_batch
        if n:
            out.append(n)
        return out

    def length_bucket(self, t):
        if self.length is None:
            return t
        for b in self.length:
            if t <= b:
                return b
        return t   # over-long: native length, never truncate

    def __repr__(self):
        return f"BucketLadder(batch={self.batch}, length={self.length})"


# -- staging ring ----------------------------------------------------------
def torch_dtype(np_dtype):
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


class StagingRing:
    """A bounded ring of pinned host buffers, one ring per signature of the
    arrays staged together. `stage(arrays, dsts)` copies each host array
    into a pinned buffer and from there, with a `non_blocking` copy on the
    current stream, into its device tensor (a graph's static input). A
    buffer is written again only after the event recorded behind its last
    copy has completed, so at most `depth` copies per signature are in
    flight. On the CPU the arrays are copied straight into the tensors.
    Either way the device tensor owns its memory: it never aliases the
    caller's numpy array."""

    def __init__(self, depth=2):
        self.depth = max(1, int(depth))
        self.staged = 0      # lifetime stage() calls
        self._rings = {}     # signature -> [next slot, [[buffers, event]]]
        self._lock = threading.Lock()

    def stage(self, arrays, dsts):
        arrays = [np.ascontiguousarray(a) for a in arrays]
        for a, d in zip(arrays, dsts):
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"staging a {a.shape} array into a "
                                 f"{tuple(d.shape)} tensor")
        with self._lock:
            self.staged += 1
            if not dsts[0].is_cuda:
                for a, d in zip(arrays, dsts):
                    d.copy_(torch.from_numpy(a))
                return dsts
            sig = tuple((a.shape, a.dtype.str) for a in arrays)
            ring = self._rings.setdefault(sig, [0, []])
            i = ring[0]
            ring[0] = (i + 1) % self.depth
            if i == len(ring[1]):
                ring[1].append([[torch.empty(
                    a.shape, dtype=torch_dtype(a.dtype), pin_memory=True)
                    for a in arrays], None])
            slot = ring[1][i]
            if slot[1] is not None:
                slot[1].synchronize()
            for buf, a, d in zip(slot[0], arrays, dsts):
                buf.numpy()[...] = a
                d.copy_(buf, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(torch.cuda.current_stream(dsts[0].device))
        return dsts


# -- the stores ------------------------------------------------------------
def _key_text(key):
    """A key as the manifest writes it (JSON: tuples become lists)."""
    return json.dumps(key, separators=(",", ":"))


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _is_sig(sig):
    """Whether a manifest's record is an input signature
    `((shape, dtype name), ...)` that `ExecutableStore` can allocate."""
    return isinstance(sig, tuple) and bool(sig) and all(
        isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], tuple)
        and all(isinstance(d, int) and d >= 0 for d in p[0])
        and isinstance(getattr(torch, str(p[1]), None), torch.dtype)
        for p in sig)


class _Entry:
    __slots__ = ("args", "graph", "out", "launches", "source", "generators")

    def __init__(self, args, source):
        self.args = args        # the static inputs
        self.graph = None       # the CUDAGraph, or None: runs eagerly
        self.out = None         # the graph's static outputs
        self.launches = ()      # (wrapper, launches per replay)
        self.source = source    # "disk" (in the manifest) | "compiled"
        self.generators = ()    # registered with the graph


class FunctionStore:
    """CUDA graphs of named functions, one per key (`key[0]` names the
    function). `warmup(items)` adds the closed key set at start-up; `run`
    is the steady-state call. `capture` defaults to True on a CUDA device
    and must be False elsewhere. `bindings`, when given, returns the tree
    of tensors (dicts, lists, tuples) that the functions read besides
    their static inputs, such as parameters, optimizer and BN state; a
    `run` that finds any of them rebound captures every graph again
    first."""

    kind = "function"

    def __init__(self, fingerprint, device, directory=None, capture=None,
                 bindings=None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.capture = cuda if capture is None else bool(capture)
        if self.capture and not cuda:
            raise ValueError(f"CUDA graphs capture on a CUDA device, not "
                             f"{self.device}")
        self.fingerprint = fingerprint
        self.flavour = device_flavour(self.device)
        self.directory = directory or None
        self.stats = {"captures": 0, "replays": 0, "eager_calls": 0,
                      "compiled": 0, "from_disk": 0, "live_captures": 0,
                      "degradations": 0, "rebinds": 0,
                      "manifest_failures": 0}
        self.degraded = {}      # repr(key) -> why it runs eagerly
        self._fns = {}
        self._entries = {}
        self._manifest = None   # {key text: record}, read at warmup
        self._warm = False
        self._bindings = bindings
        self._bound = None      # the bindings' addresses at the captures
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._lock = threading.RLock()

    def register(self, name, fn):
        """Declare `fn(*args)`: a function of its static inputs that only
        launches device work (no host sync, no allocation kept outside
        its outputs)."""
        self._fns[name] = fn
        return self

    def __contains__(self, key):
        return key in self._entries

    def __len__(self):
        return len(self._entries)

    def args(self, key):
        """The static inputs of `key`."""
        return self._entries[key].args

    # -- adding keys ------------------------------------------------------
    def add(self, key, args=(), generators=()):
        """Add `key` with its static inputs `args`. When capturing, run
        its function once eagerly on them, on a side stream, then capture
        it, and return the eager run's result (None otherwise).
        `generators` are the torch.Generators the function may draw from:
        one that the eager run advanced is registered with the graph, or,
        where this torch cannot register a generator, the key runs eagerly
        and `degraded` says why. A capture that raises leaves the key
        degraded, with the exception as its reason, and re-raises."""
        with self._lock:
            if key in self._entries:
                raise KeyError(f"{key!r} is already in the store")
            fn = self._fns[key[0]]
            self._read_manifest()
            disk = _key_text(key) in (self._manifest or {})
            entry = _Entry(tuple(args), "disk" if disk else "compiled")
            out, drawn = None, []
            if self.capture:
                states = [g.get_state() for g in generators]
                out = self._warm_up(fn, entry.args)
                drawn = [g for g, s in zip(generators, states)
                         if not torch.equal(g.get_state(), s)]
            self._entries[key] = entry
            self.stats["from_disk" if disk else "compiled"] += 1
            if self._warm:
                self.stats["live_captures"] += 1
            if self._bindings is not None and self._bound is None:
                self._bound = self._addresses()
            if self.capture:
                if drawn and not hasattr(torch.cuda.CUDAGraph,
                                         "register_generator_state"):
                    self.degrade(key, "the function draws from a "
                                 "torch.Generator, and this torch has no "
                                 "CUDAGraph.register_generator_state")
                else:
                    entry.generators = tuple(drawn)
                    try:
                        self._capture(entry, fn)
                    except Exception as e:
                        self.degrade(key, f"capture failed: {e!r}")
                        raise
            if self._warm:
                self._write_manifest()
            return out

    def _warm_up(self, fn, args):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        return out

    def _capture(self, entry, fn):
        graph = torch.cuda.CUDAGraph()
        for g in entry.generators:
            graph.register_generator_state(g)
        before = [w.launches for w in COUNTED]
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = fn(*entry.args)
        finally:
            launches = []
            for w, b in zip(COUNTED, before):
                n = w.launches - b
                if n:
                    w.launches -= n         # a capture launches nothing
                    launches.append((w, n))
        entry.graph, entry.out = graph, out
        entry.launches = tuple(launches)
        self.stats["captures"] += 1

    def degrade(self, key, reason):
        """Run `key` eagerly from now on, counted with its reason."""
        entry = self._entries[key]
        entry.graph, entry.out = None, None
        self.degraded[repr(key)] = reason
        self.stats["degradations"] += 1

    def warmup(self, items):
        """Add each (key, args) of the closed key set that the store lacks,
        then write the manifest. Returns {compiled, from_disk, captures,
        nvcc_runs, seconds, keys}; keys added after this count
        `live_captures`."""
        t0 = time.perf_counter()
        nvcc0 = _build.nvcc_runs
        with self._lock:
            before = dict(self.stats)
            self._read_manifest()
            for key, args in items:
                if key not in self._entries:
                    self.add(key, args)
            self._warm = True
            self._write_manifest()
            return {"compiled": self.stats["compiled"] - before["compiled"],
                    "from_disk": (self.stats["from_disk"]
                                  - before["from_disk"]),
                    "captures": self.stats["captures"] - before["captures"],
                    "nvcc_runs": _build.nvcc_runs - nvcc0,
                    "seconds": time.perf_counter() - t0,
                    "keys": len(self._entries)}

    # -- the steady state -------------------------------------------------
    def run(self, key):
        """Replay `key`'s graph (or run its function eagerly) on its static
        inputs; returns its static outputs."""
        entry = self._entries[key]
        if self._bindings is not None and self._addresses() != self._bound:
            self._rebind()
        if entry.graph is None:
            self.stats["eager_calls"] += 1
            return self._fns[key[0]](*entry.args)
        entry.graph.replay()
        for w, n in entry.launches:
            w.launches += n
        self.stats["replays"] += 1
        return entry.out

    # -- bindings ---------------------------------------------------------
    def _addresses(self):
        out = []
        _addresses(self._bindings(), out)
        return out

    def _rebind(self):
        """Capture every graph again against the live bindings. No eager
        warm-up runs first (for a training step it would be a step): the
        first capture of each key already made cuBLAS and cuDNN pick
        their algorithms for its shapes. Each old graph is released only
        after its successor is captured: a pool whose last graph is gone
        is freed, and a capture into it fails."""
        with self._lock:
            self._bound = self._addresses()
            self.stats["rebinds"] += 1
            for k, e in self._entries.items():
                if e.graph is None:
                    continue
                try:
                    self._capture(e, self._fns[k[0]])
                except Exception as exc:
                    self.degrade(k, f"capture failed: {exc!r}")
                    raise

    # -- the manifest -----------------------------------------------------
    def _manifest_path(self):
        return os.path.join(self.directory, LAYOUT_VERSION, self.flavour,
                            self.fingerprint, MANIFEST)

    def _meta(self):
        return {"layout": LAYOUT_VERSION, "torch": torch.__version__,
                "cuda": torch.version.cuda, "flavour": self.flavour,
                "fingerprint": self.fingerprint}

    def _read_manifest(self):
        if self._manifest is not None or self.directory is None:
            return
        self._manifest = {}
        path = self._manifest_path()
        try:
            with open(path) as f:
                rec = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError):
            rec = None
        if (not isinstance(rec, dict) or rec.get("meta") != self._meta()
                or not isinstance(rec.get("keys"), dict)):
            self.stats["manifest_failures"] += 1
            return
        self._manifest = rec["keys"]

    def recorded_keys(self):
        """The keys that this store's manifest lists (a store on the same
        directory wrote them), as tuples; [] without one."""
        with self._lock:
            self._read_manifest()
            keys = []
            for text in sorted(self._manifest or {}):
                try:
                    key = _tuples(json.loads(text))
                except ValueError:
                    continue
                if isinstance(key, tuple) and key:
                    keys.append(key)
            return keys

    def _write_manifest(self):
        if self.directory is None:
            return
        keys = dict(self._manifest or {})
        keys.update({_key_text(k): {"launches": {w.__name__: n
                                                 for w, n in e.launches},
                                    "graph": e.graph is not None}
                     for k, e in self._entries.items()})
        path = self._manifest_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump({"meta": self._meta(), "keys": keys}, f,
                          indent=1, sort_keys=True)
            os.replace(tmp, path)   # readers see whole files
        except OSError:
            self.stats["manifest_failures"] += 1
        self._manifest = keys

    def status(self):
        return {"kind": self.kind, "fingerprint": self.fingerprint,
                "flavour": self.flavour, "directory": self.directory,
                "device": str(self.device), "capture": self.capture,
                "keys": len(self._entries),
                "entries": [{"key": repr(k),
                             "mode": "graph" if e.graph is not None
                             else "eager",
                             "source": e.source,
                             "launches_per_call": {w.__name__: n
                                                   for w, n in e.launches}}
                            for k, e in sorted(self._entries.items(),
                                               key=lambda kv: repr(kv[0]))],
                "degraded": dict(self.degraded), **self.stats}


class ExecutableStore(FunctionStore):
    """The graphs of one model's inference forward, one per bucketed input
    signature `((shape, "float32"), ...)` (one pair per model input),
    keyed `("forward", signature)`. Each graph returns the model's first
    output. The model's parameters and state are the store's bindings."""

    kind = "model-forward"

    def __init__(self, model, directory=None, capture=None):
        super().__init__(model_fingerprint(model), model._device,
                         directory=directory, capture=capture,
                         bindings=lambda: (model._params, model._state))
        self.model = model
        self.register("forward", self._forward)

    def _forward(self, *xs):
        with torch.no_grad():
            out = self.model.output(list(xs) if len(xs) > 1 else xs[0])
        return out[0] if isinstance(out, list) else out

    def _inputs(self, sig):
        return tuple(torch.zeros(shape, dtype=getattr(torch, dt),
                                 device=self.device) for shape, dt in sig)

    def ensure(self, sig):
        """The static inputs of `sig`'s graph, captured first if the
        store lacks it (a live capture once warm)."""
        key = ("forward", sig)
        if key not in self._entries:
            self.add(key, self._inputs(sig))
        return self._entries[key].args

    def warmup(self, sigs):
        """Capture `sigs` and every signature the manifest records."""
        sigs = list(sigs)
        sigs += [k[1] for k in self.recorded_keys()
                 if len(k) == 2 and k[0] == "forward" and _is_sig(k[1])
                 and k[1] not in sigs]
        return super().warmup((("forward", sig), self._inputs(sig))
                              for sig in sigs)
