"""Preemption-tolerant multi-host training (≡ the reference's
SharedTrainingMaster + EncodedGradientsAccumulator stack: multi-worker
training that survives worker churn by shipping threshold-encoded
gradients): the port of `deeplearning4j_tpu/parallel/multihost.py`, over
`torch.distributed` with one rank per device.

Four pieces:

1. **Hardened bootstrap** — `initialize()`: env-driven config
   (`DL4J_COORDINATOR`, `DL4J_NUM_PROCESSES`, `DL4J_PROCESS_ID`, or
   torchrun's `MASTER_ADDR`/`MASTER_PORT`/`WORLD_SIZE`/`RANK`), a
   `TCPStore` at the coordinator address (process 0 hosts it) reached
   with retry/backoff under a connect deadline, the default process
   group brought up on that store, and a post-init barrier with its own
   timeout. Every failure is a typed `DistributedInitError`. The same
   store carries the coordination KV (`coordination.StoreKV`) and, under
   `dl4j/pg/<epoch>`, every process group an elastic re-form brings up.

2. **The dp trainer** — `MultiHostTrainer`: `ShardedTrainer` with
   gradient accumulation (G microbatches summed on the device, one
   update per optimizer step) and the gradient split into byte-balanced
   BUCKETS (`parallel/buckets.py`); each bucket is threshold-encoded
   against its own residual and threshold (`compression`) and exchanged
   as its own asynchronous collective (an all-reduce of the dense
   {−t, 0, +t} bucket, or on `wire="sparse"` an all-gather of the
   (index, sign) token payloads), issued while the next bucket encodes.
   The per-bucket encoder state is this rank's row (a leading axis of 1)
   inside `opt_state["encoder"]`, so checkpoints carry it. `zero1=True`
   shards the base optimizer state over dp (`parallel/zero.py`).

3. **Coordinated robustness** — `CoordinatedGuardian` folds the device
   verdict windows across processes at every flush (AND of ok, max of
   gnorm), so every host climbs the same rung on the same step;
   `MultiHostRunner` drives coordinated checkpoints (every rank gathers
   the state, process 0 writes, the peers verify the manifest against
   their own copy), rollback to one verified generation, the SIGTERM
   drain, and elastic membership: a graceful leave, a join
   (`join_cluster`) and the replacement of a lost peer each tear the
   process group down and bring up a new one over the new roster (a torch
   process group cannot change its size), on a fresh store prefix.

4. **Failure containment** — the sync-point heartbeats, step agreement,
   bounded barriers and `PeerLostError` live in `coordination.py`; this
   module fires `comm.allreduce`, `wire.decode` and `host.join` and runs
   a peer autopsy on a collective failure. A dead peer must not leave a
   survivor inside a collective for the group's whole timeout: give the
   groups a timeout above the coordinator's `peer_timeout` (the sync
   point fires first), as `initialize(timeout_s=)` does by default.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.nn.updaters import apply_updates
from deeplearning4j_tpu_torch.parallel import buckets as _buckets
from deeplearning4j_tpu_torch.parallel import compression as _compression
from deeplearning4j_tpu_torch.parallel import coordination as _coord
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel import zero as _zero
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, P
from deeplearning4j_tpu_torch.parallel.sharded_trainer import (
    _NODE, ShardedTrainer, _flat, _paths, accumulate_grads)
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience import guardian as _guardian
from deeplearning4j_tpu_torch.resilience.errors import (
    CheckpointIntegrityError, DistributedInitError, MembershipChangeError,
    PeerDesyncError, PeerLostError, PreemptionSignal)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy

__all__ = [
    "CoordinatedGuardian", "ElasticMembership", "GroupMeshFactory",
    "MultiHostRunner", "MultiHostTrainer", "global_batch", "initialize",
    "initialized", "process_id", "reform_group", "PeerCoordinator",
    "PeerMonitor", "LocalKV", "StoreKV", "install_preemption_handler",
]

# re-export the coordination plane under the one module name users reach
# for
PeerCoordinator = _coord.PeerCoordinator
PeerMonitor = _coord.PeerMonitor
LocalKV = _coord.LocalKV
StoreKV = _coord.StoreKV
install_preemption_handler = _coord.install_preemption_handler
from deeplearning4j_tpu_torch.parallel.membership import (  # noqa: E402
    ElasticMembership)


def __getattr__(name):
    # `multihost.ACTIVE` always reflects the LIVE coordination switch
    if name == "ACTIVE":
        return _coord.ACTIVE
    raise AttributeError(name)


def _debug(*parts):
    """Bring-up tracing for multi-process runs (`DL4J_MH_DEBUG=1`)."""
    if os.environ.get("DL4J_MH_DEBUG"):
        import sys
        print(f"[mh p{process_id()}]", *parts, file=sys.stderr, flush=True)


# =========================== bootstrap ==================================
#: the store `initialize` connected (process 0 hosts it) and the group
#: settings every re-formed group reuses
_STORE = None
_GROUP = {"backend": None, "timeout_s": None, "device": None}

#: group timeout `initialize` defaults to: above the default peer timeout
#: (60 s), so a sync point reports a dead peer before a collective times
#: out
DEFAULT_GROUP_TIMEOUT_S = 120.0


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def initialized():
    """True once a process group is up (by us or a launcher)."""
    return dist.is_available() and dist.is_initialized()


def process_id():
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if initialized() else 0


def _parse(address):
    address = address.split("://", 1)[-1]
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise DistributedInitError(
            f"coordinator address {address!r} is not host:port")
    return host, int(port)


def _init_group(store, prefix, rank, world, backend, timeout_s, device):
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(device if device is not None
                                       else f"cuda:{rank % max(1, torch.cuda.device_count())}")
    dist.init_process_group(
        backend, store=dist.PrefixStore(prefix, store), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def _teardown():
    """Destroy the default group; never waits on a dead peer (a NCCL group
    is aborted)."""
    if not initialized():
        return
    try:
        if dist.get_backend() == "nccl":
            from torch.distributed import distributed_c10d as c10d
            abort = getattr(c10d, "_abort_process_group", None)
            if abort is not None:
                abort()
                return
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — a broken group is gone either way
        pass


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, connect_deadline=None,
               barrier_timeout=None, retry_policy=None, backend=None,
               timeout_s=None, device=None):
    """Hardened multi-host bring-up. Config falls back to env vars
    (`DL4J_COORDINATOR` / `DL4J_NUM_PROCESSES` / `DL4J_PROCESS_ID`, then
    torchrun's `MASTER_ADDR:MASTER_PORT` / `WORLD_SIZE` / `RANK`); with
    no coordinator configured at all this is a silent single-process
    no-op (returns False) so the same entrypoint runs everywhere.

    - the store: process 0 hosts a `TCPStore` at the address, the others
      connect to it, retried with backoff (`resilience.RetryPolicy`)
      under a total `connect_deadline` (env `DL4J_CONNECT_DEADLINE`,
      default 120 s); a half-made group is torn down between attempts;
    - the default process group on that store (prefix `dl4j/pg/0`),
      `backend` NCCL on CUDA else gloo, with a `timeout_s` timeout
      (default `DEFAULT_GROUP_TIMEOUT_S`);
    - a post-init barrier and a world-size agreement check, each with its
      own timeout (env `DL4J_BARRIER_TIMEOUT`, default 60 s);
    - every failure raises the typed `DistributedInitError`.

    Also registers the process id with `resilience.faults` and makes the
    store the coordination KV's default client."""
    global _STORE
    coordinator_address = coordinator_address or _env("DL4J_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if coordinator_address is None:
        return False
    if initialized():
        # a launcher brought the group up itself: still honor the
        # documented side effect so FaultPlan seeds stay process-aware
        if _faults.PROCESS_ID is None:
            _faults.PROCESS_ID = dist.get_rank()
        return True
    if num_processes is None:
        v = _env("DL4J_NUM_PROCESSES", "WORLD_SIZE")
        num_processes = int(v) if v is not None else None
    if process_id is None:
        v = _env("DL4J_PROCESS_ID", "RANK")
        process_id = int(v) if v is not None else None
    if num_processes is None or process_id is None:
        raise DistributedInitError(
            f"coordinator {coordinator_address} given but no "
            f"{'number of processes' if num_processes is None else 'process id'}"
            f": set DL4J_NUM_PROCESSES and DL4J_PROCESS_ID (or WORLD_SIZE "
            f"and RANK)")
    num_processes, process_id = int(num_processes), int(process_id)
    try:
        connect_deadline = float(
            connect_deadline if connect_deadline is not None
            else os.environ.get("DL4J_CONNECT_DEADLINE", "120"))
    except ValueError:
        connect_deadline = 120.0
    try:
        barrier_timeout = float(
            barrier_timeout if barrier_timeout is not None
            else os.environ.get("DL4J_BARRIER_TIMEOUT", "60"))
    except ValueError:
        barrier_timeout = 60.0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout_s = float(timeout_s or DEFAULT_GROUP_TIMEOUT_S)
    host, port = _parse(coordinator_address)
    policy = retry_policy or RetryPolicy(
        max_attempts=8, initial_backoff=0.5, max_backoff=5.0,
        deadline=connect_deadline, seed=process_id)
    attempt_timeout = max(5, int(connect_deadline / policy.max_attempts))
    made = {}

    def attempt():
        try:
            # under torchrun the agent already hosts the store at the
            # master port: every rank is a client then
            master = process_id == 0 and os.environ.get(
                "TORCHELASTIC_USE_AGENT_STORE") != "True"
            store = dist.TCPStore(
                host, port, num_processes, master,
                timeout=datetime.timedelta(seconds=attempt_timeout),
                wait_for_workers=False)
            _init_group(store, "dl4j/pg/0", process_id, num_processes,
                        backend, timeout_s, device)
            made["store"] = store
        except Exception:
            _teardown()     # a half-made group before the retry
            raise

    try:
        policy.call(attempt, label="distributed.init")
    except Exception as e:
        raise DistributedInitError(
            f"process {process_id}/{num_processes}: could not join "
            f"coordinator {coordinator_address} within "
            f"{connect_deadline:.0f} s: {e}") from e
    store = made["store"]
    client = _coord.StoreKV(store, num_processes=num_processes)

    def post_init_failure(err):
        """A failed bring-up leaves no half-formed group behind: a retry
        would otherwise hit the already-initialized fast path and hang in
        the first collective."""
        _teardown()
        return err

    if dist.get_world_size() != num_processes:
        raise post_init_failure(DistributedInitError(
            f"cluster shape mismatch: requested {num_processes} processes "
            f"but the group formed {dist.get_world_size()}"))
    try:
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.COMM_BARRIER)
        client.wait_at_barrier("dl4j/init/sanity",
                               int(barrier_timeout * 1000),
                               expected=num_processes)
    except Exception as e:
        raise post_init_failure(DistributedInitError(
            f"process {process_id}/{num_processes}: post-init sanity "
            f"barrier not reached by all processes within "
            f"{barrier_timeout:.0f} s: {e}")) from e
    _STORE = store
    _GROUP.update(backend=backend, timeout_s=timeout_s, device=device)
    _coord._CLIENT = client
    _faults.PROCESS_ID = process_id
    if _mon.enabled():
        _mon.get_registry().gauge(
            _mon.DIST_PEERS,
            help="peer processes seen at the last sync point") \
            .set(num_processes)
    return True


def reform_group(members, process_id, epoch, store=None, backend=None,
                 timeout_s=None, device=None):
    """Tear the default process group down and, when `process_id` is in
    `members`, bring up a new one over them (rank = its place in the
    sorted roster) on the store prefix `dl4j/pg/<epoch>`: every member
    calls this with the same roster and epoch. Returns True when this
    process is in the new group."""
    store = store if store is not None else _STORE
    if store is None:
        raise DistributedInitError(
            "reform_group needs the store `initialize` connected (or one "
            "passed in)")
    members = sorted(int(p) for p in members)
    backend = backend or _GROUP["backend"] or (
        "nccl" if torch.cuda.is_available() else "gloo")
    timeout_s = float(timeout_s or _GROUP["timeout_s"]
                      or DEFAULT_GROUP_TIMEOUT_S)
    device = device if device is not None else _GROUP["device"]
    _teardown()
    if int(process_id) not in members:
        return False
    _debug("re-forming group", members, "epoch", epoch)
    _init_group(store, f"dl4j/pg/{int(epoch)}", members.index(int(process_id)),
                len(members), backend, timeout_s, device)
    return True


class GroupMeshFactory:
    """The `mesh_factory` of an elastic `MultiHostRunner` in the port:
    called with the new roster at an agreed boundary, it re-forms the
    default process group over it (`reform_group`, at the coordinator's
    membership epoch) and returns a `DeviceMesh` with one dp rank per
    member. `release()` tears the group down on a host that leaves."""

    def __init__(self, coordinator, axis="dp", store=None, backend=None,
                 timeout_s=None, device=None):
        self.coordinator = coordinator
        self.axis = axis
        self.store, self.backend = store, backend
        self.timeout_s, self.device = timeout_s, device

    def __call__(self, members):
        m = self.coordinator.membership
        reform_group(members, self.coordinator.process_id,
                     m.epoch if m is not None else 0, store=self.store,
                     backend=self.backend, timeout_s=self.timeout_s,
                     device=self.device)
        return DeviceMesh(device=self.device, **{self.axis: len(members)})

    def release(self):
        _teardown()


# ======================= the dp trainer =================================
def global_batch(mesh, tree, axis="dp", accumulation=1):
    """This rank's rows of a global batch every host holds in full (the
    lockstep data recipe: every host makes the same batch, each keeps its
    own rows), as tensors on the mesh's device. With accumulation > 1 the
    leaves carry a leading microbatch axis (G, B, ...) and dim 1 splits
    (as `ShardedTrainer.shard_batch`)."""
    mesh = getattr(mesh, "mesh", mesh)
    dim = 1 if int(accumulation) > 1 else 0
    n = mesh.shape.get(axis, 1)

    def put(a):
        t = _mesh._as_tensor(a, mesh.device)
        return _mesh._local_slice(t, dim, mesh.index(axis), n).clone()

    return _mesh._tree_map(put, tree)


class MultiHostTrainer(ShardedTrainer):
    """`ShardedTrainer` with accumulated, bucketed, threshold-encoded
    gradient exchange: each optimizer step

    1. sums `accumulation` microbatches' gradients on the device;
    2. splits the summed gradient into byte-balanced buckets
       (`parallel/buckets.py`), each one flat tensor;
    3. per bucket: threshold-encodes against that bucket's OWN residual
       and adaptive threshold (≡ EncodedGradientsAccumulator, chunked),
       then issues its collective asynchronously — an all-reduce of the
       {−t, 0, +t} bucket (`wire="dense"`) or an all-gather of the token
       payloads (`wire="sparse"`, `compression.sparse_encode`) — before
       the next bucket encodes; the waits come after the last issue
       (`exchange_log` records the order for
       `buckets.check_overlap_structure`).

    The encoder state (per bucket: a flat residual, a threshold and a
    wire count) is this rank's row, shape (1, ...), inside
    `opt_state["encoder"]`; the runner gathers the rows of all ranks
    into (dp, ...) stacks for a checkpoint.

    `compress=False` without an explicit bucket request is the plain
    ShardedTrainer step (one all-reduce); with `buckets=`/`bucket_bytes=`
    it runs the bucketed exchange on RAW gradients. `zero1=True` shards
    the BASE optimizer state over dp (`parallel/zero.py`).
    """

    def __init__(self, loss_fn, updater, mesh=None, param_specs=None,
                 batch_axis="dp", donate=True, compress=True,
                 compression_kw=None, zero1=False, accumulation=1,
                 buckets=None, bucket_bytes=None, wire="dense",
                 wire_capacity=0.05):
        if mesh is None:
            world = dist.get_world_size() if initialized() else 1
            mesh = DeviceMesh(**{batch_axis: world})
        super().__init__(loss_fn, updater, mesh, param_specs=param_specs,
                         batch_axis=batch_axis, donate=donate,
                         accumulation=accumulation)
        self.compress = bool(compress)
        self.zero1 = bool(zero1)
        self._compression_kw = dict(compression_kw or {})
        self._enc = (_compression.threshold_encoding(**self._compression_kw)
                     if self.compress else None)
        self._num_buckets = buckets
        self._bucket_bytes = bucket_bytes
        if wire not in ("dense", "sparse"):
            raise ValueError(f"wire must be 'dense' or 'sparse', got "
                             f"{wire!r}")
        if wire == "sparse" and not self.compress:
            raise ValueError("wire='sparse' ships threshold-encoded "
                             "tokens — it requires compress=True")
        self.wire = wire
        #: per-bucket token capacity: a float = fraction of the bucket's
        #: elements, or an int = absolute slots
        self._wire_capacity = wire_capacity
        #: the explicit exchange runs whenever encoding OR bucketing is
        #: requested; otherwise ShardedTrainer's one all-reduce
        self._explicit = (self.compress or buckets is not None
                          or bucket_bytes is not None)
        self.bucket_plan = None
        #: the phase order of the last step's exchange (scope names)
        self.exchange_log = []
        #: set True to keep the last step's per-bucket (flat local
        #: gradient, shipped payload, delivered mean) in `last_exchange`
        self.keep_exchange = False
        self.last_exchange = None

    @property
    def dp(self):
        """The dp width: ranks in the batch axis."""
        return int(self.mesh.shape.get(self.batch_axis, 1))

    def wire_caps(self):
        """Per-bucket wire token capacities (sparse wire only)."""
        plan = self.bucket_plan
        if self.wire != "sparse" or plan is None:
            return None
        if isinstance(self._wire_capacity, float):
            return [_compression.wire_capacity(plan.bucket_elems[b],
                                               self._wire_capacity)
                    for b in range(plan.num_buckets)]
        return [max(1, min(int(plan.bucket_elems[b]),
                           int(self._wire_capacity)))
                for b in range(plan.num_buckets)]

    def rebuild(self, mesh):
        """A fresh trainer with this one's configuration on a DIFFERENT
        mesh — the elastic re-form primitive (the plan is pure tree
        structure and carries over)."""
        clone = type(self)(
            self.loss_fn, self.tx, mesh=mesh,
            param_specs=self.param_specs, batch_axis=self.batch_axis,
            donate=self._donate, compress=self.compress,
            compression_kw=self._compression_kw, zero1=self.zero1,
            accumulation=self.accumulation, buckets=self._num_buckets,
            bucket_bytes=self._bucket_bytes, wire=self.wire,
            wire_capacity=self._wire_capacity)
        clone.bucket_plan = self.bucket_plan
        clone.keep_exchange = self.keep_exchange
        return clone

    # -- bucket plan ------------------------------------------------------
    def _ensure_plan(self, tree):
        """Build (once) the byte-balanced plan from the parameter tree's
        shapes — host metadata only."""
        if self.bucket_plan is None:
            self.bucket_plan = _buckets.plan_buckets(
                tree, num_buckets=self._num_buckets,
                bucket_bytes=self._bucket_bytes)
            if _mon.enabled():
                reg = _mon.get_registry()
                reg.gauge(_mon.DIST_EXCHANGE_BUCKETS,
                          help="independent collectives the gradient "
                               "exchange is split into").set(
                    self.bucket_plan.num_buckets)
                reg.gauge(_mon.DIST_BUCKET_BYTES,
                          help="largest planned bucket payload (bytes) "
                               "— the byte-balance quality").set(
                    max(self.bucket_plan.bucket_bytes))
        return self.bucket_plan

    # -- state -----------------------------------------------------------
    def _init_encoder_state(self, params):
        """This rank's row of the per-bucket encoder state: a flat
        residual (1, elems) per bucket, thresholds and wire counts (1,
        buckets)."""
        plan = self._ensure_plan(params)
        dev = self.mesh.device
        thr0 = float(self._compression_kw.get(
            "initial_threshold", _compression.DEFAULT_INITIAL_THRESHOLD))
        residual = {str(b): torch.zeros((1, plan.bucket_elems[b]),
                                        dtype=plan.bucket_dtype(b),
                                        device=dev)
                    for b in range(plan.num_buckets)}
        return {"residual": residual,
                "threshold": torch.full((1, plan.num_buckets), thr0,
                                        dtype=torch.float32, device=dev),
                "nnz": torch.zeros((1, plan.num_buckets), dtype=torch.int32,
                                   device=dev)}

    def init(self, params):
        params = self.shard_params(params)
        base = self.tx.init(_flat(params))
        if self.zero1:
            base = _zero.shard_optimizer_state(base, self.mesh,
                                               axis=self.batch_axis)
        if self._explicit:
            self._ensure_plan(params)
        if not self.compress:
            return params, base
        return params, {"base": base,
                        "encoder": self._init_encoder_state(params)}

    def state_specs(self, params, opt_state):
        """ShardedTrainer's specs, and the encoder's rows stacked over the
        batch axis (and their flat buckets over the one other axis that
        shards the parameters, whose ranks hold different shards)."""
        if not (self.compress and _is_encoder(opt_state)):
            return super().state_specs(params, opt_state)
        out = super().state_specs(params, opt_state["base"])
        specs = self._specs or self._path_specs(params)
        others = sorted({n for s in specs.values() for n in s
                         if n not in (None, self.batch_axis)
                         and self.mesh.shape.get(n, 1) > 1})
        if len(others) > 1:
            raise ValueError(
                f"the encoder rows of parameters sharded over {others} "
                "cannot be checkpointed: at most one axis besides "
                f"{self.batch_axis!r}")
        enc = P(self.batch_axis, *others)
        out["opt_state"] = {"base": out["opt_state"],
                            "encoder": _mesh._tree_map(
                                lambda _: enc, opt_state["encoder"])}
        return out

    # -- the bucketed exchange -------------------------------------------
    def _issue(self, sent, group, n):
        """Start one bucket's collective; returns what `_finish` needs."""
        if group is None:
            return (None, sent, None)
        buf, host = _mesh._staged(sent, group)
        if self.wire == "sparse":
            parts = [torch.empty_like(buf) for _ in range(n)]
            work = dist.all_gather(parts, buf, group=group, async_op=True)
            return (work, parts, host)
        work = dist.all_reduce(buf, group=group, async_op=True)
        return (work, buf, host)

    def _finish(self, issued, b, n, device):
        plan = self.bucket_plan
        work, out, host = issued
        if work is not None:
            work.wait()
        if self.wire == "sparse":
            rows = torch.stack(out) if isinstance(out, list) else out[None]
            rows = rows.to(device) if host else rows
            return _compression.sparse_decode(rows, plan.bucket_elems[b],
                                              plan.bucket_dtype(b))
        out = out.to(device) if host else out
        return out / n if n > 1 else out

    def _exchange(self, flats, enc):
        """Per bucket: encode (against this rank's bucket state when
        compressing), issue its collective, then the next; wait for all
        after the last issue. Returns ([delivered dp mean per bucket],
        new encoder state or None)."""
        plan = self.bucket_plan
        group = self.mesh.group(self.batch_axis)
        n = self.dp
        sparse = self.wire == "sparse"
        caps = self.wire_caps() if sparse else None
        adapt_kw = {k: v for k, v in self._compression_kw.items()
                    if k != "initial_threshold"}
        log = self.exchange_log = []
        issued, sents, res2, thr2, nnz2 = [], [], {}, [], []
        for b in range(plan.num_buckets):
            flat = flats[b]
            name = _buckets.ENCODE_SCOPE.format(b=b)
            log.append(name)
            with torch.profiler.record_function(name):
                if enc is None:
                    sent = flat
                else:
                    st = {"residual": enc["residual"][str(b)][0],
                          "threshold": enc["threshold"][0, b],
                          "nnz": enc["nnz"][0, b]}
                    if sparse:
                        sent, st2 = _compression.sparse_encode(
                            flat, st, caps[b], **adapt_kw)
                        r2 = st2["residual"]
                    else:
                        sl, st2 = self._enc.update(
                            [flat], {"residual": [st["residual"]],
                                     "threshold": st["threshold"],
                                     "nnz": st["nnz"]}, None)
                        sent, r2 = sl[0], st2["residual"][0]
                    res2[str(b)] = r2[None]
                    thr2.append(st2["threshold"])
                    nnz2.append(st2["nnz"])
            sents.append(sent)
            name = _buckets.EXCHANGE_SCOPE.format(b=b)
            log.append(name)
            with torch.profiler.record_function(name):
                issued.append(self._issue(sent, group, n))
        outs = []
        for b, iss in enumerate(issued):
            name = _buckets.WAIT_SCOPE.format(b=b)
            log.append(name)
            with torch.profiler.record_function(name):
                outs.append(self._finish(iss, b, n, flats[b].device))
        if self.keep_exchange:
            self.last_exchange = [
                {"flat": f.detach().clone(), "sent": s.detach().clone(),
                 "delivered": o.detach().clone()}
                for f, s, o in zip(flats, sents, outs)]
        if enc is None:
            return outs, None
        return outs, {"residual": res2,
                      "threshold": torch.stack(thr2)[None],
                      "nnz": torch.stack(nnz2).to(torch.int32)[None]}

    def _pmean(self, loss):
        group = self.mesh.group(self.batch_axis)
        if group is None or self.dp == 1:
            return loss
        return _mesh._all_reduce(loss.reshape(1), group, fresh=True)[0] \
            / self.dp

    def _step(self, params, opt_state, batch, generator, guard):
        if not self._explicit:
            return super()._step(params, opt_state, batch, generator, guard)
        plan = self.bucket_plan
        if plan is None:
            raise RuntimeError("bucket plan not built — call init() "
                               "before the first step")
        local = dict(_paths(params))
        grads, loss, ok_micro = accumulate_grads(
            self._gathered_loss, params, batch, generator, self.accumulation)
        grads = dict(grads)
        # a NaN fails every `>= threshold` compare, so encoding it would
        # ship zeros while poisoning the residual: poison the loss
        # instead, so every rank's guarded verdict fails and the encoder
        # state is not written
        ok_local = ok_micro & torch.isfinite(_guardian.global_norm(grads))
        loss = torch.where(ok_local, loss,
                           torch.full_like(loss, float("nan")))
        enc = opt_state["encoder"] if self.compress else None
        base = opt_state["base"] if self.compress else opt_state
        outs, enc2 = self._exchange(plan.concat(grads), enc)
        loss = self._pmean(loss)
        g = plan.split(outs)
        mesh = self.mesh
        for p in g:
            rep = 1
            for name in self._specs.get(p, P()):
                if name is not None and mesh.group(name) is not None:
                    rep *= mesh.shape[name]
            if rep != 1:
                g[p] = g[p] / rep
        fparams, fgrads = {_NODE: local}, {_NODE: g}
        lr_scale = guard[0] if guard is not None else None
        gnorm = ok = None
        if guard is not None:
            gnorm = self._gnorm(g)
            ok = _guardian.healthy(loss, gnorm, guard[1])
        extra = [(enc2, enc)] if enc is not None else []
        if isinstance(base, _zero.ZeroState):
            _zero.zero_apply(self.tx, fgrads, base, fparams, lr_scale, ok,
                             extra=extra)
        else:
            updates, state_new = self.tx.update(fgrads, base, fparams)
            if lr_scale is not None:
                ups = [u for d in updates.values() for u in d.values()]
                torch._foreach_mul_(ups, lr_scale)
            _guardian.write_where(ok, [
                (apply_updates(fparams, updates), fparams),
                (state_new, base)] + extra)
        return loss, gnorm, ok

    def fit_batch(self, params, opt_state, batch, rng=None):
        if self._explicit and _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.COMM_ALLREDUCE)
            if self.wire == "sparse":
                _faults.ACTIVE.fire(_faults.WIRE_DECODE)
        try:
            return super().fit_batch(params, opt_state, batch, rng)
        except (PeerLostError, PreemptionSignal):
            raise
        except Exception as e:  # noqa: BLE001 — autopsy, then re-raise
            c = _coord.ACTIVE
            if c is not None and len(c.members) > 1:
                c.autopsy(e)   # raises PeerLostError or re-raises e
            raise

    # -- telemetry -------------------------------------------------------
    def encoder_stats(self, opt_state):
        """The compression wire telemetry over every rank (one small
        all-reduce and one host read — call at sync cadence, on every
        rank): mean adaptive threshold, elements shipped last step,
        residual norm, and the per-bucket wire ledger."""
        if not self.compress:
            return None
        enc = opt_state["encoder"]
        plan = self.bucket_plan
        nb = plan.num_buckets
        sq = sum((r.float() ** 2).sum() for r in enc["residual"].values())
        vec = torch.cat([enc["threshold"].float().reshape(-1),
                         enc["nnz"].double().reshape(-1).float(),
                         sq.reshape(1)])
        group = self.mesh.group(self.batch_axis)
        n = self.dp
        if group is not None and n > 1:
            vec = _mesh._all_reduce(vec, group, fresh=True)
        host = vec.double().cpu().numpy()
        bucket_nnz = [int(round(v)) for v in host[nb:2 * nb]]
        out = {"threshold": float(host[:nb].sum() / (n * nb)),
               "nnz": int(sum(bucket_nnz)),
               "residual_norm": float(np.sqrt(host[2 * nb])),
               "bucket_nnz": bucket_nnz}
        # an encoded element ships as (index, sign): 4 bytes on the wire
        out["encoded_bytes"] = out["nnz"] * 4
        out["bucket_encoded_bytes"] = [v * 4 for v in bucket_nnz]
        if self.wire == "sparse":
            caps = self.wire_caps()
            out["wire_capacity"] = list(caps)
            out["bucket_wire_bytes"] = [
                _compression.wire_payload_bytes(c) * n for c in caps]
            out["wire_bytes"] = int(sum(out["bucket_wire_bytes"]))
            out["dense_bytes"] = int(sum(
                plan.bucket_elems[b] * torch.empty(
                    (), dtype=plan.bucket_dtype(b)).element_size()
                for b in range(nb)) * n)
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.DIST_ENCODED_BYTES,
                        help="approximate bytes of threshold-encoded "
                             "gradient shipped cross-host").inc(
                out["encoded_bytes"])
            reg.gauge(_mon.DIST_RESIDUAL_NORM,
                      help="global norm of the un-sent gradient "
                           "residual").set(out["residual_norm"])
            if self.wire == "sparse":
                reg.gauge(_mon.DIST_WIRE_BYTES,
                          help="actual per-step bytes on the sparse "
                               "ragged wire (all workers, all buckets: "
                               "capacity + header slots)") \
                    .set(out["wire_bytes"])
            if n > 1:
                ms = self._derived_exchange_ms()
                if ms is not None:
                    out["exposed_exchange_ms_derived"] = ms
                    reg.gauge(_mon.DIST_EXPOSED_EXCHANGE_MS,
                              help="exposed cost of the bucketed "
                                   "exchange").set(ms)
            else:
                out["exposed_exchange_ms"] = self._probe_exchange(enc)
                reg.gauge(_mon.DIST_EXPOSED_EXCHANGE_MS,
                          help="exposed cost of the bucketed exchange"
                          ).set(out["exposed_exchange_ms"])
        return out

    def _probe_exchange(self, enc):
        """Wall ms of the exchange alone (encode + collectives on zero
        gradients, a copy of the encoder state): the upper bound of what
        the overlapped schedule can hide. One rank only (a collective a
        subset of ranks issues would hang)."""
        plan = self.bucket_plan
        zeros = [torch.zeros(plan.bucket_elems[b], dtype=plan.bucket_dtype(b),
                             device=self.mesh.device)
                 for b in range(plan.num_buckets)]
        copy = _mesh._tree_map(lambda t: t.clone(), enc)
        log = self.exchange_log
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        t0 = time.perf_counter()
        self._exchange(zeros, copy)
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        self.exchange_log = log
        return (time.perf_counter() - t0) * 1e3

    @staticmethod
    def _derived_exchange_ms():
        """Multi-process exposed-exchange estimate off the straggler
        plane's published timelines."""
        coord = _coord.ACTIVE
        if coord is None:
            return None
        try:
            from deeplearning4j_tpu_torch.monitoring import stragglers as _sg
            return _sg.derived_exchange_ms(coord)
        except Exception:  # noqa: BLE001
            return None


# ===================== coordinated robustness ===========================
class CoordinatedGuardian(_guardian.TrainingGuardian):
    """TrainingGuardian whose verdict flush is folded across processes:
    each host publishes its materialized (gnorm, ok) window, gathers every
    peer's, and folds them (AND of ok, max of gnorm — NaN-poisoning
    preserved). Every host therefore feeds the IDENTICAL window into the
    escalation ladder and reaches the same skip / LR-backoff / rollback
    decision on the same step. A peer that never publishes its window
    within the peer timeout is a lost peer (`PeerLostError`), a window of
    a different length a desynced one (`PeerDesyncError`)."""

    def __init__(self, coordinator, **kw):
        kw.setdefault("check_every", coordinator.sync_every)
        super().__init__(**kw)
        self.coordinator = coordinator
        self._flushes = 0

    def _materialize(self):
        import json
        gnorms, oks, retryables = super()._materialize()
        c = self.coordinator
        if c is None or len(c.members) <= 1:
            return gnorms, oks, retryables
        n = self._flushes
        self._flushes += 1
        c.publish(f"gv/{n}/{c.process_id}",
                  json.dumps({"g": [float(x) for x in gnorms],
                              "ok": [bool(x) for x in oks]}))
        gnorms = np.asarray(gnorms, np.float32)
        oks = np.asarray(oks, bool)
        for pid in c.members:
            if pid == c.process_id:
                continue
            try:
                peer = json.loads(c.fetch(f"gv/{n}/{pid}"))
            except Exception as e:  # noqa: BLE001
                raise c._peer_lost_error(
                    f"verdict flush {n}: no window from process {pid} "
                    f"within {c.peer_timeout:.1f} s", cause=e) from e
            if len(peer["ok"]) != len(oks):
                raise c.desync_error(
                    f"verdict flush {n}: process {pid} flushed "
                    f"{len(peer['ok'])} verdicts, this process "
                    f"{len(oks)} — the guarded-step cadence desynced")
            gnorms = np.maximum(gnorms, np.asarray(peer["g"], np.float32))
            oks = np.logical_and(oks, np.asarray(peer["ok"], bool))
        if n >= 2:
            try:
                c._client.key_value_delete(
                    c._key(f"gv/{n - 2}/{c.process_id}"))
            except Exception:  # noqa: BLE001
                pass
        return gnorms, oks, retryables


# ---- host snapshots and re-placement ----------------------------------------
def _host_zeros(tree):
    return _mesh._tree_map(
        lambda a: torch.zeros(tuple(a.shape), dtype=a.dtype)
        if torch.is_tensor(a) else a, tree)


def _is_encoder(opt_state):
    return isinstance(opt_state, dict) and "encoder" in opt_state


class MultiHostRunner:
    """Coordinated driver for a `MultiHostTrainer` loop: periodic
    coordinated checkpoints (every rank gathers the state, process 0
    writes, the peers verify the manifest against their own copy),
    guardian rollbacks that land every host on the same verified
    generation, the preemption drain (agree at a sync point → final
    verified checkpoint → `PreemptionSignal` unwinds the fit loop for a
    clean exit), and, with `elastic=True`, membership changes.

        runner = MultiHostRunner(trainer, dir, coordinator,
                                 guardian=CoordinatedGuardian(coord))
        params, opt_state = runner.resume_or_init(init_params)
        while runner.step < total_steps:
            params, opt_state, loss = runner.fit_batch(
                params, opt_state, make_batch(runner.step))

    `rng=None` in `fit_batch` gives the step a torch.Generator on the
    trainer's device seeded from (rng_seed, step), so a resumed run
    replays the same dropout draws. A checkpoint holds the parameters
    and the optimizer state with the encoder rows of every rank stacked
    (dp, ...). `mesh_factory(members)` re-forms the dp mesh (in the port,
    `GroupMeshFactory`: a new process group per roster). A ZeRO-1
    trainer is refused (its sharded state is not gathered for saves).
    """

    def __init__(self, trainer, directory, coordinator, save_every=10,
                 guardian=None, verify_saves=True, max_to_keep=5,
                 rng_seed=0, monitor=True, sigterm=True,
                 elastic=False, mesh_factory=None, membership=None):
        from deeplearning4j_tpu_torch.parallel.elastic import \
            ElasticCheckpointer
        self.trainer = trainer
        self.coordinator = coordinator
        self.directory = str(directory)
        self.save_every = int(save_every)
        self.guardian = guardian
        self.verify_saves = bool(verify_saves)
        self.primary = coordinator.process_id == 0
        multi = coordinator.num_processes > 1
        if getattr(trainer, "zero1", False):
            raise ValueError(
                "MultiHostRunner with a zero1 trainer is unsupported: its "
                "ZeRO-1 optimizer-state blocks are not gathered for "
                "coordinated saves, and elastic re-forms would re-shard "
                "the partitioned state mid-run")
        self.elastic = bool(elastic)
        self.mesh_factory = mesh_factory
        self.membership = None
        self._replaces = 0
        if self.elastic:
            if mesh_factory is None:
                raise ValueError(
                    "elastic=True needs a mesh_factory(members) -> mesh "
                    "so the dp mesh can re-form when membership changes "
                    "(GroupMeshFactory re-forms the process group)")
            self.membership = membership if membership is not None \
                else ElasticMembership(coordinator)
        # single writer: process 0 owns the directory, the peers open it
        # read-only for restore + manifest verification
        self.ckpt = ElasticCheckpointer(
            directory, max_to_keep=max_to_keep, save_interval_steps=1,
            sweep_orphans=self.primary,
            primary_only=multi and self.primary,
            read_only=multi and not self.primary)
        self.step = 0
        self.resumed_step = None
        self._save_seq = 0
        self.rng_seed = int(rng_seed)
        self._last_host_state = None
        self._last_opt_state = None
        #: (step, seconds, bytes) of the last coordinated save
        self.last_save = None
        coordinator.driver_attached = True
        coordinator.bind(trainer)   # auxiliary local fits don't count
        coordinator.install()
        coordinator.on_sync = self._on_sync
        if monitor:
            coordinator.start_monitor()
        self._prev_signals = None
        if sigterm:
            try:
                self._prev_signals = \
                    _coord.install_preemption_handler(coordinator)
            except ValueError:
                # the signal API is main-thread-only
                pass
        if guardian is not None:
            guardian.driver_attached = True
            guardian.bind(trainer)
            guardian.install()

    # -- host snapshot (the coordinated-save core) -----------------------
    def _host_state(self, params, opt_state):
        """Every rank gathers the whole state on the host by the trainer's
        `state_specs`: sharded parameters and their moments, and the
        encoder rows (all-gathered over dp); replicated leaves are host
        copies. Every rank ends up with the identical full state —
        process 0 saves it, the others verify the manifest against it."""
        from deeplearning4j_tpu_torch.parallel.elastic import host_state
        tr = self.trainer
        return host_state(tr.mesh, {"params": params,
                                    "opt_state": opt_state},
                          tr.state_specs(params, opt_state))

    def _like_host(self, like_live, dp=None):
        """Host zeros in the layout a checkpoint holds: every leaf whole,
        the encoder stacks `dp` rows (default the trainer's width)."""
        from deeplearning4j_tpu_torch.parallel.elastic import whole_zeros
        tr = self.trainer
        out = whole_zeros(tr.mesh, like_live, tr.state_specs(
            like_live["params"], like_live["opt_state"]))
        if dp is not None and _is_encoder(out["opt_state"]):
            out["opt_state"]["encoder"] = _mesh._tree_map(
                lambda t: torch.zeros((int(dp),) + tuple(t.shape[1:]),
                                      dtype=t.dtype),
                out["opt_state"]["encoder"])
        return out

    # -- save ------------------------------------------------------------
    def _save(self, params, opt_state, wait=False):
        g = self.guardian
        if g is not None and not g.verify_now():
            if _mon.enabled():
                _mon.get_registry().counter(
                    _mon.GUARDIAN_SAVES_GATED,
                    help="checkpoint saves withheld because the "
                         "guardian could not vouch for the params").inc()
            return False
        t0 = time.perf_counter()
        # EVERY rank gathers, even a peer with verify_saves=False: the
        # gather is a collective the primary's would otherwise wait on
        host = self._host_state(params, opt_state)
        self._last_host_state = host
        if self.primary:
            self.ckpt.save(self.step, host["params"], host["opt_state"],
                           wait=wait,
                           verdict=None if g is None else "verified")
        if self.coordinator.num_processes > 1:
            # the primary wrote the manifest before its save returned, so
            # once it reaches this fence the peers can verify it
            self._save_seq += 1
            self.coordinator.barrier(f"save/{self.step}/{self._save_seq}")
            if not self.primary and self.verify_saves:
                self._verify_manifest(self.step, host)
        nbytes = sum(int(t.numel()) * t.element_size()
                     for _, t in _integrity_flat(host))
        self.last_save = (self.step, time.perf_counter() - t0, nbytes)
        return True

    def _fetch_decision(self, key, what):
        """Wait for a control decision process 0 publishes AFTER a
        potentially long local phase (checkpoint scan, rollback restore),
        bounded by process 0's LIVENESS (monitor beats) rather than by
        the size of its work, under a hard ceiling."""
        c = self.coordinator
        slice_s = min(c.barrier_timeout, 15.0)
        start = time.monotonic()
        hard_cap = max(4.0 * c.barrier_timeout, 2.0 * c.peer_timeout)
        while True:
            try:
                return c.fetch(key, timeout=slice_s)
            except Exception as e:  # noqa: BLE001 — timeout slice over
                waited = time.monotonic() - start
                try:
                    alive = c.alive_info()
                except Exception as kv_err:  # noqa: BLE001 — service gone
                    raise c._peer_lost_error(
                        f"coordination service unreachable while "
                        f"waiting for the {what} decision — the "
                        f"coordinator process likely died ({kv_err})",
                        cause=e) from e
                if waited > hard_cap:
                    raise c._peer_lost_error(
                        f"no {what} decision from process 0 within the "
                        f"{hard_cap:.0f} s ceiling — its process is "
                        f"{'still beating (main thread wedged?)' if alive else 'silent'}; "
                        f"raise DL4J_BARRIER_TIMEOUT for very large "
                        f"states", cause=e) from e
                if alive:
                    if 0 in c._stale_peers():
                        raise c._peer_lost_error(
                            f"process 0 never published its {what} "
                            f"decision and has stopped heartbeating — "
                            f"it likely died mid-{what}", cause=e) from e
                elif waited > c.barrier_timeout:
                    raise c._peer_lost_error(
                        f"no {what} decision from process 0 within "
                        f"{c.barrier_timeout:.0f} s and no liveness "
                        f"evidence to wait on (PeerMonitor off) — it "
                        f"may have died, or may still be working a "
                        f"large state; raise DL4J_BARRIER_TIMEOUT or "
                        f"enable the monitor", cause=e) from e

    def _verify_manifest(self, step, host_state):
        """Peer-side split-brain check: the manifest process 0 just wrote
        must checksum-match THIS process's own copy of the replicated
        state."""
        from deeplearning4j_tpu_torch.resilience import \
            integrity as _integrity
        try:
            _integrity.verify_restored(self.directory, step, host_state,
                                       check_finite=False)
        except CheckpointIntegrityError as e:
            raise PeerDesyncError(
                f"step {step}: this process's state does not match the "
                f"manifest process 0 wrote — replicated model state "
                f"has diverged across hosts ({e})",
                peers=self.coordinator.peer_table()) from e

    # -- restore ---------------------------------------------------------
    def _restore_placed(self, step, like_live, verified_scan=False,
                        dp=None):
        """Restore generation `step` (or the newest verified one) as host
        tensors in the checkpoint layout (encoder stacks `dp` rows),
        integrity-verify, re-stack the encoder to the live width when it
        differs, then place this rank's part on the trainer's mesh.
        Returns (step, placed_state)."""
        from deeplearning4j_tpu_torch.parallel.elastic import \
            replace_on_mesh
        from deeplearning4j_tpu_torch.parallel.membership import \
            restack_encoder
        from deeplearning4j_tpu_torch.resilience import \
            integrity as _integrity
        like_host = self._like_host(like_live, dp)
        if verified_scan:
            s, state = self.ckpt.restore_verified(like=like_host)
        else:
            _debug("restore: reading generation", step)
            s, state = self.ckpt.restore(step=step, like=like_host)
            _integrity.verify_restored(self.directory, s, state)
        if s is None:
            return None, None
        if dp is not None and int(dp) != self.trainer.dp \
                and _is_encoder(state["opt_state"]):
            state = dict(state)
            opt = dict(state["opt_state"])
            opt["encoder"] = restack_encoder(
                _mesh._tree_map(lambda t: t.numpy(), opt["encoder"]),
                self.trainer.dp)
            state["opt_state"] = opt
        tr = self.trainer
        placed = replace_on_mesh(tr.mesh, like_live, state, tr.state_specs(
            like_live["params"], like_live["opt_state"]))
        return s, placed

    def resume_or_init(self, init_params):
        """All hosts land on the SAME generation: process 0 scans for the
        newest verified checkpoint and publishes its choice; the peers
        restore exactly that step and verify it themselves. Returns
        (params, opt_state) with `self.step` set to the restored step (0
        when starting fresh)."""
        c = self.coordinator
        params, opt_state = self.trainer.init(init_params)
        like = {"params": params, "opt_state": opt_state}
        if c.num_processes <= 1:
            s, placed = self._restore_placed(None, like,
                                             verified_scan=True)
            if s is not None:
                self.step = int(s)
                self._note_resume()
                return placed["params"], placed["opt_state"]
            return params, opt_state
        if self.primary:
            try:
                s, placed = self._restore_placed(None, like,
                                                 verified_scan=True)
            except BaseException:
                # ANY primary-side failure must unblock the peers with a
                # clear verdict
                try:
                    c.publish("ctl/resume", "fail")
                except Exception:  # noqa: BLE001
                    pass
                raise
            c.publish("ctl/resume", str(-1 if s is None else int(s)))
        else:
            v = self._fetch_decision("ctl/resume", "resume")
            if v == "fail":
                raise CheckpointIntegrityError(
                    "process 0 failed its checkpoint scan/restore — "
                    "see its logs; refusing to resume")
            s = int(v)
            if s < 0:
                s, placed = None, None
            else:
                s, placed = self._restore_placed(s, like)
        c.barrier("resume")
        if s is None:
            return params, opt_state
        self.step = int(s)
        self._note_resume()
        return placed["params"], placed["opt_state"]

    def _note_resume(self):
        self.resumed_step = self.step
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.RESILIENCE_RESUMES,
                        help="checkpoint resumes after restart").inc()
            reg.gauge(_mon.RESILIENCE_RESUME_STEP,
                      help="step the latest resume restored") \
                .set(self.step)

    # -- rollback --------------------------------------------------------
    def _rollback(self, g, params, opt_state):
        """Guardian-requested rollback, coordinated: process 0 picks the
        newest verified generation and publishes it under a key derived
        from the (coordinated) rollback count, so every host restores —
        and verifies — the same one."""
        c = self.coordinator
        like = {"params": params, "opt_state": opt_state}
        key = f"ctl/rollback/{g.rollbacks}"
        multi = c.num_processes > 1
        if not multi or self.primary:
            try:
                self.ckpt.wait_until_finished()
                s, placed = self._restore_placed(None, like,
                                                 verified_scan=True)
                if s is None:
                    raise CheckpointIntegrityError(
                        "guardian requested rollback but no verified "
                        "checkpoint exists yet")
            except BaseException:
                if multi:
                    try:
                        c.publish(key, "fail")
                    except Exception:  # noqa: BLE001
                        pass
                raise
            if multi:
                c.publish(key, str(int(s)))
        else:
            v = self._fetch_decision(key, "rollback")
            if v == "fail":
                raise CheckpointIntegrityError(
                    "process 0 failed its rollback restore — see its "
                    "logs")
            s, placed = self._restore_placed(int(v), like)
        if multi:
            c.barrier(f"rollback/{g.rollbacks}")
        g.note_rollback(int(s))
        return placed["params"], placed["opt_state"]

    # -- elastic membership: mid-run join / leave / replace --------------
    def request_leave(self):
        """Announce a GRACEFUL leave for this host: the next sync point
        agrees the REFORM on every member, the final state drains to a
        verified checkpoint on the old mesh, the survivors re-form, and
        this host's fit loop unwinds with `PreemptionSignal`."""
        if not self.elastic:
            raise MembershipChangeError(
                "request_leave() requires an elastic runner "
                "(elastic=True with a mesh_factory)")
        return self.membership.announce_leave()

    def _encoder_dp(self, opt_state):
        """The encoder's width (the trainer's dp), or None when the
        trainer does not compress."""
        if not getattr(self.trainer, "compress", False) \
                or not _is_encoder(opt_state):
            return None
        return self.trainer.dp

    def _reform(self, params, opt_state, delta):
        """Execute an AGREED membership change at this step boundary:
        coordinated drain save on the OLD group, the join-admission fault
        window, the leader's commit (+ departed-host KV reap), then the
        survivors re-form. Returns (None, None) on the leaving host."""
        joins, leaves = delta
        c = self.coordinator
        if 0 in leaves:
            self.membership.abandon(leaves=[0])
            raise MembershipChangeError(
                "process 0 cannot leave an elastic run: it owns the "
                "checkpoint directory and hosts the coordination store "
                "— drain the whole run (preemption) instead")
        t0 = time.monotonic()
        saved = self._save(params, opt_state, wait=True)
        host = self._last_host_state if saved \
            else self._host_state(params, opt_state)
        if joins and not saved:
            # no drain checkpoint: a joiner warm-starting an OLDER
            # generation would desync — withdraw the joins
            self.membership.abandon(joins=joins)
            joins = []
            if not leaves:
                return params, opt_state
        if _faults.ACTIVE is not None:
            try:
                _faults.ACTIVE.fire(_faults.HOST_JOIN)
            except BaseException as e:
                self.membership.abandon(joins=joins, leaves=leaves)
                raise MembershipChangeError(
                    f"membership change (join={joins}, leave={leaves}) "
                    f"failed before commit — previous roster stays "
                    f"authoritative: {e}") from e
        info = {"step": self.step, "cstep": c.step, "rounds": c.rounds,
                "save_seq": self._save_seq,
                "dp": self._encoder_dp(opt_state),
                "flushes": getattr(self.guardian, "_flushes", 0),
                "rollbacks": getattr(self.guardian, "rollbacks", 0)}
        new_members = self.membership.commit(joins, leaves, info=info)
        if c.process_id in leaves:
            release = getattr(self.mesh_factory, "release", None)
            if release is not None:
                release()
            return None, None
        params, opt_state = self._rebuild(host, new_members)
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.DIST_REFORMS,
                        labels={"kind": "join" if joins else "leave"},
                        help="elastic mesh re-forms executed").inc()
            reg.gauge(_mon.DIST_REFORM_MS,
                      help="wall ms of the last elastic re-form "
                           "(drain save + rebuild + re-place)") \
                .set(round((time.monotonic() - t0) * 1000.0, 3))
        return params, opt_state

    def _adopt(self, new_trainer):
        self.trainer = new_trainer
        self._last_opt_state = None
        self.coordinator.bind(new_trainer)
        if self.guardian is not None:
            self.guardian.bind(new_trainer)

    def _rebuild(self, host, new_members):
        """Re-form onto the NEW roster from the gathered host snapshot:
        fresh trainer on `mesh_factory(members)`, the encoder stacks
        re-stacked for the new dp width (residual mass conserved), this
        rank's part placed on the new mesh."""
        from deeplearning4j_tpu_torch.parallel.elastic import \
            replace_on_mesh
        from deeplearning4j_tpu_torch.parallel.membership import \
            restack_encoder
        new_mesh = self.mesh_factory(list(new_members))
        new_trainer = self.trainer.rebuild(new_mesh)
        fresh_p, fresh_o = new_trainer.init(host["params"])
        like = {"params": fresh_p, "opt_state": fresh_o}
        state = {"params": host["params"], "opt_state": host["opt_state"]}
        if _is_encoder(state["opt_state"]) \
                and getattr(new_trainer, "compress", False):
            opt = dict(state["opt_state"])
            opt["encoder"] = restack_encoder(
                _mesh._tree_map(lambda t: t.numpy(), opt["encoder"]),
                new_trainer.dp)
            state["opt_state"] = opt
        placed = replace_on_mesh(new_mesh, like, state,
                                 new_trainer.state_specs(fresh_p, fresh_o))
        self._adopt(new_trainer)
        return placed["params"], placed["opt_state"]

    def _replace_lost(self, params, opt_state, exc):
        """A peer died mid-run (`PeerLostError`): the survivors re-form on
        the reduced roster and KEEP TRAINING from the newest verified
        checkpoint (the step may rewind by < save_every). The live state
        is unusable (a collective may have died half-way), so replacement
        is a restore. Re-raises `exc` when nothing can survive (process 0
        died: it owns the checkpoints and the store)."""
        c = self.coordinator
        lost = sorted(set(c._lost) & set(c.members))
        if not lost or c.process_id in lost or 0 in lost:
            raise exc
        survivors = [p for p in c.members if p not in lost]
        if not survivors:
            raise exc
        t0 = time.monotonic()
        old_dp = self._encoder_dp(opt_state)
        self._replaces += 1
        m = self.membership
        if c.process_id == min(survivors):
            for pid in lost:
                m.reap_host(pid)
        m.members = list(survivors)
        m.epoch += 1
        c.reform(survivors)
        new_mesh = self.mesh_factory(list(survivors))
        new_trainer = self.trainer.rebuild(new_mesh)
        fresh_p, fresh_o = new_trainer.init(_host_zeros(
            self._like_host({"params": params, "opt_state": opt_state})
            ["params"]))
        self._adopt(new_trainer)
        like = {"params": fresh_p, "opt_state": fresh_o}
        key = f"ctl/replace/{self._replaces}"
        if len(survivors) <= 1 or self.primary:
            try:
                self.ckpt.wait_until_finished()
                s, placed = self._restore_placed(
                    None, like, verified_scan=True, dp=old_dp)
                if s is None:
                    raise CheckpointIntegrityError(
                        f"peer(s) {lost} lost but no verified "
                        f"checkpoint exists to re-form from") from exc
            except BaseException:
                if len(survivors) > 1:
                    try:
                        c.publish(key, "fail")
                    except Exception:  # noqa: BLE001
                        pass
                raise
            if len(survivors) > 1:
                c.publish(key, str(int(s)))
        else:
            v = self._fetch_decision(key, "replace")
            if v == "fail":
                raise CheckpointIntegrityError(
                    "the lead survivor failed its replacement restore "
                    "— see its logs") from exc
            s, placed = self._restore_placed(int(v), like, dp=old_dp)
        if len(survivors) > 1:
            c.barrier(f"replace/{self._replaces}")
        self.step = int(s)
        self._note_resume()
        if _mon.enabled():
            reg = _mon.get_registry()
            reg.counter(_mon.DIST_REFORMS, labels={"kind": "replace"},
                        help="elastic mesh re-forms executed").inc()
            reg.gauge(_mon.DIST_REFORM_MS,
                      help="wall ms of the last elastic re-form "
                           "(drain save + rebuild + re-place)") \
                .set(round((time.monotonic() - t0) * 1000.0, 3))
            _events.emit("parallel", _events.MEMBERSHIP_REPLACED,
                         attrs={"lost": sorted(lost),
                                "survivors": sorted(survivors),
                                "step": self.step},
                         correlation_id="membership")
        return placed["params"], placed["opt_state"]

    @classmethod
    def join_cluster(cls, trainer_factory, directory, coordinator,
                     mesh_factory, init_params, timeout=None, **kw):
        """JOINER bootstrap: announce on the KV, wait for the running
        cluster to agree and admit at a step boundary, build the trainer
        on the NEW mesh (`trainer_factory(mesh_factory(members))`: in the
        port a `GroupMeshFactory` over this `coordinator` brings up the
        new process group with the members), warm-start from the drain checkpoint the members wrote
        at that boundary (encoder stacks re-stacked to the new width),
        and adopt the members' step / round / barrier counters so
        lockstep agreement holds from the first step. Returns (runner,
        params, opt_state). Raises the typed `MembershipChangeError`
        (announcement withdrawn, cluster untouched) when admission fails
        or the `host.join` fault fires."""
        m = ElasticMembership(coordinator,
                              members=[coordinator.process_id])
        m.announce_join()
        if _faults.ACTIVE is not None:
            try:
                _faults.ACTIVE.fire(_faults.HOST_JOIN)
            except BaseException as e:
                m.abandon(joins=[coordinator.process_id])
                raise MembershipChangeError(
                    f"join aborted before admission — announcement "
                    f"withdrawn, cluster roster untouched: {e}") from e
        info = m.await_admission(timeout=timeout)
        trainer = trainer_factory(mesh_factory(list(m.members)))
        coordinator.step = int(info.get("cstep") or 0)
        coordinator.rounds = int(info.get("rounds") or 0)
        runner = cls(trainer, directory, coordinator, elastic=True,
                     mesh_factory=mesh_factory, membership=m, **kw)
        runner._save_seq = int(info.get("save_seq") or 0)
        g = runner.guardian
        if g is not None:
            g._flushes = int(info.get("flushes") or 0)
            if hasattr(g, "rollbacks"):
                g.rollbacks = int(info.get("rollbacks") or 0)
        params, opt_state = runner.trainer.init(init_params)
        like = {"params": params, "opt_state": opt_state}
        step = int(info.get("step") or 0)
        s, placed = runner._restore_placed(
            step if step > 0 else None, like, verified_scan=step <= 0,
            dp=info.get("dp"))
        if s is not None:
            runner.step = int(s)
            runner._note_resume()
            params, opt_state = placed["params"], placed["opt_state"]
        return runner, params, opt_state

    # -- the step --------------------------------------------------------
    def _on_sync(self, coordinator):
        """Sync-point piggyback: refresh the compression wire telemetry at
        flush cadence (never per step); the bytes ride the next heartbeat
        via `coordinator.stats_extra`."""
        opt_state = self._last_opt_state
        if opt_state is not None and \
                getattr(self.trainer, "compress", False) and _mon.enabled():
            try:
                host = self.trainer.encoder_stats(opt_state)
                if host is not None:
                    coordinator.stats_extra["exchange_bytes"] = \
                        host["encoded_bytes"]
                    if "wire_bytes" in host:
                        coordinator.stats_extra["wire_bytes"] = \
                            host["wire_bytes"]
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass

    def generator(self, step):
        """The dropout generator of `step`: on the trainer's device,
        seeded from (rng_seed, step)."""
        gen = torch.Generator(device=self.trainer.mesh.device)
        gen.manual_seed((self.rng_seed * 1_000_003 + int(step))
                        % (2 ** 63))
        return gen

    def fit_batch(self, params, opt_state, batch, rng=None):
        """One coordinated step: dispatch (with peer autopsy on collective
        failure), guardian escalation consumption, the preemption drain,
        membership changes and the periodic coordinated save."""
        if rng is None:
            rng = self.generator(self.step)
        self._last_opt_state = opt_state
        try:
            params, opt_state, loss = self.trainer.fit_batch(
                params, opt_state, batch, rng)
        except PeerLostError as e:
            if not self.elastic:
                raise
            # survivors re-form on the reduced roster instead of dying
            # with the peer; the batch is dropped and loss is None — the
            # caller re-batches on the NEW trainer.mesh at the (possibly
            # rewound) runner.step
            params, opt_state = self._replace_lost(params, opt_state, e)
            return params, opt_state, None
        self._last_opt_state = opt_state
        self.step += 1
        g = self.guardian
        if g is not None:
            act = g.take_action()
            if act == _guardian.ROLLBACK:
                params, opt_state = self._rollback(g, params, opt_state)
        d = self.coordinator.take_decision()
        if d == _coord.PREEMPT:
            saved = self._save(params, opt_state, wait=True)
            raise PreemptionSignal(
                (f"coordinated drain complete at step {self.step} — "
                 f"checkpoint written and verified; exit and resume")
                if saved else
                (f"coordinated drain at step {self.step} — the guardian "
                 f"could not vouch for the params, so NO drain "
                 f"checkpoint was written; resume falls back to the "
                 f"last verified generation"),
                step=self.step)
        if d == _coord.REFORM and self.elastic:
            delta = self.coordinator.take_reform()
            if delta is not None:
                params, opt_state = self._reform(params, opt_state, delta)
                if params is None:
                    raise PreemptionSignal(
                        f"graceful leave complete at step {self.step} "
                        f"— final state drained to a checkpoint and "
                        f"the survivors re-formed without this host",
                        step=self.step)
                # the re-form just drain-saved THIS step
                return params, opt_state, loss
        if self.step % self.save_every == 0:
            self._save(params, opt_state, wait=False)
        return params, opt_state, loss

    def finalize(self, params=None, opt_state=None):
        """Final synchronous coordinated save + close."""
        try:
            if params is not None:
                self._save(params, opt_state, wait=True)
        finally:
            self.close()

    def close(self):
        c = self.coordinator
        c.stop_monitor()
        c.driver_attached = False
        c.on_sync = None
        c.bind(None)
        c.uninstall()
        if self._prev_signals:
            import signal as _signal
            for s, h in self._prev_signals.items():
                try:
                    _signal.signal(s, h)
                except (ValueError, TypeError):
                    pass
            self._prev_signals = None
        if self.guardian is not None:
            self.guardian.driver_attached = False
            self.guardian.bind(None)
            self.guardian.uninstall()
        self.ckpt.close()


def _integrity_flat(tree):
    from deeplearning4j_tpu_torch.resilience import integrity as _integrity
    return [(p, t) for p, t in _integrity.flatten(tree) if torch.is_tensor(t)]
