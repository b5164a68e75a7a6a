"""Cross-process coordination plane for multi-host training (≡ the
reference's SharedTrainingMaster control channel: worker liveness,
preemption drain, and lockstep agreement): the port of
`deeplearning4j_tpu/parallel/coordination.py`, over a
`torch.distributed` key-value store (a `TCPStore`) where the JAX package
uses jax's coordination service.

The design axiom: the TRAIN step is one rank's step plus the gradient
collectives of its process group, and every control decision happens at
a bounded-timeout SYNC POINT every `sync_every` steps — piggybacked on
the guardian's verdict-flush cadence, so the control plane adds no
device syncs of its own. At each sync point every process:

1. publishes a heartbeat (step number, wall time, preempt flag) to the
   KV store under a per-round key;
2. gathers every peer's heartbeat for the SAME round with a bounded
   timeout — a peer that never writes it was killed/wedged and surfaces
   as `PeerLostError` (plus a full forensics dump with the peer table)
   within `peer_timeout`, never an indefinite hang in a collective;
3. checks STEP AGREEMENT: all peers must report the same step — a
   desynced peer (one skipped a batch the others trained) is
   `PeerDesyncError`, because continuing would silently corrupt the
   replicated model;
4. reaches the PREEMPTION decision: the round's heartbeat set is
   write-once, so every process reads the same flags and reaches the
   same drain-or-continue decision at the same step.

The hot hook in `ShardedTrainer.fit_batch` is the usual one-pointer
compare (`if _coord.ACTIVE is not None: _coord.ACTIVE.on_step()`);
everything above happens only on the sync-point steps.

A `PeerMonitor` daemon thread (optional) additionally heartbeats a
wall-clock liveness key and watches the peers' — defense in depth for
the window BETWEEN sync points, and the data source for the `/health`
peer table and post-mortem autopsies of collective failures.

Two clients share one surface (`key_value_set` / `blocking_key_value_get`
/ `key_value_dir_get` / `key_value_delete` / `wait_at_barrier`):

- `LocalKV`, in process: two coordinators against one shared LocalKV
  from two threads exercise every path without spawning processes;
- `StoreKV`, over any `torch.distributed.Store` (TCPStore, FileStore,
  PrefixStore). A store has `set/get/add/compare_set/wait/delete_key`
  but no prefix listing and no barrier, so StoreKV builds both. The
  index is one key that lists every key StoreKV holds, edited with
  `compare_set` (retried when another writer came in between): a set
  adds its key, a delete takes its keys out, so the index is as large
  as what the store holds, and `key_value_dir_get` filters it. A delete
  racing a set of the same key may leave either. A barrier is an `add`
  counter whose last arrival sets a release key the others `wait` on
  under the deadline; the last to leave deletes the barrier's keys. A
  read never blocks on a key a peer deleted meanwhile: it probes with
  `compare_set` against a value no key holds, which returns the current
  value or, for a missing key, the probe itself.
"""
from __future__ import annotations

import datetime
import json
import os
import signal
import threading
import time

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.monitoring import cluster as _cluster
from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.monitoring import stragglers as _stragglers
from deeplearning4j_tpu_torch.resilience import faults as _faults
from deeplearning4j_tpu_torch.resilience.errors import (PeerDesyncError,
                                                  PeerLostError,
                                                  PreemptionSignal)

__all__ = ["ACTIVE", "LocalKV", "StoreKV", "PeerCoordinator",
           "PeerMonitor", "PREEMPT", "REFORM", "clear_coordinator",
           "default_peer_timeout", "install_preemption_handler"]

#: THE switch the trainer hot hooks check (faults.py pattern). None →
#: coordination off (the permanent state in single-host runs).
ACTIVE = None

#: decision constants a driving runner consumes via `take_decision()`
PREEMPT = "preempt"
#: membership change agreed (join/leave announcements in the round's
#: heartbeat union): the driving runner re-forms the dp mesh at this
#: step boundary. PREEMPT takes precedence when both arise in one round.
REFORM = "reform"


def default_peer_timeout():
    try:
        return float(os.environ.get("DL4J_PEER_TIMEOUT", "60"))
    except ValueError:
        return 60.0


def default_sync_every():
    try:
        return int(os.environ.get("DL4J_SYNC_EVERY", "10"))
    except ValueError:
        return 10


class LocalKV:
    """In-process stand-in for the store client (`StoreKV`): the same
    `key_value_set` / `blocking_key_value_get` / `key_value_dir_get` /
    `wait_at_barrier` surface, backed by a dict + condition variable.

    Two uses: single-process runs get a working control plane without a
    coordinator, and the chaos tests drive two `PeerCoordinator`s from
    two threads against ONE shared LocalKV — every agreement/containment
    path exercised in tier-1 without subprocess spawn cost."""

    def __init__(self):
        self._data = {}
        self._cv = threading.Condition()
        self._barriers = {}        # barrier_id -> arrival count

    def key_value_set(self, key, value, allow_overwrite=False):
        with self._cv:
            if not allow_overwrite and key in self._data:
                raise RuntimeError(f"ALREADY_EXISTS: {key}")
            self._data[key] = value
            self._cv.notify_all()

    def blocking_key_value_get(self, key, timeout_in_ms):
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        with self._cv:
            while key not in self._data:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    if key in self._data:
                        break
                    raise TimeoutError(
                        f"DEADLINE_EXCEEDED: key {key!r} not set within "
                        f"{timeout_in_ms} ms")
            return self._data[key]

    def key_value_dir_get(self, key):
        with self._cv:
            return [(k, v) for k, v in sorted(self._data.items())
                    if k.startswith(key)]

    def key_value_delete(self, key):
        with self._cv:
            for k in [k for k in self._data if k.startswith(key)]:
                self._data.pop(k, None)

    def wait_at_barrier(self, barrier_id, timeout_in_ms, process_ids=None,
                        expected=1):
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        with self._cv:
            n = self._barriers.get(barrier_id, 0) + 1
            self._barriers[barrier_id] = n
            self._cv.notify_all()
            while self._barriers[barrier_id] < expected:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    if self._barriers[barrier_id] >= expected:
                        break
                    raise TimeoutError(
                        f"DEADLINE_EXCEEDED: barrier {barrier_id!r} "
                        f"({self._barriers[barrier_id]}/{expected}) "
                        f"within {timeout_in_ms} ms")


#: the key holding StoreKV's index: every key it holds, one per line
_INDEX = "__kvindex"
#: a value no key ever holds: `compare_set(key, _PROBE, ...)` returns the
#: key's value, or `_PROBE` itself when the key is missing
_PROBE = "\x00dl4j-probe"


def _text(v):
    return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)


class StoreKV:
    """The coordination KV over a `torch.distributed.Store` (see the
    module docstring for the index and the barrier). Values are text.
    `expected` of a barrier defaults to `num_processes`."""

    def __init__(self, store, num_processes=1):
        self.store = store
        self.num_processes = int(num_processes)

    # -- the index ---------------------------------------------------------
    def _keys(self):
        v = self._peek(_INDEX)
        return set(v.split("\n")) - {""} if v else set()

    def _edit(self, add=(), drop=()):
        """Add and drop keys in the index: read, then compare-and-set,
        again until no other writer came in between."""
        while True:
            old = self._peek(_INDEX) or ""
            keys = set(old.split("\n")) - {""}
            want = (keys | set(add)) - set(drop)
            if want == keys:
                return
            new = "\n".join(sorted(want))
            if _text(self.store.compare_set(_INDEX, old, new)) == new:
                return

    def _peek(self, key):
        """The key's value, or None when it is missing; never blocks."""
        v = _text(self.store.compare_set(key, _PROBE, _PROBE + "!"))
        return None if v == _PROBE else v

    # -- the client surface ------------------------------------------------
    def key_value_set(self, key, value, allow_overwrite=False):
        value = _text(value)
        if allow_overwrite:
            self.store.set(key, value)
        elif _text(self.store.compare_set(key, "", value)) != value:
            raise RuntimeError(f"ALREADY_EXISTS: {key}")
        self._edit(add=[key])

    def blocking_key_value_get(self, key, timeout_in_ms):
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        while True:
            v = self._peek(key)
            if v is not None:
                return v
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"DEADLINE_EXCEEDED: key {key!r} not set within "
                    f"{timeout_in_ms} ms")
            try:
                self.store.wait([key], datetime.timedelta(
                    seconds=max(left, 0.001)))
            except Exception:  # noqa: BLE001 — the deadline decides
                pass

    def key_value_dir_get(self, key):
        out = []
        for k in sorted(k for k in self._keys() if k.startswith(key)):
            v = self._peek(k)
            if v is not None:
                out.append((k, v))
        return out

    def key_value_delete(self, key):
        doomed = {k for k in self._keys() if k.startswith(key)} | {key}
        # out of the index first: a listing meanwhile skips a missing key
        self._edit(drop=doomed)
        for k in doomed:
            try:
                self.store.delete_key(k)
            except Exception:  # noqa: BLE001 — deletes are best-effort
                pass

    def wait_at_barrier(self, barrier_id, timeout_in_ms, process_ids=None,
                        expected=None):
        n = len(process_ids) if process_ids else (
            self.num_processes if expected is None else int(expected))
        count, done, left = (f"{barrier_id}/arrived",
                             f"{barrier_id}/released", f"{barrier_id}/left")
        if self.store.add(count, 1) >= n:
            self.store.set(done, "1")
        try:
            self.store.wait([done], datetime.timedelta(
                milliseconds=max(int(timeout_in_ms), 1)))
        except Exception as e:  # noqa: BLE001 — timeout or transport
            have = int(self.store.add(count, 0))
            if have < n:
                raise TimeoutError(
                    f"DEADLINE_EXCEEDED: barrier {barrier_id!r} "
                    f"({have}/{n}) within {timeout_in_ms} ms") from e
        # the last to leave removes the barrier's keys
        if self.store.add(left, 1) >= n:
            for k in (count, done, left):
                try:
                    self.store.delete_key(k)
                except Exception:  # noqa: BLE001 — best-effort
                    pass


#: the client `multihost.initialize` brought up (a StoreKV over its
#: TCPStore); None until then
_CLIENT = None


def _distributed_client():
    """The live coordination client, or None outside a distributed run:
    the one `multihost.initialize` made, else a StoreKV over the default
    process group's store when a launcher brought the group up.
    Private-API access kept in ONE place."""
    global _CLIENT
    if _CLIENT is not None:
        return _CLIENT
    try:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return None
        from torch.distributed import distributed_c10d as c10d
        _CLIENT = StoreKV(c10d._get_default_store(),
                          num_processes=dist.get_world_size())
        return _CLIENT
    except Exception:  # noqa: BLE001 — no client is a normal state
        return None


def _world():
    """(process id, number of processes) of the default process group,
    or (0, 1) without one."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001
        pass
    return 0, 1


class PeerCoordinator:
    """The per-process control-plane endpoint. One per training loop.

    Parameters
    ----------
    sync_every: steps between sync points (heartbeat + agreement); align
        with the guardian's `check_every` so the flush and the heartbeat
        share one host-bound moment.
    peer_timeout: seconds a peer may lag a sync point / stay silent
        before it is declared lost (env `DL4J_PEER_TIMEOUT`).
    barrier_timeout: seconds for explicit named barriers (checkpoint
        fences); defaults to 2× peer_timeout.
    client / process_id / num_processes: default to the live
        distributed state (`multihost.initialize`'s store client, the
        default process group's rank and size); tests pass a shared
        `LocalKV` + explicit ids to simulate a cluster in-process.
    dump_dir: where peer-loss forensic reports go (cwd default).
    """

    def __init__(self, sync_every=None, peer_timeout=None,
                 barrier_timeout=None, client=None, process_id=None,
                 num_processes=None, namespace="dl4j", dump_dir=None,
                 clock=time.monotonic):
        self.sync_every = int(sync_every if sync_every is not None
                              else default_sync_every())
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self.peer_timeout = float(peer_timeout if peer_timeout is not None
                                  else default_peer_timeout())
        self.barrier_timeout = float(
            barrier_timeout if barrier_timeout is not None
            else 2.0 * self.peer_timeout)
        self._client = client if client is not None \
            else (_distributed_client() or LocalKV())
        rank, world = _world()
        self.process_id = int(process_id if process_id is not None
                              else rank)
        self.num_processes = int(num_processes if num_processes is not None
                                 else world)
        #: the ACTIVE roster — every gather/agreement/autopsy loop walks
        #: this, never `range(num_processes)`. Fixed-membership runs
        #: keep the full range; an attached `ElasticMembership` rewrites
        #: it through `reform()` at agreed boundaries.
        self.members = list(range(self.num_processes))
        self.membership = None     # ElasticMembership attaches itself
        self._pending_reform = None  # (joins, leaves) behind a REFORM
        self.ns = namespace
        self.dump_dir = dump_dir
        self._clock = clock

        self.step = 0              # trainer steps observed (on_step calls)
        self.rounds = 0            # sync points completed
        #: when bound to a specific trainer, on_step calls from OTHER
        #: trainers are ignored — a host-local auxiliary fit (probe,
        #: validation) must not desync the step-agreement check (the
        #: watchdog's per-instance heartbeats guard against the same
        #: confusion)
        self._bound = None
        #: a driving runner consumes take_decision() after each batch —
        #: without one, a preempt decision raises PreemptionSignal
        #: directly from the sync point (nothing else could act on it)
        self.driver_attached = False
        self._decision = None
        self._preempt_requested = False
        self._preempt_reason = None
        self.preempted = False     # a drain decision was reached
        self._peers = {}           # last gathered peer table
        self._lost = {}            # pid -> info for peers declared lost
        #: pid -> (last published beat value, LOCAL monotonic time we
        #: first observed it) — staleness always compares the local
        #: observation clock, never a peer's wall clock (cross-host
        #: clock skew would otherwise stretch/shrink the peer timeout
        #: and corrupt the post-failure proof-of-life check)
        self._beat_obs = {}
        self.last_report_path = None
        self.on_sync = None        # callback(self) after each sync point
        self._monitor = None
        self._prev_active = None
        #: extra per-host stats riding the heartbeat + metrics snapshot
        #: (a driving runner drops e.g. exchange_bytes in here at sync
        #: cadence; the peer table and the cluster plane surface them)
        self.stats_extra = {}
        self._last_sync = None     # (step, clock) of the previous sync

    # -- install / clear (faults.py pattern) -----------------------------
    def install(self):
        global ACTIVE
        if ACTIVE is not self:
            self._prev_active = ACTIVE
            ACTIVE = self
        return self

    def uninstall(self):
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = self._prev_active
            self._prev_active = None
        return self

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        if self._monitor is not None:
            self._monitor.stop()
        return False

    # -- KV helpers ------------------------------------------------------
    def _key(self, suffix):
        return f"{self.ns}/{suffix}"

    def publish(self, key, value, overwrite=False):
        self._client.key_value_set(self._key(key), value,
                                   allow_overwrite=overwrite)

    def fetch(self, key, timeout=None):
        """Blocking KV read with a bounded timeout (seconds)."""
        t = self.peer_timeout if timeout is None else float(timeout)
        return self._client.blocking_key_value_get(
            self._key(key), int(t * 1000))

    def fetch_dir(self, key):
        pfx = self._key(key)
        return [(k[len(pfx):], v)
                for k, v in self._client.key_value_dir_get(pfx)]

    def publish_json(self, key, doc):
        """Overwrite-publish one JSON document under `key` — the
        directory-registry primitive: each process re-publishes its own
        `<prefix>/<pid>` entry and `fetch_json_dir` merges the cross-host
        view (the fleet replica registry rides this)."""
        self.publish(key, json.dumps(doc), overwrite=True)

    def fetch_json_dir(self, prefix):
        """Read every JSON document under `prefix` → {suffix: doc},
        skipping entries that fail to parse (a publisher mid-write or a
        foreign key must not poison the merged registry view)."""
        out = {}
        for suffix, raw in self.fetch_dir(prefix):
            try:
                out[suffix] = json.loads(raw)
            except (TypeError, ValueError):
                continue
        return out

    def barrier(self, name, timeout=None):
        """Named cross-process fence with a bounded timeout → a timeout
        is a LOST/WEDGED peer (dump + `PeerLostError`), never a silent
        gRPC hang. The `comm.barrier` fault site fires first so chaos
        plans can break fences on schedule."""
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.fire(_faults.COMM_BARRIER)
        t = self.barrier_timeout if timeout is None else float(timeout)
        try:
            # scoped to the ACTIVE members: a departed host can never be
            # waited on
            self._client.wait_at_barrier(self._key(f"barrier/{name}"),
                                         int(t * 1000),
                                         expected=len(self.members))
        except Exception as e:  # noqa: BLE001 — timeout/transport alike
            if _mon.enabled():
                _mon.get_registry().counter(
                    _mon.DIST_BARRIER_TIMEOUTS,
                    help="cross-process barriers that timed out").inc()
            raise self._peer_lost_error(
                f"barrier {name!r} not reached by all "
                f"{len(self.members)} members within {t:.1f} s",
                cause=e) from e

    # -- preemption ------------------------------------------------------
    def request_preemption(self, reason="signal"):
        """Mark THIS process as preempted; the flag rides the next
        heartbeat, and every process (including this one) reaches the
        same drain decision at the same sync point. Signal-handler safe:
        one bool store."""
        self._preempt_requested = True
        self._preempt_reason = reason

    @property
    def preempt_requested(self):
        return self._preempt_requested

    def take_decision(self):
        """Return-and-clear the pending control decision (PREEMPT /
        None). The driving runner consumes this after each batch —
        mirror of TrainingGuardian.take_action()."""
        d, self._decision = self._decision, None
        return d

    def take_reform(self):
        """Return-and-clear the (joins, leaves) delta behind the last
        REFORM decision — the runner consumes this right after
        `take_decision()` returned REFORM."""
        r, self._pending_reform = self._pending_reform, None
        return r

    def reform(self, members):
        """Adopt a NEW member roster at an agreed boundary: every
        subsequent gather / barrier / autopsy walks the new list, and
        stale per-peer bookkeeping for departed pids is dropped so a
        replaced host re-joining under the same pid starts clean."""
        members = sorted(int(p) for p in members)
        if not members:
            raise ValueError("reform: empty member roster")
        self.members = members
        keep = set(members)
        self._lost = {p: v for p, v in self._lost.items() if p in keep}
        self._peers = {p: v for p, v in self._peers.items() if p in keep}
        self._beat_obs = {p: v for p, v in self._beat_obs.items()
                          if p in keep}
        if self._monitor is not None:
            self._monitor._tripped &= keep
        if _mon.enabled():
            _mon.get_registry().gauge(
                _mon.DIST_PEERS,
                help="peer processes seen at the last sync point") \
                .set(len(members))
        return self

    def bind(self, trainer):
        """Scope step counting to `trainer`: while bound, ONLY calls
        whose `source` is that trainer advance the lockstep step
        counter — source-less calls are dropped too (any extra count
        desyncs step agreement across hosts). None unbinds (every call
        counts, the default)."""
        self._bound = trainer
        return self

    # -- the hot hook ----------------------------------------------------
    def on_step(self, source=None):
        """Called once per trainer step (the `fit_batch` hook). Cheap
        off the sync cadence: an int increment and a modulo. `source`
        is the calling trainer; when this coordinator is bound to a
        specific one, every other source (including None) is ignored."""
        if self._bound is not None and source is not self._bound:
            return
        self.step += 1
        if self._lost:
            # the monitor already counted + dumped when it tripped
            raise self._peer_lost_error(
                "peer(s) declared lost by the monitor thread",
                write_report=False, count=False)
        if self.step % self.sync_every:
            return
        self._sync_point()

    def _sync_point(self):
        rnd = self.rounds
        self.rounds += 1
        if _faults.ACTIVE is not None:
            # host.preempt: a PreemptionSignal injected here simulates
            # SIGTERM delivery at an exact step — it requests the drain
            # instead of propagating. Any other injected exception (or
            # a factory that kills the process outright) propagates the
            # chaos as designed.
            try:
                _faults.ACTIVE.fire(_faults.HOST_PREEMPT)
            except PreemptionSignal as e:
                self.request_preemption(f"injected: {e}")
        now = self._clock()
        rate = None
        if self._last_sync is not None and now > self._last_sync[1]:
            rate = round((self.step - self._last_sync[0])
                         / (now - self._last_sync[1]), 3)
        self._last_sync = (self.step, now)
        hb = {"step": self.step, "t": time.time(),
              "preempt": bool(self._preempt_requested),
              "reason": self._preempt_reason,
              "steps_per_s": rate}
        if self.membership is not None:
            # this process's VIEW of pending join/leave announcements —
            # the agreed delta is the UNION over the round's write-once
            # heartbeat set, so every member reaches the same REFORM
            # decision even when announcements land mid-round
            mj, ml = self.membership.pending()
            if mj:
                hb["mjoin"] = mj
            if ml:
                hb["mleave"] = ml
        if self.stats_extra:
            hb.update(self.stats_extra)
        self.publish(f"hb/{rnd}/{self.process_id}", json.dumps(hb))
        peers = {self.process_id: hb}
        for pid in self.members:
            if pid == self.process_id:
                continue
            try:
                peers[pid] = json.loads(
                    self.fetch(f"hb/{rnd}/{pid}"))
            except Exception as e:  # noqa: BLE001 — silence IS the signal
                self._lost[pid] = {"round": rnd, "error": str(e)}
                raise self._peer_lost_error(
                    f"process {pid} never published its round-{rnd} "
                    f"heartbeat within {self.peer_timeout:.1f} s "
                    f"(step {self.step})", cause=e) from e
        self._peers = peers
        steps = {pid: info.get("step") for pid, info in peers.items()}
        if len(set(steps.values())) > 1:
            raise self._desync_error(steps)
        if any(info.get("preempt") for info in peers.values()):
            self.preempted = True
            self._decision = PREEMPT
            if _mon.enabled():
                _mon.get_registry().counter(
                    _mon.DIST_PREEMPTIONS,
                    help="coordinated preemption drains agreed").inc()
        elif self.membership is not None:
            joins, leaves = set(), set()
            for info in peers.values():
                joins.update(int(p) for p in info.get("mjoin") or ())
                leaves.update(int(p) for p in info.get("mleave") or ())
            joins -= set(self.members)
            leaves &= set(self.members)
            if joins or leaves:
                if self.driver_attached:
                    self._decision = REFORM
                    self._pending_reform = (sorted(joins), sorted(leaves))
                    if _mon.enabled():
                        _mon.get_registry().counter(
                            _mon.DIST_REFORMS_AGREED,
                            help="membership changes agreed at sync "
                                 "points").inc()
                # undriven: nothing can execute a mesh re-form — the
                # announcements stay pending and harmless
        if _mon.enabled():
            _mon.get_registry().gauge(
                _mon.DIST_PEERS,
                help="peer processes seen at the last sync point") \
                .set(len(peers))
        # reap the round-before-last's heartbeat keys (everyone is
        # provably past them — this round's gather completed) so a
        # long run doesn't grow the coordination service's KV store
        # without bound; best effort, every process deletes its OWN key
        if rnd >= 2:
            try:
                self._client.key_value_delete(
                    self._key(f"hb/{rnd - 2}/{self.process_id}"))
            except Exception:  # noqa: BLE001
                pass
        if _mon.enabled():
            # cluster metrics plane: ONE overwritten `metrics/<pid>` KV
            # key per process at this (guardian-flush) cadence — no new
            # collectives, no new syncs, bounded keys by construction.
            # Best-effort: a full/failed KV write must not fail a step.
            try:
                extra = {"steps_per_s": rate, **self.stats_extra}
                _cluster.publish(self, extra=extra)
            except Exception:  # noqa: BLE001
                pass
            # per-host step timeline (straggler plane): ONE overwritten
            # `steps/<pid>` key per process at the same cadence — same
            # zero-cost contract, same best-effort posture.
            try:
                _stragglers.publish(self, extra={"steps_per_s": rate})
            except Exception:  # noqa: BLE001
                pass
        if self.on_sync is not None:
            self.on_sync(self)
        if self._decision == PREEMPT and not self.driver_attached:
            # nothing will consume the decision — unwind the fit loop
            # directly (the caller has no checkpointer to drain into)
            self._decision = None
            raise PreemptionSignal(
                f"preemption agreed at step {self.step} "
                f"({self._agreed_reason()})", step=self.step)

    def _agreed_reason(self):
        for pid, info in sorted(self._peers.items()):
            if info.get("preempt"):
                return f"requested by process {pid}: {info.get('reason')}"
        return self._preempt_reason or "requested"

    # -- containment -----------------------------------------------------
    def _peer_lost_error(self, message, cause=None, write_report=True,
                         count=True):
        """count=False when re-surfacing a loss the monitor already
        counted — one lost peer must land on `dl4j.dist.peer_lost`
        exactly once regardless of which path detected it."""
        if count and _mon.enabled():
            _mon.get_registry().counter(
                _mon.DIST_PEER_LOST,
                help="peers declared lost/wedged/desynced").inc()
        if _mon.enabled():
            # before the report, so its journal tail shows this loss
            _events.emit("parallel", _events.PEER_LOST,
                         attrs={"message": message},
                         correlation_id="peers-%d" % self.process_id)
        path = None
        if write_report:
            path = self._write_report(["PEER LOST: " + message]
                                      + ([f"cause: {cause}"] if cause
                                         else []))
        return PeerLostError(message, peers=self.peer_table(),
                             report_path=path or self.last_report_path)

    def desync_error(self, msg):
        """Build a `PeerDesyncError` the standard way — counted on
        `dl4j.dist.peer_lost` and with a forensics report — so every
        desync class (step disagreement here, verdict-window mismatch in
        CoordinatedGuardian) surfaces identically."""
        if _mon.enabled():
            _mon.get_registry().counter(
                _mon.DIST_PEER_LOST,
                help="peers declared lost/wedged/desynced").inc()
            _events.emit("parallel", _events.PEER_DESYNC,
                         attrs={"message": msg},
                         correlation_id="peers-%d" % self.process_id)
        path = self._write_report(["PEER DESYNC: " + msg])
        return PeerDesyncError(msg, peers=self.peer_table(),
                               report_path=path)

    def _desync_error(self, steps):
        return self.desync_error(
            f"step disagreement at sync round {self.rounds - 1}: "
            + ", ".join(f"p{pid}={s}"
                        for pid, s in sorted(steps.items())))

    def _write_report(self, headline):
        from deeplearning4j_tpu_torch.resilience.watchdog import write_debug_report
        try:
            # count_dump=False: peer reports land on dl4j.dist.peer_lost,
            # not dl4j.watchdog.dumps — a stall-dump alert must not fire
            # for a peer loss on a healthy host
            self.last_report_path = write_debug_report(
                headline, dump_dir=self.dump_dir,
                prefix="dl4j-peer-report", count_dump=False)
        except Exception:  # noqa: BLE001 — the report must never mask
            self.last_report_path = None
        return self.last_report_path

    def autopsy(self, exc):
        """A collective/dispatch failure just surfaced: decide whether a
        dead peer caused it. Polls the monitor liveness keys until
        either every peer shows a fresh beat (→ re-raise the original
        error: the peers are fine, the failure is real) or a peer stays
        silent past `peer_timeout` (→ `PeerLostError` from the original
        error). Bounded by `peer_timeout` either way. With NO liveness
        keys at all (no `PeerMonitor` running anywhere) there is no
        evidence to adjudicate on — the original error re-raises
        immediately rather than being blamed on peers that may be
        perfectly healthy."""
        try:
            empty = not self.fetch_dir("alive/")
        except Exception as kv_err:  # noqa: BLE001 — service itself gone
            # the coordination service rides the coordinator process:
            # its death IS a peer loss, surfaced typed like any other
            raise self._peer_lost_error(
                f"coordination service unreachable while adjudicating a "
                f"collective failure — the coordinator process likely "
                f"died ({kv_err}); original error: {exc}",
                cause=exc) from exc
        if empty:
            raise exc
        started = time.monotonic()
        deadline = started + self.peer_timeout + 1.0
        while True:
            try:
                # one guarded pass: refresh local beat observations and
                # compute staleness from them
                stale = self._stale_peers()
            except Exception as kv_err:  # noqa: BLE001
                raise self._peer_lost_error(
                    f"coordination service unreachable mid-autopsy — "
                    f"the coordinator process likely died ({kv_err}); "
                    f"original error: {exc}", cause=exc) from exc
            # a beat OBSERVED after the failure is proof of life — once
            # every peer has produced one, the failure was not a peer
            # death (observation times are local-monotonic: clock skew
            # on the peers cannot fake or hide freshness)
            if all(self._beat_obs.get(pid, (None, -1.0))[1] >= started
                   for pid in self.members
                   if pid != self.process_id):
                raise exc
            if stale:
                # silence crossed peer_timeout: declared lost the moment
                # the age threshold trips, not a further timeout later
                err = self._peer_lost_error(
                    f"collective failed and peer(s) "
                    f"{sorted(stale)} stopped heartbeating: {exc}",
                    cause=exc)
                raise err from exc
            if time.monotonic() >= deadline:
                raise exc          # inconclusive: the real error wins
            time.sleep(min(0.2, self.peer_timeout / 10))

    def alive_info(self):
        """{pid: parsed liveness record} from the monitor 'alive/' keys
        — THE one parse of those keys (the monitor, the staleness
        checks, and the peer table all read through here). Also folds
        each NEW beat value into `_beat_obs` with the LOCAL monotonic
        observation time, which is what every staleness decision
        compares against (peer wall clocks are display-only)."""
        seen = {}
        now = time.monotonic()
        for k, v in self.fetch_dir("alive/"):
            try:
                pid, info = int(k), json.loads(v)
            except (ValueError, TypeError):
                continue
            seen[pid] = info
            prev = self._beat_obs.get(pid)
            if prev is None or prev[0] != info.get("t"):
                self._beat_obs[pid] = (info.get("t"), now)
        return seen

    def _stale_peers(self, grace_start=None):
        """Peers whose monitor liveness beat is older than peer_timeout
        (or missing entirely), measured on THIS process's monotonic
        clock from when each beat was first observed — immune to
        cross-host clock skew. `grace_start` (monotonic): a peer with
        NO key yet is only stale once peer_timeout has elapsed since
        that time (its monitor may not have beaten yet); None treats
        absence as staleness — correct for autopsies at death time.
        Requires monitors running on the peers."""
        seen = self.alive_info()
        now = time.monotonic()
        stale = set()
        for pid in self.members:
            if pid == self.process_id:
                continue
            if pid not in seen:
                if grace_start is None \
                        or now - grace_start > self.peer_timeout:
                    stale.add(pid)
                continue
            obs = self._beat_obs.get(pid)
            if obs is not None and now - obs[1] > self.peer_timeout:
                stale.add(pid)
        return stale

    # -- the /health + report surface ------------------------------------
    def peer_table(self):
        """pid -> last-known info (heartbeat step/time/preempt flag,
        monitor beat age, lost verdicts) — the `GET /health` peer table
        and the forensics-report section."""
        now = time.time()
        table = {}
        for pid, info in self._peers.items():
            entry = dict(info)
            if "t" in entry:
                entry["hb_age_s"] = round(now - entry.pop("t"), 3)
            table[pid] = entry
        try:
            seen = self.alive_info()
            mono = time.monotonic()
            for pid, info in seen.items():
                obs = self._beat_obs.get(pid)
                if obs is not None:
                    table.setdefault(pid, {})["alive_age_s"] = \
                        round(mono - obs[1], 3)
                table.setdefault(pid, {}).setdefault(
                    "step", info.get("step"))
        except Exception:  # noqa: BLE001 — table is best-effort
            pass
        for pid, info in self._lost.items():
            table.setdefault(pid, {})["lost"] = info
        # straggler columns: per-host attributed step time + the culprit
        # verdict on the slow host's row (best-effort, read-only KV)
        if _mon.enabled() and self.num_processes > 1:
            try:
                _stragglers.annotate_peer_table(self, table)
            except Exception:  # noqa: BLE001
                pass
        return table

    def snapshot(self):
        snap = {
            "process_id": self.process_id,
            "num_processes": self.num_processes,
            "members": list(self.members),
            "step": self.step,
            "rounds": self.rounds,
            "sync_every": self.sync_every,
            "peer_timeout_s": self.peer_timeout,
            "preempt_requested": self._preempt_requested,
            "preempted": self.preempted,
            "lost": {str(k): v for k, v in self._lost.items()},
            "peers": {str(k): v for k, v in self.peer_table().items()},
            "last_report": self.last_report_path,
        }
        # accumulation / bucketed-exchange knobs of the bound trainer
        # (GET /health "distributed" section): how many microbatches
        # each optimizer step accumulates and how the exchange is split
        t = self._bound
        if t is not None:
            snap["accum_microbatches"] = int(
                getattr(t, "accumulation", 1) or 1)
            plan = getattr(t, "bucket_plan", None)
            if plan is not None:
                snap["exchange_buckets"] = plan.num_buckets
                snap["bucket_bytes"] = list(plan.bucket_bytes)
        # cluster metrics plane (process 0 is the serving end): per-host
        # snapshot ages / steps/s / exchange bytes for GET /health —
        # best-effort and bounded (health must always answer fast)
        if self.process_id == 0 and self.num_processes > 1 \
                and _mon.enabled():
            cm = _cluster.health_meta(self)
            if cm is not None:
                snap["cluster"] = cm
            try:
                sg = _stragglers.attribution(self)
            except Exception:  # noqa: BLE001
                sg = None
            if sg is not None:
                snap["stragglers"] = sg
        return snap

    # -- monitor thread --------------------------------------------------
    def start_monitor(self, poll_interval=None, abort=None):
        if self._monitor is None:
            self._monitor = PeerMonitor(self, poll_interval=poll_interval,
                                        abort=abort).start()
        return self._monitor

    def stop_monitor(self):
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None


class PeerMonitor:
    """Daemon thread: writes this process's wall-clock liveness key
    every `poll_interval` (overwrite allowed) and watches the peers'.
    A peer silent past `peer_timeout` trips ONCE: forensics dump with
    the peer table, `dl4j.dist.peer_lost`, the coordinator's `_lost`
    table (the next `on_step` raises `PeerLostError` — bounded even
    between sync points), and the optional `abort` callable (e.g.
    `lambda: os._exit(134)` when the main thread may be wedged inside a
    native collective that no Python-level exception can reach)."""

    def __init__(self, coordinator, poll_interval=None, abort=None):
        self.c = coordinator
        self.poll_interval = (min(1.0, self.c.peer_timeout / 4.0)
                              if poll_interval is None
                              else float(poll_interval))
        self.abort = abort
        self._stop = threading.Event()
        self._thread = None
        self._tripped = set()
        self._started = None

    def start(self):
        if self._thread is None:
            self._started = time.monotonic()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dl4j-peer-monitor")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None
        return self

    def check_now(self):
        """One liveness beat + peer scan (exposed for tests). A peer
        that has never written a liveness key is only stale once the
        grace window (one peer_timeout from monitor start) has elapsed —
        its monitor may simply not have beaten yet."""
        c = self.c
        if self._started is None:
            self._started = time.monotonic()
        c.publish(f"alive/{c.process_id}",
                  json.dumps({"step": c.step, "t": time.time()}),
                  overwrite=True)
        stale = c._stale_peers(grace_start=self._started) - self._tripped
        for pid in stale:
            self._tripped.add(pid)
            c._lost[pid] = {"monitor": True, "t": time.time()}
            c._peer_lost_error(
                f"process {pid} silent for > {c.peer_timeout:.1f} s "
                f"(monitor thread)", write_report=True)
            if self.abort is not None:
                try:
                    self.abort()
                except Exception:  # noqa: BLE001
                    pass
        return stale

    def _run(self):
        # grace: peers need one poll to write their first liveness key;
        # don't scan until this process has beaten at least once
        while not self._stop.wait(self.poll_interval):
            try:
                self.check_now()
            except Exception:  # noqa: BLE001 — monitor must stay alive
                pass


def install_preemption_handler(coordinator, signals=(signal.SIGTERM,)):
    """SIGTERM → `coordinator.request_preemption()`: the in-flight step
    drains, the next sync point reaches the coordinated drain decision,
    and the runner writes the final verified checkpoint before a clean
    exit. Chains any existing handler. Main thread only (signal API);
    returns the previous handlers for restoration."""
    prev = {}

    def make(old):
        def handler(signum, frame):
            coordinator.request_preemption(
                f"signal {signal.Signals(signum).name}")
            if callable(old):
                old(signum, frame)
        return handler

    for s in signals:
        prev[s] = signal.getsignal(s)
        signal.signal(s, make(prev[s]))
    return prev


def clear_coordinator():
    """Force-reset the global switch — test teardown only."""
    global ACTIVE
    ACTIVE = None
