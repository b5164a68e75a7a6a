"""Elastic cluster membership over the coordination KV (≡ the
reference's SharedTrainingMaster dynamic worker registry: workers
announce themselves to the master, join the parameter-sharing group at
a step boundary, and leave without tearing the run down).

TPU-native inversion: there is no master process holding the roster.
Membership changes ride the same write-once heartbeat agreement the
preemption drain uses — a host announces a JOIN or LEAVE on the KV
store, every member folds the pending announcements into its next
heartbeat, and the UNION over the round's (write-once) heartbeat set is
the agreed membership delta: every member computes the identical REFORM
decision at the identical step, so the dp mesh re-forms at a
coordinated step boundary with no one-sided view possible.

Commit is leader-driven only for KV hygiene (the lowest surviving pid
writes the new roster epoch, admits joiners, deletes the announcement
keys, and reaps the departed hosts' KV state); the roster itself was
already agreed by the heartbeat union before commit runs — a leader
crash mid-commit leaves announcements behind, which simply re-surface
at the next sync point.

Key schema (under the coordinator's namespace):

    em/join/<pid>    announcement: <pid> wants in  (overwrite ok)
    em/leave/<pid>   announcement: <pid> drains out (overwrite ok)
    em/roster/<e>    committed member list for epoch <e> (write-once)
    em/admit/<pid>   joiner's admission ticket: {"epoch", "members"}

`restack_encoder` is the host-side state migration for the per-worker
threshold-encoder stacks when the dp width changes — the elastic
sibling of the runner's `_migrate_encoder` legacy path.
"""
from __future__ import annotations

import json
import time

import numpy as np

from deeplearning4j_tpu_torch import monitoring as _mon
from deeplearning4j_tpu_torch.monitoring import events as _events
from deeplearning4j_tpu_torch.resilience.errors import MembershipChangeError

__all__ = ["ElasticMembership", "restack_encoder",
           "JOIN_PREFIX", "LEAVE_PREFIX", "ROSTER_PREFIX", "ADMIT_PREFIX"]

JOIN_PREFIX = "em/join/"
LEAVE_PREFIX = "em/leave/"
ROSTER_PREFIX = "em/roster/"
ADMIT_PREFIX = "em/admit/"

#: KV prefixes holding PER-HOST state that must not outlive the host —
#: reaped on leave/replace so /metrics, the /health peer table and the
#: straggler attribution stop showing the departed host as a live row
REAP_PREFIXES = ("metrics/", "steps/", "alive/")


class ElasticMembership:
    """Per-process membership endpoint, attached to a PeerCoordinator.

    The coordinator folds `pending()` into each heartbeat and reaches
    the REFORM decision; the driving runner then calls `commit()` on
    every member at the agreed boundary. Joining hosts use
    `announce_join()` + `await_admission()`."""

    def __init__(self, coordinator, members=None):
        self.c = coordinator
        self.members = sorted(members if members is not None
                              else range(coordinator.num_processes))
        self.epoch = 0
        coordinator.membership = self
        coordinator.members = list(self.members)

    # -- announcements ---------------------------------------------------
    def announce_join(self, pid=None):
        pid = self.c.process_id if pid is None else int(pid)
        self.c.publish(f"{JOIN_PREFIX}{pid}",
                       json.dumps({"pid": pid, "t": time.time()}),
                       overwrite=True)
        return pid

    def announce_leave(self, pid=None):
        pid = self.c.process_id if pid is None else int(pid)
        self.c.publish(f"{LEAVE_PREFIX}{pid}",
                       json.dumps({"pid": pid, "t": time.time()}),
                       overwrite=True)
        if _mon.enabled():
            _events.emit("parallel", _events.MEMBERSHIP_LEAVE,
                         attrs={"pid": pid},
                         correlation_id="membership")
        return pid

    def pending(self):
        """(joins, leaves) currently announced on the KV — this
        process's VIEW, which rides its next heartbeat; the agreed delta
        is the union over the round's heartbeat set, not this."""
        joins = sorted(int(k) for k, _ in self.c.fetch_dir(JOIN_PREFIX)
                       if int(k) not in self.members)
        leaves = sorted(int(k) for k, _ in self.c.fetch_dir(LEAVE_PREFIX)
                        if int(k) in self.members)
        return joins, leaves

    # -- the agreed transition -------------------------------------------
    def commit(self, joins, leaves, info=None):
        """Apply the AGREED delta. Every member calls this with the same
        (joins, leaves) — the union the coordinator computed from the
        round's write-once heartbeats. The leader (lowest surviving pid)
        additionally writes the roster epoch, admits joiners, clears the
        announcements and reaps departed-host KV state. `info` rides the
        joiners' admission tickets (warm-start pointers: drain-save
        step, old dp width, coordinator round counters). Returns the
        new member list."""
        joins = sorted(set(int(p) for p in joins) - set(self.members))
        leaves = sorted(set(int(p) for p in leaves) & set(self.members))
        new_members = sorted((set(self.members) - set(leaves))
                             | set(joins))
        if not new_members:
            raise MembershipChangeError(
                "membership change would leave zero members "
                f"(leaves={leaves})")
        survivors = sorted(set(self.members) - set(leaves))
        leader = min(survivors) if survivors else min(new_members)
        self.epoch += 1
        if self.c.process_id == leader:
            self.c.publish(f"{ROSTER_PREFIX}{self.epoch}",
                           json.dumps({"members": new_members,
                                       "epoch": self.epoch,
                                       "t": time.time()}))
            ticket = {"epoch": self.epoch, "members": new_members}
            if info:
                ticket.update(info)
            for pid in joins:
                self._delete(f"{JOIN_PREFIX}{pid}")
                self.c.publish(f"{ADMIT_PREFIX}{pid}",
                               json.dumps(ticket), overwrite=True)
            for pid in leaves:
                self._delete(f"{LEAVE_PREFIX}{pid}")
                self.reap_host(pid)
        self.members = new_members
        self.c.reform(new_members)
        if _mon.enabled():
            _events.emit("parallel", _events.MEMBERSHIP_EPOCH,
                         attrs={"epoch": self.epoch, "joins": joins,
                                "leaves": leaves,
                                "members": new_members},
                         correlation_id="membership")
        return new_members

    def abandon(self, joins=(), leaves=()):
        """Withdraw announcements after a FAILED transition (fault
        injected / joiner died mid-admission): the previous roster stays
        authoritative and the announcements stop re-surfacing. Safe on
        every member (deletes are idempotent)."""
        for pid in joins:
            self._delete(f"{JOIN_PREFIX}{int(pid)}")
        for pid in leaves:
            self._delete(f"{LEAVE_PREFIX}{int(pid)}")

    def await_admission(self, timeout=None):
        """JOINER side: block until the leader admits this process,
        then adopt the committed roster. Returns the admission ticket
        (epoch, members, plus whatever warm-start info the leader
        attached at commit). Raises the typed `MembershipChangeError`
        when nothing admits us in time (the cluster may have drained,
        or our announcement was abandoned)."""
        t = self.c.peer_timeout if timeout is None else float(timeout)
        try:
            raw = self.c.fetch(f"{ADMIT_PREFIX}{self.c.process_id}",
                               timeout=t)
        except Exception as e:  # noqa: BLE001 — timeout/transport alike
            raise MembershipChangeError(
                f"join announced but never admitted within {t:.1f} s "
                f"({e})") from e
        info = json.loads(raw)
        self.epoch = int(info["epoch"])
        self.members = sorted(int(p) for p in info["members"])
        self.c.reform(self.members)
        if _mon.enabled():
            _events.emit("parallel", _events.MEMBERSHIP_JOINED,
                         attrs={"pid": self.c.process_id,
                                "epoch": self.epoch,
                                "members": self.members},
                         correlation_id="membership")
        return info

    # -- departed-host KV hygiene ----------------------------------------
    def reap_host(self, pid):
        """Delete every KV key a departed host owned: its metrics /
        step-timeline / liveness records (the monitoring planes drop the
        stale row at their next gather) and any heartbeat keys it left
        behind."""
        for pfx in REAP_PREFIXES:
            self._delete(f"{pfx}{pid}")
        # heartbeat keys are round-keyed (hb/<rnd>/<pid>): enumerate and
        # delete the departed pid's leaves
        try:
            for k, _ in self.c.fetch_dir("hb/"):
                if k.endswith(f"/{pid}"):
                    self._delete(f"hb/{k}")
        except Exception:  # noqa: BLE001 — hygiene is best-effort
            pass

    def _delete(self, key):
        try:
            self.c._client.key_value_delete(self.c._key(key))
        except Exception:  # noqa: BLE001 — deletes are best-effort
            pass


def restack_encoder(enc, new_n):
    """Re-stack per-worker threshold-encoder state for a NEW dp width —
    host-side numpy, called at the reform boundary on gathered state
    (the elastic sibling of the runner's `_migrate_encoder`).

    Shrink folds row i into row i % new_n: residual mass is CONSERVED
    (the departed workers' un-sent gradient mass is inherited by the
    survivors instead of silently dropped). Grow keeps the surviving
    rows and appends zero residual for the new workers, with thresholds
    tiled cyclically from the existing rows (a joiner starts from a
    peer's adapted threshold, not the cold-start default). `nnz` is
    telemetry from the LAST step on the OLD width — zeroed either way.
    """
    thr = np.asarray(enc["threshold"])
    old_n = int(thr.shape[0])
    new_n = int(new_n)
    if new_n < 1:
        raise ValueError(f"restack_encoder: new width {new_n} < 1")
    if new_n == old_n:
        return enc

    def stack_rows(a):
        a = np.asarray(a)
        if new_n < old_n:
            out = a[:new_n].copy()
            for i in range(new_n, old_n):
                out[i % new_n] = out[i % new_n] + a[i]
            return out
        return np.concatenate(
            [a, np.zeros((new_n - old_n,) + a.shape[1:], a.dtype)])

    residual = {b: stack_rows(r) for b, r in enc["residual"].items()}
    if new_n < old_n:
        new_thr = thr[:new_n].copy()
    else:
        extra = np.stack([thr[i % old_n] for i in range(old_n, new_n)])
        new_thr = np.concatenate([thr, extra])
    nnz = np.zeros((new_n,) + np.asarray(enc["nnz"]).shape[1:],
                   np.asarray(enc["nnz"]).dtype)
    return {"residual": residual, "threshold": new_thr, "nnz": nnz}
