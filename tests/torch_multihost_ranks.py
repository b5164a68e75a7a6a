"""The rank side of the port's multi-host tests (tests/test_torch_multihost.py).

`spawn(world, cases, directory, inputs)` starts `world` gloo ranks with
`torch.multiprocessing.spawn` over a FileStore in `directory`; every rank
runs every named case on the shared `inputs` (numpy) and pickles its
results (numpy) to `directory`. The FileStore also carries the
coordination KV (`StoreKV`) and the process groups an elastic re-form
brings up. A case that raises records its traceback, so the test of that
contract fails and the others still run; the elastic case re-forms the
default group, so it runs last. This module imports no JAX.

The seeded inputs both packages use are made here too.
"""
from __future__ import annotations

import os
import pickle
import traceback

import numpy as np

TIMEOUT_S = 120
#: the rank's FileStore (the coordination KV and re-formed groups use it)
STORE = None
OUT_DIR = None

# the MLP of bench_multihost.py:66-80, at a small batch
FEATURES, HIDDEN, CLASSES, MICRO = 256, 256, 16, 8


def mlp_params(seed=0):
    r = np.random.default_rng(seed)
    return {"W1": (r.standard_normal((FEATURES, HIDDEN)) * 0.05
                   ).astype(np.float32),
            "b1": np.zeros(HIDDEN, np.float32),
            "W2": (r.standard_normal((HIDDEN, CLASSES)) * 0.05
                   ).astype(np.float32),
            "b2": np.zeros(CLASSES, np.float32)}


def mlp_batch(step, g=2, rows=2 * MICRO):
    """A super-batch (G, rows, ...) of step `step` (G = 1: (rows, ...))."""
    r = np.random.default_rng(1 + step)
    xs = r.standard_normal((g, rows, FEATURES)).astype(np.float32)
    ys = np.eye(CLASSES, dtype=np.float32)[r.integers(0, CLASSES, (g, rows))]
    if g == 1:
        return {"x": xs[0], "y": ys[0]}
    return {"x": xs, "y": ys}


def bert_batch(cfg_vocab, cfg_labels, step, g=2, rows=4, t=16):
    r = np.random.default_rng(50 + step)
    ids = r.integers(0, cfg_vocab, (g, rows, t))
    labels = r.integers(0, cfg_labels, (g, rows))
    return {"input_ids": ids, "labels": labels}


#: the trainer settings every parity case shares with the JAX side
LR = 0.1
THRESHOLD = 1e-3
STEPS = 3
PARITY = {
    "dense": dict(wire="dense", buckets=3, updater="sgd"),
    "sparse": dict(wire="sparse", buckets=3, updater="sgd",
                   wire_capacity=1.0),
    "zero1": dict(wire="dense", buckets=2, updater="nesterovs", zero1=True),
}


def _mlp_loss(p, batch, gen):
    import torch
    h = torch.tanh(batch["x"] @ p["W1"] + p["b1"])
    logp = torch.log_softmax(h @ p["W2"] + p["b2"], -1)
    return -(batch["y"] * logp).sum(-1).mean()


def _np(t):
    """A copy (a CPU tensor's .numpy() shares the memory a later in-place
    step writes)."""
    return np.array(t.detach().cpu())


def _tree_np(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_np(v) for v in tree]
    return _np(tree) if torch.is_tensor(tree) else tree


def _updater(name):
    from deeplearning4j_tpu_torch.nn import Nesterovs, Sgd
    return Sgd(LR) if name == "sgd" else Nesterovs(LR, 0.9)


def _encoder(o):
    enc = o["encoder"]
    return {"residual": {b: _np(r) for b, r in enc["residual"].items()},
            "threshold": _np(enc["threshold"]), "nnz": _np(enc["nnz"])}


def _parity(loss_fn, params, batches, kw):
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHostTrainer, global_batch)
    kw = dict(kw)
    tr = MultiHostTrainer(loss_fn, _updater(kw.pop("updater")),
                          compress=True, accumulation=2,
                          compression_kw={"initial_threshold": THRESHOLD},
                          **kw)
    p, o = tr.init(params)
    losses = []
    for b in batches:
        p, o, loss = tr.fit_batch(p, o, global_batch(tr.mesh, b,
                                                     accumulation=2))
        losses.append(float(loss))
    return {"params": _tree_np(p), "encoder": _encoder(o),
            "losses": losses, "log": list(tr.exchange_log),
            "buckets": tr.bucket_plan.buckets}


def case_mlp(inputs):
    batches = [mlp_batch(s) for s in range(STEPS)]
    return {name: _parity(_mlp_loss, mlp_params(), batches, kw)
            for name, kw in PARITY.items()}


def case_bert(inputs):
    from deeplearning4j_tpu_torch.models.bert import (bert_tiny,
                                                      classification_loss)
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    cfg = bert_tiny()
    params = params_from_numpy(cfg, inputs["bert_params"], device="cpu")

    def loss_fn(p, batch, gen):
        return classification_loss(cfg, p, batch, train=False)

    batches = [bert_batch(cfg.vocab_size, cfg.num_labels, s)
               for s in range(STEPS)]
    return _parity(loss_fn, params, batches,
                   dict(wire="dense", buckets=4, updater="sgd"))


def case_sparse_bits(inputs):
    """Within the port at two ranks: the sparse wire at a capacity that
    admits the shipped set equals the dense wire bit for bit (params,
    residuals, thresholds, losses), over 5 steps."""
    import torch
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHostTrainer, global_batch)
    runs = {}
    for wire in ("dense", "sparse"):
        tr = MultiHostTrainer(_mlp_loss, _updater("sgd"), compress=True,
                              buckets=3, wire=wire, wire_capacity=1.0,
                              compression_kw={"initial_threshold": THRESHOLD})
        p, o = tr.init(mlp_params())
        losses = []
        for s in range(5):
            p, o, loss = tr.fit_batch(p, o, global_batch(
                tr.mesh, mlp_batch(s, g=1)))
            losses.append(float(loss))
        runs[wire] = (p, o, losses, tr)
    (pd, od, ld, _), (ps, os_, ls, trs) = runs["dense"], runs["sparse"]
    same = all(torch.equal(pd[k], ps[k]) for k in pd)
    same_enc = all(torch.equal(a, b) for a, b in zip(
        od["encoder"]["residual"].values(),
        os_["encoder"]["residual"].values())) and torch.equal(
        od["encoder"]["threshold"], os_["encoder"]["threshold"])
    return {"params_equal": same, "encoder_equal": same_enc,
            "losses": (ld, ls), "stats": trs.encoder_stats(os_),
            "log": list(trs.exchange_log)}


# -- the runner at two ranks ----------------------------------------------------
def _runner(ns, directory, preempt=None, guardian=False, sync_every=2,
            save_every=4):
    from deeplearning4j_tpu_torch.parallel.multihost import (
        CoordinatedGuardian, MultiHostRunner, MultiHostTrainer,
        PeerCoordinator, StoreKV)
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.errors import PreemptionSignal
    import torch.distributed as dist
    c = PeerCoordinator(sync_every=sync_every, peer_timeout=30.0,
                        client=StoreKV(STORE, 2), namespace=ns,
                        dump_dir=OUT_DIR)
    tr = MultiHostTrainer(_mlp_loss, _updater("sgd"), compress=True,
                          accumulation=2, buckets=2,
                          compression_kw={"initial_threshold": THRESHOLD})
    g = CoordinatedGuardian(c, warmup_steps=100) if guardian else None
    r = MultiHostRunner(tr, directory, c, save_every=save_every, guardian=g,
                        rng_seed=3, monitor=False, sigterm=False)
    if preempt is not None and dist.get_rank() == 1:
        plan = faults.FaultPlan(seed=0)
        plan.fail_at(faults.HOST_PREEMPT, preempt,
                     exc=lambda site, n: PreemptionSignal(f"inj@{n}"))
        plan.install()
    return r


def _drive(r, total):
    from deeplearning4j_tpu_torch.parallel.multihost import global_batch
    p, o = r.resume_or_init(mlp_params())
    losses = []
    while r.step < total:
        p, o, loss = r.fit_batch(p, o, global_batch(
            r.trainer.mesh, mlp_batch(r.step), accumulation=2))
        losses.append(float(loss))
    return p, o, losses


def case_runner(inputs):
    """Clean 8 steps; a preemption injected on rank 1 at its second sync
    round drains both ranks at step 4 into a verified checkpoint; a fresh
    runner resumes and ends bit-identical to the clean run (params and
    encoder state)."""
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.errors import PreemptionSignal
    base = os.path.join(OUT_DIR, "runner")
    r = _runner("mh-clean", base + "-clean", guardian=True)
    p, o, losses = _drive(r, 8)
    r.finalize(p, o)
    clean = {"params": _tree_np(p), "encoder": _encoder(o),
             "losses": losses, "save": r.last_save}
    r = _runner("mh-pre", base + "-pre", preempt=2, guardian=True)
    drained = None
    try:
        _drive(r, 8)
    except PreemptionSignal:
        drained = r.step
    finally:
        faults.clear_plan()
        r.close()
    r = _runner("mh-res", base + "-pre", guardian=True)
    p, o, losses = _drive(r, 8)
    resumed = r.resumed_step
    r.finalize(p, o)
    return {"clean": clean, "drained": drained, "resumed": resumed,
            "params": _tree_np(p), "encoder": _encoder(o)}


def case_ft_sharded(inputs):
    """FaultTolerantTrainer's sharded mode over a compressing
    MultiHostTrainer at dp = 2: a run stopped after step 5 resumes from
    its step-4 save on both ranks and ends bit-identical to the clean
    6-step run (parameters, base state, each rank's encoder row); then a
    NaN window rolls both ranks back to one generation."""
    import torch
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHostTrainer, global_batch)
    from deeplearning4j_tpu_torch.resilience import (FaultTolerantTrainer,
                                                     TrainingGuardian)
    from deeplearning4j_tpu_torch.resilience import integrity
    base = os.path.join(OUT_DIR, "ft-sharded")

    def run(directory, steps, guardian=None, nan=()):
        tr = MultiHostTrainer(_mlp_loss, _updater("nesterovs"),
                              compress=True, buckets=2,
                              compression_kw={"initial_threshold":
                                              THRESHOLD})
        t = FaultTolerantTrainer(tr, directory, save_every=2,
                                 guardian=guardian)
        p, o = t.resume_or_init_sharded(mlp_params())
        start = t.step
        while t.step < steps:
            b = global_batch(tr.mesh, mlp_batch(t.step, g=1))
            if t.step in nan:
                b["x"] = b["x"] * float("nan")
            p, o, _ = t.fit_batch(p, o, b, None)
        return t, p, o, start

    t, want_p, want_o, _ = run(base + "-clean", 6)
    t.close()
    t, p, o, _ = run(base + "-cut", 5)
    t.close()
    t, p, o, start = run(base + "-cut", 6)
    t.close()
    equal = [pa == pb and torch.equal(a, b) for (pa, a), (pb, b) in zip(
        integrity.flatten({"p": p, "o": o}),
        integrity.flatten({"p": want_p, "o": want_o}))]
    g = TrainingGuardian(check_every=1, warmup_steps=100, max_skips=1,
                         max_lr_retries=0, max_rollbacks=2)
    t, p, _, _ = run(base + "-nan", 8, guardian=g, nan=(4, 5))
    t.close()
    return {"start": start, "equal": equal, "rollbacks": g.rollbacks,
            "restored": g.last_restored_step, "after": _tree_np(p),
            "finite": all(bool(torch.isfinite(v).all())
                          for v in p.values())}


def case_elastic(inputs):
    """A graceful leave 2 → 1 at step 4 and a `join_cluster` 1 → 2 of the
    same process: the group re-forms each time (GroupMeshFactory), the
    encoder rows re-stack with their residual mass conserved, and both
    ranks finish in lockstep with equal parameters."""
    import time
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.multihost import (
        ElasticMembership, GroupMeshFactory, MultiHostRunner,
        MultiHostTrainer, PeerCoordinator, StoreKV, global_batch)
    from deeplearning4j_tpu_torch.resilience.errors import PreemptionSignal
    rank = dist.get_rank()
    directory = os.path.join(OUT_DIR, "elastic")
    kv = StoreKV(STORE, 2)

    def trainer(mesh):
        return MultiHostTrainer(_mlp_loss, _updater("sgd"), mesh=mesh,
                                compress=True, buckets=2,
                                compression_kw={"initial_threshold":
                                                THRESHOLD})

    def coordinator():
        return PeerCoordinator(sync_every=2, peer_timeout=30.0, client=kv,
                               process_id=rank, num_processes=2,
                               namespace="el", dump_dir=OUT_DIR)

    c = coordinator()
    m = ElasticMembership(c)
    factory = GroupMeshFactory(c, store=STORE, backend="gloo",
                               timeout_s=TIMEOUT_S)
    r = MultiHostRunner(trainer(DeviceMesh(dp=2)), directory, c,
                        save_every=4, elastic=True, mesh_factory=factory,
                        membership=m, monitor=False, sigterm=False)
    p, o = r.resume_or_init(mlp_params())
    out = {"widths": []}

    def step():
        nonlocal p, o
        p, o, loss = r.fit_batch(p, o, global_batch(
            r.trainer.mesh, mlp_batch(r.step, g=1)))
        out["widths"].append((r.step, r.trainer.dp))

    total = 14
    if rank == 1:
        try:
            while True:
                if r.step == 4:
                    r.request_leave()
                step()
        except PreemptionSignal:
            out["left_at"] = r.step
        r.close()
        time.sleep(0.5)
        c = coordinator()
        r, p, o = MultiHostRunner.join_cluster(
            trainer, directory, c, GroupMeshFactory(
                c, store=STORE, backend="gloo", timeout_s=TIMEOUT_S),
            mlp_params(), timeout=60.0, save_every=4, monitor=False,
            sigterm=False)
        out["joined_at"] = r.step
        out["joined_encoder"] = _encoder(o)
    else:
        reformed = False
        while r.step < total:
            before = r.trainer.dp
            step()
            if before == 2 and r.trainer.dp == 1:
                snap = r._last_host_state["opt_state"]["encoder"]
                out["leave_mass"] = {
                    b: (_np(snap["residual"][b]).sum(0),
                        _np(o["encoder"]["residual"][b])[0])
                    for b in snap["residual"]}
                out["left_at"] = r.step
                # wait for the rejoin announcement before going on, so
                # the join lands mid-run
                deadline = time.monotonic() + 60
                while not m.pending()[0] and time.monotonic() < deadline:
                    time.sleep(0.05)
            if before == 1 and r.trainer.dp == 2 and not reformed:
                reformed = True
                out["joined_at"] = r.step
                out["joined_encoder"] = _encoder(o)
    while r.step < total:
        step()
    out["members"] = list(c.members)
    out["params"] = _tree_np(p)
    out["encoder"] = _encoder(o)
    out["world"] = dist.get_world_size()
    r.finalize(p, o)
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _rank_main(rank, world, store_path, out_dir, cases, inputs_path):
    global STORE, OUT_DIR
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import faulthandler
    import sys
    faulthandler.dump_traceback_later(
        float(os.environ.get("RANK_DUMP_S", "1e9")), exit=True,
        file=sys.stderr)
    STORE = dist.FileStore(store_path, world)
    OUT_DIR = out_dir
    dist.init_process_group("gloo", store=STORE, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    try:
        for name in cases:
            try:
                res = {"ok": CASES[name](inputs)}
            except Exception:   # the test of this contract reports it
                res = {"error": traceback.format_exc()}
            with open(os.path.join(out_dir, f"{name}.{rank}.pkl"),
                      "wb") as f:
                pickle.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world, cases, directory, inputs):
    """Run `cases` on `world` gloo ranks; returns {case: [each rank's
    result dict ({"ok": ...} or {"error": traceback})]}."""
    import torch.multiprocessing as mp
    directory = str(directory)
    inputs_path = os.path.join(directory, "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_rank_main, args=(world, os.path.join(directory, "store"),
                               directory, list(cases), inputs_path),
             nprocs=world, join=True)
    out = {}
    for name in cases:
        out[name] = []
        for r in range(world):
            with open(os.path.join(directory, f"{name}.{r}.pkl"), "rb") as f:
                out[name].append(pickle.load(f))
    return out
