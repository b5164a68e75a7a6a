"""The port's MultiHostRunner, MultiHostTrainer's wire and the elastic
membership flows in one process, held to the contracts of the JAX
package's tests/test_multihost_chaos.py (:418-615, its single-process
runner tier), tests/test_wire_format.py and tests/test_elastic.py.

The runner tier runs one rank over a `LocalKV` (the world of one the
port has without a process group). The elastic flows drive ONE real
runner (process 0) against synthetic peers: bare `PeerCoordinator`s
pumped from threads on the shared LocalKV, as the JAX package's tests
do; with one process the mesh stays one rank wide, so these hold the
membership protocol (agreement, commit, reap, rewind, bit-equal replay,
typed failures) and tests/test_torch_multihost.py holds the width
changes at two real ranks. Every bit-identity contract is held inside
the port, bit for bit.
"""
import hashlib
import json
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import Sgd
from deeplearning4j_tpu_torch.parallel import coordination as coord_mod
from deeplearning4j_tpu_torch.parallel import compression as comp
from deeplearning4j_tpu_torch.parallel.buckets import \
    check_overlap_structure
from deeplearning4j_tpu_torch.parallel.membership import (JOIN_PREFIX,
                                                          ElasticMembership,
                                                          restack_encoder)
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
from deeplearning4j_tpu_torch.parallel.multihost import (CoordinatedGuardian,
                                                         LocalKV,
                                                         MultiHostRunner,
                                                         MultiHostTrainer,
                                                         PeerCoordinator,
                                                         global_batch)
from deeplearning4j_tpu_torch.resilience import faults, integrity
from deeplearning4j_tpu_torch.resilience.errors import (
    MembershipChangeError, PreemptionSignal, WireFormatError)

TOTAL, SYNC, SAVE = 12, 2, 4


@pytest.fixture(autouse=True)
def _clean_switches():
    yield
    coord_mod.clear_coordinator()
    faults.clear_plan()
    from deeplearning4j_tpu_torch.resilience import guardian as _g
    _g.clear_guardian()


def _loss_fn(params, batch, gen):
    h = torch.tanh(batch["x"] @ params["W1"])
    scale = batch["scale"].mean() if "scale" in batch else 1.0
    return scale * (h * h).mean()


def _init_params():
    r = np.random.default_rng(0)
    return {"W1": (r.standard_normal((6, 5)) * 0.5).astype(np.float32)}


def _make_runner(tmp_path, name, preempt_at=None, guardian=False,
                 compress=True, accum=1, buckets=None):
    coordinator = PeerCoordinator(sync_every=SYNC, peer_timeout=5.0,
                                  client=LocalKV(), process_id=0,
                                  num_processes=1, dump_dir=str(tmp_path))
    trainer = MultiHostTrainer(_loss_fn, Sgd(0.3), compress=compress,
                               accumulation=accum, buckets=buckets,
                               compression_kw={"initial_threshold": 1e-4})
    g = None
    if guardian:
        g = CoordinatedGuardian(coordinator, check_every=SYNC,
                                warmup_steps=100, max_skips=1,
                                max_lr_retries=0, max_rollbacks=2)
    runner = MultiHostRunner(trainer, str(tmp_path / name), coordinator,
                             save_every=SAVE, guardian=g, rng_seed=3,
                             monitor=False, sigterm=False)
    if preempt_at is not None:
        plan = faults.FaultPlan(seed=0)
        plan.fail_at(faults.HOST_PREEMPT, preempt_at,
                     exc=lambda site, n: PreemptionSignal(f"inj@{n}"))
        plan.install()
    return runner


def _batch(trainer, step, nan=False):
    r = np.random.default_rng(100 + step)
    g = trainer.accumulation
    if g > 1:
        # super-batch (G, B, ...): a NaN poisons ONE microbatch only
        xs = r.standard_normal((g, 8, 6)).astype(np.float32)
        scale = np.ones((g, 8, 1), np.float32)
        if nan:
            scale[1] = np.nan
        return global_batch(trainer.mesh, {"x": xs, "scale": scale},
                            accumulation=g)
    xs = r.standard_normal((8, 6)).astype(np.float32)
    return global_batch(trainer.mesh, {
        "x": xs, "scale": np.full((8, 1), np.nan if nan else 1.0,
                                  np.float32)})


def _drive(runner, total=TOTAL, nan_steps=()):
    params, opt_state = runner.resume_or_init(_init_params())
    while runner.step < total:
        b = _batch(runner.trainer, runner.step,
                   nan=runner.step in nan_steps)
        params, opt_state, _ = runner.fit_batch(params, opt_state, b)
    return params, opt_state


def _digest(tree):
    h = hashlib.md5()
    for _, leaf in integrity.flatten(tree):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


# ===================== the runner (test_multihost_chaos.py:502-615) =========
@pytest.mark.parametrize("accum,buckets", [(1, None), (4, 2)])
def test_runner_preemption_bit_identical(tmp_path, accum, buckets):
    """host.preempt injected mid-run → coordinated drain + verified
    checkpoint + PreemptionSignal; a fresh runner resumes and the final
    parameters AND the per-bucket encoder state (residuals, thresholds)
    are bit-identical to a never-preempted run — with in-step
    accumulation and the bucketed exchange too."""
    runner = _make_runner(tmp_path, "clean", accum=accum, buckets=buckets)
    params, opt = _drive(runner)
    ref = (_digest(params), _digest(opt["encoder"]))
    runner.finalize(params, opt)

    runner = _make_runner(tmp_path, "pre", preempt_at=2, accum=accum,
                          buckets=buckets)
    with pytest.raises(PreemptionSignal):
        _drive(runner)
    faults.clear_plan()
    drained = runner.step
    runner.close()
    assert 0 < drained < TOTAL

    runner = _make_runner(tmp_path, "pre", accum=accum, buckets=buckets)
    params2, opt2 = _drive(runner)
    assert runner.resumed_step == drained
    assert (_digest(params2), _digest(opt2["encoder"])) == ref
    runner.finalize(params2, opt2)


def test_runner_resume_restores_encoder_residual(tmp_path):
    runner = _make_runner(tmp_path, "res", preempt_at=2)
    with pytest.raises(PreemptionSignal):
        _drive(runner)
    faults.clear_plan()
    runner.close()
    runner = _make_runner(tmp_path, "res")
    _, opt_state = runner.resume_or_init(_init_params())
    assert opt_state["encoder"]["residual"]["0"].abs().sum() > 0
    runner.close()


@pytest.mark.parametrize("accum,buckets", [(1, None), (4, 2)])
def test_runner_rollback_lands_on_verified_generation(tmp_path, accum,
                                                      buckets):
    """A NaN window (a NaN in one MICROBATCH of the super-batch under
    accumulation) fails the verdict on device, exhausts the skip rung,
    and the coordinated rollback restores the newest verified generation;
    training ends finite."""
    runner = _make_runner(tmp_path, "roll", guardian=True, accum=accum,
                          buckets=buckets)
    params, opt = _drive(runner, nan_steps=(5, 6, 7, 8))
    g = runner.guardian
    assert g.skipped >= 2
    assert g.rollbacks >= 1
    assert g.last_restored_step is not None
    assert torch.isfinite(params["W1"]).all()
    runner.finalize(params, opt)


def test_compressed_trainer_trains_and_reports_stats(tmp_path):
    runner = _make_runner(tmp_path, "stats")
    params, opt_state = runner.resume_or_init(_init_params())
    losses = []
    while runner.step < 8:
        params, opt_state, loss = runner.fit_batch(
            params, opt_state, _batch(runner.trainer, 0))
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    stats = runner.trainer.encoder_stats(opt_state)
    assert stats["nnz"] >= 0 and stats["threshold"] > 0
    assert np.isfinite(stats["residual_norm"])
    runner.finalize(params, opt_state)


def test_coordinated_save_verifies_and_reports(tmp_path):
    """A coordinated save writes the gathered state (encoder stacks one
    row wide here) with a manifest that verifies against the saving
    rank's own copy; the runner reports its seconds and bytes."""
    runner = _make_runner(tmp_path, "save")
    params, opt = _drive(runner, total=4)
    step, seconds, nbytes = runner.last_save
    assert step == 4 and seconds >= 0
    runner.ckpt.wait_until_finished()
    host = runner._last_host_state
    assert integrity.verify_restored(str(tmp_path / "save"), 4, host,
                                     check_finite=False) == "verified"
    assert nbytes == sum(int(t.numel()) * t.element_size()
                         for _, t in integrity.flatten(host))
    assert host["opt_state"]["encoder"]["threshold"].shape == (1, 1)
    runner.finalize(params, opt)


def test_raw_buckets_equal_the_sharded_trainer_bit_for_bit(tmp_path):
    """compress=False with buckets: the bucketed exchange of raw
    gradients at one rank gives the ShardedTrainer's update bit for bit
    (the mean of one is exact), with accumulation. Twelve layers in a
    list: accumulation returns the gradients with their paths in string
    order ("/layers/10" before "/layers/2"), so buckets that packed by
    position instead of by path would hand layer 10's gradient to layer
    2."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer
    r = np.random.default_rng(4)
    params = {"layers": [{"W": r.standard_normal((5, 5)).astype(
        np.float32) * 0.5, "b": r.standard_normal(5).astype(np.float32)}
        for _ in range(12)],
        "out": r.standard_normal((5, 3)).astype(np.float32)}

    def loss_fn(p, b, gen):
        h = b["x"]
        for layer in p["layers"]:
            h = torch.tanh(h @ layer["W"] + layer["b"])
        return (h @ p["out"]).pow(2).mean()

    batches = [{"x": r.standard_normal((2, 8, 5)).astype(np.float32)}
               for _ in range(3)]
    for buckets in (1, 3):
        a = MultiHostTrainer(loss_fn, Sgd(0.1), compress=False,
                             buckets=buckets, accumulation=2)
        b = ShardedTrainer(loss_fn, Sgd(0.1), a.mesh, accumulation=2)
        pa, sa = a.init(params)
        pb, sb = b.init(params)
        for x in batches:
            pa, sa, la = a.fit_batch(pa, sa, a.shard_batch(x))
            pb, sb, lb = b.fit_batch(pb, sb, b.shard_batch(x))
            assert torch.equal(la, lb)
        for (ka, va), (kb, vb) in zip(integrity.flatten(pa),
                                      integrity.flatten(pb)):
            assert ka == kb and torch.equal(va, vb), ka
        assert check_overlap_structure(a.exchange_log, buckets) == []


def test_residual_mass_is_conserved_per_bucket():
    """Per bucket, the shipped payload plus the new residual equals the
    gradient plus the old residual (to f32 rounding of one subtraction)."""
    r = np.random.default_rng(5)
    params = {"W1": r.standard_normal((6, 5)).astype(np.float32),
              "W2": r.standard_normal((5, 3)).astype(np.float32)}

    def loss_fn(p, b, gen):
        return (torch.tanh(b["x"] @ p["W1"]) @ p["W2"]).pow(2).mean()

    tr = MultiHostTrainer(loss_fn, Sgd(0.1), buckets=2,
                          compression_kw={"initial_threshold": 1e-2})
    tr.keep_exchange = True
    p, o = tr.init(params)
    for i in range(3):
        old = [t.clone() for t in o["encoder"]["residual"].values()]
        p, o, _ = tr.fit_batch(p, o, tr.shard_batch(
            {"x": r.standard_normal((8, 6)).astype(np.float32)}))
        for b, (ex, r0) in enumerate(zip(tr.last_exchange, old)):
            r1 = o["encoder"]["residual"][str(b)][0]
            lhs, rhs = ex["sent"] + r1, ex["flat"] + r0[0]
            assert (lhs - rhs).abs().max() <= 1e-6 * max(
                1.0, float(rhs.abs().max()))
            assert torch.equal(ex["delivered"], ex["sent"])


# ===================== the wire (test_wire_format.py) ========================
def _wire_trainer(wire, capacity=1.0, threshold=1e-4, buckets=None):
    return MultiHostTrainer(_loss_fn, Sgd(0.3), compress=True, wire=wire,
                            wire_capacity=capacity, buckets=buckets,
                            compression_kw={"initial_threshold": threshold})


def _wire_batch(tr, step):
    r = np.random.default_rng(100 + step)
    return global_batch(tr.mesh,
                        {"x": r.standard_normal((8, 6)).astype(np.float32)})


def test_wire_capacity_and_payload_bytes():
    assert comp.wire_capacity(1000, 0.05) == 50
    assert comp.wire_capacity(10, 0.0001) == 1
    assert comp.wire_capacity(10, 1.0) == 10
    assert comp.wire_capacity(7, 0.5) == 4
    assert comp.wire_payload_bytes(50) == (50 + comp.WIRE_HEADER) * 4


def test_sparse_trainer_bit_identical_to_dense():
    runs = {}
    for wire in ("dense", "sparse"):
        tr = _wire_trainer(wire)
        p, s = tr.init(_init_params())
        for step in range(10):
            p, s, loss = tr.fit_batch(p, s, _wire_batch(tr, step))
        runs[wire] = (p, s, float(loss))
    (pd, sd, ld), (ps, ss, ls) = runs["dense"], runs["sparse"]
    assert torch.equal(pd["W1"], ps["W1"])
    for a, b in zip(sd["encoder"]["residual"].values(),
                    ss["encoder"]["residual"].values()):
        assert torch.equal(a, b)
    assert torch.equal(sd["encoder"]["threshold"],
                       ss["encoder"]["threshold"])
    assert ld == ls


def test_sparse_capacity_overflow_stays_in_residual():
    tr = _wire_trainer("sparse", capacity=2)
    p, s = tr.init(_init_params())
    for step in range(4):
        p, s, _ = tr.fit_batch(p, s, _wire_batch(tr, step))
    stats = tr.encoder_stats(s)
    assert stats["wire_capacity"] == [2]
    assert stats["residual_norm"] > 0
    assert torch.isfinite(p["W1"]).all()


def test_wire_bytes_track_nnz():
    tr = _wire_trainer("sparse", capacity=1.0)
    p, s = tr.init(_init_params())
    for step in range(3):
        p, s, _ = tr.fit_batch(p, s, _wire_batch(tr, step))
    stats = tr.encoder_stats(s)
    header_bytes = comp.WIRE_HEADER * 4 * len(stats["wire_capacity"])
    assert stats["wire_bytes"] <= 2 * stats["nnz"] * 4 + header_bytes
    tr2 = _wire_trainer("sparse", capacity=3, threshold=10.0)
    p2, s2 = tr2.init(_init_params())
    for step in range(2):
        p2, s2, _ = tr2.fit_batch(p2, s2, _wire_batch(tr2, step))
    st2 = tr2.encoder_stats(s2)
    assert st2["wire_bytes"] < st2["dense_bytes"]


def test_wire_decode_fault_site_containment():
    """The wire.decode site drives the corrupt-message chaos through the
    trainer's hook: the injected WireFormatError surfaces typed, and
    after the plan clears the SAME trainer keeps training."""
    tr = _wire_trainer("sparse")
    p, s = tr.init(_init_params())
    p, s, _ = tr.fit_batch(p, s, _wire_batch(tr, 0))
    before = p["W1"].clone()
    plan = faults.FaultPlan(seed=0).fail_at(
        faults.WIRE_DECODE, 1,
        exc=lambda site, n: WireFormatError(
            f"injected corrupt sparse message at {site} call {n}"))
    try:
        with plan:
            with pytest.raises(WireFormatError, match="corrupt sparse"):
                tr.fit_batch(p, s, _wire_batch(tr, 1))
        assert plan.fired[faults.WIRE_DECODE] == 1
    finally:
        faults.clear_plan()
    assert torch.equal(p["W1"], before)
    p, s, loss = tr.fit_batch(p, s, _wire_batch(tr, 1))
    assert np.isfinite(float(loss))


def test_comm_allreduce_fault_site_fires_per_exchange():
    tr = _wire_trainer("dense")
    p, s = tr.init(_init_params())
    plan = faults.FaultPlan(seed=0)
    with plan:
        for step in range(3):
            p, s, _ = tr.fit_batch(p, s, _wire_batch(tr, step))
    assert plan._calls[faults.COMM_ALLREDUCE] == 3
    assert plan._calls.get(faults.WIRE_DECODE, 0) == 0


def test_sparse_exchange_overlap_structure():
    """The sparse exchange's recorded order over 3 buckets: one
    collective per bucket, each issued before the next bucket encodes
    and waited only after the last issue."""
    tr = _wire_trainer("sparse", buckets=3)
    p, s = tr.init({"W1": _init_params()["W1"],
                    "W2": np.zeros((5, 4), np.float32),
                    "W3": np.zeros((4, 3), np.float32)})

    def loss_fn(params, batch, gen):
        h = torch.tanh(batch["x"] @ params["W1"]) @ params["W2"]
        return (h @ params["W3"]).pow(2).mean()

    tr.loss_fn = loss_fn
    tr.fit_batch(p, s, _wire_batch(tr, 0))
    assert tr.bucket_plan.num_buckets == 3
    assert check_overlap_structure(tr.exchange_log, 3,
                                   require_async=True) == []
    serial = [n for b in range(3) for n in (f"dl4j_bucket{b}_encode",
                                            f"dl4j_bucket{b}_exchange",
                                            f"dl4j_bucket{b}_wait")]
    assert check_overlap_structure(serial, 3) == []
    assert check_overlap_structure(serial, 3, require_async=True) != []
    enc_first = [f"dl4j_bucket{b}_encode" for b in range(3)] + \
        [f"dl4j_bucket{b}_exchange" for b in range(3)]
    assert check_overlap_structure(enc_first, 3) != []


# ===================== elastic membership (test_elastic.py) ==================
def _mesh_factory(members):
    return DeviceMesh(dp=1)


def _etrainer(mesh, **kw):
    kw.setdefault("compress", True)
    kw.setdefault("compression_kw", {"initial_threshold": 1e-4})
    return MultiHostTrainer(_loss_fn, Sgd(0.3), mesh=mesh, **kw)


def _ebatch(trainer, step):
    r = np.random.default_rng(100 + step)
    return global_batch(trainer.mesh,
                        {"x": r.standard_normal((8, 6)).astype(np.float32)})


def _coord(kv, pid, tmp, peer_timeout=6.0):
    return PeerCoordinator(sync_every=2, peer_timeout=peer_timeout,
                           client=kv, process_id=pid, num_processes=1,
                           dump_dir=tmp)


def _enc(n, buckets=2, elems=7, seed=0):
    r = np.random.default_rng(seed)
    return {"residual": {str(b): r.standard_normal(
                (n, elems)).astype(np.float32) for b in range(buckets)},
            "threshold": np.linspace(1e-4, 8e-4, n).astype(np.float32),
            "nnz": np.arange(n, dtype=np.int32)}


def test_restack_encoder_shrink_conserves_residual_mass():
    enc = _enc(8)
    out = restack_encoder(enc, 4)
    for b in ("0", "1"):
        assert out["residual"][b].shape == (4, 7)
        np.testing.assert_allclose(out["residual"][b].sum(axis=0),
                                   enc["residual"][b].sum(axis=0),
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            out["residual"][b][1],
            enc["residual"][b][1] + enc["residual"][b][5])
    np.testing.assert_array_equal(out["threshold"], enc["threshold"][:4])
    assert (out["nnz"] == 0).all() and out["nnz"].shape == (4,)


def test_restack_encoder_grow_tiles_thresholds_zero_residual():
    enc = _enc(4)
    out = restack_encoder(enc, 8)
    for b in ("0", "1"):
        np.testing.assert_array_equal(out["residual"][b][:4],
                                      enc["residual"][b])
        assert (out["residual"][b][4:] == 0).all()
    np.testing.assert_array_equal(out["threshold"][4:], enc["threshold"])
    assert (out["nnz"] == 0).all()
    assert restack_encoder(enc, 4) is enc
    with pytest.raises(ValueError, match="width 0"):
        restack_encoder(enc, 0)


@pytest.mark.parametrize("kind", ["local", "store"])
def test_membership_join_commit_admits_and_clears(kind):
    from test_torch_coordination import _clients
    kv0, kv1 = _clients(kind)
    tmp = tempfile.mkdtemp()
    c0, c1 = _coord(kv0, 0, tmp), _coord(kv1, 1, tmp)
    m0 = ElasticMembership(c0, members=[0])
    m1 = ElasticMembership(c1, members=[1])
    m1.announce_join()
    assert m0.pending() == ([1], [])
    info = {"step": 4, "cstep": 4, "rounds": 2, "save_seq": 1, "dp": 4}
    assert m0.commit([1], [], info=info) == [0, 1]
    assert m0.epoch == 1 and c0.members == [0, 1]
    assert not kv0.key_value_dir_get(c0._key(JOIN_PREFIX))
    roster = json.loads(kv1.blocking_key_value_get(
        c0._key("em/roster/1"), 1000))
    assert roster["members"] == [0, 1]
    ticket = m1.await_admission(timeout=1.0)
    assert m1.members == [0, 1] and ticket["dp"] == 4 \
        and ticket["cstep"] == 4


@pytest.mark.parametrize("kind", ["local", "store"])
def test_membership_leave_commit_reaps_departed_state(kind):
    from test_torch_coordination import _clients
    kv, _ = _clients(kind)
    c0 = _coord(kv, 0, tempfile.mkdtemp())
    m0 = ElasticMembership(c0, members=[0, 1])
    for k in ("metrics/1", "steps/1", "alive/1", "hb/7/1"):
        kv.key_value_set(c0._key(k), "x")
    m0.announce_leave(pid=1)
    assert m0.pending() == ([], [1])
    assert m0.commit([], [1]) == [0]
    live = {k for k, _ in kv.key_value_dir_get(c0._key(""))}
    for k in ("metrics/1", "steps/1", "alive/1", "hb/7/1", "em/leave/1"):
        assert c0._key(k) not in live, f"{k} must be reaped"
    with pytest.raises(MembershipChangeError, match="zero members"):
        m0.commit([], [0])


def test_membership_admission_timeout_and_abandon():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c1 = _coord(kv, 1, tmp)
    m1 = ElasticMembership(c1, members=[1])
    m1.announce_join()
    with pytest.raises(MembershipChangeError, match="never admitted"):
        m1.await_admission(timeout=0.2)
    m1.abandon(joins=[1])
    assert not kv.key_value_dir_get(c1._key(JOIN_PREFIX))


def test_elastic_runner_validation():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    tr = _etrainer(_mesh_factory([0]))
    with pytest.raises(ValueError, match="mesh_factory"):
        MultiHostRunner(tr, tmp + "/ck", _coord(kv, 0, tmp), elastic=True,
                        monitor=False, sigterm=False)
    zr = MultiHostTrainer(_loss_fn, Sgd(0.3), mesh=_mesh_factory([0]),
                          zero1=True)
    with pytest.raises(ValueError, match="zero1"):
        MultiHostRunner(zr, tmp + "/ck", _coord(kv, 0, tmp), elastic=True,
                        mesh_factory=_mesh_factory, monitor=False,
                        sigterm=False)
    run = MultiHostRunner(tr, tmp + "/ck", _coord(kv, 0, tmp),
                          monitor=False, sigterm=False)
    try:
        with pytest.raises(MembershipChangeError, match="elastic"):
            run.request_leave()
    finally:
        run.close()


def test_join_at_a_sync_boundary_commits_and_admits():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c0 = _coord(kv, 0, tmp, peer_timeout=8.0)
    runner = MultiHostRunner(
        _etrainer(_mesh_factory([0]), wire="sparse", wire_capacity=1.0),
        tmp + "/ck", c0, save_every=4, elastic=True,
        mesh_factory=_mesh_factory, monitor=False, sigterm=False)
    params, opt = runner.resume_or_init(_init_params())
    for _ in range(4):
        params, opt, _ = runner.fit_batch(params, opt,
                                          _ebatch(runner.trainer,
                                                  runner.step))
    err, admitted = [], []

    def joiner():
        try:
            c1 = _coord(kv, 1, tmp, peer_timeout=12.0)
            m1 = ElasticMembership(c1, members=[1])
            m1.announce_join()
            info = m1.await_admission(timeout=12.0)
            admitted.append(info)
            c1.step = int(info["cstep"])
            c1.rounds = int(info["rounds"])
            for _ in range(4):
                c1.on_step()
        except Exception as e:  # noqa: BLE001 — assert on main thread
            err.append(e)

    t = threading.Thread(target=joiner)
    t.start()
    time.sleep(0.3)
    for _ in range(6):
        params, opt, loss = runner.fit_batch(params, opt,
                                             _ebatch(runner.trainer,
                                                     runner.step))
    t.join(timeout=30)
    assert not err, f"joiner failed: {err}"
    assert c0.members == [0, 1]
    info = admitted[0]
    assert info["dp"] == 1 and info["step"] == runner.step - 6 + 2
    assert np.isfinite(float(loss))
    runner.finalize(params, opt)


def test_graceful_leave_reaps_the_leaver():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c0 = _coord(kv, 0, tmp)
    m0 = ElasticMembership(c0, members=[0, 1])
    runner = MultiHostRunner(
        _etrainer(_mesh_factory([0, 1])), tmp + "/ck", c0, save_every=4,
        elastic=True, mesh_factory=_mesh_factory, membership=m0,
        monitor=False, sigterm=False)
    for k in ("metrics/1", "steps/1", "alive/1"):
        kv.key_value_set(c0._key(k), "{}")
    params, opt = runner.resume_or_init(_init_params())
    err = []

    def peer():
        try:
            c1 = _coord(kv, 1, tmp, peer_timeout=10.0)
            m1 = ElasticMembership(c1, members=[0, 1])
            for i in range(6):
                if i == 4:
                    m1.announce_leave()
                c1.on_step()
        except Exception as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=peer)
    t.start()
    for _ in range(6):
        params, opt, _ = runner.fit_batch(params, opt,
                                          _ebatch(runner.trainer,
                                                  runner.step))
    t.join(timeout=30)
    assert not err, f"peer failed: {err}"
    assert c0.members == [0]
    live = {k for k, _ in kv.key_value_dir_get(c0._key(""))}
    for k in ("metrics/1", "steps/1", "alive/1", "em/leave/1"):
        assert c0._key(k) not in live, f"{k} must be reaped"
    assert not [k for k in live if "/hb/" in k and k.endswith("/1")]
    for _ in range(4):
        params, opt, loss = runner.fit_batch(params, opt,
                                             _ebatch(runner.trainer,
                                                     runner.step))
    assert np.isfinite(float(loss))
    runner.finalize(params, opt)


def test_peer_lost_triggers_replacement_not_death():
    """The contract of the JAX package's test of this name (which
    currently fails there): a silent peer triggers REPLACEMENT — exactly one
    transition with loss None, the roster shrinks to the survivor, the
    step rewinds to the newest verified checkpoint (by at most
    save_every), the replayed step's loss equals the one first computed
    at that step bit for bit, and the dead host's KV state is reaped."""
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c0 = _coord(kv, 0, tmp, peer_timeout=2.0)
    m0 = ElasticMembership(c0, members=[0, 1])
    runner = MultiHostRunner(
        _etrainer(_mesh_factory([0, 1])), tmp + "/ck", c0, save_every=4,
        elastic=True, mesh_factory=_mesh_factory, membership=m0,
        monitor=False, sigterm=False)
    kv.key_value_set(c0._key("metrics/1"), "{}")
    params, opt = runner.resume_or_init(_init_params())

    def peer():
        c1 = _coord(kv, 1, tmp, peer_timeout=10.0)
        for _ in range(4):
            c1.on_step()       # rounds 1-2 heartbeat, then SILENCE

    t = threading.Thread(target=peer)
    t.start()
    trace = []
    for _ in range(8):
        params, opt, loss = runner.fit_batch(params, opt,
                                             _ebatch(runner.trainer,
                                                     runner.step))
        trace.append((runner.step, None if loss is None else float(loss)))
    t.join(timeout=30)
    restores = [i for i, (_, l) in enumerate(trace) if l is None]
    assert len(restores) == 1 and runner._replaces == 1
    i = restores[0]
    assert c0.members == [0] and m0.epoch == 1
    assert trace[i - 1][0] - trace[i][0] in range(1, runner.save_every + 1)
    by_step = {s: l for s, l in trace[:i]}
    s1, l1 = trace[i + 1]
    assert by_step[s1] == l1, "replayed step must be bit-identical"
    live = {k for k, _ in kv.key_value_dir_get(c0._key(""))}
    assert c0._key("metrics/1") not in live
    runner.finalize(params, opt)


def test_join_cluster_warm_starts_and_adopts_counters():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c0 = _coord(kv, 0, tmp)
    run0 = MultiHostRunner(_etrainer(_mesh_factory([0])), tmp + "/ck", c0,
                           save_every=4, monitor=False, sigterm=False)
    params, opt = run0.resume_or_init(_init_params())
    for _ in range(4):
        params, opt, _ = run0.fit_batch(params, opt,
                                        _ebatch(run0.trainer, run0.step))
    run0.finalize(params, opt)
    want = params["W1"].clone()
    err = []

    def leader():
        try:
            cl = _coord(kv, 0, tmp, peer_timeout=10.0)
            ml = ElasticMembership(cl, members=[0])
            cl.fetch(f"{JOIN_PREFIX}1", timeout=10.0)
            ml.commit([1], [], info={"step": 4, "cstep": 4, "rounds": 2,
                                     "save_seq": 1, "dp": 1,
                                     "flushes": 2, "rollbacks": 0})
            cl.step, cl.rounds = 4, 2
            for _ in range(4):
                cl.on_step()
        except Exception as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=leader)
    t.start()
    c1 = _coord(kv, 1, tmp, peer_timeout=10.0)
    runner, p1, o1 = MultiHostRunner.join_cluster(
        lambda mesh: _etrainer(mesh), tmp + "/ck", c1, _mesh_factory,
        _init_params(), timeout=10.0, save_every=4, monitor=False,
        sigterm=False)
    assert runner.step == 4 and runner.resumed_step == 4
    assert c1.members == [0, 1]
    assert c1.step == 4 and c1.rounds == 2 and runner._save_seq == 1
    assert torch.equal(p1["W1"], want)
    for _ in range(4):
        p1, o1, loss = runner.fit_batch(p1, o1,
                                        _ebatch(runner.trainer, runner.step))
    t.join(timeout=30)
    assert not err, f"leader failed: {err}"
    assert runner.step == 8 and np.isfinite(float(loss))
    runner.finalize(p1, o1)


def test_host_join_fault_keeps_old_roster_authoritative():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c0 = _coord(kv, 0, tmp, peer_timeout=8.0)
    runner = MultiHostRunner(
        _etrainer(_mesh_factory([0])), tmp + "/ck", c0, save_every=4,
        elastic=True, mesh_factory=_mesh_factory, monitor=False,
        sigterm=False)
    params, opt = runner.resume_or_init(_init_params())
    m1 = ElasticMembership(_coord(kv, 1, tmp), members=[1])
    m1.announce_join()
    plan = faults.FaultPlan(seed=0).fail_at(faults.HOST_JOIN, 1)
    try:
        with plan:
            with pytest.raises(MembershipChangeError,
                               match="previous roster stays"):
                for _ in range(4):
                    params, opt, _ = runner.fit_batch(
                        params, opt, _ebatch(runner.trainer, runner.step))
        assert plan.fired[faults.HOST_JOIN] == 1
    finally:
        faults.clear_plan()
    step_at_fault = runner.step
    assert c0.members == [0]
    assert not kv.key_value_dir_get(c0._key(JOIN_PREFIX))
    params, opt = runner.resume_or_init(_init_params())
    assert runner.step == step_at_fault
    for _ in range(2):
        params, opt, loss = runner.fit_batch(params, opt,
                                             _ebatch(runner.trainer,
                                                     runner.step))
    assert np.isfinite(float(loss))
    runner.finalize(params, opt)


def test_host_join_fault_on_joiner_withdraws_announcement():
    kv, tmp = LocalKV(), tempfile.mkdtemp()
    c1 = _coord(kv, 1, tmp)
    plan = faults.FaultPlan(seed=0).fail_at(faults.HOST_JOIN, 1)
    try:
        with plan:
            with pytest.raises(MembershipChangeError,
                               match="announcement withdrawn"):
                MultiHostRunner.join_cluster(
                    lambda mesh: _etrainer(mesh), tmp + "/ck", c1,
                    _mesh_factory, _init_params(), timeout=5.0,
                    monitor=False, sigterm=False)
        assert plan.fired[faults.HOST_JOIN] == 1
    finally:
        faults.clear_plan()
    assert not kv.key_value_dir_get(c1._key(JOIN_PREFIX))


def test_membership_and_peer_events_reach_the_journal(tmp_path):
    """With monitoring on, the membership transitions and the peer
    verdicts land in the ops journal: a leave announcement, a roster
    epoch, a join admission, a replacement, a lost and a desynced peer —
    and the metrics count them."""
    from deeplearning4j_tpu_torch import monitoring
    from deeplearning4j_tpu_torch.monitoring import events
    from deeplearning4j_tpu_torch.resilience.errors import (PeerDesyncError,
                                                            PeerLostError)
    monitoring.enable()
    try:
        kv, tmp = LocalKV(), str(tmp_path)
        c0, c1 = _coord(kv, 0, tmp, peer_timeout=0.5), _coord(kv, 1, tmp)
        m0 = ElasticMembership(c0, members=[0, 1])
        m1 = ElasticMembership(c1, members=[1])
        m0.announce_leave(pid=1)
        m0.commit([], [1])
        m1.announce_join()
        m0.commit([1], [])
        m1.await_admission(timeout=1.0)
        with pytest.raises(PeerLostError):
            c0.on_step(); c0.on_step()
        raise_desync = c0.desync_error("forged window")
        assert isinstance(raise_desync, PeerDesyncError)
        test_peer_lost_triggers_replacement_not_death()
        kinds = [e["kind"] for e in events.snapshot(last=256)["events"]]
        for kind in (events.MEMBERSHIP_LEAVE, events.MEMBERSHIP_EPOCH,
                     events.MEMBERSHIP_JOINED, events.MEMBERSHIP_REPLACED,
                     events.PEER_LOST, events.PEER_DESYNC):
            assert kind in kinds, kind
        text = monitoring.get_registry().prometheus_text()
        assert "dl4j_dist_peer_lost" in text
        assert "dl4j_dist_reforms" in text
    finally:
        monitoring.get_registry().clear()
        monitoring.disable()
