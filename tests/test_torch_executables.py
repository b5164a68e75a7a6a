"""The port's executable store (deeplearning4j_tpu_torch/runtime/
executables.py) on the CPU, where it runs its functions eagerly under the
same keys and counters that replay CUDA graphs on the card: the bucket
ladder against the JAX package's, the server's closed key set against the
JAX server's, fingerprints, the manifest's disk tier (round trip, and a
corrupt or mismatched manifest counted as a miss and rewritten), the
staging ring's copies, the generation server and ParallelInference
through the store, and Adam's device-side step count against optax."""
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.generation import BertDecoder as JaxDecoder
from deeplearning4j_tpu.generation import GenerationServer as JaxServer
from deeplearning4j_tpu.models import bert as jb
from deeplearning4j_tpu.nn import updaters as jup
from deeplearning4j_tpu.runtime import executables as jexe
from deeplearning4j_tpu_torch.generation import BertDecoder, GenerationServer
from deeplearning4j_tpu_torch.models import bert as tb
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.nn import (ComputationGraph, DenseLayer,
                                         InputType, NeuralNetConfiguration,
                                         OutputLayer, Sgd)
from deeplearning4j_tpu_torch.nn import updaters as tup
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference,
                                                         _Request)
from deeplearning4j_tpu_torch.resilience.policy import CircuitBreaker
from deeplearning4j_tpu_torch.runtime import executables as texe


# -- the bucket ladder --------------------------------------------------------
@pytest.mark.parametrize("batch", [[1, 2, 4, 8], [2, 4, 8], [3], [1, 5, 32,
                                                                   16]])
def test_bucket_ladder_routes_as_the_jax_ladder(batch):
    jl, tl = jexe.BucketLadder(batch=batch), texe.BucketLadder(batch=batch)
    assert tl.batch == jl.batch and tl.max_batch == jl.max_batch
    for n in range(1, 3 * max(batch) + 2):
        assert tl.bucket(n) == jl.bucket(n), n
        assert tl.chunks(n) == jl.chunks(n), n
        assert all(tl.bucket(c) is not None for c in tl.chunks(n))


@pytest.mark.parametrize("length", [None, [4, 8], [16]])
def test_length_buckets_as_the_jax_ladder(length):
    jl = jexe.BucketLadder(batch=[4], length=length)
    tl = texe.BucketLadder(batch=[4], length=length)
    assert tl.length == jl.length
    for t in range(1, 25):
        assert tl.length_bucket(t) == jl.length_bucket(t), t


def test_ladders_reject_bad_buckets_alike():
    for kw in (dict(batch=[0, 2]), dict(batch=[]), dict(batch=[2],
                                                         length=[0])):
        with pytest.raises(ValueError):
            jexe.BucketLadder(**kw)
        with pytest.raises(ValueError):
            texe.BucketLadder(**kw)


# -- the server's closed key set ------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = jb.bert_tiny()
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    tcfg = tb.bert_tiny()
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jp, tcfg, tp


@pytest.mark.parametrize("conf", [
    dict(slots=2, cache_lengths=[16, 32], prompt_buckets=[8, 16],
         superstep=3),
    dict(slots=3, cache_lengths=[8, 16, 32], prompt_buckets=[4, 16],
         superstep=1)], ids=["two-rungs", "three-rungs"])
def test_server_warmup_keys_equal_the_jax_servers(tiny, conf):
    """The same (name, rung, bucket) keys as the JAX server's executables,
    its crash-replay key-advance included, which runs on the host here
    and so is no key of the store."""
    cfg, jp, tcfg, tp = tiny
    jsrv = JaxServer(JaxDecoder(cfg, jp), **conf)
    tsrv = GenerationServer(BertDecoder(tcfg, tp), **conf)
    try:
        jsrv.warmup()
        stats = tsrv.warmup()
        want = set(jsrv._exes)
        assert ("advance_key_n",) in want
        assert tsrv.executable_keys() == want
        host = {("advance_key_n",)}
        assert set(tsrv._store._entries) == want - host
        assert stats["executables"] == stats["compiled"] == len(want) - 1
        assert stats["captures"] == 0 and stats["from_disk"] == 0
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


# -- fingerprints -------------------------------------------------------------
def _net(n_hidden=8, seed=3):
    conf = (NeuralNetConfiguration.Builder()
            .seed(seed).updater(Sgd(0.1)).activation("tanh")
            .graphBuilder().addInputs("in")
            .setInputTypes(InputType.feedForward(5))
            .addLayer("hidden", DenseLayer(nOut=n_hidden), "in")
            .addLayer("out", OutputLayer(lossFunction="mcxent", nOut=3,
                                         activation="softmax"), "hidden")
            .setOutputs("out").build())
    return ComputationGraph(conf).init("cpu")


def test_fingerprints_differ_by_architecture_and_slots(tiny):
    a, b = texe.model_fingerprint(_net()), texe.model_fingerprint(_net())
    assert a == b                                   # same architecture
    assert texe.model_fingerprint(_net(seed=4)) != a  # conf differs
    assert texe.model_fingerprint(_net(n_hidden=16)) != a
    _, _, tcfg, tp = tiny
    prints = set()
    for slots in (2, 3):
        srv = GenerationServer(BertDecoder(tcfg, tp), slots=slots,
                               cache_lengths=[16], prompt_buckets=[8])
        try:
            srv.warmup()
            prints.add(srv._store.fingerprint)
        finally:
            srv.shutdown()
    assert len(prints) == 2
    assert texe.device_flavour("cpu").startswith("cpu-torch")


# -- the disk tier ------------------------------------------------------------
def _store(directory):
    store = texe.FunctionStore("fp0", "cpu", directory=directory)
    store.register("double", lambda x: x * 2)
    return store


def _items():
    return [(("double", n), (torch.zeros(n),)) for n in (1, 2, 4)]


def test_manifest_round_trip_warms_from_disk(tmp_path):
    first = _store(str(tmp_path)).warmup(_items())
    assert (first["compiled"], first["from_disk"]) == (3, 0)
    path = tmp_path / "v1" / texe.device_flavour("cpu") / "fp0" / \
        "manifest.json"
    rec = json.loads(path.read_text())
    assert sorted(map(json.loads, rec["keys"])) == [["double", n]
                                                    for n in (1, 2, 4)]
    second = _store(str(tmp_path))
    assert second.recorded_keys() == [k for k, _ in _items()]
    stats = second.warmup(_items())
    assert (stats["compiled"], stats["from_disk"]) == (0, 3)
    assert stats["nvcc_runs"] == 0
    # a key the manifest lacks counts as compiled, and is a live capture
    # once the store is warm
    second.add(("double", 8), (torch.zeros(8),))
    assert second.stats["live_captures"] == 1
    assert ("double", 8) in _store(str(tmp_path)).recorded_keys()


@pytest.mark.parametrize("damage", ["garbage", "meta", "keys"])
def test_bad_manifest_is_a_miss_and_is_rewritten(tmp_path, damage):
    _store(str(tmp_path)).warmup(_items())
    path = tmp_path / "v1" / texe.device_flavour("cpu") / "fp0" / \
        "manifest.json"
    if damage == "garbage":
        path.write_bytes(b"not a manifest \x00\xff")
    else:
        rec = json.loads(path.read_text())
        if damage == "meta":
            rec["meta"]["torch"] = "0.0.0-foreign"
        else:
            rec["keys"] = ["a list, not a mapping"]
        path.write_text(json.dumps(rec))
    store = _store(str(tmp_path))
    stats = store.warmup(_items())
    assert store.stats["manifest_failures"] == 1
    assert (stats["compiled"], stats["from_disk"]) == (3, 0)
    # rewritten: the next store warms from it
    assert _store(str(tmp_path)).warmup(_items())["from_disk"] == 3


def test_unwritable_directory_never_stops_the_store(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    store = _store(str(blocker))
    assert store.warmup(_items())["keys"] == 3
    assert store.stats["manifest_failures"] >= 1


def test_manifest_supplies_the_warm_signatures(tmp_path):
    """A second ExecutableStore on the same directory captures every
    signature the first one held, the one it captured live included."""
    first = texe.ExecutableStore(_net(), directory=str(tmp_path))
    first.warmup([(((2, 5), "float32"),)])
    first.ensure((((3, 5), "float32"),))           # served live
    second = texe.ExecutableStore(_net(), directory=str(tmp_path))
    stats = second.warmup([])
    assert (stats["keys"], stats["from_disk"], stats["compiled"]) == (
        2, 2, 0)
    assert ("forward", (((3, 5), "float32"),)) in second
    assert second.stats["live_captures"] == 0


def test_manifest_records_that_are_no_signature_are_skipped(tmp_path):
    store = texe.ExecutableStore(_net(), directory=str(tmp_path))
    store.warmup([(((2, 5), "float32"),)])
    path = tmp_path / "v1" / store.flavour / store.fingerprint / \
        "manifest.json"
    rec = json.loads(path.read_text())
    for bad in (["forward", [[[2, -1], "float32"]]],
                ["forward", [[[2, 5], "no_such_dtype"]]], ["forward", 7],
                ["other", 1]):
        rec["keys"][json.dumps(bad)] = {"graph": True, "launches": {}}
    rec["keys"]["{not json"] = {}
    path.write_text(json.dumps(rec))
    stats = texe.ExecutableStore(_net(), directory=str(tmp_path)).warmup([])
    assert (stats["keys"], stats["from_disk"]) == (1, 1)


def test_parallel_inference_warmup_reads_its_manifest(tmp_path):
    x = np.random.default_rng(2).standard_normal((6, 5)).astype(np.float32)
    stats, answers = [], []
    for ladder in ([1, 2, 4, 8], None):
        builder = (ParallelInference.Builder(_net())
                   .inferenceMode(InferenceMode.BATCHED)
                   .executableCacheDir(str(tmp_path)))
        if ladder is not None:
            builder.bucketLadder(ladder)
        pi = builder.build()
        try:
            stats.append(pi.warmup(buckets=None if ladder else [8]))
            answers.append(pi.output(x))
        finally:
            pi.shutdown()
    assert (stats[0]["compiled"], stats[0]["from_disk"]) == (4, 0)
    # the second ladder names bucket 8 only; the manifest brings back 1-4
    assert (stats[1]["keys"], stats[1]["from_disk"],
            stats[1]["compiled"]) == (4, 4, 0)
    np.testing.assert_array_equal(answers[0], answers[1])


# -- failures and rebinding ---------------------------------------------------
class _FailingCapture(texe.FunctionStore):
    """A CPU store taken down the capture path, whose capture raises."""

    def __init__(self):
        super().__init__("fp2", "cpu")
        self.capture = True

    def _warm_up(self, fn, args):
        return fn(*args)

    def _capture(self, entry, fn):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def test_a_failed_capture_degrades_its_key_and_raises():
    store = _FailingCapture()
    store.register("inc", lambda x: x.add_(1))
    x = torch.zeros(2)
    with pytest.raises(RuntimeError, match="capturing"):
        store.add(("inc",), (x,))
    assert torch.equal(x, torch.ones(2))        # the eager warm-up ran
    assert store.stats["degradations"] == 1
    assert "capture failed" in store.degraded[repr(("inc",))]
    store.run(("inc",))
    assert store.stats["eager_calls"] == 1 and torch.equal(
        x, torch.full((2,), 2.0))


def test_rebound_bindings_capture_again_in_place_updates_do_not():
    weights = {"w": torch.ones(3)}
    store = texe.FunctionStore("fp3", "cpu", bindings=lambda: weights)
    store.register("scale", lambda x: x * weights["w"])
    x = torch.arange(3.0)
    store.add(("scale",), (x,))
    weights["w"].mul_(2)                         # same tensor: no rebind
    assert torch.equal(store.run(("scale",)), x * 2)
    assert store.stats["rebinds"] == 0
    weights["w"] = torch.full((3,), 5.0)         # a weight load
    assert torch.equal(store.run(("scale",)), x * 5)
    assert store.stats["rebinds"] == 1
    store.run(("scale",))
    assert store.stats["rebinds"] == 1


def test_forward_store_binds_the_models_tensors():
    net = _net()
    store = texe.ExecutableStore(net)
    leaves = texe.tensor_leaves((net._params, net._state))
    assert sorted(store._addresses()) == sorted(
        t.data_ptr() for t in leaves) and leaves


# -- the store's eager mode and the staging ring ------------------------------
def test_cpu_store_runs_the_function_on_its_static_inputs():
    store = texe.FunctionStore("fp1", "cpu")
    store.register("affine", lambda x, w: x @ w + 1)
    x, w = torch.zeros(3, 4), torch.randn(4, 2)
    assert store.add(("affine",), (x, w)) is None     # nothing ran
    ring = texe.StagingRing(2)
    host = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)
    ring.stage([host], [x])
    host[:] = 0            # the static input holds a copy, not an alias
    got = store.run(("affine",))
    assert torch.equal(got, torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 4)).astype(
            np.float32)) @ w + 1)
    assert store.stats["eager_calls"] == 1 and store.stats["replays"] == 0
    with pytest.raises(ValueError, match="staging"):
        ring.stage([np.zeros((2, 4), np.float32)], [x])
    with pytest.raises(KeyError):
        store.add(("affine",), (x, w))
    with pytest.raises(ValueError, match="CUDA device"):
        texe.FunctionStore("fp1", "cpu", capture=True)


def test_executable_store_forward_equals_the_model():
    net = _net()
    store = texe.ExecutableStore(net)
    sig = (((4, 5), "float32"),)
    assert store.warmup([sig])["keys"] == 1
    x = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    (static,) = store.ensure(sig)
    static.copy_(torch.from_numpy(x))
    np.testing.assert_array_equal(store.run(("forward", sig)).numpy(),
                                  net.output(x).numpy())
    st = store.status()
    assert st["kind"] == "model-forward" and st["entries"][0]["mode"] == \
        "eager"


# -- the serving entry points through the store -------------------------------
REQS = [dict(prompt=[5, 17, 99], max_new_tokens=6, method="greedy"),
        dict(prompt=[3, 1, 4, 1, 5, 9, 2], max_new_tokens=13,
             method="temperature", temperature=0.8),
        dict(prompt=[42, 7], max_new_tokens=9, method="top_k", top_k=5),
        dict(prompt=[11, 22, 33, 44, 55, 66], max_new_tokens=14,
             method="greedy")]


def test_server_with_exec_cache_dir_streams_the_same_tokens(tiny, tmp_path):
    _, _, tcfg, tp = tiny
    conf = dict(slots=2, cache_lengths=[16, 32], prompt_buckets=[8],
                seed=3, superstep=2)
    streams, warm = [], []
    for d in (None, str(tmp_path), str(tmp_path)):
        srv = GenerationServer(BertDecoder(tcfg, tp), exec_cache_dir=d,
                               **conf)
        try:
            warm.append(srv.warmup())
            streams.append([srv.submit(**r).result(timeout=120)
                            for r in REQS])
            ex = srv.status()["executables"]
            assert ex["live_captures"] == 0 and ex["degradations"] == 0
        finally:
            srv.shutdown()
    assert streams[0] == streams[1] == streams[2]
    assert warm[1]["from_disk"] == 0
    assert warm[2]["from_disk"] == warm[2]["executables"] > 0


def test_parallel_inference_bucket_ladder_equals_output():
    net = _net()
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.BATCHED)
          .bucketLadder([1, 2, 4, 8]).build())
    try:
        assert pi.warmup()["keys"] == 4
        rng = np.random.default_rng(0)
        for n in (1, 2, 3, 5, 8, 7, 1, 20, 4, 6):    # 20 splits 8 + 8 + 4
            x = rng.standard_normal((n, 5)).astype(np.float32)
            np.testing.assert_allclose(pi.output(x), net.output(x).numpy(),
                                       atol=1e-6, rtol=1e-6)
        st = pi.status()
        ex = st["executables"]
        assert ex["keys"] == 4 and ex["live_captures"] == 0
        assert st["aot_fallbacks"] == 0 and st["batch_limit"] == 8
        assert ex["eager_calls"] == pi.model_calls >= 12
    finally:
        pi.shutdown()


def test_failed_dispatch_opens_the_aot_breaker_and_serves_eagerly():
    net = _net()
    t = [0.0]
    pi = (ParallelInference.Builder(net)
          .inferenceMode(InferenceMode.SEQUENTIAL)
          .bucketLadder([2, 4])
          .aotBreaker(CircuitBreaker(failure_threshold=1, cooldown=5.0,
                                     clock=lambda: t[0])).build())
    pi.warmup()
    store = pi._store
    real = store.run
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    want = net.output(x).numpy()

    def broken(key):
        raise RuntimeError("replay failed")

    store.run = broken
    try:
        np.testing.assert_allclose(pi._direct((x,), False, False), want,
                                   atol=1e-6)
        batch = [_Request((x,))]
        pi._run(batch)
        np.testing.assert_allclose(batch[0].result, want, atol=1e-6)
        st = pi.status()
        assert st["aot_fallbacks"] == 1 and st["aot_breaker"] == "open"
        assert "replay failed" in st["aot_error"]
        # after the cooldown the probe goes through the graphs again
        store.run = real
        t[0] = 10.0
        pi._run(batch)
        assert pi.status()["aot_breaker"] == "closed"
    finally:
        store.run = real
        pi.shutdown()


# -- Adam's step count on the device ------------------------------------------
def test_adam_device_count_matches_optax_over_five_steps():
    rng = np.random.default_rng(0)
    params = {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)}}
    jtx = jup.build_optimizer(jup.Adam(1e-2), None, 1.0, 0.0)
    ttx = tup.build_optimizer(tup.Adam(1e-2), None, 1.0, 0.0)
    jp = {n: {k: jnp.asarray(v) for k, v in d.items()}
          for n, d in params.items()}
    tp = {n: {k: torch.from_numpy(v) for k, v in d.items()}
          for n, d in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.standard_normal(4).astype(np.float32)}}
        ju, js = jtx.update({n: {k: jnp.asarray(v) for k, v in d.items()}
                             for n, d in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({n: {k: torch.from_numpy(v)
                                 for k, v in d.items()}
                             for n, d in g.items()}, ts, tp)
        tp = tup.apply_updates(tp, tu)
        for k in ("W", "b"):
            np.testing.assert_allclose(tp["a"][k].numpy(),
                                       np.asarray(jp["a"][k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"step {step}")
    count = ts["__global__"][0][0][0]      # chain > adam chain > (count,
    #                                          mu, nu)
    assert torch.is_tensor(count) and count.dtype == torch.int32
    assert int(count) == 5
