"""The port's trace decoder (`deeplearning4j_tpu_torch/optimize/xplane.py`)
against the JAX package's, on the CPU.

- XSpace: the reference test_xplane.py fixtures, hand-encoded with the
  port's own protobuf writer, decode to equal tables in both packages
  (op_breakdown, memory_breakdown, op_table, category_rollup, the text
  report and the Chrome-trace conversion): exactly equal.
- Kineto JSON: a `*.pt.trace.json` carrying the same events gives the
  same op_table, self times and category_rollup; a kernel named in the
  port's `kernels/csrc/` is "custom-call"; kernels carry no bytes.
- A real torch.profiler trace of a small port network on the CPU decodes
  with device_substr="".
"""
import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.optimize import xplane as jx
from deeplearning4j_tpu_torch.autodiff.tfproto import _write_varint
from deeplearning4j_tpu_torch.optimize import xplane as tx


def _tag(f, w):
    out = bytearray()
    _write_varint(out, (f << 3) | w)
    return bytes(out)


def _varint(v):
    out = bytearray()
    _write_varint(out, v)
    return bytes(out)


def _ld(f, payload):
    return _tag(f, 2) + _varint(len(payload)) + payload


def _vint(f, v):
    return _tag(f, 0) + _varint(v)


def _map_entry(field, key, value_msg):
    return _ld(field, _vint(1, key) + _ld(2, value_msg))


def _event(meta_id, off_ps, dur_ps, stats=b""):
    return _ld(4, _vint(1, meta_id) + _vint(2, off_ps)
               + _vint(3, dur_ps) + stats)


def _stat(meta_id, payload):
    return _ld(4, _vint(1, meta_id) + payload)


def _plane(plane_name=b"/device:TPU:0", line_name=b"XLA Ops", events=(),
           event_metas=(), stat_metas=(), extra_lines=()):
    body = b""
    for sid, name in stat_metas:
        body += _map_entry(5, sid, _vint(1, sid) + _ld(2, name))
    for mid, name, meta_stats in event_metas:
        body += _map_entry(4, mid, _vint(1, mid) + _ld(2, name)
                           + meta_stats)
    line = _ld(3, _ld(2, line_name) + _vint(3, 0) + b"".join(events))
    return _ld(1, _ld(2, plane_name) + body + line + b"".join(extra_lines))


def _fx_aggregate():
    return _plane(event_metas=[(1, b"%mul", b""), (2, b"%add", b"")],
                  events=[_event(1, 0, 1_000_000_000),
                          _event(1, 2_000_000_000, 2_000_000_000),
                          _event(2, 5_000_000_000, 1_000_000_000)])


def _fx_display_name():
    host = _plane(plane_name=b"/host:CPU",
                  event_metas=[(1, b"%ugly.raw", b"")],
                  events=[_event(1, 0, 1_000_000_000)])
    pretty = _ld(1, _ld(2, b"/device:TPU:0")
                 + _map_entry(4, 1, _vint(1, 1) + _ld(2, b"%raw")
                              + _ld(3, b"nice_op"))
                 + _ld(3, _ld(2, b"XLA Ops") + _vint(3, 0)
                       + _event(1, 0, 2_000_000_000)))
    return host + pretty


def _fx_xla_ops_line():
    steps = _ld(3, _ld(2, b"Steps") + _vint(3, 0)
                + _event(1, 0, 9_000_000_000))
    return _plane(event_metas=[(1, b"%op", b"")],
                  events=[_event(1, 0, 4_000_000_000)], extra_lines=[steps])


def _fx_memory():
    return _plane(stat_metas=[(1, b"bytes accessed")],
                  event_metas=[(1, b"%fusion.7", b"")],
                  events=[_event(1, 0, 2_000_000_000,
                                 _stat(1, _vint(3, 4_000_000)))])


def _fx_nested():
    return _plane(event_metas=[(1, b"%fusion", b""), (2, b"%child", b"")],
                  events=[_event(1, 0, 10_000_000_000),
                          _event(2, 2_000_000_000, 4_000_000_000)])


def _fx_categories():
    return _plane(stat_metas=[(1, b"category"), (2, b"my-cat")],
                  event_metas=[(1, b"%op.a", b""),
                               (2, b"%convolution.3", b""),
                               (3, b"%mystery", b"")],
                  events=[_event(1, 0, 1_000_000_000,
                                 _stat(1, _vint(7, 2))),
                          _event(2, 1_000_000_000, 1_000_000_000),
                          _event(3, 2_000_000_000, 1_000_000_000)])


def _fx_flops():
    stats = _stat(1, _vint(3, 1_000)) + _stat(2, _vint(3, 2_048))
    return _plane(stat_metas=[(1, b"flops"), (2, b"bytes accessed")],
                  event_metas=[(1, b"%dot.1", b"")],
                  events=[_event(1, 0, 1_000_000_000, stats),
                          _event(1, 1_000_000_000, 1_000_000_000, stats)])


def _fx_rollup():
    return _plane(event_metas=[(1, b"%dot.1", b""), (2, b"%copy.2", b"")],
                  events=[_event(1, 0, 3_000_000_000),
                          _event(2, 3_000_000_000, 1_000_000_000)])


FIXTURES = {"aggregate": _fx_aggregate, "display_name": _fx_display_name,
            "xla_ops_line": _fx_xla_ops_line, "memory": _fx_memory,
            "nested": _fx_nested, "categories": _fx_categories,
            "flops": _fx_flops, "rollup": _fx_rollup}


def _write_xspace(tmp_path, data):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    (d / "host.xplane.pb").write_bytes(data)
    return str(tmp_path)


def _tables(mod, trace, sub):
    rows = mod.op_table(trace, device_substr=sub)
    return {"breakdown": mod.op_breakdown(trace, device_substr=sub),
            "memory": mod.memory_breakdown(trace, device_substr=sub),
            "op_table": rows, "rollup": mod.category_rollup(rows),
            "report": mod.render_report(
                rows, mod.memory_breakdown(trace, device_substr=sub)),
            "planes": mod.parse_xspace(
                mod.find_xplane_files(trace)[0], with_stats=True)}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
@pytest.mark.parametrize("sub", ["TPU", ""])
def test_xspace_fixture_decodes_equal_in_both_packages(tmp_path, fixture,
                                                       sub):
    """Exact equality: the port's XSpace reader is the reference's."""
    trace = _write_xspace(tmp_path, FIXTURES[fixture]())
    want, got = _tables(jx, trace, sub), _tables(tx, trace, sub)
    assert got == want
    n_j = jx.to_chrome_trace(trace, str(tmp_path / "j.json"))
    n_t = tx.to_chrome_trace(trace, str(tmp_path / "t.json"))
    assert n_t == n_j
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def _kineto_doc(planes):
    """A Kineto-style Chrome trace carrying the events of decoded XSpace
    planes: a pid per plane, a tid per line, "X" events in µs."""
    events = []
    for pid, plane in enumerate(planes):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": plane["name"]}})
        for tid, line in enumerate(plane["lines"]):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": line["name"]}})
            base_us = line["timestamp_ns"] / 1e3
            for name, dur, off, stats in line["events"]:
                args = {k: v for k, v in stats.items()
                        if k not in ("flops",) and "bytes" not in k}
                events.append({"ph": "X", "cat": "cpu_op", "name": name,
                               "pid": pid, "tid": tid,
                               "ts": base_us + off / 1e6, "dur": dur / 1e6,
                               "args": args})
    return {"traceEvents": events}


@pytest.mark.parametrize("fixture", ["aggregate", "nested", "categories",
                                     "rollup"])
def test_kineto_json_with_the_same_events_gives_the_same_tables(tmp_path,
                                                               fixture):
    """The same events as torch.profiler's JSON: op_table (self times
    included) and category_rollup equal the JAX package's XSpace decode
    (float ms within 1e-9: µs and ps round differently)."""
    xdir = tmp_path / "x"
    trace = _write_xspace(xdir, FIXTURES[fixture]())
    planes = jx.parse_xspace(jx.find_xplane_files(trace)[0],
                             with_stats=True)
    kdir = tmp_path / "k"
    kdir.mkdir()
    (kdir / "w.pt.trace.json").write_text(json.dumps(_kineto_doc(planes)))
    assert tx.find_xplane_files(str(kdir)) == [str(kdir / "w.pt.trace.json")]
    want = jx.op_table(trace, device_substr="TPU")
    got = tx.op_table(str(kdir), device_substr="TPU")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert g["count"] == w["count"] and g["category"] == w["category"]
        for k in ("total_ms", "self_ms", "pct"):
            assert g[k] == pytest.approx(w[k], abs=1e-9)
    roll_g, roll_w = tx.category_rollup(got), jx.category_rollup(want)
    assert [c["category"] for c in roll_g] == [c["category"] for c in roll_w]
    for g, w in zip(roll_g, roll_w):
        assert g["self_ms"] == pytest.approx(w["self_ms"], abs=1e-9)


def test_kineto_device_planes_kernels_and_bytes(tmp_path):
    """A card trace: kernels on two streams of the "GPU 0" plane, one a
    port kernel (custom-call), a memcpy with bytes; host events on their
    own plane. device_substr="GPU" reads the card only; kernels carry no
    bytes (Kineto's args hold none), the copy its own."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 4242,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 10.0,
         "dur": 5.0, "name": "void dl4j::(anonymous namespace)::"
         "matmul_stats_kernel<float, 64, 64>(dl4j::(anonymous namespace)"
         "::StatsArgs<float>)", "args": {"grid": [4, 1, 1],
                                         "shared memory": 4096}},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 8, "ts": 11.0,
         "dur": 2.0, "name": "ampere_sgemm_128x64_nn", "args": {}},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 20.0,
         "dur": 1.0, "name": "Memcpy HtoD (Pinned -> Device)",
         "args": {"bytes": 4096}},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 9.0, "dur": 20.0, "name": "ProfilerStep#1", "args": {}},
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1, "ts": 0.0,
         "dur": 30.0, "name": "aten::mm", "args": {}},
    ]
    (tmp_path / "c.pt.trace.json").write_text(json.dumps(
        {"traceEvents": ev}))
    rows = {tx.kernel_base_name(r["name"]): r
            for r in tx.op_table(str(tmp_path), device_substr="GPU")}
    assert set(rows) == {"matmul_stats_kernel", "ampere_sgemm_128x64_nn",
                         "Memcpy HtoD (Pinned -> Device)"}
    mm = rows["matmul_stats_kernel"]
    assert mm["category"] == "custom-call" and mm["count"] == 1
    # streams are lines of their own: overlapping kernels keep their time
    assert mm["self_ms"] == pytest.approx(0.005)
    assert rows["ampere_sgemm_128x64_nn"]["category"] == "matmul"
    mem = {tx.kernel_base_name(n): b for n, _, b, _ in
           tx.memory_breakdown(str(tmp_path), device_substr="GPU")}
    assert mem["Memcpy HtoD (Pinned -> Device)"] == 4096
    assert mem["matmul_stats_kernel"] == 0
    host = tx.op_table(str(tmp_path), device_substr="python")
    assert [r["name"] for r in host] == ["aten::mm"]
    assert tx.kernel_base_name(mm["name"]) == "matmul_stats_kernel"
    assert {"matmul_stats_kernel", "bn_grad_stats_kernel",
            "bn_conv_grads_kernel", "flash_fwd_kernel",
            "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
            "matmul_epilogue_kernel", "layernorm_kernel",
            "bottleneck_block_kernel",
            "flash_decode_kernel"} <= tx.port_kernel_names()


def test_real_cpu_torch_profiler_trace_decodes(tmp_path):
    """A small port network's forward under torch.profiler on the CPU,
    exported as Kineto JSON, decodes with device_substr="": the aten ops
    appear with self times that add up to at most the wall time."""
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                             MultiLayerNetwork,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(DenseLayer(nOut=16, activation="relu"))
            .layer(OutputLayer(nOut=3, activation="softmax",
                               lossFunction="mcxent"))
            .setInputType(InputType.feedForward(8)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        net.output(x)
    prof.export_chrome_trace(str(tmp_path / "cpu.pt.trace.json"))
    assert tx.op_table(str(tmp_path), device_substr="GPU") == []
    rows = tx.op_table(str(tmp_path), device_substr="")
    names = {r["name"] for r in rows}
    assert any(n.startswith("aten::") for n in names), names
    assert sum(r["self_ms"] for r in rows) > 0
    roll = tx.category_rollup(rows)
    assert sum(c["count"] for c in roll) == sum(r["count"] for r in rows)
