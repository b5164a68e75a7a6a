"""Trace reader of the port: the XSpace decoder of
`deeplearning4j_tpu/optimize/xplane.py`, copied, and a reader of the
Chrome-trace JSON that torch.profiler writes (`export_chrome_trace`,
Kineto's format), both into one plane/line/event form so that the same
tables run on either.

A plane is {"name", "lines": [{"name", "timestamp_ns", "events"}]} and an
event is (name, duration_ps, offset_ps[, stats]).

- XSpace (`*.xplane.pb`, jax.profiler): field numbers follow
  tensorflow/tsl/profiler/protobuf/xplane.proto, decoded by the port's
  own protobuf codec (`autodiff/tfproto.py`):
    XSpace.planes = 1
    XPlane: id=1, name=2, lines=3, event_metadata=4 (map), stat_metadata=5
    XLine:  id=1, name=2, timestamp_ns=3, events=4
    XEvent: metadata_id=1, offset_ps=2, duration_ps=3, stats=4
    XEventMetadata: id=1, name=2, display_name=3, stats=5
    XStat:  metadata_id=1, double=2, uint64=3, int64=4, str=5, bytes=6,
            ref=7
    XStatMetadata: id=1, name=2
  A JAX trace decodes here exactly as in the JAX package.
- Kineto JSON (`*.pt.trace.json`, torch.profiler): a plane is a
  `process_name` (pid), a line a `thread_name` or CUDA stream (tid), an
  event an "X" event (µs converted to ps), its stats the event's `args`.
  The card's planes are named "GPU <n>"; a device plane without that name
  (an older exporter) is given it. A kernel whose `__global__` name comes
  from the port's `kernels/csrc/` takes the category "custom-call", as a
  Pallas kernel appears in an XLA trace; other events fall through the
  name table. Kineto carries bytes only on memcpy and memset events
  (`args["bytes"]`): a kernel's row in `memory_breakdown` reads 0 bytes,
  nothing is estimated.

`device_substr` selects planes: "TPU" or "GPU" the device planes, "" every
plane (a CPU trace's host threads).

Usage:
  rows = op_table(trace_dir, device_substr="GPU")
  for r in rows[:20]: print(f"{r['self_ms']:8.3f} ms  {r['name']}")
"""
from __future__ import annotations

import glob
import json
import os
import re
import struct

from deeplearning4j_tpu_torch.autodiff.tfproto import _signed, parse_fields


def _decode_stat(raw, stat_metas):
    """XStat bytes -> (name, value). The oneof: double(2)/uint64(3)/
    int64(4)/str(5)/bytes(6)/ref(7 — index into stat_metadata)."""
    f = parse_fields(raw)
    name = stat_metas.get(f.get(1, [0])[0], str(f.get(1, [0])[0]))
    if 2 in f:
        return name, struct.unpack("<d", f[2][0])[0]
    if 3 in f:
        return name, f[3][0]
    if 4 in f:
        return name, _signed(f[4][0])
    if 5 in f:
        return name, f[5][0].decode("utf-8", "replace")
    if 6 in f:
        return name, f[6][0]
    if 7 in f:
        return name, stat_metas.get(f[7][0], str(f[7][0]))
    return name, None


def _decode_map_entry(buf):
    """protobuf map<int64, Message> entry -> (key, value_bytes)."""
    f = parse_fields(buf)
    key = f.get(1, [0])[0]
    val = f.get(2, [b""])[0]
    return key, val


def find_xplane_files(trace_dir):
    """The trace files under a directory: jax.profiler's
    `plugins/profile/*/*.xplane.pb` and torch.profiler's `*.pt.trace.json`
    (at any depth)."""
    pb = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                "*.xplane.pb"))
    js = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                   recursive=True)
    return sorted(pb) + sorted(js)


#: Kineto categories of the card's own activity
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: events that span the device work they annotate: they are not work
_SKIP_CATS = ("gpu_user_annotation",)
_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "csrc")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")
_port_names = None


def port_kernel_names():
    """The `__global__` names of the port's hand-written kernels
    (`kernels/csrc/*.cu`, `*.cuh`)."""
    global _port_names
    if _port_names is None:
        names = set()
        for path in glob.glob(os.path.join(_CSRC, "*.cu*")):
            with open(path) as f:
                names.update(_GLOBAL.findall(f.read()))
        _port_names = frozenset(names)
    return _port_names


def kernel_base_name(name):
    """A demangled kernel name without its return type, namespaces,
    template arguments and parameters:
    "void dl4j::(anonymous namespace)::foo_kernel<float>(Args<float>)"
    -> "foo_kernel"."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.startswith("void "):
        n = n[5:]
    m = re.match(r"[\w:]*?(\w+)\s*(?:<|\(|$)", n)
    return m.group(1) if m else n


def _kineto_stats(ev, cat):
    stats = dict(ev.get("args") or {})
    if cat not in ("gpu_memcpy", "gpu_memset"):
        # only copies and fills carry bytes; no other stat is read as one
        stats = {k: v for k, v in stats.items() if "bytes" not in k.lower()}
    if cat == "kernel" and kernel_base_name(ev.get("name", "")) \
            in port_kernel_names():
        stats["category"] = "custom-call"
    return stats


def planes_from_trace_events(events, with_stats=False, plane_substr=None):
    """Chrome trace events (Kineto's) -> planes, as `parse_xspace` gives
    them: one per pid, one line per (pid, tid), the "X" events in ps from
    the line's first event."""
    pnames, tnames, by_line = {}, {}, {}
    device_pids = set()
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                pnames[ev.get("pid")] = str((ev.get("args") or {})
                                            .get("name", ""))
            elif ev.get("name") == "thread_name":
                tnames[(ev.get("pid"), ev.get("tid"))] = str(
                    (ev.get("args") or {}).get("name", ""))
            continue
        if ph != "X":
            continue
        cat = str(ev.get("cat", ""))
        if cat in _SKIP_CATS:
            continue
        if cat in _DEVICE_CATS:
            device_pids.add(ev.get("pid"))
        by_line.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    planes = {}
    for (pid, tid) in sorted(by_line, key=lambda k: (str(k[0]), str(k[1]))):
        pname = pnames.get(pid, f"pid {pid}")
        if pid in device_pids and "gpu" not in pname.lower():
            pname = f"GPU {pid} ({pname})" if pname else f"GPU {pid}"
        if plane_substr is not None and \
                plane_substr.lower() not in pname.lower():
            continue
        evs = by_line[(pid, tid)]
        base_us = min(float(e.get("ts", 0.0)) for e in evs)
        out = []
        for e in evs:
            name = str(e.get("name", ""))
            dur = int(round(float(e.get("dur", 0.0)) * 1e6))
            off = int(round((float(e.get("ts", 0.0)) - base_us) * 1e6))
            if with_stats:
                out.append((name, dur, off,
                            _kineto_stats(e, str(e.get("cat", "")))))
            else:
                out.append((name, dur, off))
        plane = planes.setdefault(pid, {"name": pname, "lines": []})
        plane["lines"].append({
            "name": tnames.get((pid, tid), f"thread {tid}"),
            "timestamp_ns": int(round(base_us * 1e3)), "events": out})
    return list(planes.values())


def parse_kineto(path, with_stats=False, plane_substr=None):
    """A torch.profiler Chrome trace (`*.pt.trace.json`) -> planes."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return planes_from_trace_events(events, with_stats, plane_substr)


def parse_trace(path, with_stats=False, plane_substr=None):
    """Either trace format -> planes."""
    if str(path).endswith(".json"):
        return parse_kineto(path, with_stats, plane_substr)
    return parse_xspace(path, with_stats, plane_substr)


def parse_xspace(path, with_stats=False, plane_substr=None):
    """xplane.pb -> list of planes:
    {"name": str, "lines": [{"name": str, "timestamp_ns": int,
    "events": [(meta_name, duration_ps, offset_ps)]}]}.

    with_stats=True appends a 4th element to each event tuple — a
    {stat_name: value} dict decoded from the event's XStats merged with
    its event-METADATA stats (XLA puts static cost-analysis numbers like
    "bytes accessed"/"flops" on the metadata, per-occurrence values on
    the event). plane_substr skips non-matching planes BEFORE any event
    decoding (host/thread planes dwarf the device plane in real traces)."""
    with open(path, "rb") as f:
        space = parse_fields(f.read())
    planes = []
    for praw in space.get(1, []):
        pf = parse_fields(praw)
        name = pf.get(2, [b""])[0].decode("utf-8", "replace")
        if plane_substr is not None and \
                plane_substr.lower() not in name.lower():
            continue
        stat_metas = {}
        for mraw in pf.get(5, []):
            k, v = _decode_map_entry(mraw)
            mf = parse_fields(v)
            stat_metas[k] = mf.get(2, [b""])[0].decode("utf-8", "replace")
        metas = {}
        meta_stats = {}
        for mraw in pf.get(4, []):
            k, v = _decode_map_entry(mraw)
            mf = parse_fields(v)
            metas[k] = mf.get(2, [b""])[0].decode("utf-8", "replace")
            # display_name (3) is the prettier name when present
            disp = mf.get(3, [b""])[0]
            if disp:
                metas[k] = disp.decode("utf-8", "replace")
            if with_stats and 5 in mf:
                meta_stats[k] = dict(
                    _decode_stat(s, stat_metas) for s in mf[5])
        lines = []
        for lraw in pf.get(3, []):
            lf = parse_fields(lraw)
            lname = lf.get(2, [b""])[0].decode("utf-8", "replace")
            ts_ns = lf.get(3, [0])[0]
            events = []
            for eraw in lf.get(4, []):
                ef = parse_fields(eraw)
                mid = ef.get(1, [0])[0]
                off = ef.get(2, [0])[0]
                dur = ef.get(3, [0])[0]
                if with_stats:
                    stats = dict(meta_stats.get(mid, {}))
                    for sraw in ef.get(4, []):
                        sk, sv = _decode_stat(sraw, stat_metas)
                        stats[sk] = sv
                    events.append((metas.get(mid, str(mid)), dur, off,
                                   stats))
                else:
                    events.append((metas.get(mid, str(mid)), dur, off))
            lines.append({"name": lname, "timestamp_ns": ts_ns,
                          "events": events})
        planes.append({"name": name, "lines": lines})
    return planes


def _bytes_accessed(stats):
    """Largest 'bytes'-ish cost-analysis stat on an event — XLA variously
    spells it "bytes accessed" / "bytes_accessed" / per-memory-space
    variants; the op and memory tables must agree on the heuristic."""
    b = 0
    for k, v in stats.items():
        if "bytes" in k.lower() and isinstance(v, int):
            b = max(b, v)
    return b


def memory_breakdown(trace_dir, device_substr="TPU", line_substr=None,
                     lines=None):
    """Per-op bytes-accessed table from the XStat cost-analysis metrics:
    [(op_name, total_ms, bytes_accessed, GB_per_s)] sorted by bytes
    descending. Rides the same plane/line selection as op_breakdown; ops
    with no bytes stat report 0 (fusion roots carry the stat on TPU).
    `lines` (from collect_lines) skips the parse and reuses an
    already-decoded selection."""
    totals, nbytes = {}, {}
    if lines is None:
        lines = _selected_lines(trace_dir, device_substr, line_substr,
                                with_stats=True)
    for line in lines:
        for ev in line["events"]:
            name, dur, stats = ev[0], ev[1], ev[3]
            b = _bytes_accessed(stats)
            totals[name] = totals.get(name, 0) + dur
            nbytes[name] = nbytes.get(name, 0) + b
    rows = []
    for n, b in nbytes.items():
        ms = totals[n] / 1e9
        gbps = (b / 1e9) / (ms / 1e3) if ms > 0 else 0.0
        rows.append((n, ms, b, gbps))
    rows.sort(key=lambda r: -r[2])
    return rows


def _selected_lines(trace_dir, device_substr, line_substr, with_stats):
    """Shared plane/line selection for the breakdown tables.

    `device_substr` picks the device planes ("TPU", "GPU", or "" for
    CPU-only traces where XLA ops land on host-thread planes).
    `line_substr` picks activity lines within a plane; the default (None)
    uses the serialized "XLA Ops" line when the plane has one — summing
    every line would double-count, since "Steps" / "XLA Modules" /
    "Async XLA Ops" events span the same wall time — and otherwise
    falls back to all lines (CPU traces have per-thread lines instead)."""
    for path in find_xplane_files(trace_dir):
        for plane in parse_trace(path, with_stats=with_stats,
                                 plane_substr=device_substr or None):
            lines = plane["lines"]
            if line_substr is not None:
                lines = [l for l in lines if line_substr in l["name"]]
            elif any(l["name"] == "XLA Ops" for l in lines):
                lines = [l for l in lines if l["name"] == "XLA Ops"]
            yield from lines


def collect_lines(trace_dir, device_substr="TPU", line_substr=None):
    """Materialize one stats-bearing plane/line selection so several
    tables (op_table + memory_breakdown) can be derived from a single
    decode of the trace — closing a ProfileSession window parses each
    candidate device plane once instead of once per table."""
    return list(_selected_lines(trace_dir, device_substr, line_substr,
                                with_stats=True))


def op_breakdown(trace_dir, device_substr="TPU", line_substr=None):
    """Aggregate device-plane op durations across a trace directory.

    Returns [(op_name, total_ms, count)] sorted by total time descending;
    see _selected_lines for the plane/line selection rules."""
    totals, counts = {}, {}
    for line in _selected_lines(trace_dir, device_substr, line_substr,
                                with_stats=False):
        for name, dur, _off in line["events"]:
            totals[name] = totals.get(name, 0) + dur
            counts[name] = counts.get(name, 0) + 1
    rows = [(n, t / 1e9, counts[n]) for n, t in totals.items()]
    rows.sort(key=lambda r: -r[1])
    return rows


def _self_times(events):
    """Per-event SELF time (duration minus nested children) for one
    line's [(name, dur_ps, off_ps), ...] events.

    XLA lines nest: a fusion event spans its constituent sub-events, and
    "total time" double-counts every level. Sweep events in start order
    (ties: longer first, so parents precede their children) with a
    containment stack; each event's duration is charged against its
    nearest enclosing ancestor. Returns self-times aligned with
    `events`' order."""
    idx = sorted(range(len(events)),
                 key=lambda i: (events[i][2], -events[i][1]))
    selfs = [0] * len(events)
    stack = []   # (end_ps, original_index) of open ancestors
    child_total = {}
    for i in idx:
        _name, dur, off = events[i][0], events[i][1], events[i][2]
        while stack and stack[-1][0] <= off:
            stack.pop()
        if stack:
            parent = stack[-1][1]
            child_total[parent] = child_total.get(parent, 0) + dur
        stack.append((off + dur, i))
    for i in range(len(events)):
        selfs[i] = max(0, events[i][1] - child_total.get(i, 0))
    return selfs


#: substring -> category for ops whose stats carry no explicit category
_NAME_CATEGORIES = (
    ("fusion", "fusion"), ("convolution", "convolution"),
    ("conv", "convolution"), ("dot", "matmul"), ("gemm", "matmul"),
    ("matmul", "matmul"), ("all-reduce", "collective"),
    ("all-gather", "collective"), ("reduce-scatter", "collective"),
    ("collective", "collective"), ("copy", "copy"),
    ("transpose", "copy"), ("reshape", "copy"), ("broadcast", "copy"),
    ("reduce", "reduce"), ("scatter", "scatter"), ("gather", "gather"),
    ("sort", "sort"), ("rng", "rng"), ("infeed", "infeed"),
    ("outfeed", "outfeed"), ("custom-call", "custom-call"),
)


def _categorize(name, stats):
    cat = stats.get("category") or stats.get("equation_category")
    if isinstance(cat, str) and cat:
        return cat
    low = name.lower()
    for sub, cat in _NAME_CATEGORIES:
        if sub in low:
            return cat
    return "other"


def op_table(trace_dir, device_substr="TPU", line_substr=None,
             lines=None):
    """The full per-op cost table ProfileSession publishes: one row per
    distinct op name with

        {"name", "total_ms", "self_ms", "count", "category",
         "flops", "bytes_accessed", "pct"}

    sorted by self_ms descending (`pct` is self_ms share of the summed
    self time, which — unlike total time — adds to ~100% even with
    nested fusion events). Plane/line selection matches op_breakdown;
    `lines` (from collect_lines) skips the parse and reuses an
    already-decoded selection."""
    rows = {}
    total_self = 0
    if lines is None:
        lines = _selected_lines(trace_dir, device_substr, line_substr,
                                with_stats=True)
    for line in lines:
        events = line["events"]
        selfs = _self_times([(e[0], e[1], e[2]) for e in events])
        for ev, self_ps in zip(events, selfs):
            name, dur, stats = ev[0], ev[1], ev[3]
            r = rows.get(name)
            if r is None:
                r = rows[name] = {
                    "name": name, "total_ms": 0.0, "self_ms": 0.0,
                    "count": 0, "category": _categorize(name, stats),
                    "flops": 0, "bytes_accessed": 0}
            r["total_ms"] += dur / 1e9
            r["self_ms"] += self_ps / 1e9
            r["count"] += 1
            total_self += self_ps
            fl = stats.get("flops")
            if isinstance(fl, int) and fl > 0:
                r["flops"] += fl
            r["bytes_accessed"] += _bytes_accessed(stats)
    out = sorted(rows.values(), key=lambda r: -r["self_ms"])
    denom = total_self / 1e9
    for r in out:
        r["pct"] = 100.0 * r["self_ms"] / denom if denom > 0 else 0.0
    return out


def category_rollup(rows):
    """Aggregate an op_table by category:
    [{"category", "self_ms", "count", "flops", "pct"}], self-time
    descending."""
    cats = {}
    for r in rows:
        c = cats.setdefault(r["category"],
                            {"category": r["category"], "self_ms": 0.0,
                             "count": 0, "flops": 0})
        c["self_ms"] += r["self_ms"]
        c["count"] += r["count"]
        c["flops"] += r["flops"]
    out = sorted(cats.values(), key=lambda c: -c["self_ms"])
    total = sum(c["self_ms"] for c in out)
    for c in out:
        c["pct"] = 100.0 * c["self_ms"] / total if total > 0 else 0.0
    return out


def render_report(rows, memory_rows=None, top=25):
    """Text report over an op_table (+ optional memory_breakdown rows):
    top-K ops by self time, the category rollup, and the top memory
    movers — the `repr` surface of a ProfileSession and the payload of
    `print_profile()`."""
    lines = []
    total_self = sum(r["self_ms"] for r in rows)
    lines.append(f"device self time: {total_self:.3f} ms across "
                 f"{len(rows)} distinct ops")
    lines.append(f"{'self ms':>10}  {'total ms':>10}  {'%':>5}  "
                 f"{'count':>6}  {'category':<12} op")
    for r in rows[:top]:
        lines.append(f"{r['self_ms']:10.3f}  {r['total_ms']:10.3f}  "
                     f"{r['pct']:5.1f}  {r['count']:6d}  "
                     f"{r['category']:<12} {r['name'][:70]}")
    lines.append("")
    lines.append("by category:")
    for c in category_rollup(rows):
        gflops = c["flops"] / 1e9
        lines.append(f"{c['self_ms']:10.3f} ms  {c['pct']:5.1f}%  "
                     f"x{c['count']:<7d} {c['category']:<12}"
                     + (f"  {gflops:.2f} GFLOP" if gflops else ""))
    if memory_rows:
        lines.append("")
        lines.append("top memory movers (bytes accessed):")
        for name, ms, b, gbps in memory_rows[:top]:
            lines.append(f"{b:14,d} B  {ms:9.3f} ms  {gbps:8.1f} GB/s  "
                         f"{name[:60]}")
    return "\n".join(lines)


def print_breakdown(trace_dir, top=25, device_substr="TPU",
                    line_substr=None, out=print):
    rows = op_breakdown(trace_dir, device_substr, line_substr)
    total = sum(r[1] for r in rows)
    out(f"device total: {total:.2f} ms across {len(rows)} distinct ops")
    for name, ms, n in rows[:top]:
        out(f"{ms:9.3f} ms  x{n:<5d} {name[:90]}")
    return rows


def to_chrome_trace(trace_dir, out_path, max_events=200000):
    """Convert a trace directory (either format) into Chrome trace-event
    JSON (open in chrome://tracing or ui.perfetto.dev — no TensorBoard
    needed; ≡ the timeline view role of the reference's UI training
    dashboard).

    One pid per XPlane, one tid per XLine; complete ('X') events with
    microsecond timestamps. Returns the number of events written."""
    import json

    events = []
    pid = 0
    full = False
    for path in find_xplane_files(trace_dir):
        if full:
            break
        for plane in parse_trace(path):
            if full:
                break
            pid += 1
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": plane["name"]}})
            for tid, line in enumerate(plane["lines"], 1):
                if full:
                    break
                events.append({"ph": "M", "pid": pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": line["name"]}})
                base_us = line["timestamp_ns"] / 1e3
                for name, dur, off in line["events"]:
                    if len(events) >= max_events:
                        full = True
                        break
                    events.append({
                        "ph": "X", "pid": pid, "tid": tid,
                        "name": name.split(" = ")[0].lstrip("%"),
                        "ts": base_us + off / 1e6,   # ps -> us
                        "dur": max(dur / 1e6, 0.001),
                    })
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
