"""The dashboard and operations endpoints of the port: `UIServer`, the
port of `deeplearning4j_tpu/ui/server.py` (≡ deeplearning4j-ui ::
UIServer), over the port's modules.

`UIServer.getInstance().attach(storage)` then `start(port)` (port 0 takes
an ephemeral port, read back from `.port`) serves, from a stdlib
`ThreadingHTTPServer` on a background thread:

- `GET /` — the dashboard page (the JAX package's, as it is), which polls
  the routes below every second;
- `GET /stats` — the JSON records of every attached storage (`.all()`:
  `ui/stats.py`'s InMemoryStatsStorage or FileStatsStorage, which a
  `StatsListener` fills, one record per iteration);
- `GET /tsne` — the points `attachTsne` holds;
- `GET /generation` — every live `GenerationServer`'s status;
- `GET /fleet` — every live `FleetRouter`'s status: per-replica health,
  burn rate, slot and queue occupancy, routing and failover tallies, the
  autoscale signal;
- `GET /requests`, `GET /requests/<trace-id>` — request timelines (404
  for an unknown id), with the latency histograms' exemplars;
- `GET /slo` — the SLO tracker; `GET /trace` — the merged Chrome trace;
- `GET /health` — `resilience.health_snapshot()` (the installed
  guardian's and watchdog's snapshots among its sections): 200 while `ok`
  or `degraded`, 503 otherwise (`stalled`, `diverged`, `serving_dead`);
- `GET /events`, `GET /incidents` — the ops event journal;
- `GET /metrics` — the registry's Prometheus text (a multi-host cluster
  view on process 0 once a coordinator is active);
- `GET /steps` — the step-time flight recorder; `GET /stragglers` —
  straggler attribution, 404 with no active coordinator
  (`parallel/coordination.py`);
- `GET /executables` — `runtime.executables.status()`;
- `GET /profile` — the profiler's status: the armed session and the last
  one's report (per-op table decoded from its torch.profiler trace);
  `POST /profile?steps=k` arms a session over the next k training steps;
- `POST /debug/bundle` — writes the post-mortem bundle under
  `DL4J_CRASH_DUMP_DIR` (never a client-supplied path).

Any other path answers 404 (the JAX package serves its page there). A
route that raises answers 500 with the error, and the handler lives on.
`render_static_html(storage, path)` writes a self-contained HTML snapshot
of a stats storage (inline SVG charts: score, iteration time, update
ratios, the latest activation histograms, an optional t-SNE scatter) for
environments without an open port.
Modules are looked up when a route is served, so a dashboard-only server
imports neither the server nor the fleet; the coordinator, like the
JAX package's, is read from `sys.modules`.
"""
from __future__ import annotations

import json
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["UIServer", "render_static_html"]

#: the port's coordination module, read from sys.modules (never imported:
#: a coordinator is only active where something imported it)
_COORDINATION = "deeplearning4j_tpu_torch.parallel.coordination"

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu training</title>
<style>
body{font-family:system-ui,sans-serif;margin:24px;background:#fafafa}
h1{font-size:18px} .chart{background:#fff;border:1px solid #ddd;
border-radius:6px;padding:12px;margin-bottom:16px}
svg{width:100%;height:220px}
.meta{color:#666;font-size:13px}
</style></head><body>
<h1>Training dashboard</h1>
<div class="meta" id="meta">waiting for stats…</div>
<div class="chart"><h2>Score vs iteration</h2><svg id="score"></svg></div>
<div class="chart"><h2>Iteration time (ms)</h2><svg id="time"></svg></div>
<div class="chart"><h2>log10 update:parameter ratio</h2>
<svg id="ratios"></svg><div class="meta" id="ratiokeys"></div></div>
<div class="chart"><h2>Activation histograms (latest)</h2>
<div id="hists"></div></div>
<div class="chart"><h2>t-SNE</h2><svg id="tsne" style="height:320px">
</svg><div class="meta" id="tsnemeta">no t-SNE data attached</div></div>
<div class="chart"><h2>Metrics (host-side monitoring)</h2>
<div class="meta">Prometheus exposition of the monitoring registry —
enable with <code>net.setListeners(MetricsListener())</code>; scrape at
<code>/metrics</code></div>
<pre id="metrics" style="max-height:320px;overflow:auto;font-size:12px">
monitoring disabled or no metrics yet</pre></div>
<div class="chart"><h2>Device profile (XLA per-op)</h2>
<div class="meta">On-demand jax.profiler window decoded to a per-op
table — arm with
<button onclick="armProfile()">profile next 3 steps</button> or
<code>POST /profile?steps=k</code>; also
<code>monitoring.profile_next_steps(k)</code></div>
<pre id="profile" style="max-height:360px;overflow:auto;font-size:12px">
no profile captured yet</pre></div>
<div class="chart"><h2>Generation (KV-cache decode)</h2>
<div class="meta">Continuous-batching autoregressive serving —
<code>GET /generation</code>; live while a GenerationServer runs</div>
<pre id="generation" style="max-height:240px;overflow:auto;font-size:12px">
no generation servers live</pre></div>
<div class="chart"><h2>Fleet (replica routing)</h2>
<div class="meta">Health-driven routing across GenerationServer
replicas — <code>GET /fleet</code>; per-replica health + burn rate,
failover tallies, and the autoscale signal</div>
<pre id="fleet" style="max-height:240px;overflow:auto;font-size:12px">
no fleet routers live</pre></div>
<div class="chart"><h2>Requests (trace timelines)</h2>
<div class="meta">Request-scoped tracing — <code>GET /requests</code>,
<code>GET /requests/&lt;trace-id&gt;</code>; p99 exemplars link
histogram tails to slow-request timelines; full merged Chrome trace at
<code>GET /trace</code></div>
<pre id="requests" style="max-height:240px;overflow:auto;font-size:12px">
no request timelines yet</pre></div>
<div class="chart"><h2>SLOs (burn rate)</h2>
<div class="meta">Declarative objectives on a multi-window burn-rate
rule — <code>GET /slo</code>; a breach flips <code>GET /health</code>
to degraded with the objective named</div>
<pre id="slo" style="max-height:160px;overflow:auto;font-size:12px">
no SLO tracker installed</pre></div>
<div class="chart"><h2>Step-time attribution (flight recorder)</h2>
<div class="meta">Per-step host phase breakdown (data_next / dispatch /
listeners + host-blocked and compile stalls) — <code>GET /steps</code>;
records appear while monitoring is enabled
(<code>MetricsListener()</code>)</div>
<pre id="steps" style="max-height:320px;overflow:auto;font-size:12px">
no step records yet</pre></div>
<div class="chart"><h2>Incidents (ops event journal)</h2>
<div class="meta">Correlated cross-subsystem incidents — raw events at
<code>GET /events</code>, incidents at <code>GET /incidents</code>;
post-mortem bundle on demand via <code>POST /debug/bundle</code></div>
<pre id="incidents" style="max-height:240px;overflow:auto;font-size:12px">
no incidents yet</pre></div>
<script>
const COLORS = ['#0a6','#06a','#a06','#a60','#60a','#6a0','#066','#660'];
function poly(svg, xs, ys, color){
  const el = document.getElementById(svg);
  if (xs.length < 2){ return; }
  const W = el.clientWidth || 600, H = 220, P = 30;
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const sx = x => P + (x - xmin) / (xmax - xmin || 1) * (W - 2*P);
  const sy = y => H - P - (y - ymin) / (ymax - ymin || 1) * (H - 2*P);
  const pts = xs.map((x,i)=>sx(x)+","+sy(ys[i])).join(" ");
  el.innerHTML = `<polyline fill="none" stroke="${color}" stroke-width="1.5"
    points="${pts}"/><text x="4" y="12" font-size="11">${ymax.toFixed(4)}
    </text><text x="4" y="${H-6}" font-size="11">${ymin.toFixed(4)}</text>`;
}
function multiPoly(svg, series){   // series: [{name, xs, ys, color}]
  const el = document.getElementById(svg);
  const all = series.flatMap(s=>s.ys);
  if (!all.length){ return; }
  const W = el.clientWidth || 600, H = 220, P = 30;
  const xs = series.flatMap(s=>s.xs);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...all), ymax = Math.max(...all);
  const sx = x => P + (x - xmin) / (xmax - xmin || 1) * (W - 2*P);
  const sy = y => H - P - (y - ymin) / (ymax - ymin || 1) * (H - 2*P);
  el.innerHTML = series.map(s=>`<polyline fill="none" stroke="${s.color}"
    stroke-width="1.2" points="${s.xs.map((x,i)=>sx(x)+","+sy(s.ys[i]))
    .join(" ")}"/>`).join("") +
    `<text x="4" y="12" font-size="11">${ymax.toFixed(2)}</text>
     <text x="4" y="${H-6}" font-size="11">${ymin.toFixed(2)}</text>`;
}
function histSvg(h, title, color){
  const W = 300, H = 120, n = h.counts.length;
  const cmax = Math.max(...h.counts, 1);
  const bars = h.counts.map((c,i)=>`<rect x="${i*W/n}" width="${W/n-1}"
    y="${H-20-(H-24)*c/cmax}" height="${(H-24)*c/cmax}"
    fill="${color}"/>`).join("");
  return `<svg viewBox="0 0 ${W} ${H}" style="width:300px;height:120px">
    ${bars}<text x="2" y="${H-6}" font-size="10">${h.min.toFixed(2)}</text>
    <text x="${W-40}" y="${H-6}" font-size="10">${h.max.toFixed(2)}</text>
    <text x="2" y="10" font-size="10">${title}</text></svg>`;
}
async function tick(){
  const r = await fetch('/stats'); const recs = await r.json();
  if (recs.length){
    const last = recs[recs.length-1];
    document.getElementById('meta').textContent =
      `iteration ${last.iteration} · epoch ${last.epoch} · score ` +
      last.score.toFixed(6);
    poly('score', recs.map(r=>r.iteration), recs.map(r=>r.score), '#0a6');
    const t = recs.filter(r=>r.iterationTimeMs != null);
    poly('time', t.map(r=>r.iteration), t.map(r=>r.iterationTimeMs), '#06a');
    const withR = recs.filter(r=>r.updateRatios &&
                              Object.keys(r.updateRatios).length);
    if (withR.length){
      const keys = Object.keys(withR[withR.length-1].updateRatios);
      multiPoly('ratios', keys.map((k,i)=>({name:k,
        xs: withR.filter(r=>k in r.updateRatios).map(r=>r.iteration),
        ys: withR.filter(r=>k in r.updateRatios)
          .map(r=>Math.log10(r.updateRatios[k]+1e-12)),
        color: COLORS[i % COLORS.length]})));
      document.getElementById('ratiokeys').innerHTML = keys.map((k,i)=>
        `<span style="color:${COLORS[i%COLORS.length]}">${k}</span>`)
        .join(" · ");
    }
    const ah = last.activationHistograms || {};
    document.getElementById('hists').innerHTML = Object.keys(ah)
      .map((k,i)=>histSvg(ah[k], k, COLORS[i % COLORS.length])).join("");
  }
  try {
    const mr = await fetch('/metrics'); const mt = await mr.text();
    if (mt.trim()){
      document.getElementById('metrics').textContent = mt;
    }
  } catch (e) {}
  try {
    const pr = await fetch('/profile'); const pd = await pr.json();
    const el = document.getElementById('profile');
    if (pd.last && pd.last.report){
      const rep = pd.last.report;
      let txt = `captured ${rep.steps} steps · device self time ` +
        `${rep.device_self_ms.toFixed(3)} ms · ${rep.op_count} ops\n\n` +
        '   self ms   total ms      %  count  category     op\n';
      for (const r of rep.ops){
        txt += `${r.self_ms.toFixed(3).padStart(10)} ` +
          `${r.total_ms.toFixed(3).padStart(10)} ` +
          `${r.pct.toFixed(1).padStart(6)} ${String(r.count).padStart(6)}` +
          `  ${r.category.padEnd(12)} ${r.name.slice(0,70)}\n`;
      }
      el.textContent = txt;
    } else if (pd.active){
      el.textContent = `profiling: ${pd.active.state} ` +
        `(${pd.active.captured_steps}/${pd.active.steps} steps)`;
    }
  } catch (e) {}
  try {
    const gr = await fetch('/generation'); const gd = await gr.json();
    if (gd.servers && gd.servers.length){
      document.getElementById('generation').textContent =
        gd.servers.map(s =>
          `${s.decoder} [${s.state}]: slots ${s.active_slots}/` +
          `${s.slots} · rung ${s.rung} · queued ${s.queued} · ` +
          `tokens ${s.tokens} · admissions ${s.admissions} · ` +
          `retirements ${s.retirements} · errors ${s.errors} · ` +
          `replays ${s.replays} · restarts ${s.restarts} · ` +
          `degradations ${s.degradations}\n` +
          `  superstep k=${s.superstep} draft=${s.draft} · ` +
          `supersteps ${s.supersteps} · tok/dispatch ` +
          `${s.tokens_per_dispatch ?? '-'} · syncs/tok ` +
          `${s.host_syncs_per_token ?? '-'} · per-token p50 ` +
          `${s.per_token_p50_ms ?? '-'} ms p99 ` +
          `${s.per_token_p99_ms ?? '-'} ms · draft ok/ko ` +
          `${s.draft_accepts}/${s.draft_rejects}`).join("\n");
    }
  } catch (e) {}
  try {
    const fr = await fetch('/fleet'); const fd = await fr.json();
    if (fd.routers && fd.routers.length){
      document.getElementById('fleet').textContent =
        fd.routers.map(f =>
          f.replicas.map(r =>
            `${r.name} [${r.health}] burn ${r.burn_short}/` +
            `${r.burn_long} · slots ${r.active_slots}/${r.slots} · ` +
            `queued ${r.queued} · routed ${r.routed} · failovers ` +
            `${r.failovers} · replacements ${r.replacements}`
          ).join("\n") +
          `\n  fleet: submitted ${f.submitted} · completed ` +
          `${f.completed} · failovers ${f.failovers} · shed ` +
          `${f.shed} · desired replicas ` +
          `${f.autoscale.desired_replicas} (util ` +
          `${f.autoscale.utilization} x burn ` +
          `${f.autoscale.slo_burn})`).join("\n\n");
    }
  } catch (e) {}
  try {
    const rr = await fetch('/requests?last=12'); const rd = await rr.json();
    const rows = [...(rd.active||[]), ...(rd.recent||[]).slice().reverse()];
    if (rows.length){
      document.getElementById('requests').textContent = rows.map(t => {
        const last = t.events.length ? t.events[t.events.length-1] : null;
        const blocks = t.events.filter(e=>e.event==='block').length;
        return `${t.trace_id} [${t.kind}] ${t.status||'in-flight'} · ` +
          `${t.events.length} events · blocks ${blocks}` +
          (last ? ` · last ${last.event}@${last.t_ms.toFixed(1)}ms` : '');
      }).join("\n");
    }
  } catch (e) {}
  try {
    const lr = await fetch('/slo'); const ld = await lr.json();
    if (ld.installed && ld.objectives){
      document.getElementById('slo').textContent =
        Object.values(ld.objectives).map(o =>
          `${o.breached ? 'BREACH' : '  ok  '} ${o.name}: ` +
          `burn short ${o.burn_short} long ${o.burn_long} · ` +
          `last ${o.last_value==null?'-':o.last_value.toFixed(3)} ` +
          `(limit ${o.threshold})`).join("\n");
    }
  } catch (e) {}
  try {
    const sr = await fetch('/steps'); const sd = await sr.json();
    const el = document.getElementById('steps');
    if (sd.summary && sd.summary.count){
      const s = sd.summary;
      let txt = `${s.count} steps`;
      if (s.wall_ms){ txt += ` · wall p50 ${s.wall_ms.p50.toFixed(2)} ms` +
        ` p95 ${s.wall_ms.p95.toFixed(2)} ms`; }
      if (s.coverage != null){
        txt += ` · attribution coverage ${(100*s.coverage).toFixed(0)}%`; }
      txt += '\n';
      for (const k in s.phases){
        const p = s.phases[k];
        txt += `  ${k}: p50 ${p.p50.toFixed(2)} ms  ` +
          `p95 ${p.p95.toFixed(2)} ms\n`;
      }
      txt += `  compiles: ${s.compile_count_total} ` +
        `(${s.compile_ms_total.toFixed(1)} ms) · host blocked ` +
        `${s.host_blocked_ms_total.toFixed(1)} ms\n\nlast steps:\n`;
      for (const r of sd.records.slice(-12)){
        const ph = Object.entries(r.phases)
          .map(([k,v])=>`${k}=${v.toFixed(2)}`).join(' ');
        txt += `  #${r.step} wall=` +
          (r.wall_ms==null?'?':r.wall_ms.toFixed(2)) + ` ms  ${ph}\n`;
      }
      el.textContent = txt;
    }
  } catch (e) {}
  try {
    const ir = await fetch('/incidents'); const id_ = await ir.json();
    const rows = [...(id_.open||[]), ...(id_.recent||[]).slice().reverse()];
    if (rows.length){
      document.getElementById('incidents').textContent = rows.map(i =>
        `${i.state==='open' ? 'OPEN  ' : 'closed'} ${i.id} · ` +
        `trigger ${i.trigger.kind} [${i.trigger.subsystem}] · ` +
        `${i.actions.length} actions · ` +
        `resolution ${i.resolution || '-'} · ` +
        (i.duration_s==null ? 'ongoing' :
         `${i.duration_s.toFixed(2)} s`)).join("\n");
    }
  } catch (e) {}
  const tr = await fetch('/tsne'); const td = await tr.json();
  if (td.points && td.points.length){
    const el = document.getElementById('tsne');
    const W = el.clientWidth || 600, H = 320, P = 20;
    const xs = td.points.map(p=>p[0]), ys = td.points.map(p=>p[1]);
    const xmin=Math.min(...xs), xmax=Math.max(...xs);
    const ymin=Math.min(...ys), ymax=Math.max(...ys);
    const labs = td.labels || [];
    const lset = [...new Set(labs)];
    el.innerHTML = td.points.map((p,i)=>`<circle
      cx="${P+(p[0]-xmin)/(xmax-xmin||1)*(W-2*P)}"
      cy="${H-P-(p[1]-ymin)/(ymax-ymin||1)*(H-2*P)}" r="2.5"
      fill="${lset.length ?
        COLORS[((lset.indexOf(labs[i]) % COLORS.length) + COLORS.length)
               % COLORS.length] : COLORS[0]}"/>`).join("");
    document.getElementById('tsnemeta').textContent =
      `${td.points.length} points` + (lset.length>1 ?
      ` · classes: ${lset.join(", ")}` : "");
  }
}
async function armProfile(){
  try { await fetch('/profile?steps=3', {method: 'POST'}); } catch (e) {}
}
setInterval(tick, 1000); tick();
</script></body></html>"""

class _Answer(Exception):
    """A route's early answer other than 200 (a 404, a 501)."""

    def __init__(self, code, body, ctype="application/json"):
        super().__init__(code)
        self.code, self.body, self.ctype = code, body, ctype


def _json(doc):
    return json.dumps(doc, default=str).encode()


def _query_int(path, name, default):
    q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
    try:
        return int(q.get(name, [str(default)])[0])
    except ValueError:
        return default


def _coordinator():
    mod = sys.modules.get(_COORDINATION)
    return getattr(mod, "ACTIVE", None) if mod is not None else None


# -- GET routes: each returns (body bytes, content type) ---------------------
def _get_profile(path, ui):
    from deeplearning4j_tpu_torch.monitoring import profiler as _prof
    return _json(_prof.status())


def _get_steps(path, ui):
    # the flight recorder's ring (?last=N, default 64) and its summary;
    # on process 0 of a multi-host run every host's published digest
    from deeplearning4j_tpu_torch.monitoring import steps as _steps
    rec = _steps.recorder()
    doc = {"records": rec.records(last=_query_int(path, "last", 64)),
           "summary": rec.summary()}
    coord = _coordinator()
    if coord is not None and coord.process_id == 0 \
            and coord.num_processes > 1:
        try:
            from deeplearning4j_tpu_torch.monitoring import \
                stragglers as _sg
            doc["hosts"] = {str(pid): snap.get("timeline")
                            for pid, snap in sorted(_sg.gather(coord).items())}
        except Exception:  # noqa: BLE001 — the local ring still answers
            pass
    return _json(doc)


def _get_stragglers(path, ui):
    coord = _coordinator()
    if coord is None:
        raise _Answer(404, b"no active peer coordinator", "text/plain")
    from deeplearning4j_tpu_torch.monitoring import stragglers as _sg
    att = _sg.attribution(coord)
    if att is None:
        att = {"hosts": {}, "published": 0, "ratio": None,
               "median_step_ms": None, "slowest": None,
               "error": "coordination KV unreachable"}
    return _json(att)


def _get_executables(path, ui):
    from deeplearning4j_tpu_torch.runtime import executables as _exe
    return _json(_exe.status())


def _get_generation(path, ui):
    from deeplearning4j_tpu_torch.generation import server as _gen
    return _json(_gen.status())


def _get_fleet(path, ui):
    from deeplearning4j_tpu_torch.generation import fleet as _fleet
    return _json(_fleet.status())


def _get_requests(path, ui):
    # /requests: in-flight + recent timelines (?last=N, default 32) and
    # the exemplars linking histogram tails to them; /requests/<id>: one
    from deeplearning4j_tpu_torch import monitoring as _mon
    from deeplearning4j_tpu_torch.monitoring import requests as _reqs
    parts = [p for p in urllib.parse.urlparse(path).path.split("/") if p]
    if len(parts) > 1:
        tl = _reqs.log().get(urllib.parse.unquote(parts[1]))
        if tl is None:
            raise _Answer(404, b'{"error": "unknown trace id"}')
        return _json(tl.snapshot())
    doc = _reqs.log().snapshot(last=_query_int(path, "last", 32))
    reg = _mon.get_registry()
    ex = {}
    for name in (_mon.GEN_PER_TOKEN_MS, _mon.GEN_PREFILL_MS,
                 _mon.INFERENCE_REQUEST_MS):
        h = reg.get(name)
        if h is not None and h.exemplars():
            ex[name] = h.exemplars()
    doc["exemplars"] = ex
    return _json(doc)


def _get_slo(path, ui):
    from deeplearning4j_tpu_torch.monitoring import slo as _slo
    t = _slo.ACTIVE
    return _json({"installed": t is not None,
                  **(t.snapshot() if t is not None else {})})


def _get_trace(path, ui):
    from deeplearning4j_tpu_torch.monitoring import requests as _reqs
    return _json(_reqs.merged_chrome_trace())


def _get_health(path, ui):
    # load balancers and supervisors key off the status code alone
    from deeplearning4j_tpu_torch import resilience as _res
    snap = _res.health_snapshot()
    if snap["status"] not in ("ok", "degraded"):
        raise _Answer(503, _json(snap))
    return _json(snap)


def _get_events(path, ui):
    from deeplearning4j_tpu_torch.monitoring import events as _ev
    return _json(_ev.snapshot(last=_query_int(path, "last", 64)))


def _get_incidents(path, ui):
    from deeplearning4j_tpu_torch.monitoring import events as _ev
    return _json(_ev.incidents())


def _get_metrics(path, ui):
    # with monitoring on the core families and the device-memory gauges
    # refresh per scrape; off, whatever the registry holds
    from deeplearning4j_tpu_torch import monitoring as _mon
    reg = _mon.get_registry()
    if _mon.enabled():
        try:
            _mon.bootstrap_core_metrics(reg)
        except Exception:  # noqa: BLE001 — always serve
            pass
    body = None
    coord = _coordinator()
    if coord is not None and coord.num_processes > 1 \
            and coord.process_id == 0:
        try:
            from deeplearning4j_tpu_torch.monitoring import \
                cluster as _cluster
            body = _cluster.cluster_prometheus_text(coord, reg).encode()
        except Exception:  # noqa: BLE001 — always serve
            body = None
    if body is None:
        body = reg.prometheus_text().encode()
    return body, "text/plain; version=0.0.4; charset=utf-8"


_GET = (("/stats", lambda path, ui: _json(
            [r for s in ui._storages for r in s.all()])),
        ("/tsne", lambda path, ui: _json(ui._tsne)),
        ("/profile", _get_profile),
        ("/steps", _get_steps),
        ("/stragglers", _get_stragglers),
        ("/executables", _get_executables),
        ("/generation", _get_generation),
        ("/fleet", _get_fleet),
        ("/requests", _get_requests),
        ("/slo", _get_slo),
        ("/trace", _get_trace),
        ("/health", _get_health),
        ("/events", _get_events),
        ("/incidents", _get_incidents),
        ("/metrics", _get_metrics))


# -- POST routes ---------------------------------------------------------------
def _post_profile(path, ui):
    from deeplearning4j_tpu_torch.monitoring import profiler as _prof
    session = _prof.profile_next_steps(steps=_query_int(path, "steps", 3))
    return _json({"armed": True, "steps": session.steps})


def _post_bundle(path, ui):
    # the directory comes from DL4J_CRASH_DUMP_DIR (cwd otherwise), never
    # from the request: this endpoint is unauthenticated
    from deeplearning4j_tpu_torch.monitoring import events as _ev
    p = _ev.write_bundle(headline="POST /debug/bundle")
    body = _json({"path": p, "sections": list(_ev.BUNDLE_SECTIONS)})
    if not p:
        raise _Answer(500, body)
    return body


_POST = (("/profile", _post_profile), ("/debug/bundle", _post_bundle))


def _route(table, path):
    """The handler of the first route `path` names: the route itself, or
    a sub-path or query of it."""
    bare = urllib.parse.urlparse(path).path
    for prefix, fn in table:
        if bare == prefix or bare.startswith(prefix + "/"):
            return fn
    return None


class UIServer:
    """≡ org.deeplearning4j.ui.api.UIServer (singleton surface)."""

    _instance = None

    def __init__(self):
        self._storages = []
        self._httpd = None
        self._thread = None
        self.port = None
        self._tsne = {"points": [], "labels": []}

    @classmethod
    def getInstance(cls):
        if cls._instance is None:
            cls._instance = UIServer()
        return cls._instance

    def attach(self, storage):
        """Serve `storage.all()` (a list of JSON records) on `/stats`."""
        self._storages.append(storage)
        return self

    def detach(self, storage):
        self._storages.remove(storage)
        return self

    def attachTsne(self, vectors, labels=None, maxIter=300, perplexity=30.0,
                   seed=0, device=None):
        """t-SNE tab (≡ the reference UI's word-vector t-SNE view): pass
        2-D coords directly, or higher-dim vectors to embed here via
        clustering.tsne (exact gradients, on the card unless
        `device="cpu"`)."""
        import numpy as _np
        vectors = _np.asarray(vectors, _np.float32)
        if vectors.ndim != 2:
            raise ValueError(f"attachTsne expects (N, D), got "
                             f"{vectors.shape}")
        if vectors.shape[1] != 2:
            from deeplearning4j_tpu_torch.clustering.tsne import \
                BarnesHutTsne
            vectors = (BarnesHutTsne.Builder().setMaxIter(int(maxIter))
                       .perplexity(perplexity).seed(seed).build()
                       .fit(vectors, device=device).getData())
        self._tsne = {
            "points": [[float(a), float(b)] for a, b in vectors],
            "labels": [str(l) for l in labels] if labels is not None else [],
        }
        return self

    def start(self, port=9000):
        """Serve on 127.0.0.1:`port` (0: an ephemeral port, then `.port`)
        from a background thread. Idempotent."""
        if self._httpd is not None:
            return self
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def _answer(self, table, default):
                fn = _route(table, self.path)
                code, ctype = 200, "application/json"
                try:
                    if fn is None:
                        if default is None:
                            raise _Answer(404, b'{"error": "unknown '
                                               b'endpoint"}')
                        body, ctype = default, "text/html"
                    else:
                        body = fn(self.path, ui)
                        if isinstance(body, tuple):
                            body, ctype = body
                except _Answer as a:
                    code, body, ctype = a.code, a.body, a.ctype
                except Exception as e:  # noqa: BLE001 — answer, live on
                    code = 500
                    body = _json({"error": f"{type(e).__name__}: {e}"})
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                bare = urllib.parse.urlparse(self.path).path
                self._answer(_GET, _PAGE.encode()
                             if bare in ("/", "/index.html") else None)

            def do_POST(self):
                self._answer(_POST, None)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
        return self


def render_static_html(storage, path, tsne=None):
    """Static dashboard snapshot: inline-SVG score/time charts plus the
    round-5 panels — log10 update:parameter ratios, latest activation
    histograms, and an optional t-SNE scatter (tsne=(coords, labels))."""
    import math

    recs = storage.all()

    def svg_line(xs, ys, color):
        if len(xs) < 2:
            return "<svg></svg>"
        W, H, P = 640, 220, 30
        xmin, xmax = min(xs), max(xs)
        ymin, ymax = min(ys), max(ys)
        def sx(x):
            return P + (x - xmin) / ((xmax - xmin) or 1) * (W - 2 * P)
        def sy(y):
            return H - P - (y - ymin) / ((ymax - ymin) or 1) * (H - 2 * P)
        pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
        return (f'<svg viewBox="0 0 {W} {H}">'
                f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
                f'points="{pts}"/>'
                f'<text x="4" y="12" font-size="11">{ymax:.4g}</text>'
                f'<text x="4" y="{H-6}" font-size="11">{ymin:.4g}</text>'
                f'</svg>')

    iters = [r["iteration"] for r in recs]
    scores = [r["score"] for r in recs]
    times = [(r["iteration"], r["iterationTimeMs"]) for r in recs
             if r.get("iterationTimeMs") is not None]
    html = ("<!DOCTYPE html><html><head><title>training snapshot</title>"
            "</head><body><h1>Training snapshot</h1>"
            f"<p>{len(recs)} records</p>"
            "<h2>Score</h2>" + svg_line(iters, scores, "#0a6"))
    if times:
        html += "<h2>Iteration time (ms)</h2>" + svg_line(
            [t[0] for t in times], [t[1] for t in times], "#06a")

    colors = ["#0a6", "#06a", "#a06", "#a60", "#60a", "#6a0", "#066"]
    with_r = [r for r in recs if r.get("updateRatios")]
    if with_r:
        keys = sorted(with_r[-1]["updateRatios"])
        html += "<h2>log10 update:parameter ratio</h2>"
        for i, k in enumerate(keys):
            pts = [(r["iteration"],
                    math.log10(r["updateRatios"][k] + 1e-12))
                   for r in with_r if k in r["updateRatios"]]
            html += (f'<div>{k}</div>'
                     + svg_line([p[0] for p in pts], [p[1] for p in pts],
                                colors[i % len(colors)]))
    ah = next((r["activationHistograms"] for r in reversed(recs)
               if r.get("activationHistograms")), None)
    if ah:
        html += "<h2>Activation histograms (latest)</h2>"
        for i, (k, h) in enumerate(sorted(ah.items())):
            cmax = max(h["counts"]) or 1
            W, H, n = 300, 120, len(h["counts"])
            bars = "".join(
                f'<rect x="{j * W / n:.1f}" width="{W / n - 1:.1f}" '
                f'y="{H - 20 - (H - 24) * c / cmax:.1f}" '
                f'height="{(H - 24) * c / cmax:.1f}" '
                f'fill="{colors[i % len(colors)]}"/>'
                for j, c in enumerate(h["counts"]))
            html += (f'<h3>{k}</h3><svg viewBox="0 0 {W} {H}" '
                     f'width="{W}" height="{H}">{bars}'
                     f'<text x="2" y="{H - 6}" font-size="10">'
                     f'{h["min"]:.2f}</text>'
                     f'<text x="{W - 44}" y="{H - 6}" font-size="10">'
                     f'{h["max"]:.2f}</text></svg>')
    if tsne is not None:
        coords, labels = (tsne if isinstance(tsne, tuple)
                          else (tsne, None))
        import numpy as _np
        coords = _np.asarray(coords, _np.float32)
        lset = sorted(set(map(str, labels))) if labels is not None else []
        W, H, P = 640, 360, 20
        xmin, ymin = coords.min(0)
        xmax, ymax = coords.max(0)
        dots = "".join(
            f'<circle cx="{P + (cx - xmin) / ((xmax - xmin) or 1) * (W - 2 * P):.1f}" '
            f'cy="{H - P - (cy - ymin) / ((ymax - ymin) or 1) * (H - 2 * P):.1f}" '
            f'r="2.5" fill="'
            + (colors[lset.index(str(labels[i])) % len(colors)]
               if lset else colors[0]) + '"/>'
            for i, (cx, cy) in enumerate(coords))
        html += (f"<h2>t-SNE ({len(coords)} points)</h2>"
                 f'<svg viewBox="0 0 {W} {H}" width="{W}" '
                 f'height="{H}">{dots}</svg>')
    html += "</body></html>"
    with open(path, "w") as f:
        f.write(html)
    return path
