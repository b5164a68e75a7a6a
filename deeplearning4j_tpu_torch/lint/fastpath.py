"""Fast-path lint of the port: the twin of `scripts/check_fastpath.py`,
pointed at `deeplearning4j_tpu_torch/`.

Run:  python -m deeplearning4j_tpu_torch.lint.fastpath   (exit 1 on a
violation; `tests/test_torch_lints.py` runs it in tier-1).

Rules, each an AST walk of the port's sources:

- Registry guard (`HOT_MODULES`): every `registry.counter(...)` /
  `.gauge(...)` / `.histogram(...)` / `get_registry()` in a per-step
  module sits inside the `if _mon.enabled():` guard (or behind an early
  return on it), so monitoring off costs one branch.
- Event guard (`EVENT_HOOK_MODULES`): every `_events.emit(...)` likewise.
- No capture on a steady-state path: from the roots of the serving, the
  generation and the fleet walks (an intra-package call graph by bare
  function name), no call that captures a CUDA graph, builds a kernel or
  warms a server or store (`CAPTURE_CALL_NAMES`) is reachable without
  crossing a declared cold boundary (the store's miss path `ensure`, a
  weight load's `_rebind`, the fleet's `_supervise`).
- No host sync on a per-token path: from the generation, fleet,
  timeline-publish and event-journal roots, no call that waits for or
  reads back the device (`SYNC_CALL_NAMES`) is reachable outside the
  declared fetch boundaries (`_fetch_tokens`, `_start_fetch`, `_fetch`,
  the staging ring's `stage`).

Every module, root and boundary named here must exist in the port: a
stale name is itself a violation, so the lists follow the code. Matching
is by bare callee name; a false positive is accepted over a missed
capture or sync on a hot path.
"""
from __future__ import annotations

import ast
import os
import sys

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: per-step modules (relative to the package): registry calls guarded
HOT_MODULES = [
    "nn/graph.py",
    # the fit loop: guarded steps, fault sites and heartbeats
    "nn/_network.py",
    "nn/multilayer.py",
    # the training half of resilience: per-step verdicts, saves, beats
    "resilience/guardian.py",
    "resilience/watchdog.py",
    "resilience/trainer.py",
    "parallel/elastic.py",
    "runtime/pipeline.py",
    "runtime/executables.py",
    "parallel/inference.py",
    "resilience/faults.py",
    # the decode loop, its decoder, sampling and page allocator
    "generation/server.py",
    "generation/decode.py",
    "generation/sampling.py",
    "generation/paging.py",
    # the fleet router: routed/failover counters ride every request
    "generation/fleet.py",
    "quantize/core.py",
    "quantize/kvcache.py",
    "monitoring/requests.py",
]

# -- serving steady state -------------------------------------------------
#: ParallelInference's dispatch path and the store's steady-state calls
SERVING_MODULES = ["parallel/inference.py", "runtime/executables.py",
                   "monitoring/requests.py"]
SERVING_ROOTS = {"_dispatch", "_run", "_serve_graphs", "run", "stage"}
#: the store's miss path (a signature outside the warmed ladder captures
#: once: `ensure` → `add`), warm-up, and a weight load's recapture
SERVING_MISS_BOUNDARY = {"warmup", "ensure", "_rebind", "_ensure_store"}

# -- the generation decode loop -------------------------------------------
GENERATION_MODULES = [
    "generation/server.py",
    "generation/decode.py",
    "generation/sampling.py",
    "generation/paging.py",
    "runtime/executables.py",
    "quantize/kvcache.py",
    "quantize/core.py",
    "monitoring/requests.py",
]
#: decode-loop entry points, crash replay and the supervised restart
#: (recovery replays the warm graphs: zero captures), and the paged
#: allocator's per-block work
GENERATION_ROOTS = {"_dispatch_block", "_deliver_block", "_block_args",
                    "_propose_drafts", "_admit_pending", "_admit_one",
                    "_admit_adopted", "_admit_fresh", "_admit_rec",
                    "_retire_slot", "_deliver", "_survive", "_recover",
                    "_replay_one", "_advance_key", "_supervised_restart",
                    "_page_args", "admit_slot", "ensure_range",
                    "evict_cold", "release_slot", "build_table"}
#: a weight load's recapture (`run` → `_rebind`, counted `rebinds`); a
#: call of `warmup` or of the store's `add` is itself a violation here
GENERATION_MISS_BOUNDARY = {"_rebind"}
#: per-block sync rule roots
GENERATION_SYNC_ROOTS = {"_dispatch_block", "_deliver_block",
                         "_block_args", "_propose_drafts", "_deliver",
                         "_push", "_retire_slot", "_finish", "_fail",
                         "_page_args", "_emit_page_metrics", "admit_slot",
                         "abort_admit", "ensure_range", "evict_cold",
                         "release_slot", "build_table"}
#: the declared fetches: a block's tokens (`_start_fetch` starts the
#: copy and waits only for the pinned buffer's previous copy,
#: `_fetch_tokens` waits for it), an admission's first token (`_fetch`),
#: and the staging ring, whose wait is for a copy two stages back
GENERATION_SYNC_BOUNDARY = {"_fetch_tokens", "_start_fetch", "_fetch",
                            "stage"}

# -- the fleet router ------------------------------------------------------
#: route / dispatch / relay / failover run on every request and every
#: failover: pure host bookkeeping
FLEET_MODULES = ["generation/fleet.py"]
FLEET_ROOTS = {"_route", "_dispatch", "_relay", "_failover", "_health",
               "_mark", "_retryable", "_finalize"}
#: replica replacement builds and warms a server: the cold boundary (a
#: `warmup` call anywhere else on the walk is a violation)
FLEET_BOUNDARY = {"_supervise"}

# -- step-timeline publish (straggler plane) ------------------------------
TIMELINE_MODULE_GROUPS = [
    ["monitoring/stragglers.py", "monitoring/steps.py"],
    ["monitoring/cluster.py"],
]
TIMELINE_SYNC_ROOTS = {"publish", "compact_summary"}
TIMELINE_SYNC_BOUNDARY = set()

# -- ops events ------------------------------------------------------------
EVENT_HOOK_MODULES = ["resilience/faults.py", "generation/server.py",
                      "generation/fleet.py", "monitoring/slo.py",
                      "resilience/guardian.py", "resilience/watchdog.py"]
EVENT_EMIT_ALIASES = {"_events"}
EVENT_JOURNAL_MODULES = ["monitoring/events.py"]
EVENT_EMIT_ROOTS = {"emit", "journal", "_correlate", "_sweep_quiet",
                    "_close", "_publish_locked", "snapshot",
                    "incidents", "absorb", "close"}
EVENT_EMIT_BOUNDARY = {"bundle", "write_bundle"}

#: calls that capture a CUDA graph, build a kernel or compile: a graph
#: capture, a kernel build, torch.compile, a server's or a store's
#: warm-up, and the store's `add` (a live capture once warm)
CAPTURE_CALL_NAMES = {"CUDAGraph", "graph", "capture_begin", "_capture",
                      "build_all", "compile", "warmup", "add"}
#: calls that wait for or read back the device
SYNC_CALL_NAMES = {"item", "tolist", "cpu", "numpy", "synchronize"}

REGISTRY_ATTRS = {"counter", "gauge", "histogram"}
REGISTRY_FUNCS = {"get_registry"}
GUARD_TOKENS = ("enabled", "STATE.", "mon_on", "ACTIVE")


def _is_registry_call(node):
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in REGISTRY_ATTRS:
        return f".{f.attr}(...)"
    name = None
    if isinstance(f, ast.Attribute):
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    if name in REGISTRY_FUNCS:
        return f"{name}()"
    return None


def _test_is_guard(test):
    try:
        src = ast.unparse(test)
    except Exception:  # noqa: BLE001 — unparse of odd nodes
        return False
    return any(tok in src for tok in GUARD_TOKENS)


def _guarded(node, ancestors):
    """Inside an `if <enabled-ish>` block, or after an early-return
    `if not <enabled-ish>: return` in the enclosing function."""
    func = None
    for anc in reversed(ancestors):
        if isinstance(anc, ast.If) and _test_is_guard(anc.test):
            return True
        if func is None and isinstance(anc, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
            func = anc
    if func is not None:
        for stmt in ast.walk(func):
            if isinstance(stmt, ast.If) and _test_is_guard(stmt.test) \
                    and stmt.lineno < node.lineno \
                    and any(isinstance(s, (ast.Return, ast.Raise))
                            for s in stmt.body):
                return True
    return False


def check_source(source, path="<string>"):
    """[(path, lineno, description)] for unguarded registry calls."""
    tree = ast.parse(source, filename=path)
    violations = []

    def walk(node, ancestors):
        if isinstance(node, ast.Call):
            what = _is_registry_call(node)
            if what is not None and not _guarded(node, ancestors):
                violations.append(
                    (path, node.lineno,
                     f"{what} outside the enabled-guard fast path"))
        for child in ast.iter_child_nodes(node):
            walk(child, ancestors + [node])

    walk(tree, [])
    return violations


def _call_name(node):
    """Best-effort callee name of a Call: `f(...)` → f, `a.b.f(...)` →
    f. Good enough for an intra-repo method-name call graph."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _check_reachable(sources, roots, boundary, flag_names, describe):
    """Walk the union call graph (intra-repo, by function name) of
    every function/method defined in `sources`, starting from `roots`
    and NOT descending into `boundary`, and flag any call whose callee
    name is in `flag_names`. `describe(what, via)` renders the
    violation message. Matching is by bare callee name — a theoretical
    false positive (e.g. `"x".lower()`) is accepted over ever missing
    a real trace/sync on a hot path."""
    defs = {}        # name -> (path, FunctionDef)
    for path, source in sources.items():
        tree = ast.parse(source, filename=path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, (path, node))
    violations = []
    seen = set()
    frontier = [r for r in roots if r in defs]
    while frontier:
        name = frontier.pop()
        if name in seen or name in boundary:
            continue
        seen.add(name)
        path, fn = defs[name]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = _call_name(node)
            if callee in flag_names:
                f = node.func
                what = (f".{callee}(...)" if isinstance(f, ast.Attribute)
                        else f"{callee}(...)")
                violations.append(
                    (path, node.lineno, describe(what, name)))
            if callee in defs and callee not in seen \
                    and callee not in boundary:
                frontier.append(callee)
    return violations


def check_event_emit_guarded(source, path="<string>"):
    """Every ops-event emission hook (`_events.emit(...)`) must sit
    inside the enabled-guard: the event journal is monitoring-plane
    state, and a disabled run pays one branch per hook site, not a
    journal append per incident-adjacent code path."""
    tree = ast.parse(source, filename=path)
    violations = []

    def walk(node, ancestors):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "emit" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in EVENT_EMIT_ALIASES \
                    and not _guarded(node, ancestors):
                violations.append(
                    (path, node.lineno,
                     f"{f.value.id}.emit(...) outside the "
                     "enabled-guard — ops-event hooks must cost one "
                     "branch when monitoring is off"))
        for child in ast.iter_child_nodes(node):
            walk(child, ancestors + [node])

    walk(tree, [])
    return violations


def _read(rels):
    """{path: source} of modules relative to the package; a listed module
    that is missing raises (the lists follow the code)."""
    out = {}
    for rel in rels:
        path = os.path.join(PACKAGE, rel)
        with open(path) as f:
            out[path] = f.read()
    return out


def _stale_names(sources, names, what):
    """Roots and boundaries must name functions of their walk."""
    defined = set()
    for path, source in sources.items():
        for node in ast.walk(ast.parse(source, filename=path)):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defined.add(node.name)
    return [("<lint>", 0, f"{what}: {n!r} names no function of "
                          f"{sorted(os.path.relpath(p, PACKAGE) for p in sources)}")
            for n in sorted(set(names) - defined)]


def _walk(rels, roots, boundary, flags, describe, what):
    sources = _read(rels)
    return (_stale_names(sources, roots | boundary, what)
            + _check_reachable(sources, roots, boundary, flags, describe))


def main():
    violations = []
    for rel, source in _read(HOT_MODULES).items():
        violations.extend(check_source(source, rel))
    for rel, source in _read(EVENT_HOOK_MODULES).items():
        violations.extend(check_event_emit_guarded(source, rel))
    violations += _walk(
        SERVING_MODULES, SERVING_ROOTS, SERVING_MISS_BOUNDARY,
        CAPTURE_CALL_NAMES, lambda what, via: (
            f"{what} reachable from the serving dispatch path (via {via})"
            " — steady state replays the warmed bucket graphs"), "serving")
    violations += _walk(
        GENERATION_MODULES, GENERATION_ROOTS, GENERATION_MISS_BOUNDARY,
        CAPTURE_CALL_NAMES, lambda what, via: (
            f"{what} reachable from the generation decode loop (via "
            f"{via}) — step/admit/retire/replay replay the warm graphs"),
        "generation")
    violations += _walk(
        GENERATION_MODULES, GENERATION_SYNC_ROOTS, GENERATION_SYNC_BOUNDARY,
        SYNC_CALL_NAMES, lambda what, via: (
            f"{what} reachable from the decode step (via {via}) — the "
            "token fetches are the only host syncs of a block"),
        "generation sync")
    for flags, kind in ((CAPTURE_CALL_NAMES, "capture"),
                        (SYNC_CALL_NAMES, "device sync")):
        violations += _walk(
            FLEET_MODULES, FLEET_ROOTS, FLEET_BOUNDARY, flags,
            lambda what, via, kind=kind: (
                f"{what} reachable from the fleet routing walk (via {via})"
                f" — a {kind} belongs to replica replacement (_supervise)"
                " alone"), "fleet")
    for group in TIMELINE_MODULE_GROUPS:
        sources = _read(group)
        violations += _check_reachable(
            sources, TIMELINE_SYNC_ROOTS, TIMELINE_SYNC_BOUNDARY,
            SYNC_CALL_NAMES, lambda what, via: (
                f"{what} reachable from the step-timeline publish path "
                f"(via {via}) — publishing is host serialization"))
    violations += _walk(
        EVENT_JOURNAL_MODULES, EVENT_EMIT_ROOTS, EVENT_EMIT_BOUNDARY,
        SYNC_CALL_NAMES | CAPTURE_CALL_NAMES, lambda what, via: (
            f"{what} reachable from the event-journal emit path (via "
            f"{via}) — emission is host bookkeeping"), "events")
    for path, lineno, msg in violations:
        rel = os.path.relpath(path, PACKAGE) if os.path.isabs(path) \
            else path
        print(f"{rel}:{lineno}: {msg}")
    if violations:
        print(f"\n{len(violations)} fast-path violation(s)")
    return violations


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
