"""The port's lints (deeplearning4j_tpu_torch/lint/): each exits 0 on the
tree, as `python -m deeplearning4j_tpu_torch.lint.<name>` runs it, and
each catches the violation it exists for on a planted source."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.lint import (_coverage, event_coverage,
                                           fastpath, fault_coverage)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["fastpath", "fault_coverage",
                                  "event_coverage"])
def test_lint_exits_zero_on_the_tree(name):
    res = subprocess.run(
        [sys.executable, "-m", f"deeplearning4j_tpu_torch.lint.{name}"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_fleet_walk_is_linted():
    """fleet.py's route, dispatch, relay and failover code sits in the
    registry and event guards and in both reachability walks."""
    assert "generation/fleet.py" in fastpath.HOT_MODULES
    assert "generation/fleet.py" in fastpath.EVENT_HOOK_MODULES
    assert fastpath.FLEET_MODULES == ["generation/fleet.py"]
    assert {"_route", "_dispatch", "_relay", "_failover"} \
        <= fastpath.FLEET_ROOTS
    assert fastpath.FLEET_BOUNDARY == {"_supervise"}
    for rel in ("generation/server.py", "generation/decode.py",
                "parallel/inference.py", "nn/graph.py"):
        assert rel in fastpath.HOT_MODULES


def test_fastpath_flags_an_unguarded_registry_call_and_a_sync():
    src = ("def _dispatch(self):\n"
           "    _mon.get_registry().counter('x').inc()\n"
           "    if _mon.enabled():\n"
           "        _mon.get_registry().counter('y').inc()\n"
           "    self._relay()\n"
           "def _relay(self):\n"
           "    return self.tokens.cpu()\n")
    assert [v[1] for v in fastpath.check_source(src)] == [2, 2]
    found = fastpath._check_reachable(
        {"f.py": src}, {"_dispatch"}, set(), fastpath.SYNC_CALL_NAMES,
        lambda what, via: f"{what} via {via}")
    assert found == [("f.py", 7, ".cpu(...) via _relay")]
    assert fastpath._check_reachable(
        {"f.py": src}, {"_dispatch"}, {"_relay"}, fastpath.SYNC_CALL_NAMES,
        lambda what, via: what) == []


def test_coverage_rules():
    decl = {"A_SITE": "a.site", "B_SITE": "b.site", "C_SITE": "c.site",
            "D_SITE": "d.site"}
    used = {"A_SITE": ["x.py:1"], "B_SITE": ["x.py:2"], "D_SITE": ["x:3"]}
    pending = {"C_SITE": "A99", "D_SITE": "A98", "E_SITE": "A97"}
    tests = {"t.py": "fire(faults.A_SITE)"}
    out = _coverage.check(decl, used, pending, tests, "fault site")
    assert len(out) == 4
    assert "B_SITE" in out[0] and "no port test" in out[0]
    assert "D_SITE" in out[1] and "take it off" in out[1]
    assert "D_SITE" in out[2] and "no port test" in out[2]
    assert "E_SITE" in out[3] and "not declared" in out[3]
    unlisted = _coverage.check({"F_SITE": "f.site"}, {}, {}, tests, "x")
    assert len(unlisted) == 1 and "ROADMAP" in unlisted[0]


def test_the_fleet_sites_and_kinds_are_fired_and_covered():
    sites = _coverage.declared(fault_coverage.FAULTS_MODULE)
    fired = _coverage.used_at("fire", sites, fault_coverage.FAULTS_MODULE)
    assert {"ROUTER_DISPATCH", "REPLICA_RESTART"} <= set(fired)
    kinds = _coverage.declared(event_coverage.EVENTS_MODULE)
    emitted = _coverage.used_at("emit", kinds, event_coverage.EVENTS_MODULE)
    fleet_kinds = {"REPLICA_UNHEALTHY", "REPLICA_DRAINED",
                   "REPLICA_REPLACED", "REQUEST_FAILOVER"}
    assert fleet_kinds <= set(emitted)
    blob = "\n".join(_coverage.port_tests().values())
    for name in ("ROUTER_DISPATCH", "REPLICA_RESTART", *fleet_kinds):
        value = sites.get(name) or kinds[name]
        assert _coverage.covered(name, value, blob), name
    # every pending entry names the ROADMAP item that brings its code
    for pending in (fault_coverage.PENDING, event_coverage.PENDING):
        assert all(v.startswith("A") and ":" in v
                   for v in pending.values())


def test_lints_import_nothing_but_the_standard_library():
    for path in (REPO / "deeplearning4j_tpu_torch" / "lint").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n in ("__future__", "ast", "os", "re", "sys") \
                    or n.startswith("deeplearning4j_tpu_torch.lint"), \
                    (path.name, n)
