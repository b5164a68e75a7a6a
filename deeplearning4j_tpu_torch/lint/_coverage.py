"""The shared walk of the two coverage lints: declared names of a module,
the ones the port's code uses at a call, and the port tests' references.
"""
from __future__ import annotations

import ast
import os
import re

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
TESTS_DIR = os.path.join(REPO, "tests")

#: a site or kind value: lowercase dotted words ("cache.grow")
_VALUE_RE = re.compile(r"[a-z_]+(\.[a-z_]+)+")


def declared(path):
    """{CONSTANT: "dotted.value"} of the module-level declarations."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and _VALUE_RE.fullmatch(node.value.value)):
            out[node.targets[0].id] = node.value.value
    return out


def used_at(call_attr, names, skip):
    """{CONSTANT: ["file:line", ...]} of the `names` that appear in the
    arguments of a `.<call_attr>(...)` call in the port's modules (all but
    `skip`, the declaring module): the sites the port fires, or the kinds
    it emits."""
    out = {}
    for base, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            path = os.path.join(base, name)
            if not name.endswith(".py") or os.path.samefile(path, skip):
                continue
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == call_attr):
                    continue
                for arg in node.args:
                    for sub in ast.walk(arg):
                        ident = (sub.attr if isinstance(sub, ast.Attribute)
                                 else sub.id if isinstance(sub, ast.Name)
                                 else None)
                        if ident in names:
                            out.setdefault(ident, []).append(
                                f"{os.path.relpath(path, REPO)}:"
                                f"{sub.lineno}")
    return out


def port_tests(tests_dir=None):
    """{path: source} of the port's tests (`tests/test_torch_*.py`)."""
    tests_dir = tests_dir or TESTS_DIR
    out = {}
    for name in sorted(os.listdir(tests_dir)):
        if name.startswith("test_torch_") and name.endswith(".py"):
            path = os.path.join(tests_dir, name)
            with open(path) as f:
                out[path] = f.read()
    return out


def covered(name, value, blob):
    """A test references the constant (word-bounded) or its value."""
    return bool(re.search(rf"\b{re.escape(name)}\b", blob)) \
        or value in blob


def check(decl, used, pending, sources, what):
    """Violations: a used name no test covers; a pending (listed) name the
    port uses or does not declare; an unused name not listed."""
    blob = "\n".join(sources.values())
    out = []
    for name, value in sorted(decl.items()):
        if name in used:
            if name in pending:
                out.append(f"{name} ({value!r}): listed as pending "
                           f"({pending[name]}) but the port already "
                           f"uses it at {used[name][0]}: take it off the "
                           f"list")
            if not covered(name, value, blob):
                out.append(f"{name} ({value!r}): used at "
                           f"{used[name][0]}, but no port test "
                           f"(tests/test_torch_*.py) references this "
                           f"{what}")
        elif name not in pending:
            out.append(f"{name} ({value!r}): the port never uses this "
                       f"{what}; list it as pending with the ROADMAP "
                       f"item that brings its code")
    for name in sorted(set(pending) - set(decl)):
        out.append(f"{name}: listed as pending but not declared")
    return out
