"""Fault-site coverage lint of the port: the twin of
`scripts/check_fault_coverage.py`.

Every injection site declared in `resilience/faults.py` (a module-level
`UPPER_NAME = "dotted.site"`) that the port fires (named in the argument
of a `.fire(...)` call in any other module of the package) must be
referenced by a port test (`tests/test_torch_*.py`), by constant or by
site string. A declared site that the port does not fire yet stands in
`PENDING` beside the ROADMAP item that brings its firing code; a listed
site the port fires is a violation, so the list only shrinks.

Run:  python -m deeplearning4j_tpu_torch.lint.fault_coverage   (exit 1 on
a violation).
"""
from __future__ import annotations

import os
import sys

from deeplearning4j_tpu_torch.lint import _coverage

FAULTS_MODULE = os.path.join(_coverage.PACKAGE, "resilience", "faults.py")

#: declared sites the port does not fire yet -> the ROADMAP item
PENDING = {}


def main():
    decl = _coverage.declared(FAULTS_MODULE)
    used = _coverage.used_at("fire", decl, FAULTS_MODULE)
    out = _coverage.check(decl, used, PENDING, _coverage.port_tests(),
                          "fault site")
    for line in out:
        print(line)
    if out:
        print(f"\n{len(out)} fault-coverage violation(s)")
    return out


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
