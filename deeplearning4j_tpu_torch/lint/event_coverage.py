"""Event-kind coverage lint of the port: the twin of
`scripts/check_event_coverage.py`.

Every ops-event kind declared in `monitoring/events.py` (a module-level
`UPPER_NAME = "dotted.kind"`) that the port emits (named in the argument
of an `.emit(...)` call in any other module of the package) must be
referenced by a port test (`tests/test_torch_*.py`), by constant or by
kind string. A declared kind that the port does not emit yet stands in
`PENDING` beside the ROADMAP item that brings its emitting code; a listed
kind the port emits is a violation, so the list only shrinks.

Run:  python -m deeplearning4j_tpu_torch.lint.event_coverage   (exit 1 on
a violation).
"""
from __future__ import annotations

import os
import sys

from deeplearning4j_tpu_torch.lint import _coverage

EVENTS_MODULE = os.path.join(_coverage.PACKAGE, "monitoring", "events.py")

#: declared kinds the port does not emit yet -> the ROADMAP item
PENDING = {}


def main():
    decl = _coverage.declared(EVENTS_MODULE)
    used = _coverage.used_at("emit", decl, EVENTS_MODULE)
    out = _coverage.check(decl, used, PENDING, _coverage.port_tests(),
                          "event kind")
    for line in out:
        print(line)
    if out:
        print(f"\n{len(out)} event-coverage violation(s)")
    return out


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
