"""Memory workspaces (≡ libnd4j MemoryWorkspace / nd4j WorkspaceConfiguration):
the port of `deeplearning4j_tpu/runtime/workspace.py`.

The reference's workspaces exist to reuse device scratch between iterations
without GC pressure. In the port that job is done on the device by the
training step writing parameters, optimizer and BN state in place and by
the CUDA graphs' memory pools. What remains host-side is batch staging,
covered by runtime.native_lib.NativeArena.

This module keeps the reference's API shape so user code ports cleanly:
`with Nd4jWorkspace("WS"): ...` scopes a host staging arena, and
WorkspaceConfiguration maps its knobs onto arena sizing.
"""
from __future__ import annotations

import numpy as np


class WorkspaceConfiguration:
    def __init__(self, initialSize=64 << 20, policyAllocation="strict",
                 policyLearning="first_loop"):
        self.initialSize = int(initialSize)
        self.policyAllocation = policyAllocation
        self.policyLearning = policyLearning


class Nd4jWorkspace:
    """Host staging workspace: float32 scratch from a native bump arena,
    reset on scope exit (device side: nothing to do)."""

    def __init__(self, id="WS", configuration=None):
        from deeplearning4j_tpu_torch.runtime.native_lib import (NativeArena,
                                                               available)
        self.id = id
        conf = configuration or WorkspaceConfiguration()
        self._arena = None
        if available():
            try:
                self._arena = NativeArena(conf.initialSize)
            except RuntimeError:
                self._arena = None

    def alloc(self, shape, dtype=np.float32):
        if self._arena is not None and np.dtype(dtype) == np.float32:
            return self._arena.alloc_f32(shape)
        return np.empty(shape, dtype)

    def reset(self):
        if self._arena is not None:
            self._arena.reset()

    def bytes_used(self):
        return self._arena.used() if self._arena is not None else 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.reset()
        return False

    def close(self):
        if self._arena is not None:
            self._arena.close()
            self._arena = None
