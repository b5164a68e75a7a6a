"""The rank side of tests/test_torch_examples.py: `spawn(world, names,
directory)` starts `world` gloo ranks over a FileStore in `directory`;
every rank runs `main(device="cpu")` of each named example twin and
pickles what it returns (or the traceback) to `directory`. Imports no
JAX: a spawned child re-imports this module."""
from __future__ import annotations

import contextlib
import datetime
import importlib
import io
import os
import pickle
import traceback

TIMEOUT_S = 120


def _rank_main(rank, world, store_path, out_dir, names):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        for name in names:
            mod = importlib.import_module(
                f"deeplearning4j_tpu_torch.examples.{name}")
            printed = io.StringIO()
            try:
                with contextlib.redirect_stdout(printed):
                    res = {"ok": mod.main(device="cpu")}
            except Exception:   # the twin's test reports it
                res = {"error": traceback.format_exc()}
            res["printed"] = printed.getvalue()
            with open(os.path.join(out_dir, f"{name}.{rank}.pkl"),
                      "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(world, names, directory):
    """{name: [each rank's {"ok": facts, "printed": ...} or {"error":
    traceback}]}."""
    import torch.multiprocessing as mp
    directory = str(directory)
    mp.spawn(_rank_main, args=(world, os.path.join(directory, "store"),
                               directory, list(names)),
             nprocs=world, join=True)
    out = {}
    for name in names:
        out[name] = []
        for r in range(world):
            with open(os.path.join(directory, f"{name}.{r}.pkl"), "rb") as f:
                out[name].append(pickle.load(f))
    return out
