"""The flash kernels' times at the serving and training paths' shapes, for
comparing two versions of the kernels on one card.

    python3 deeplearning4j_tpu_torch/kernels/flash_ab.py TREE build
    python3 deeplearning4j_tpu_torch/kernels/flash_ab.py TREE time

TREE is the root of a checkout whose `deeplearning4j_tpu_torch` is imported
(another commit unpacked with `git archive`, or `.`). `build` builds its
flash libraries (one nvcc each, in parallel); `time` prints one line
`AB <TREE> <json>` of {case: ms} by CUDA events (50 calls after 3, the
host queued ahead): flash_fwd, flash_bwd_dq and flash_bwd_dkv at BERT's
prefill, fine-tune and encode shapes, the attention layers' D = 128 and
the wide head dims (DL4J's one-head layers at D = 256, their learned
queries at Tq = 4, the wide layer at D = 512, and D = 1024),
flash_decode at C = 128 and 512, f32 and bf16. Run the two trees in turns
in one call (A, B, B, A) and compare within it. Needs a CUDA card.
"""
from __future__ import annotations

import importlib
import json
import sys


def _ms(fn, iters=50):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: (label, (B, H, Tq, Tk, D), key lengths or None, causal)
SHAPES = (("prefill P=128", (1, 12, 128, 128, 64), None, True),
          ("train B=32 T=128", (32, 12, 128, 128, 64),
           [128 - 2 * i for i in range(32)], False),
          ("encode", (8, 12, 512, 512, 64),
           [512, 300, 128, 1, 0, 77, 450, 511], False),
          ("attn D=128", (16, 4, 512, 512, 128),
           [512 - 31 * i for i in range(16)], False),
          ("attn D=256", (32, 1, 512, 512, 256),
           [512 - 13 * i for i in range(32)], False),
          ("learned Tq=4 D=256", (32, 1, 4, 512, 256),
           [512 - 13 * i for i in range(32)], False),
          ("attn D=512", (16, 1, 512, 512, 512),
           [512 - 31 * i for i in range(16)], False),
          ("D=1024", (1, 1, 128, 128, 1024), None, False))


def time_flash():
    import torch
    tfa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def mask(lens, t):
        return torch.arange(t, device=dev)[None] < torch.tensor(
            lens, device=dev)[:, None]

    res = {}
    for dt in (torch.float32, torch.bfloat16):
        for label, (b, h, tq, tk, d), lens, causal in SHAPES:
            q, k, v, go = (torch.randn((b, h, t, d), generator=g,
                                       device=dev).to(dt)
                           for t in (tq, tk, tk, tq))
            m = None if lens is None else mask(lens, tk)
            o, lse = tfa._flash_forward(q, k, v, m if tq == tk else None, m,
                                        causal)
            args = (q, k, v, go, lse, tfa._delta(go, o), m, causal)
            res[f"fwd {label} {dt}"] = _ms(
                lambda: tfa.flash_fwd(q, k, v, m, causal))
            res[f"dq {label} {dt}"] = _ms(lambda: tfa.flash_bwd_dq(*args))
            res[f"dkv {label} {dt}"] = _ms(lambda: tfa.flash_bwd_dkv(*args))
        for c in (128, 512):
            q = torch.randn((8, 12, 1, 64), generator=g, device=dev).to(dt)
            k, v = (torch.randn((8, 12, c, 64), generator=g,
                                device=dev).to(dt) for _ in range(2))
            m = mask([c, c // 2, 1, 0, 37, c - 1, 64, 100], c)
            res[f"decode C={c} {dt}"] = _ms(
                lambda: tfa.flash_decode(q, k, v, m))
    return res


def build_flash():
    from deeplearning4j_tpu_torch.kernels import _build
    names = [n for n in _build.kernel_names() if n.startswith("flash")]
    jobs = {n: _build._start(n, ()) for n in names}
    for name, (out, job) in jobs.items():
        _build._finish(name, out, job)
    return names


if __name__ == "__main__":
    tree, what = sys.argv[1], sys.argv[2]
    sys.path.insert(0, tree)
    if what == "build":
        print(tree, "built", build_flash())
    else:
        print("AB", tree, json.dumps(time_flash()))
