"""Drive the PyTorch/H100 port on one NVIDIA card, end to end.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --profile  # and phase 6

Phases, in order; any failure exits non-zero and prints no result:

1. card:    the `nvidia-smi` name and power limit.
2. build:   compile every kernel source (one nvcc each, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at
            the main path's shapes, in f32 and bf16, with its time, the
            plain version's time, one PyTorch library call's time (a
            yardstick only; the port never calls it) and the least time
            the card could take for the same work.
4. encoder: `bert_classify` at `bert_base()` width through the kernels,
            against `attn_impl="dense"` on the card.
5. serving: `GenerationServer(BertDecoder(bert_base(), params))` answers
            12 mixed requests with a cache-rung growth; its greedy streams
            must equal a second server's built with `attn_impl="dense"`.
6. profile (only with --profile): the serving workload once more under
            torch.profiler: the card's busy and idle share of the wall
            time, and device time by kernel group.

The kernels' launch counters are set to 0 just before the main path (the
encoder and the serving phases) and read just after. Every number is
measured in this run; the last lines are the kernel JSON object and the
`{"ok": true, "device": ...}` line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.generation import BertDecoder, GenerationServer
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    _decode_reference, _flash_forward_reference, flash_decode, flash_fwd)
from deeplearning4j_tpu_torch.models import (bert_base, bert_classify,
                                             init_bert_params)

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

#: published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.bfloat16: 989e12}    # bf16 tensor cores
#: kernel vs plain version: f32 sums run in another order; bf16 rounds
#: its output to 8 mantissa bits
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: the encoder phase's padding: ragged, every example non-empty
ENCODE_LENS = [128, 100, 64, 17, 128, 1, 90, 128]
#: the kernel-check case whose numbers stand for each kernel in the JSON
#: line: the shapes the serving path gives it
REPRESENTATIVE = {"flash_fwd": ("prefill P=128", "f32"),
                  "flash_decode": ("decode C=512", "f32")}

SOURCES = {
    "flash_fwd": ("deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu",
                  "deeplearning4j_tpu/kernels/flash_attention.py:42"),
    "flash_decode": ("deeplearning4j_tpu_torch/kernels/csrc/flash_decode.cu",
                     "deeplearning4j_tpu/kernels/flash_attention.py:42"),
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20):
    """Mean device time of one call, by CUDA events over `iters` calls
    after three warm-up calls. The stream first sleeps ~20 ms on the
    card, so the host queues every call before the first starts: the
    events read device time alone, without host-side launch gaps."""
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


def bound(flops, nbytes, dtype):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the dtype's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 ------------------------------------------------------------------
def phase_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    line = line.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


# -- phase 2 ------------------------------------------------------------------
def phase_build():
    res = _build.build_all(verbose=True)
    log(f"[build] {len(res['logs'])} kernels in {res['seconds']:.2f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(
        "\n".join(f"== {n}\n{t}" for n, t in res["logs"].items()))
    for name, text in res["logs"].items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build] {name}: {ln.strip()}")
    return res["seconds"]


# -- phase 3 ------------------------------------------------------------------
def _ragged_mask(lengths, t, dev):
    lens = torch.tensor(lengths, device=dev)
    return torch.arange(t, device=dev)[None, :] < lens[:, None]


def _fwd_case(label, b, h, tq, tk, d, causal, lengths, dtype, gen):
    dev = torch.device("cuda")
    q = torch.randn((b, h, tq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, h, tk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, h, tk, d), generator=gen, device=dev).to(dtype)
    mask = None if lengths is None else _ragged_mask(lengths, tk, dev)
    out, lse = flash_fwd(q, k, v, mask, causal)
    ref, ref_lse = _flash_forward_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if mask is None:
        vk = torch.full((b,), tk, device=dev)
    else:
        vk = mask.sum(1)
    # work this run's data needs: only valid (query, key) pairs; the
    # zeroed query rows of a padded self-attention example need none
    if causal:
        pairs = b * h * tq * (tq + 1) / 2
    elif tq == tk and mask is not None:
        pairs = h * float((vk.float() ** 2).sum())
    else:
        pairs = h * tq * float(vk.float().sum())
    flops = 4.0 * pairs * d
    esz = q.element_size()
    nbytes = (2 * b * h * tq * d * esz + 2 * h * float(vk.sum()) * d * esz
              + b * h * tq * 4 + (0 if mask is None else mask.numel()))
    bms, by = bound(flops, nbytes, dtype)
    ms = time_ms(lambda: flash_fwd(q, k, v, mask, causal))
    plain = time_ms(lambda: _flash_forward_reference(q, k, v, mask,
                                                        causal))
    am = None if mask is None else mask[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, is_causal=causal))
    return dict(name="flash_fwd", case=label, shape=[b, h, tq, tk, d],
                dtype=DTYPE_NAMES[dtype], causal=causal,
                max_abs_err=max(err, lse_err), out_err=err,
                lse_err=lse_err, atol=ATOL[dtype], ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def _decode_case(label, b, h, c, d, lengths, dtype, gen):
    dev = torch.device("cuda")
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, h, c, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, h, c, d), generator=gen, device=dev).to(dtype)
    mask = _ragged_mask(lengths, c, dev)
    out = flash_decode(q, k, v, mask)
    ref = _decode_reference(q, k, v, mask)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    empty = [i for i, n in enumerate(lengths) if n == 0]
    if empty and out[empty].abs().max().item() != 0:
        raise AssertionError(f"flash_decode {label}: empty rows not zero")
    valid = float(mask.sum())
    esz = q.element_size()
    flops = 4.0 * h * valid * d
    nbytes = 2 * b * h * d * esz + 2 * h * valid * d * esz + mask.numel()
    bms, by = bound(flops, nbytes, dtype)
    ms = time_ms(lambda: flash_decode(q, k, v, mask), iters=50)
    plain = time_ms(lambda: _decode_reference(q, k, v, mask), iters=50)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]), iters=50)
    return dict(name="flash_decode", case=label, shape=[b, h, c, d],
                dtype=DTYPE_NAMES[dtype], max_abs_err=err, atol=ATOL[dtype],
                ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    enc_lens = [512, 300, 128, 1, 0, 77, 450, 511]   # one fully padded
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(_fwd_case("encode", 8, 12, 512, 512, 64, False,
                              enc_lens, dtype, gen))
        rows.append(_fwd_case("encode T=128", 8, 12, 128, 128, 64, False,
                              ENCODE_LENS, dtype, gen))
        for p in (16, 128):
            rows.append(_fwd_case(f"prefill P={p}", 1, 12, p, p, 64, True,
                                  None, dtype, gen))
        rows.append(_fwd_case("cross Tq!=Tk", 2, 12, 100, 300, 64, False,
                              [300, 171], dtype, gen))
        for c in (128, 512):
            lens = [c, c // 2, 1, 0, 37, c - 1, 64, 100]  # one empty row
            rows.append(_decode_case(f"decode C={c}", 8, 12, c, 64, lens,
                                     dtype, gen))
    bad = []
    for r in rows:
        ok = r["max_abs_err"] <= r["atol"]
        lib = r["library_ms"]
        log(f"[kernels] {r['name']:<12} {r['case']:<14} "
            f"shape={r['shape']} {r['dtype']:<4} "
            f"max_abs_err={r['max_abs_err']:.3e} (atol {r['atol']:.0e}) "
            f"{'ok' if ok else 'FAIL'}  ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib:.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
        if not ok:
            bad.append(f"{r['name']} {r['case']} {r['dtype']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad}")
    return rows


# -- phase 4 ------------------------------------------------------------------
def _reset_counts():
    flash_fwd.launches = 0
    flash_decode.launches = 0


def _counts():
    return {"flash_fwd": flash_fwd.launches,
            "flash_decode": flash_decode.launches}


def phase_encoder(cfg, params):
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    b, t = 8, 128
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t)),
                          device=dev)
    mask = _ragged_mask(ENCODE_LENS, t, dev)
    bert_classify(cfg, params, ids, attn_mask=mask)      # warm
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    logits = bert_classify(cfg, params, ids, attn_mask=mask)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    dense = bert_classify(cfg, params, ids, attn_mask=mask,
                          attn_impl="dense")
    err = (logits - dense).abs().max().item()
    log(f"[encoder] bert_classify bert_base B={b} T={t} f32: "
        f"{wall:.2f} ms, flash_fwd launches {launches['flash_fwd']}, "
        f"max |flash - dense| = {err:.3e} (atol 1e-4)")
    if launches["flash_fwd"] != cfg.num_layers:
        raise AssertionError(f"encoder: flash_fwd launched "
                             f"{launches['flash_fwd']} times, expected "
                             f"{cfg.num_layers}")
    if not torch.isfinite(logits).all() or logits.shape != (b, 2):
        raise AssertionError(f"encoder: bad logits {logits.shape}")
    if err > 1e-4:
        raise AssertionError(f"encoder: flash vs dense differ by {err}")
    return {"wall_ms": wall, "max_abs_err": err, "launches": launches}


# -- phase 5 ------------------------------------------------------------------
SERVER = dict(slots=8, cache_lengths=[128, 512],
              prompt_buckets=[16, 32, 64, 128], superstep=4, seed=0)


def _requests(cfg):
    """12 requests: prompt lengths 5-120, 32-64 new tokens, greedy /
    temperature 0.8 / top-k 40 in turn; request 3 needs 120 + 64 rows, so
    its admission grows the cache from rung 128 to 512 mid-flight."""
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(12):
        plen = 120 if i == 3 else int(rng.integers(5, 121))
        new = 64 if i == 3 else int(rng.integers(32, 65))
        mode = ("greedy", "temperature", "top_k")[i % 3]
        reqs.append(dict(prompt=rng.integers(1, cfg.vocab_size, plen),
                         max_new_tokens=new, method=mode, temperature=0.8,
                         top_k=40 if mode == "top_k" else 0))
    assert any(len(r["prompt"]) + r["max_new_tokens"] > 128 for r in reqs)
    return reqs


def _serve(cfg, params, attn_impl, reqs):
    srv = GenerationServer(BertDecoder(cfg, params, attn_impl=attn_impl),
                           **SERVER)
    try:
        srv.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        handles = [srv.submit(**r) for r in reqs]
        streams = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        return streams, handles, wall, launches, srv.status()
    finally:
        srv.shutdown()


def phase_serving(cfg, params):
    reqs = _requests(cfg)
    streams, handles, wall, launches, st = _serve(cfg, params, "auto", reqs)
    ntok = sum(len(s) for s in streams)
    for r, s, h in zip(reqs, streams, handles):
        if len(s) != r["max_new_tokens"] or h.finish_reason != "length":
            raise AssertionError(f"serving: a request ended with "
                                 f"{len(s)} tokens ({h.finish_reason}), "
                                 f"expected {r['max_new_tokens']}")
        if any(not 0 <= tok < cfg.vocab_size for tok in s):
            raise AssertionError("serving: token id out of the vocab")
    if st["rung"] != 512:
        raise AssertionError(f"serving: no growth to rung 512 ({st})")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"serving: kernels never launched: {missing}")
    log(f"[serving] bert_base f32 slots=8 superstep=4: {len(reqs)} requests,"
        f" {ntok} tokens in {wall:.3f} s = {ntok / wall:.1f} tokens/s; "
        f"per-token p50 {st['per_token_p50_ms']:.3f} ms p99 "
        f"{st['per_token_p99_ms']:.3f} ms; {st['steps']} blocks, "
        f"{st['admissions']} admissions, rung {st['rung']}; launches "
        f"{launches}")
    dstreams, _, dwall, _, dst = _serve(cfg, params, "dense", reqs)
    greedy = [i for i, r in enumerate(reqs) if r["method"] == "greedy"]
    diff = [i for i in greedy if streams[i] != dstreams[i]]
    same_sampled = sum(streams[i] == dstreams[i] for i in range(len(reqs))
                       if i not in greedy)
    log(f"[serving] dense-attention server: {ntok / dwall:.1f} tokens/s; "
        f"greedy streams identical {len(greedy) - len(diff)}/{len(greedy)},"
        f" sampled identical {same_sampled}/{len(reqs) - len(greedy)}")
    if diff:
        raise AssertionError(f"serving: greedy streams {diff} differ from "
                             f"the dense-attention server")
    return {"requests": len(reqs), "tokens": ntok, "wall_s": wall,
            "tokens_per_s": ntok / wall,
            "per_token_p50_ms": st["per_token_p50_ms"],
            "per_token_p99_ms": st["per_token_p99_ms"],
            "blocks": st["steps"], "admissions": st["admissions"],
            "launches": launches, "dense_tokens_per_s": ntok / dwall,
            "dense_per_token_p50_ms": dst["per_token_p50_ms"],
            "sampled_identical": same_sampled}


# -- phase 6 (--profile) ------------------------------------------------------
#: kernel-name substrings -> the part of the decode step they belong to
KERNEL_GROUPS = (("flash_fwd_kernel", "flash_fwd"),
                 ("flash_decode_kernel", "flash_decode"),
                 ("gemm", "matmul"), ("gemv", "matmul"),
                 ("cutlass", "matmul"), ("sort", "sort (top-k)"),
                 ("reduce", "reductions"), ("index", "gather/scatter"),
                 ("elementwise", "elementwise"))


def _busy_us(spans):
    """Length of the union of [start, end) spans: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def phase_profile(cfg, params):
    """The serving phase's workload once more, under torch.profiler: the
    card's busy and idle share of the wall time, and device time by
    kernel group and by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = _requests(cfg)
    srv = GenerationServer(BertDecoder(cfg, params), **SERVER)
    try:
        srv.warmup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for h in [srv.submit(**r) for r in reqs]:
                h.result(timeout=600)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        st = srv.status()
    finally:
        srv.shutdown()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log("[profile] torch.profiler recorded no device kernels: "
            "device time not measured")
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in kern]
    busy = _busy_us(spans)
    by_name, by_group = {}, {}
    for e in kern:
        dur = e.time_range.elapsed_us()
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
        low = e.name.lower()
        group = next((g for sub, g in KERNEL_GROUPS if sub in low), "other")
        n, t = by_group.get(group, (0, 0.0))
        by_group[group] = (n + 1, t + dur)
    steps = st["steps"] * srv.superstep
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us, "kernels": len(kern),
           "decode_steps": steps, "admissions": st["admissions"],
           "kernels_per_decode_step": len(kern) / steps,
           "groups": {g: {"count": n, "ms": t / 1e3}
                      for g, (n, t) in sorted(by_group.items(),
                                              key=lambda kv: -kv[1][1])},
           "top": [{"name": n[:120], "count": c, "ms": t / 1e3}
                   for n, (c, t) in top]}
    log(f"[profile] serving under torch.profiler: wall {out['wall_ms']:.1f}"
        f" ms, card busy {out['device_busy_ms']:.1f} ms, idle share "
        f"{out['idle_share']:.4f}; {len(kern)} kernels over {steps} decode "
        f"steps + {st['admissions']} prefills "
        f"({out['kernels_per_decode_step']:.1f} per step)")
    for g, d in out["groups"].items():
        log(f"[profile]   {g:<16} {d['count']:>7} kernels "
            f"{d['ms']:>10.3f} ms")
    return out


def kernel_line(rows, launches):
    """The per-kernel JSON object: each kernel's numbers at its
    representative case, its launches from the serving run, and its
    largest error over every checked case of the same dtype."""
    out = []
    for name, (case, dt) in REPRESENTATIVE.items():
        r = next(x for x in rows
                 if x["name"] == name and x["case"] == case
                 and x["dtype"] == dt)
        err = max(x["max_abs_err"] for x in rows
                  if x["name"] == name and x["dtype"] == dt)
        src, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "case": case,
                    "shape": r["shape"], "dtype": dt, "atol": r["atol"]})
    return {"kernels": out}


# -- main ---------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="stop after the kernel checks (bring-up runs)")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving phase, profile the same "
                         "workload (card busy/idle share, kernel time)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    rows = phase_kernels()
    OUT_DIR.mkdir(exist_ok=True)
    if args.only == "kernels":
        (OUT_DIR / "smoke_kernels.json").write_text(json.dumps(rows,
                                                               indent=1))
        return 0
    cfg = bert_base()
    t1 = time.perf_counter()
    params = init_bert_params(cfg, seed=0)
    log(f"[params] bert_base random from seed 0: "
        f"{time.perf_counter() - t1:.1f} s")
    encoder = phase_encoder(cfg, params)
    serving = phase_serving(cfg, params)
    prof = phase_profile(cfg, params) if args.profile else None
    line = kernel_line(rows, serving["launches"])
    (OUT_DIR / "smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": rows,
         "encoder": encoder, "serving": serving, "profile": prof,
         "line": line, "seconds": time.perf_counter() - t0}, indent=1))
    log(f"[smoke] {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
