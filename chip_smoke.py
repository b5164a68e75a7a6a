"""Drive the PyTorch/H100 port on one NVIDIA card, end to end.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --only resnet   # card, build, kernels, resnet,
                                          # resnet_train
    python3 chip_smoke.py --only graphs   # card, build, graphs
    python3 chip_smoke.py --only paged    # card, build, paged
    python3 chip_smoke.py --only chaos    # card, build, chaos
    python3 chip_smoke.py --profile  # and phase 12

Phases, in order; any failure exits non-zero and prints no result:

1. card:    the `nvidia-smi` name and power limit.
2. build:   compile every kernel source (one nvcc each, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at
            the main paths' shapes, in f32 and bf16, with its time, the
            plain version's time, one PyTorch library call's time (a
            yardstick only; the port never calls it) and the least time
            the card could take for the same work. The backward pair and
            the decode kernel are also re-run and must agree bit for bit
            (each decode call is one launch, its cluster size logged);
            the int8 epilogue's int32 sums must be exact at four shapes
            (its tile logged); the bottleneck block runs ResNet-50's four
            identity stages, re-run for bit identity, its plan (R rows a
            block, P pixels, blocks, L2 weight bytes) logged.
            bn_conv_grads also runs the 15
            shapes of a ResNet-50 training step's 36 conv1x1+BN pairs
            (`step36`): kernel and library ms summed over the pairs
            beside the step's bound. matmul_epilogue and matmul_stats run
            the same 15 shapes (the 36 pairs of one ResNet-50 forward,
            `fwd36`) in f32 and bf16, summed the same way beside the sum of
            their bounds on the tensor-core route. `bert_step12` sums the BERT
            fine-tune step's 12 layers of flash_fwd, flash_bwd_dq and
            flash_bwd_dkv against 12 SDPA forwards and backwards.
4. encoder: `bert_classify` at `bert_base()` width through the kernels,
            against `attn_impl="dense"` on the card.
5. serving: `GenerationServer(BertDecoder(bert_base(), params))` answers
            12 mixed requests with a cache-rung growth; its greedy streams
            must equal a second server's built with `attn_impl="dense"`.
6. train:   `bert_base()` fine-tuning as bench.py builds it (B=32, T=128,
            ragged padding, dropout 0.1, `classification_loss`, backward,
            Adam 2e-5): 2 warm-up and 10 timed steps, each launching
            flash_fwd, flash_bwd_dq and flash_bwd_dkv 12 times; one
            step's gradients through the kernels against
            `attn_impl="dense"`; and 10 steps on one batch whose loss
            must fall.
7. resnet:  `ResNet50()` at 224×224×3, 1000 classes, f32, built once
            with the conv1x1+BN fusion on and once with it off, from one
            seed, with BN statistics and γ/β drawn from a seeded
            generator. ≥ 96 images, as requests of 1–8 rows from 8
            threads, through `ParallelInference(BATCHED, batchLimit=32)`
            over the fused net: every answer must equal the unfused net's
            output for the same rows, each forward must launch
            matmul_epilogue exactly 36 times; the avgpool features of the
            two nets must agree; one B=32 forward timed fused and unfused;
            and `bottleneck_block`, on res4_1's folded weights and the
            fused net's res4_0_relu activation, must give its res4_1_relu.
8. resnet_train: `ResNet50()` at 224×224×3, 1000 classes, f32, fused and
            unfused from one seed, trained through `ComputationGraph.fit`
            with the zoo's Nesterovs at a rate of 0.01. One step on one
            seeded batch of 32 in both nets and in the unfused net in f64:
            each gradient of the fused net must be as close to the f64
            one as the unfused f32 net's (RESNET_GRAD_FACTOR), and the new
            BN running statistics must equal the unfused net's. Then 2
            warm-up and 10 timed fused steps on that
            batch, each launching matmul_stats, bn_grad_stats and
            bn_conv_grads 36 times; the loss must fall.
9. graphs:  the executable store's three capture targets, each against
            its eager run in turns (eager, graph, graph, eager):
            BERT serving as in phase 5 (every stream equal to the eager
            server's, greedy and sampled; a second store on the same
            directory warms with every key `from_disk` and no nvcc run);
            ResNet-50 training at B=32 (parameters, optimizer and BN state
            and loss bit-identical to eager steps after 3 steps, with
            cuDNN's deterministic algorithms; 10 timed steps per arm, each
            of eager and graph with prefetch 0 and 2, in mirrored turns);
            ResNet-50 through `ParallelInference` with
            `bucketLadder([1, 2, 4, 8, 16, 32])` (each bucket's replay
            bit-identical to the eager forward of its rows, the 96 images
            equal to `net.output`, one B=32 forward timed both ways, and a
            store given no signature warming every bucket from the
            manifest). No capture after warmup, no eager call or
            degradation in a graph store, and launch counters that count
            replays.
10. paged: `bert_base()` served from a page pool (`page_size=16`,
            `pool_pages=129`: half the dense worst case) with phase 5's
            knobs, on 12 requests of which six share a 64-token system
            prompt and two are identical (one growth to rung 512). Six
            servers in turns, each through its graphs: dense fp (the
            control), paged fp, dense int8, paged int8, paged fp with
            `draft=2`, dense fp again. Gates: paged fp streams equal the
            dense fp ones and paged int8 the dense int8 ones (all, greedy
            and sampled); the drafted greedy streams equal the undrafted
            ones with drafts accepted; the paged pool counts >= 5 prefix
            hits, >= 1 copy-on-write and no page mapped at the end;
            flash_fwd and flash_decode launch in the paged fp run; every
            store serves with no live capture, eager call or degradation;
            each server fetches once per block plus once per admission. A
            pool of 3 pages refuses a 3-page prompt with
            `PagePoolExhaustedError` and then serves a 1-page one. Printed,
            not gated: tokens/s and per-token p50/p99 of each server; the
            int8 decode's logit error against fp over 16 steps; the pool's
            bytes against the dense caches'; the card time of the page
            gather, the int8 and the multi-query attention beside
            flash_decode.
11. chaos:  phase 5's server (graphed, f32) and 12 requests under injected
            faults. Fault-free first, monitoring off, on, on, off in
            turns, twice (tokens/s each; every run's streams equal).
            Then:
            two block kills (`generation.superstep`) and one admission
            kill (`generation.admit`): streams equal the fault-free run's,
            the replay modes, the ms from each fault to the next
            delivered token, the largest |Δlogit| between the decode
            path and the replay's prefill at each prefix replay point,
            flash_fwd and flash_decode launched; a `cache.page` kill on
            the paged server (streams equal, no page mapped at the end);
            an OOM-shaped fault at the growth to rung 512 (that request
            refused with `MemoryPressureError`, the rest served, relief
            back to serving); `memory_high_water` just under the
            `mem_get_info` reading after the warm-up (growth refused by
            the telemetry); and a restart budget that runs out
            (`ServerDeadError`, every consumer released within 1 s). No
            capture, rebind, degradation or eager call after a warm-up;
            every fetch a block, an admission or a replay. One JSON line
            per case.
12. profile (only with --profile): the serving workload, one fused B=32
            ResNet-50 forward and three fused ResNet-50 training steps,
            each eager and through its graphs (training: eager and graph
            with prefetch 0, graph with prefetch 2), the paged server's
            workload through its graphs, and three fine-tune steps,
            once more under torch.profiler: the card's busy and idle share
            of the wall time, and device time by kernel group.

Phases 5, 7 and 8 run as a user runs them: the server and `fit` replay
CUDA graphs on the card by default. The kernels' launch counters are set
to 0 just before each main path (the encoder, serving, the timed training
steps, ResNet serving, the timed ResNet training steps, each arm of the
graphs phase and each server of the chaos phase) and read just after; a
replay adds the launches its capture recorded. Every number is measured
in this run; the last lines are the kernel JSON object and the
`{"ok": true, "device": ...}` line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.generation import BertDecoder, GenerationServer
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels.flash_attention import (
    _decode_reference, _delta, _dkv_reference, _dq_reference,
    _flash_forward, _flash_forward_reference, decode_cluster_size,
    flash_attention_decode, flash_attention_decode_mq,
    flash_attention_decode_paged, flash_bwd_dkv, flash_bwd_dq, flash_decode,
    flash_fwd, gather_kv_pages)
from deeplearning4j_tpu_torch.models import (bert_base, bert_classify,
                                             bert_encode, bert_mlm_logits,
                                             classification_loss,
                                             init_bert_params, param_leaves)
from deeplearning4j_tpu_torch.kernels.layernorm import (
    _layernorm_reference, fused_layernorm)
from deeplearning4j_tpu_torch.kernels.pointwise_conv import (
    _bn_conv_grads_reference, _bn_dy, _bn_grad_stats_reference,
    _epilogue_reference, _fwd_tile, _matmul_stats_reference, bn_conv_grads,
    bn_grad_stats, int8_matmul_epilogue, matmul_epilogue, matmul_stats)
from deeplearning4j_tpu_torch.kernels.residual_block import (
    _plan as _block_plan_of, bottleneck_block, bottleneck_block_xla)
from deeplearning4j_tpu_torch.models.convert import named_param_leaves
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.nn import Nesterovs
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)
from deeplearning4j_tpu_torch.quantize import cache_page_bytes, quantize_rows
from deeplearning4j_tpu_torch import monitoring as mon
from deeplearning4j_tpu_torch.monitoring import events as ev
from deeplearning4j_tpu_torch.monitoring import memory as _mem
from deeplearning4j_tpu_torch.resilience import faults
from deeplearning4j_tpu_torch.resilience.errors import (
    MemoryPressureError, PagePoolExhaustedError, ServerDeadError)
from deeplearning4j_tpu_torch.resilience.policy import RetryPolicy
from deeplearning4j_tpu_torch.runtime.executables import (ExecutableStore,
                                                          tensor_leaves)

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
#: the card; a rehearsal of a phase on the CPU sets "cpu" (the kernel
#: wrappers then run their plain versions)
DEV = "cuda"

#: published H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12,      # f32 outside the tensor cores
              torch.bfloat16: 989e12,    # bf16 tensor cores
              torch.int8: 1979e12}       # int8 tensor cores (TOP/s)
#: TF32 tensor cores: bn_conv_grads, the forward GEMMs and the flash
#: kernels but decode take f32 through them as 3×TF32, three TF32 products
#: for each f32 product
PEAK_TF32 = 495e12
#: the flash kernels whose f32 route is 3×TF32 on the tensor cores
#: (flash_decode runs f32 FMA)
TF32_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: kernel vs plain version: f32 sums run in another order; bf16 rounds
#: its output to 8 mantissa bits. Gradients, the epilogue GEMM and the
#: bottleneck block are held to the same atol scaled by
#: max(1, max |plain|): their size grows with the sums they take. int8:
#: the int32 sums must be bit-exact, the f32 epilogue within INT8_RTOL
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
INT8_RTOL = 1e-5
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8"}

#: the encoder phase's padding: ragged, every example non-empty
ENCODE_LENS = [128, 100, 64, 17, 128, 1, 90, 128]
#: the kernel-check case whose numbers stand for each kernel in the JSON
#: line: the shapes the serving path gives it
REPRESENTATIVE = {"flash_fwd": ("prefill P=128", "f32"),
                  "flash_decode": ("decode C=512", "f32"),
                  "flash_bwd_dq": ("train B=32 T=128", "f32"),
                  "flash_bwd_dkv": ("train B=32 T=128", "f32"),
                  "matmul_epilogue": ("res2_c B=32", "f32"),
                  "int8_matmul_epilogue": ("res4_a B=32", "int8"),
                  "bottleneck_block": ("res4 B=32", "f32"),
                  "matmul_stats": ("res2_c B=32", "f32"),
                  "bn_grad_stats": ("res2_c B=32", "f32"),
                  "bn_conv_grads": ("res2_c B=32", "f32"),
                  "fused_layernorm": ("bert_base 4096x768", "f32")}

SOURCES = {
    "flash_fwd": ("deeplearning4j_tpu_torch/kernels/csrc/flash_fwd.cu",
                  "deeplearning4j_tpu/kernels/flash_attention.py:42"),
    "flash_decode": ("deeplearning4j_tpu_torch/kernels/csrc/flash_decode.cu",
                     "deeplearning4j_tpu/kernels/flash_attention.py:42"),
    "flash_bwd_dq": ("deeplearning4j_tpu_torch/kernels/csrc/flash_bwd_dq.cu",
                     "deeplearning4j_tpu/kernels/flash_attention.py:232"),
    "flash_bwd_dkv": (
        "deeplearning4j_tpu_torch/kernels/csrc/flash_bwd_dkv.cu",
        "deeplearning4j_tpu/kernels/flash_attention.py:272"),
    "matmul_epilogue": (
        "deeplearning4j_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:116"),
    "int8_matmul_epilogue": (
        "deeplearning4j_tpu_torch/kernels/csrc/matmul_epilogue.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:116"),
    "bottleneck_block": (
        "deeplearning4j_tpu_torch/kernels/csrc/bottleneck_block.cu",
        "deeplearning4j_tpu/kernels/residual_block.py:38"),
    "matmul_stats": ("deeplearning4j_tpu_torch/kernels/csrc/matmul_stats.cu",
                     "deeplearning4j_tpu/kernels/pointwise_conv.py:47"),
    "bn_grad_stats": (
        "deeplearning4j_tpu_torch/kernels/csrc/bn_grad_stats.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:206"),
    "bn_conv_grads": (
        "deeplearning4j_tpu_torch/kernels/csrc/bn_conv_grads.cu",
        "deeplearning4j_tpu/kernels/pointwise_conv.py:262"),
    "fused_layernorm": ("deeplearning4j_tpu_torch/kernels/csrc/layernorm.cu",
                        "deeplearning4j_tpu/kernels/layernorm.py:21"),
}
#: flops per valid (query, key) pair: the forward's two products, the dQ
#: kernel's three (S, dO·Vᵀ, dS·K), the dK/dV kernel's four
FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


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


def bound(flops, nbytes, dtype, peak=None):
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the dtype's peak (or
    `peak`, for a kernel whose route runs at another rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
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
        for fn, regs, spills in _ptxas_report(text):
            log(f"[build] {name}: {fn}: {regs}; {spills}")
    return res["seconds"]


def _ptxas_report(text):
    """(kernel, registers line, spill line) per instantiation in nvcc's
    `-Xptxas -v` output, the kernel's name demangled where c++filt exists
    and cut to the name and its template arguments."""
    out, fn, spills = [], "?", ""
    for ln in text.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill" in ln:
            spills = ln
        elif "registers" in ln:
            out.append([fn, ln.split(":", 1)[-1].strip(), spills])
    if out and shutil.which("c++filt"):
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in out),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        for r, full in zip(out, names):
            m = re.search(r"(\w+(?:<[^()]*>)?)\(", full)
            r[0] = m.group(1) if m else full
    return out


# -- phase 3 ------------------------------------------------------------------
def _ragged_mask(lengths, t, dev):
    lens = torch.tensor(lengths, device=dev)
    return torch.arange(t, device=dev)[None, :] < lens[:, None]


def _randn(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _work(name, b, h, tq, tk, d, causal, mask, esz):
    """(flops, bytes) that this run's data needs: only valid (query, key)
    pairs — the zeroed query rows of a padded self-attention example need
    none — and each input read once, each output written once in full.
    K and V rows that the key mask removes are not read; in self-attention
    neither are the q, dO, lse and Δ rows of padded queries (their P is
    exactly 0)."""
    vk = (torch.full((b,), tk) if mask is None else mask.sum(1)).float()
    self_masked = tq == tk and mask is not None and not causal
    if causal:
        pairs = b * h * tq * (tq + 1) / 2
    elif self_masked:
        pairs = h * float((vk ** 2).sum())
    else:
        pairs = h * tq * float(vk.sum())
    flops = FLOPS_PER_PAIR[name] * pairs * d
    vq = h * float(vk.sum()) if self_masked else b * h * tq  # valid q rows
    q_in = vq * d * esz                      # the valid rows of q or dO
    q_out = b * h * tq * d * esz             # one whole (B, H, Tq, D)
    kv_rows = h * float(vk.sum()) * d * esz  # the valid rows of K or V
    masks = 0 if mask is None else mask.numel()
    if name == "flash_fwd":                  # q, k, v -> o, lse
        nbytes = q_in + q_out + 2 * kv_rows + b * h * tq * 4 + masks
    elif name == "flash_bwd_dq":             # q, k, v, dO, lse, Δ -> dq
        nbytes = 2 * q_in + q_out + 2 * kv_rows + 2 * vq * 4 + masks
    else:                                    # the same -> dk, dv
        nbytes = (2 * q_in + 2 * kv_rows + 2 * vq * 4 + masks
                  + 2 * b * h * tk * d * esz)
    return flops, nbytes


def _flash_bound(name, b, h, tq, tk, d, causal, mask, dtype):
    """The least time of a flash kernel on its route: f32 through 3×TF32
    (three TF32 operations per f32 operation at the TF32 rate) where the
    kernel takes that route, else the dtype's own rate."""
    flops, nbytes = _work(name, b, h, tq, tk, d, causal, mask,
                          torch.finfo(dtype).bits // 8)
    if dtype == torch.float32 and name in TF32_FLASH:
        return bound(3 * flops, nbytes, dtype, PEAK_TF32)
    return bound(flops, nbytes, dtype)


def _fwd_case(label, b, h, tq, tk, d, causal, lengths, dtype, gen):
    dev = torch.device(DEV)
    q = _randn(gen, dtype, b, h, tq, d)
    k = _randn(gen, dtype, b, h, tk, d)
    v = _randn(gen, dtype, b, h, tk, d)
    mask = None if lengths is None else _ragged_mask(lengths, tk, dev)
    out, lse = flash_fwd(q, k, v, mask, causal)
    again = flash_fwd(q, k, v, mask, causal)
    ref, ref_lse = _flash_forward_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    identical = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    bms, by = _flash_bound("flash_fwd", b, h, tq, tk, d, causal, mask, dtype)
    ms = time_ms(lambda: flash_fwd(q, k, v, mask, causal))
    plain = time_ms(lambda: _flash_forward_reference(q, k, v, mask,
                                                        causal))
    am = None if mask is None else mask[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, is_causal=causal))
    return dict(name="flash_fwd", case=label, shape=[b, h, tq, tk, d],
                dtype=DTYPE_NAMES[dtype], causal=causal,
                max_abs_err=max(err, lse_err), out_err=err,
                lse_err=lse_err, atol=ATOL[dtype], bit_identical=identical,
                ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by)


def _decode_case(label, b, h, c, d, lengths, dtype, gen):
    dev = torch.device(DEV)
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, h, c, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, h, c, d), generator=gen, device=dev).to(dtype)
    mask = _ragged_mask(lengths, c, dev)
    on_card = dev.type == "cuda"   # a CPU rehearsal runs the plain version
    before = flash_decode.launches
    out = flash_decode(q, k, v, mask)
    if on_card and flash_decode.launches - before != 1:
        raise AssertionError(f"flash_decode {label}: "
                             f"{flash_decode.launches - before} launches "
                             "for one call")
    again = flash_decode(q, k, v, mask)
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
                bit_identical=torch.equal(out, again),
                cluster=(decode_cluster_size(b, h, c, d, dtype, dev)
                         if on_card else None),
                ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


def _sdpa_backward_ms(q, k, v, g, mask, causal):
    """The yardstick of the backward pair: one backward of
    `F.scaled_dot_product_attention` at the same shape and mask (dQ, dK and
    dV together), timed alone on a retained graph."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    am = None if mask is None else mask[:, None, None, :]
    out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=am,
                                         is_causal=causal)
    return time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), g,
                                               retain_graph=True))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _bwd_cases(label, b, h, tq, tk, d, causal, lengths, dtype, gen):
    """Both backward kernels on one input: each against its plain version,
    re-run for bit identity, timed beside its plain version, the SDPA
    backward and its bound. Self-attention cases (`lengths` and Tq == Tk)
    mask queries and keys alike, as BERT does; the cross case masks keys
    only."""
    dev = torch.device(DEV)
    q = _randn(gen, dtype, b, h, tq, d)
    k = _randn(gen, dtype, b, h, tk, d)
    v = _randn(gen, dtype, b, h, tk, d)
    g = _randn(gen, dtype, b, h, tq, d)
    mask = None if lengths is None else _ragged_mask(lengths, tk, dev)
    qmask = mask if tq == tk else None
    o, lse = _flash_forward(q, k, v, qmask, mask, causal)
    args = (q, k, v, g, lse, _delta(g, o), mask, causal)
    # the plain versions in f64 on the same inputs: how far the kernels are
    # from exact, a yardstick that does not share the f32 plain version's
    # rounding (the two can agree bit for bit)
    args64 = tuple(t.double() if torch.is_tensor(t) and t.is_floating_point()
                   else t for t in args)
    lib = _sdpa_backward_ms(q, k, v, g, mask, causal)
    rows = []
    for name, kernel, plain in (("flash_bwd_dq", flash_bwd_dq, _dq_reference),
                                ("flash_bwd_dkv", flash_bwd_dkv,
                                 _dkv_reference)):
        got, again = _as_tuple(kernel(*args)), _as_tuple(kernel(*args))
        want = _as_tuple(plain(*args))
        exact = _as_tuple(plain(*args64))
        torch.cuda.synchronize()
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(got, want))
        f64_err = max((a.double() - w).abs().max().item()
                      for a, w in zip(got, exact))
        del exact
        scale = max([1.0] + [w.float().abs().max().item() for w in want])
        identical = all(torch.equal(a, c) for a, c in zip(got, again))
        padded = [i for i, n in enumerate(lengths or []) if n == 0]
        leak = any(a[i].abs().max().item() != 0 for a in got for i in padded)
        bms, by = _flash_bound(name, b, h, tq, tk, d, causal, mask, dtype)
        rows.append(dict(
            name=name, case=label, shape=[b, h, tq, tk, d],
            dtype=DTYPE_NAMES[dtype], causal=causal, max_abs_err=err,
            atol=ATOL[dtype] * scale, f64_err=f64_err,
            bit_identical=identical,
            padded_example_zero=not leak, ms=time_ms(lambda: kernel(*args)),
            plain_ms=time_ms(lambda: plain(*args)), library_ms=lib,
            bound_ms=bms, bound_by=by))
    return rows


#: the 1×1 convs whose shapes the epilogue GEMM is checked at, ResNet-50
#: at 224×224 and B=32: (M = B·H·W, K, N), and one ragged M (and K) with
#: a residual and relu
EPILOGUE_SHAPES = {"res2_c B=32": (32 * 56 * 56, 64, 256),
                   "res4_a B=32": (32 * 14 * 14, 1024, 256),
                   "res5_c B=32": (32 * 7 * 7, 512, 2048),
                   "ragged+res+relu": (4999, 1000, 256)}
#: the int8 epilogue GEMM's cases: three 1×1 convs of ResNet-50 at B=32 and
#: a ragged one (K % 16 and N % 8 not 0: rows copied byte by byte) with a
#: residual and bf16 out: (M, K, N, residual and bf16 out)
INT8_SHAPES = {"res2_c B=32": (32 * 56 * 56, 64, 256, False),
               "res4_a B=32": (32 * 14 * 14, 1024, 256, False),
               "res5_c B=32": (32 * 7 * 7, 512, 2048, False),
               "ragged+res bf16": (4999, 1000, 251, True)}
#: ResNet-50's identity blocks at B=32: (B, H, W, C, M)
BOTTLENECK_SHAPES = {"res2 B=32": (32, 56, 56, 256, 64),
                     "res3 B=32": (32, 28, 28, 512, 128),
                     "res4 B=32": (32, 14, 14, 1024, 256),
                     "res5 B=32": (32, 7, 7, 2048, 512)}


def _scaled_err(got, want):
    """max |got − want| and max(1, max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, max(1.0, want.float().abs().max().item())


def _fwd_work(m, k, n, dtype, nbytes, extra_flops=0.0):
    """(operations, bytes, peak) of a forward GEMM (matmul_epilogue,
    matmul_stats) on its tensor-core route: f32 as 3×TF32 (three TF32
    products of 2·M·K·N each) at the TF32 rate, bf16 at the bf16 rate."""
    if dtype == torch.float32:
        return 6.0 * m * k * n + extra_flops, nbytes, PEAK_TF32
    return 2.0 * m * k * n + extra_flops, nbytes, None


def _tile(m, k, n, int8=False):
    """The tile the forward GEMMs' launch picks on the card, "BMxBN"."""
    return ("x".join(map(str, _fwd_tile(m, k, n, int8))) if DEV == "cuda"
            else None)


def _epilogue_case(label, m, k, n, with_res, act, dtype, gen, iters=20):
    """matmul_epilogue against its plain version, timed beside it, beside
    cuBLAS's product with the same epilogue in PyTorch, and its bound."""
    x = _randn(gen, dtype, m, k)
    w = (torch.randn((k, n), generator=gen, device=DEV) / k ** 0.5).to(
        dtype)
    scale = torch.rand(n, generator=gen, device=DEV) + 0.5
    shift = torch.randn(n, generator=gen, device=DEV) * 0.1
    res = _randn(gen, dtype, m, n) if with_res else None
    out = matmul_epilogue(x, w, scale, shift, residual=res, act=act)
    ref = _epilogue_reference(x, w, scale, shift, res, act, dtype)
    torch.cuda.synchronize()
    err, scl = _scaled_err(out, ref)
    esz = x.element_size()
    nbytes = (m * k + k * n + m * n * (2 if with_res else 1)) * esz + 8 * n
    flops, nbytes, peak = _fwd_work(m, k, n, dtype, nbytes)
    bms, by = bound(flops, nbytes, dtype, peak)

    def library():
        y = torch.matmul(x, w) * scale + shift
        if res is not None:
            y = y + res
        return torch.relu(y) if act == "relu" else y

    return dict(
        name="matmul_epilogue", case=label, shape=[m, k, n],
        dtype=DTYPE_NAMES[dtype], act=act, tile=_tile(m, k, n),
        max_abs_err=err, atol=ATOL[dtype] * scl,
        ms=time_ms(lambda: matmul_epilogue(x, w, scale, shift, residual=res,
                                           act=act), iters),
        plain_ms=time_ms(lambda: _epilogue_reference(x, w, scale, shift, res,
                                                     act, dtype), iters),
        library_ms=time_ms(library, iters), bound_ms=bms, bound_by=by)


def _int8_case(label, m, k, n, ragged, gen):
    """int8_matmul_epilogue: the int32 sums bit-exact (scale 1, shift 0
    against the exact product), then the epilogue (relu; with a residual
    and bf16 out where `ragged`) within INT8_RTOL of the largest f32
    output (one rounding of acc·scale + shift apart), or ATOL[bf16] of it
    in bf16 (the output's rounding). The yardstick is torch._int_mm
    (cuBLAS int8) with the same epilogue."""
    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=DEV,
                             dtype=torch.int32).to(torch.int8)

    xq, wq = ints(m, k), ints(k, n)
    scale = (torch.rand(n, generator=gen, device=DEV) + 0.5) * 1e-3
    shift = torch.randn(n, generator=gen, device=DEV)
    out_dtype = torch.bfloat16 if ragged else torch.float32
    res = _randn(gen, out_dtype, m, n) if ragged else None
    ones = torch.ones(n, device=DEV)
    acc = int8_matmul_epilogue(xq, wq, ones, torch.zeros_like(ones))
    exact = (xq.double() @ wq.double()).float()

    def kernel():
        return int8_matmul_epilogue(xq, wq, scale, shift, residual=res,
                                    act="relu", out_dtype=out_dtype)

    def plain():
        return _epilogue_reference(xq, wq, scale, shift, res, "relu",
                                   out_dtype)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    acc_exact = bool(torch.equal(acc, exact))
    err, scl = _scaled_err(out, ref)
    atol = (ATOL[torch.bfloat16] * scl if ragged
            else INT8_RTOL * ref.abs().max().item())
    osz = 2 if ragged else 4
    nbytes = m * k + k * n + osz * m * n * (2 if ragged else 1) + 8 * n
    bms, by = bound(2.0 * m * k * n, nbytes, torch.int8)

    def library():
        y = torch._int_mm(xq, wq).float() * scale + shift
        if res is not None:
            y = y + res
        return torch.relu(y).to(out_dtype)

    try:
        library()
        lib = time_ms(library)
    except RuntimeError as e:      # the yardstick only; not the port
        log(f"[kernels] torch._int_mm unavailable at {[m, k, n]}: {e}")
        lib = None
    return dict(
        name="int8_matmul_epilogue", case=label, shape=[m, k, n],
        dtype="int8", out_dtype=DTYPE_NAMES[out_dtype],
        tile=_tile(m, k, n, int8=True), max_abs_err=err,
        acc_exact=acc_exact, atol=atol, ms=time_ms(kernel),
        plain_ms=time_ms(plain), library_ms=lib, bound_ms=bms, bound_by=by)


def _bottleneck_library(x, w1, b1, w2, b2, w3, b3):
    """The block as three cuDNN convolutions in the activation dtype
    (channels-last; bf16 on the tensor cores): the yardstick."""
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)

    def conv(t, w, pad):
        return F.conv2d(t, w.permute(3, 2, 0, 1).contiguous(
            memory_format=cl), padding=pad)

    h1 = torch.relu(conv(xc, w1[None, None], 0)
                    + b1.to(x.dtype)[None, :, None, None])
    h2 = torch.relu(conv(h1, w2, 1) + b2.to(x.dtype)[None, :, None, None])
    y = conv(h2, w3[None, None], 0) + b3.to(x.dtype)[None, :, None, None]
    return torch.relu(y + xc).permute(0, 2, 3, 1)


def _bottleneck_weights(c, m, dtype, gen):
    """Folded-BN weights of one identity block, scaled so the activations
    stay O(1) through it."""
    def rnd(*shape, std):
        return (torch.randn(shape, generator=gen, device=DEV) * std).to(dtype)

    return (rnd(c, m, std=(2 / c) ** 0.5),
            torch.randn(m, generator=gen, device=DEV) * 0.1,
            rnd(3, 3, m, m, std=(2 / (9 * m)) ** 0.5),
            torch.randn(m, generator=gen, device=DEV) * 0.1,
            rnd(m, c, std=0.5 / m ** 0.5),
            torch.randn(c, generator=gen, device=DEV) * 0.1)


def _bottleneck_work(b, h, w, c, m, esz):
    """(operations, bytes, peak) of the block on its tensor-core route: f32
    as 3×TF32 (three TF32 products each) at the TF32 rate, bf16 at the bf16
    rate; bytes are x, y and the weights once, and the f32 biases."""
    flops = 2.0 * b * h * w * (c * m + 9 * m * m + m * c)
    nbytes = 2 * b * h * w * c * esz + (2 * c * m + 9 * m * m) * esz \
        + (2 * m + c) * 4
    if esz == 4:
        return 3.0 * flops, nbytes, PEAK_TF32
    return flops, nbytes, None


def _block_plan(b, h, w, c, m, dtype):
    """The launch's plan (R, pixels, blocks, mi, smem) and the L2 weight
    bytes it implies: every block streams all 17·M² weight values."""
    if DEV != "cuda":
        return None
    plan = _block_plan_of(dtype, b, h, w, c, m)
    esz = torch.tensor([], dtype=dtype).element_size()
    plan["l2_weight_bytes"] = plan["blocks"] * 17 * m * m * esz
    return plan


def _bottleneck_case(label, b, h, w, c, m, dtype, gen):
    x = torch.relu(_randn(gen, dtype, b, h, w, c))
    wts = _bottleneck_weights(c, m, dtype, gen)
    args = (x, wts[0], wts[1], wts[2], wts[3], wts[4], wts[5])
    out = bottleneck_block(*args, block_b=1)
    again = bottleneck_block(*args, block_b=1)
    ref = bottleneck_block_xla(*args)
    torch.cuda.synchronize()
    err, scl = _scaled_err(out, ref)
    flops, nbytes, peak = _bottleneck_work(b, h, w, c, m, x.element_size())
    bms, by = bound(flops, nbytes, dtype, peak)
    return dict(
        name="bottleneck_block", case=label, shape=[b, h, w, c, m],
        dtype=DTYPE_NAMES[dtype], max_abs_err=err, atol=ATOL[dtype] * scl,
        bit_identical=bool(torch.equal(out, again)),
        plan=_block_plan(b, h, w, c, m, dtype),
        fma_bound_ms=(bound(flops / 3, nbytes, dtype)[0] if peak else None),
        ms=time_ms(lambda: bottleneck_block(*args, block_b=1), iters=10),
        plain_ms=time_ms(lambda: bottleneck_block_xla(*args), iters=10),
        library_ms=time_ms(lambda: _bottleneck_library(*args), iters=10),
        bound_ms=bms, bound_by=by)


#: the shapes the training path gives the three BN-training kernels
#: (ResNet-50 at 224×224 and B=32, (M, K, N)) and one ragged case
BN_TRAIN_SHAPES = {"res2_c B=32": (32 * 56 * 56, 64, 256),
                   "res4_a B=32": (32 * 14 * 14, 1024, 256),
                   "res5_c B=32": (32 * 7 * 7, 512, 2048),
                   "ragged": (4999, 200, 1000)}
#: fused_layernorm at BERT-base's rows (B=32 × T=128, D=768) and a ragged
#: (rows, D)
LAYERNORM_SHAPES = {"bert_base 4096x768": (4096, 768),
                    "ragged 4999x1000": (4999, 1000)}


def _worst(got, want, atol):
    """Over pairs of outputs: (max |got − want| of the output nearest its
    tolerance, that output's tolerance atol × max(1, max |want|), all
    within)."""
    best = None
    for a, b in zip(got, want):
        err, scl = _scaled_err(a, b)
        if best is None or err / scl > best[0] / best[1]:
            best = (err, scl)
    return best[0], atol * best[1]


def _kernel_row(name, label, shape, dtype, kernel, plain, library, work,
                iters=20, peak=None):
    """Run a kernel and its plain version on the same inputs: the largest
    error against the tolerance, a re-run for bit identity, and the times
    of the kernel, the plain version and the library yardstick beside the
    bound."""
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err, atol = _worst(got, want, ATOL[dtype])
    identical = all(torch.equal(a, b) for a, b in zip(got, again))
    bms, by = bound(*work, dtype, peak)
    return dict(name=name, case=label, shape=list(shape),
                dtype=DTYPE_NAMES[dtype], max_abs_err=err, atol=atol,
                bit_identical=identical, ms=time_ms(kernel, iters),
                plain_ms=time_ms(plain, iters),
                library_ms=time_ms(library, iters), bound_ms=bms,
                bound_by=by)


def _stats_case(label, m, k, n, dtype, gen, iters=20):
    """matmul_stats (row 5); the yardstick is cuBLAS's product and two
    PyTorch sums over it. The bound is the route's (_fwd_work)."""
    x = _randn(gen, dtype, m, k)
    w = (torch.randn((k, n), generator=gen, device=DEV) / k ** 0.5).to(dtype)

    def library():
        yf = torch.matmul(x, w).float()
        return yf.sum(0), (yf * yf).sum(0)

    esz = x.element_size()
    *work, peak = _fwd_work(m, k, n, dtype,
                            (m * k + k * n + m * n) * esz + 8 * n,
                            3.0 * m * n)
    row = _kernel_row(
        "matmul_stats", label, (m, k, n), dtype, lambda: matmul_stats(x, w),
        lambda: _matmul_stats_reference(x, w), library, work, iters, peak)
    row["tile"] = _tile(m, k, n)
    return row


def _bn_vectors(n, gen):
    """μ, and r = 1/√(var + ε), of a batch of BN inputs."""
    return (torch.randn(n, generator=gen, device=DEV) * 0.1,
            torch.rand(n, generator=gen, device=DEV) + 0.5)


def _grad_stats_case(label, m, k, n, dtype, gen):
    """bn_grad_stats (row 7); the yardstick is the two PyTorch sums."""
    y, dz = _randn(gen, dtype, m, n), _randn(gen, dtype, m, n)
    mu, r = _bn_vectors(n, gen)

    def library():
        dzf = dz.float()
        return (dzf * ((y.float() - mu) * r)).sum(0), dzf.sum(0)

    return _kernel_row(
        "bn_grad_stats", label, (m, n), dtype,
        lambda: bn_grad_stats(y, dz, mu, r),
        lambda: _bn_grad_stats_reference(y, dz, mu, r), library,
        (4.0 * m * n, 2 * m * n * y.element_size() + 16 * n))


def _conv_grads_work(m, k, n, esz):
    """(operations, bytes, peak) of bn_conv_grads on its route: f32 as
    3×TF32 (three TF32 products of 4·M·K·N each) on the TF32 tensor cores,
    bf16 on the bf16 ones; x, y, dz, w read once, dX and dW written once."""
    flops = 4.0 * m * k * n * (3 if esz == 4 else 1) + 5.0 * m * n
    nbytes = (2 * m * k + 2 * m * n + k * n) * esz + 4 * k * n + 16 * n
    return flops, nbytes, (PEAK_TF32 if esz == 4 else None)


def _conv_grads_case(label, m, k, n, dtype, gen, iters=20):
    """bn_conv_grads (row 8); the yardstick is the dy pass in PyTorch and
    cuBLAS's two products."""
    x = _randn(gen, dtype, m, k)
    y, dz = _randn(gen, dtype, m, n), _randn(gen, dtype, m, n)
    w = (torch.randn((k, n), generator=gen, device=DEV) / n ** 0.5).to(dtype)
    mu, r = _bn_vectors(n, gen)
    k1 = torch.rand(n, generator=gen, device=DEV) + 0.5
    k2 = k1 * r * torch.randn(n, generator=gen, device=DEV) * 1e-3
    c = k1 * torch.randn(n, generator=gen, device=DEV) * 1e-3
    args = (x, y, dz, w, k1, k2, c, mu)

    def library():
        dy = _bn_dy(y, dz, k1, k2, c, mu, dtype).to(dtype)
        return dy @ w.T, x.T @ dy

    *work, peak = _conv_grads_work(m, k, n, x.element_size())
    return _kernel_row(
        "bn_conv_grads", label, (m, k, n), dtype,
        lambda: bn_conv_grads(*args),
        lambda: _bn_conv_grads_reference(*args), library, work, iters, peak)


#: the 36 conv1x1+BN pairs of one ResNet-50 training step at B=32, 224×224:
#: (M, K, N) -> pairs of that shape (M = 32·H·W; res2 56², res3 28², res4
#: 14², res5 7²)
STEP36 = {(100352, 64, 256): 4, (100352, 256, 64): 2, (100352, 64, 64): 1,
          (25088, 128, 512): 4, (25088, 512, 128): 3, (25088, 256, 128): 1,
          (25088, 256, 512): 1,
          (6272, 256, 1024): 6, (6272, 1024, 256): 5, (6272, 512, 256): 1,
          (6272, 512, 1024): 1,
          (1568, 512, 2048): 3, (1568, 2048, 512): 2, (1568, 1024, 512): 1,
          (1568, 1024, 2048): 1}


def step36_cases():
    """bn_conv_grads at each of the step's 15 shapes, f32, each checked
    against its plain version (10 timed calls each)."""
    case = functools.partial(_conv_grads_case, iters=10)
    return [(case, f"step36 {m}x{k}x{n}", m, k, n, torch.float32)
            for (m, k, n) in STEP36]


def step36_summary(rows):
    """The step's bn_conv_grads: kernel and library ms summed over the 36
    pairs (each shape's time × its count), beside the step's bound: the
    larger of its bytes over the memory rate and its 3×TF32 operations over
    the TF32 rate, each summed over the pairs."""
    got = {tuple(r["shape"]): r for r in rows
           if r["name"] == "bn_conv_grads" and r["case"].startswith("step36")}
    flops = nbytes = 0.0
    for (m, k, n), count in STEP36.items():
        f, b, _ = _conv_grads_work(m, k, n, 4)
        flops, nbytes = flops + count * f, nbytes + count * b
    out = {"pairs": sum(STEP36.values()), "shapes": len(got),
           "kernel_ms": sum(c * got[s]["ms"] for s, c in STEP36.items()),
           "library_ms": sum(c * got[s]["library_ms"]
                             for s, c in STEP36.items()),
           "plain_ms": sum(c * got[s]["plain_ms"] for s, c in STEP36.items()),
           "bound_ms": max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_TF32) * 1e3,
           "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                        >= flops / PEAK_TF32 else "operations"),
           "worst_err_over_atol": max(got[s]["max_abs_err"] / got[s]["atol"]
                                      for s in STEP36),
           "bit_identical": all(got[s]["bit_identical"] for s in STEP36)}
    log(f"[kernels] bn_conv_grads step36 ({out['pairs']} pairs, "
        f"{out['shapes']} shapes, f32): kernel_ms={out['kernel_ms']:.4f} "
        f"library_ms={out['library_ms']:.4f} plain_ms={out['plain_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}) "
        f"worst err/atol={out['worst_err_over_atol']:.3f} "
        f"bit_identical={out['bit_identical']}")
    return out


#: the forward kernels' kernel-phase cases over STEP36: f32, the dtype of
#: both main paths, and bf16
FWD36_DTYPES = (torch.float32, torch.bfloat16)


def fwd36_cases():
    """matmul_epilogue and matmul_stats at each of STEP36's 15 shapes (the
    36 conv1x1+BN pairs of one ResNet-50 forward), in f32 and bf16, each
    checked against its plain version (10 timed calls each). The epilogue
    takes relu where the pair's BN does: the 16 `_a` convs, which narrow
    the channels (N ≤ K); the `_c` and shortcut convs are identity."""
    cases = []
    for dtype in FWD36_DTYPES:
        for (m, k, n) in STEP36:
            label = f"fwd36 {m}x{k}x{n}"
            cases.append((functools.partial(_epilogue_case, iters=10), label,
                          m, k, n, False, "relu" if n <= k else "identity",
                          dtype))
            cases.append((functools.partial(_stats_case, iters=10), label,
                          m, k, n, dtype))
    return cases


def fwd36_summary(rows):
    """Each forward kernel over one ResNet-50 forward's 36 pairs, per
    dtype: kernel, library and plain ms summed over the pairs (each shape's
    time × its count), beside the bound summed the same way (each shape's
    larger of bytes at the memory rate and operations at its route's
    rate)."""
    out = {}
    for name in ("matmul_epilogue", "matmul_stats"):
        for dtype in FWD36_DTYPES:
            dt = DTYPE_NAMES[dtype]
            got = {tuple(r["shape"]): r for r in rows
                   if r["name"] == name and r["dtype"] == dt
                   and r["case"].startswith("fwd36")}

            def total(key):
                return sum(c * got[s][key] for s, c in STEP36.items())

            s = {"pairs": sum(STEP36.values()), "shapes": len(got),
                 "kernel_ms": total("ms"), "library_ms": total("library_ms"),
                 "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                 "worst_err_over_atol": max(
                     got[sh]["max_abs_err"] / got[sh]["atol"]
                     for sh in STEP36),
                 "shapes_slower_than_library": [
                     list(sh) for sh in STEP36
                     if got[sh]["ms"] > got[sh]["library_ms"]],
                 "tiles": {"x".join(map(str, sh)): got[sh]["tile"]
                           for sh in STEP36}}
            if name == "matmul_stats":
                s["bit_identical"] = all(got[sh]["bit_identical"]
                                         for sh in STEP36)
            out[f"{name} {dt}"] = s
            log(f"[kernels] {name} fwd36 ({s['pairs']} pairs, "
                f"{s['shapes']} shapes, {dt}): "
                f"kernel_ms={s['kernel_ms']:.4f} "
                f"library_ms={s['library_ms']:.4f} "
                f"plain_ms={s['plain_ms']:.4f} bound_ms={s['bound_ms']:.4f} "
                f"worst err/atol={s['worst_err_over_atol']:.3f} "
                f"slower than library at "
                f"{len(s['shapes_slower_than_library'])} shapes"
                + (f" bit_identical={s['bit_identical']}"
                   if "bit_identical" in s else ""))
    return out


#: the fine-tune step's attention: each of its 12 layers launches flash_fwd,
#: flash_bwd_dq and flash_bwd_dkv once at this kernel-phase case
STEP12_CASE = "train B=32 T=128"


def bert_step12_summary(rows):
    """The fine-tune step's three attention kernels per dtype: 12 × (fwd +
    dQ + dK/dV) kernel ms at the step's shape, against 12 × (SDPA forward +
    SDPA backward), beside 12 × the three bounds."""
    out = {}
    for dt in ("f32", "bf16"):
        got = {r["name"]: r for r in rows
               if r["case"] == STEP12_CASE and r["dtype"] == dt}
        names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        s = {"layers": 12,
             "kernel_ms": 12 * sum(got[n]["ms"] for n in names),
             "library_ms": 12 * (got["flash_fwd"]["library_ms"]
                                 + got["flash_bwd_dq"]["library_ms"]),
             "bound_ms": 12 * sum(got[n]["bound_ms"] for n in names),
             "by_kernel_ms": {n: 12 * got[n]["ms"] for n in names}}
        out[dt] = s
        log(f"[kernels] bert_step12 ({dt}, 12 layers at {STEP12_CASE}): "
            f"kernel_ms={s['kernel_ms']:.4f} (fwd "
            f"{s['by_kernel_ms']['flash_fwd']:.4f} + dQ "
            f"{s['by_kernel_ms']['flash_bwd_dq']:.4f} + dK/dV "
            f"{s['by_kernel_ms']['flash_bwd_dkv']:.4f}) "
            f"library_ms={s['library_ms']:.4f} (SDPA forward + backward) "
            f"bound_ms={s['bound_ms']:.5f}")
    return out


def _layernorm_case(label, rows, d, dtype, gen):
    """fused_layernorm's kernel (row 4); the yardstick is F.layer_norm."""
    x = _randn(gen, dtype, rows, d) * 2 + 0.5
    g = torch.rand(d, generator=gen, device=DEV) + 0.5
    b = torch.randn(d, generator=gen, device=DEV) * 0.1
    gd, bd = g.to(dtype), b.to(dtype)
    return _kernel_row(
        "fused_layernorm", label, (rows, d), dtype,
        lambda: (fused_layernorm(x, g, b),),
        lambda: _layernorm_reference(x, g, b, 1e-5)[:1],
        lambda: F.layer_norm(x, (d,), gd, bd, 1e-5),
        (8.0 * rows * d, 2 * rows * d * x.element_size() + 8 * d + 8 * rows))


def training_kernel_cases(dtype):
    """The cases of the four kernels of the ResNet-50 training slice."""
    cases = []
    for label, (m, k, n) in BN_TRAIN_SHAPES.items():
        for fn in (_stats_case, _grad_stats_case, _conv_grads_case):
            cases.append((fn, label, m, k, n, dtype))
    for label, (rows, d) in LAYERNORM_SHAPES.items():
        cases.append((_layernorm_case, label, rows, d, dtype))
    return cases


def run_kernel_cases(cases, gen):
    """Run each case and log its row; raises if any kernel disagrees with
    its plain version (or re-runs other bits). Returns the rows."""
    rows = []
    for fn, *a in cases:
        t = time.perf_counter()
        got = fn(*a, gen)
        for r in got if isinstance(got, list) else [got]:
            r["wall_s"] = time.perf_counter() - t   # the whole case's
            rows.append(r)
    bad = []
    for r in rows:
        ok = (r["max_abs_err"] <= r["atol"] and r.get("bit_identical", True)
              and r.get("padded_example_zero", True)
              and r.get("acc_exact", True))
        lib = r["library_ms"]
        log(f"[kernels] {r['name']:<12} {r['case']:<14} "
            f"shape={r['shape']} {r['dtype']:<4} "
            f"max_abs_err={r['max_abs_err']:.3e} (atol {r['atol']:.2e}) "
            f"{'ok' if ok else 'FAIL'}  ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms="
            + ("none" if lib is None else f"{lib:.4f}")
            + f" bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
            f"case_s={r['wall_s']:.2f}"
            + ("" if "bit_identical" not in r else
               f" bit_identical={r['bit_identical']}")
            + ("" if "f64_err" not in r else f" f64_err={r['f64_err']:.3e}")
            + ("" if "cluster" not in r else f" cluster={r['cluster']}")
            + ("" if "acc_exact" not in r else
               f" int32_sums_exact={r['acc_exact']}")
            + ("" if not r.get("tile") or r["name"] != "int8_matmul_epilogue"
               else f" tile={r['tile']}")
            + ("" if not r.get("plan") else
               " R={rows} P={pixels} blocks={blocks} mi={mi} smem={smem} "
               "l2_weight_bytes={l2_weight_bytes}".format(**r["plan"]))
            + ("" if not r.get("fma_bound_ms") else
               f" fma_rate_bound_ms={r['fma_bound_ms']:.5f}"))
        if not ok:
            bad.append(f"{r['name']} {r['case']} {r['dtype']}")
    if bad:
        raise AssertionError(f"kernels disagree with their plain "
                             f"versions: {bad}")
    return rows


def phase_kernels():
    """Every kernel against its plain version; returns (rows, launches of
    each kernel in this phase)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    _reset_counts()
    enc_lens = [512, 300, 128, 1, 0, 77, 450, 511]   # one fully padded
    train_lens = _train_lengths(TRAIN["batch"], TRAIN["seq"])
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((_fwd_case, "encode", 8, 12, 512, 512, 64, False,
                      enc_lens, dtype))
        cases.append((_fwd_case, "encode T=128", 8, 12, 128, 128, 64, False,
                      ENCODE_LENS, dtype))
        for p in (16, 128):
            cases.append((_fwd_case, f"prefill P={p}", 1, 12, p, p, 64, True,
                          None, dtype))
        cases.append((_fwd_case, "cross Tq!=Tk", 2, 12, 100, 300, 64, False,
                      [300, 171], dtype))
        cases.append((_fwd_case, "train B=32 T=128", 32, 12, 128, 128, 64,
                      False, train_lens, dtype))
        for c in (128, 512):
            lens = [c, c // 2, 1, 0, 37, c - 1, 64, 100]  # one empty row
            cases.append((_decode_case, f"decode C={c}", 8, 12, c, 64, lens,
                          dtype))
        cases.append((_bwd_cases, "train B=32 T=128", 32, 12, 128, 128, 64,
                      False, train_lens, dtype))
        cases.append((_bwd_cases, "encode", 8, 12, 512, 512, 64, False,
                      enc_lens, dtype))
        cases.append((_bwd_cases, "causal T=128", 1, 12, 128, 128, 64, True,
                      None, dtype))
        cases.append((_bwd_cases, "cross Tq!=Tk", 2, 12, 100, 300, 64, False,
                      [300, 171], dtype))
        for label, (m, k, n) in EPILOGUE_SHAPES.items():
            ragged = label.startswith("ragged")
            cases.append((_epilogue_case, label, m, k, n, ragged,
                          "relu" if ragged else "identity", dtype))
        for label, shape in BOTTLENECK_SHAPES.items():
            cases.append((_bottleneck_case, label, *shape, dtype))
        cases += training_kernel_cases(dtype)
    for label, shape in INT8_SHAPES.items():
        cases.append((_int8_case, label, *shape))
    cases += step36_cases()
    cases += fwd36_cases()
    return run_kernel_cases(cases, gen), _counts()


# -- phase 4 ------------------------------------------------------------------
KERNELS = (flash_fwd, flash_decode, flash_bwd_dq, flash_bwd_dkv,
           matmul_epilogue, int8_matmul_epilogue, bottleneck_block,
           matmul_stats, bn_grad_stats, bn_conv_grads, fused_layernorm)


def _reset_counts():
    for kernel in KERNELS:
        kernel.launches = 0


def _counts():
    return {kernel.__name__: kernel.launches for kernel in KERNELS}


def phase_encoder(cfg, params):
    dev = torch.device(DEV)
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


def _fault_free(st, what):
    """A run that met no fault. The server recovers from a failed block
    or admission by replaying its requests, so a failure that clears on
    retry shows only in its counters: no error, replay, restart or
    dropped block, and each token fetch a delivered block or an
    admission. `st` is a status read after the shutdown, or a run."""
    bad = {k: st[k] for k in ("errors", "replays", "restarts",
                              "blocks_dropped") if st[k]}
    if bad or st["token_fetches"] != st["steps"] + st["admissions"]:
        raise AssertionError(f"{what}: the server met a fault: {bad}; "
                             f"{st['token_fetches']} token fetches for "
                             f"{st['steps']} blocks and {st['admissions']} "
                             f"admissions")


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
    finally:
        srv.shutdown()
    # after the shutdown, which delivers the block still in flight
    st = srv.status()
    _fault_free(st, f"serving ({attn_impl} attention)")
    return streams, handles, wall, _counts(), st


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
    missing = [k for k in ("flash_fwd", "flash_decode") if launches[k] == 0]
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


# -- phase 6 ------------------------------------------------------------------
#: the fine-tune step of bench.py::_bench_bert_finetune: bert_base, f32,
#: batch 32 x 128 with ragged padding (lengths 64-128), random labels,
#: dropout 0.1, Adam(2e-5)
TRAIN = dict(batch=32, seq=128, lr=2e-5, warmup=2, steps=10)
#: flash vs dense gradients of one step, per leaf: max |flash - dense| <=
#: GRAD_RTOL * max |dense| (f32 sums in another order through 12 layers)
GRAD_RTOL = 1e-4


def _train_lengths(b, t):
    return np.random.default_rng(3).integers(t // 2, t + 1, b).tolist()


def _train_batch(cfg):
    rng = np.random.default_rng(4)
    b, t = TRAIN["batch"], TRAIN["seq"]
    dev = torch.device(DEV)
    return {"input_ids": torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (b, t)), device=dev),
            "labels": torch.as_tensor(
                rng.integers(0, cfg.num_labels, b), device=dev),
            "attention_mask": _ragged_mask(_train_lengths(b, t), t,
                                           dev).float()}


def _trainable(tree):
    """A copy of the parameter tree whose leaves require grad."""
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_trainable(v) for v in tree]
    return tree.detach().clone().requires_grad_()


def _trainer(cfg, params, batch, generator, attn_impl="auto"):
    """One fine-tune step as bench.py builds it: loss, backward, Adam."""
    params = _trainable(params)
    opt = torch.optim.Adam(param_leaves(params), lr=TRAIN["lr"],
                           betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = classification_loss(cfg, params, batch, train=True,
                                   generator=generator, attn_impl=attn_impl)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def phase_train(cfg, params):
    batch = _train_batch(cfg)
    b, t, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    step = _trainer(cfg, params, batch, gen)
    losses = [step() for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    losses = [float(x) for x in losses]
    per_step = {k: launches[k] / steps
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    log(f"[train] bert_base f32 B={b} T={t} dropout {cfg.dropout} "
        f"Adam({TRAIN['lr']}): {wall * 1e3 / steps:.2f} ms/step, "
        f"{steps / wall:.3f} steps/s, {b * t * steps / wall:.1f} tokens/s; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches per step "
        f"{per_step}")
    wrong = {k: n for k, n in per_step.items() if n != cfg.num_layers}
    if wrong:
        raise AssertionError(f"train: launches per step {wrong}, expected "
                             f"{cfg.num_layers} of each")
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: a loss is not finite: {losses}")
    del step

    # one step's gradients, dropout off: the kernels against dense attention
    grads = {}
    for impl in ("flash", "dense"):
        tree = _trainable(params)
        classification_loss(cfg, tree, batch, train=True,
                            attn_impl=impl).backward()
        grads[impl] = [(name, leaf.grad)
                       for name, leaf in named_param_leaves(tree)]
        del tree
    worst, bad = 0.0, []
    for (name, a), (_, d) in zip(grads["flash"], grads["dense"]):
        if a is None or d is None:
            if (a is None) != (d is None):
                bad.append(name)
            continue
        rel = ((a - d).abs().max() / d.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not rel <= GRAD_RTOL:
            bad.append(f"{name} ({rel:.2e})")
    del grads
    log(f"[train] one step, dropout off: flash vs dense gradients, worst "
        f"leaf max|diff|/max|dense| = {worst:.3e} (rtol {GRAD_RTOL:.0e})")
    if bad:
        raise AssertionError(f"train: flash gradients differ from dense: "
                             f"{bad}")

    # ten steps on one fixed batch, dropout off: the loss must fall
    step = _trainer(cfg, params, batch, None)
    fixed = [float(step()) for _ in range(10)]
    del step
    log(f"[train] 10 steps on one batch, dropout off: loss "
        f"{fixed[0]:.4f} -> {fixed[-1]:.4f}")
    if not (np.isfinite(fixed).all() and fixed[-1] < fixed[0]):
        raise AssertionError(f"train: loss did not fall: {fixed}")
    return {"ms_per_step": wall * 1e3 / steps, "steps_per_s": steps / wall,
            "tokens_per_s": b * t * steps / wall, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "grad_worst_rel": worst, "fixed_batch_losses": fixed}


# -- phase 7 ------------------------------------------------------------------
#: the ResNet serving workload: at least 96 images of 224×224×3 as
#: requests of 1-8 rows from 8 client threads, coalesced up to 32 rows
RESNET = dict(batch=32, images=96, threads=8, seed=0, timed=5)
#: fused vs unfused on the card, answers and features: f32 sums in
#: another order through 53 layers, held to RESNET_RTOL of the largest
#: unfused value
RESNET_RTOL = 1e-4
#: conv1x1+BN pairs the fusion marks in ResNet-50: the _a and _c convs of
#: 16 blocks and 4 shortcuts
EPILOGUE_PAIRS = 36


def _perturb_bn(net, seed):
    """Draw every BN's running statistics and γ/β from a seeded generator,
    so the fold is not the identity. The last BN of each residual branch
    (_c, _sc) gets γ in [0.2, 0.5], which keeps the activations O(1)
    through the 16 blocks (at γ ~ 1 they grow to tens by res5 and the
    softmax saturates)."""
    rng = np.random.default_rng(seed)
    for name in sorted(net._state):
        st, p = net._state[name], net._params[name]
        n = st["mean"].shape[0]
        lo, hi = (0.2, 0.5) if name.endswith(("_c_bn", "_sc_bn")) \
            else (0.5, 1.0)
        for t, v in ((st["mean"], rng.normal(0, 0.1, n)),
                     (st["var"], rng.uniform(0.5, 1.5, n)),
                     (p["gamma"], rng.uniform(lo, hi, n)),
                     (p["beta"], rng.normal(0, 0.1, n))):
            t.copy_(torch.as_tensor(v, dtype=torch.float32))


def _resnet_nets(**zoo):
    """(fused, unfused) ResNet-50 at 224×224×3, 1000 classes, f32, both
    from the zoo's seed with the same BN draws; `zoo` goes to ResNet50."""
    before = os.environ.get("DL4J_TPU_FUSE_CONV_BN")
    nets = []
    try:
        for fuse in ("1", "0"):
            os.environ["DL4J_TPU_FUSE_CONV_BN"] = fuse
            net = ResNet50(**zoo).init(DEV)
            _perturb_bn(net, RESNET["seed"])
            nets.append(net)
    finally:
        if before is None:
            os.environ.pop("DL4J_TPU_FUSE_CONV_BN", None)
        else:
            os.environ["DL4J_TPU_FUSE_CONV_BN"] = before
    fused, plain = nets
    if len(fused._fused_pairs) != EPILOGUE_PAIRS or plain._fused_pairs:
        raise AssertionError(f"resnet: {len(fused._fused_pairs)} fused pairs"
                             f" (expected {EPILOGUE_PAIRS}), "
                             f"{len(plain._fused_pairs)} in the unfused net")
    return fused, plain


def _serve_resnet(net, images, sizes, ladder=None, cache_dir=None):
    """The requests through ParallelInference(BATCHED, batchLimit=32) from
    RESNET["threads"] client threads; with `ladder`, through its bucket
    graphs (`bucketLadder(ladder)`, `warmup()`). Returns (answers,
    per-request latencies s, wall s, kernel launches, forwards, {warmup
    stats, status})."""
    off = np.concatenate([[0], np.cumsum(sizes)])
    answers, lat, errs = [None] * len(sizes), [None] * len(sizes), []
    nxt, lock = [0], threading.Lock()
    builder = (ParallelInference.Builder(net)
               .inferenceMode(InferenceMode.BATCHED)
               .batchLimit(RESNET["batch"]))
    if ladder is not None:
        builder.bucketLadder(ladder).executableCacheDir(cache_dir)
    pi = builder.build()

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(sizes):
                return
            t = time.perf_counter()
            try:
                answers[i] = pi.output(images[off[i]:off[i + 1]])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
                return
            lat[i] = time.perf_counter() - t

    info = {}
    try:
        if ladder is not None:
            info["warmup"] = pi.warmup()
        else:
            # warm: the allocator grows to the padded batch sizes the
            # collector forms (32 rows, and 64 when a batch runs past 32)
            for rows in (1, RESNET["batch"], 2 * RESNET["batch"]):
                pi.output(np.resize(images, (rows,) + images.shape[1:]))
        torch.cuda.synchronize()
        _reset_counts()
        calls = pi.model_calls
        threads = [threading.Thread(target=client)
                   for _ in range(RESNET["threads"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        calls = pi.model_calls - calls
        info["status"] = pi.status()
    finally:
        pi.shutdown()
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"resnet: serving failed: {errs}")
    return answers, lat, wall, launches, calls, info


def _forward_ms(net, x):
    """Mean host-clock ms of one forward ending in a synchronize, after two
    warm-up forwards."""
    for _ in range(2):
        net.output(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(RESNET["timed"]):
        t = time.perf_counter()
        net.output(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.mean(times)), float(np.min(times))


def _fold(net, bn):
    """The (scale, shift) of a BN node's inference affine."""
    st, p = net._state[bn], net._params[bn]
    inv = torch.rsqrt(st["var"] + net.getLayer(bn).eps)
    return p["gamma"] * inv, p["beta"] - p["gamma"] * st["mean"] * inv


def _res4_block_check(net, acts):
    """bottleneck_block on res4_1's three convs with their BNs folded in,
    from the fused net's res4_0_relu activation, against its
    res4_1_relu."""
    (a1, c1), (a2, c2), (a3, c3) = (_fold(net, f"res4_1_{k}_bn")
                                    for k in "abc")
    w = {k: net._params[f"res4_1_{k}_conv"]["W"] for k in "abc"}
    before = bottleneck_block.launches
    y = bottleneck_block(acts["res4_0_relu"], w["a"][0, 0] * a1, c1,
                         w["b"] * a2, c2, w["c"][0, 0] * a3, c3,
                         block_b=RESNET["batch"] // 4)
    want = acts["res4_1_relu"]
    torch.cuda.synchronize()
    err = (y - want).abs().max().item()
    tol = RESNET_RTOL * want.abs().max().item()
    return {"max_abs_err": err, "tol": tol,
            "launches": bottleneck_block.launches - before,
            "shape": list(y.shape)}


def _resnet_requests():
    """(request sizes of 1-8 rows, summing to >= RESNET["images"], the
    images), from a seed."""
    rng = np.random.default_rng(5)
    sizes = []
    while sum(sizes) < RESNET["images"]:
        sizes.append(int(rng.integers(1, 9)))
    images = rng.standard_normal((sum(sizes), 224, 224, 3)).astype(
        np.float32)
    return sizes, images


def phase_resnet():
    fused, plain = _resnet_nets()
    sizes, images = _resnet_requests()
    answers, lat, wall, launches, calls, _ = _serve_resnet(fused, images,
                                                           sizes)
    n_img = int(sum(sizes))
    # the unfused net's answers for the same rows, on the card
    want = np.concatenate([plain.output(images[i:i + RESNET["batch"]])
                           .cpu().numpy()
                           for i in range(0, n_img, RESNET["batch"])])
    got = np.concatenate(answers)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    lat_ms = np.asarray(lat) * 1e3
    per_forward = launches["matmul_epilogue"] / max(calls, 1)
    log(f"[resnet] ResNet-50 224x224x3 f32, fusion on: {n_img} images in "
        f"{len(sizes)} requests of 1-8 rows from {RESNET['threads']} "
        f"threads, {calls} coalesced forwards, {wall:.3f} s = "
        f"{n_img / wall:.1f} images/s; per-request p50 "
        f"{np.percentile(lat_ms, 50):.2f} ms p99 "
        f"{np.percentile(lat_ms, 99):.2f} ms; matmul_epilogue launches "
        f"{launches['matmul_epilogue']} ({per_forward:.1f} per forward); "
        f"max |fused - unfused| = {err:.3e} of max {scale:.3e} "
        f"(rtol {RESNET_RTOL:.0e})")
    if launches["matmul_epilogue"] != EPILOGUE_PAIRS * calls or calls == 0:
        raise AssertionError(f"resnet: {launches['matmul_epilogue']} "
                             f"matmul_epilogue launches over {calls} "
                             f"forwards, expected {EPILOGUE_PAIRS} each")
    if got.shape != (n_img, 1000) or not np.isfinite(got).all():
        raise AssertionError(f"resnet: bad answers {got.shape}")
    if not err <= RESNET_RTOL * scale:
        raise AssertionError(f"resnet: fused answers differ from the "
                             f"unfused net's by {err}")
    x = torch.as_tensor(images[:RESNET["batch"]], device=DEV)
    fa = fused.feedForward(x)
    fb = plain.feedForward(x)
    feat_err = (fa["avgpool"] - fb["avgpool"]).abs().max().item()
    feat_scale = fb["avgpool"].abs().max().item()
    del fb
    block = _res4_block_check(fused, fa)
    del fa
    log(f"[resnet] avgpool features B={RESNET['batch']}: max |fused - "
        f"unfused| = {feat_err:.3e} of max {feat_scale:.3e}; "
        f"bottleneck_block on res4_1 (folded BNs) from res4_0_relu "
        f"{block['shape']}: max |kernel - res4_1_relu| = "
        f"{block['max_abs_err']:.3e} (tol {block['tol']:.3e})")
    if not feat_err <= RESNET_RTOL * feat_scale:
        raise AssertionError(f"resnet: avgpool features differ by "
                             f"{feat_err}")
    if not block["max_abs_err"] <= block["tol"] or block["launches"] != 1:
        raise AssertionError(f"resnet: bottleneck_block does not give "
                             f"res4_1_relu: {block}")
    fused_ms, fused_min = _forward_ms(fused, x)
    plain_ms, plain_min = _forward_ms(plain, x)
    log(f"[resnet] one B={RESNET['batch']} forward: fused {fused_ms:.3f} ms "
        f"(min {fused_min:.3f}), unfused {plain_ms:.3f} ms (min "
        f"{plain_min:.3f}); {RESNET['batch'] / fused_ms * 1e3:.1f} vs "
        f"{RESNET['batch'] / plain_ms * 1e3:.1f} images/s")
    del plain
    stats = {"images": n_img, "requests": len(sizes), "forwards": calls,
             "wall_s": wall, "images_per_s": n_img / wall,
             "p50_ms": float(np.percentile(lat_ms, 50)),
             "p99_ms": float(np.percentile(lat_ms, 99)),
             "launches": launches, "epilogue_per_forward": per_forward,
             "max_abs_err": err, "answer_scale": scale,
             "avgpool_err": feat_err, "avgpool_scale": feat_scale,
             "res4_block": block, "forward_ms": fused_ms,
             "forward_min_ms": fused_min, "unfused_forward_ms": plain_ms,
             "unfused_forward_min_ms": plain_min}
    return stats, fused, x


# -- phase 8 ------------------------------------------------------------------
#: ResNet-50 training: one seeded batch of 32 images and labels, 2 warm-up
#: and 10 timed steps, the zoo's Nesterovs at momentum 0.9 and a rate of
#: 0.01: at the zoo's 0.1 the loss on one fixed batch rises from this init
#: (10.7 -> 26.1 in 12 steps at 64×64, B=8, on the CPU, where 0.01 takes it
#: to 3.0)
RESNET_TRAIN = dict(batch=32, size=224, warmup=2, steps=10, seed=7, lr=0.01)
#: One step's gradients are held to the unfused net's run in f64. At this
#: random init they are ill-conditioned in f32: a relu input within f32
#: noise of 0 takes the other branch, BN's backward spreads that over its
#: channel, and both f32 nets land ~2 % (median leaf, max |err| over max
#: |f64|) from the f64 answer, each leaf by its own luck; fused and unfused
#: f32 differ from each other by as much (up to 14 % of a leaf's largest
#: on the card). So the fusion may add no error beyond f32's own: each
#: fused leaf within max(RESNET_GRAD_RTOL, RESNET_GRAD_FACTOR × its unfused
#: distance, the unfused net's worst leaf), and the fused median within
#: RESNET_GRAD_FACTOR × the unfused median. A wrong term in the fused
#: backward moves every leaf it reaches by O(1).
RESNET_GRAD_RTOL = 1e-3
RESNET_GRAD_FACTOR = 2.0
#: the kernels of the training fusion, launched once per pair and step
TRAIN_KERNELS = ("matmul_stats", "bn_grad_stats", "bn_conv_grads")


def _train_batch_resnet():
    rng = np.random.default_rng(RESNET_TRAIN["seed"])
    b = RESNET_TRAIN["batch"]
    hw = RESNET_TRAIN["size"]
    x = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    return DataSet(x, y)


def _leaf_errors(got, want):
    """{(node, key): max |got − want| / max |want|} over two {node: {key:
    tensor}} trees, in f64."""
    out = {}
    for n in sorted(want):
        for k in sorted(want[n]):
            a, w = got[n][k].double(), want[n][k].double()
            out[n, k] = ((a - w).abs().max()
                         / w.abs().max().clamp_min(1e-300)).item()
    return out


def _in_f64(net):
    """A copy of `net` whose forward and backward run in f64."""
    m = net.clone()
    m._compute_dtype = torch.float64
    m._params = {n: {k: v.double() for k, v in d.items()}
                 for n, d in m._params.items()}
    m._state = {n: {k: v.double() for k, v in d.items()}
                for n, d in m._state.items()}
    return m


def phase_resnet_train():
    """ResNet-50 trained with the fusion on; returns (stats, the fused net,
    the batch) for the profile phase."""
    fused, plain = _resnet_nets(updater=Nesterovs(RESNET_TRAIN["lr"], 0.9))
    ds = _train_batch_resnet()
    ins, labels, _ = fused._unpack(ds)
    # one step's gradients and BN statistics: fused, unfused, unfused in f64
    lf, gf, sf = fused._value_and_grad(ins, labels)
    lp, gp, sp = plain._value_and_grad(ins, labels)
    exact = _in_f64(plain)
    del plain
    le, ge, _ = exact._value_and_grad(ins, labels)
    del exact
    ef, eu, direct = (_leaf_errors(gf, ge), _leaf_errors(gp, ge),
                      _leaf_errors(gf, gp))
    state = _leaf_errors(sf, sp)
    del gf, gp, ge, sf, sp
    eu_worst, eu_median = max(eu.values()), float(np.median(list(
        eu.values())))
    bad = [f"{n}/{k} ({ef[n, k]:.2e} vs unfused {eu[n, k]:.2e})"
           for n, k in ef if not ef[n, k] <= max(
               RESNET_GRAD_RTOL, RESNET_GRAD_FACTOR * eu[n, k], eu_worst)]
    if not np.median(list(ef.values())) <= RESNET_GRAD_FACTOR * eu_median:
        bad.append(f"median {np.median(list(ef.values())):.2e} vs unfused "
                   f"{eu_median:.2e}")
    s_bad = [f"{n}/{k}" for (n, k), e in state.items() if not e <= RESNET_RTOL]
    ratio = max(ef[key] / max(eu[key], RESNET_GRAD_RTOL) for key in ef)
    log(f"[resnet_train] one step B={RESNET_TRAIN['batch']}: loss fused "
        f"{lf.item():.6f} unfused {lp.item():.6f} f64 {le.item():.6f}; "
        f"gradients against the unfused net in f64, per leaf max|err|/"
        f"max|f64|: fused worst {max(ef.values()):.3e} median "
        f"{np.median(list(ef.values())):.3e}, unfused f32 worst "
        f"{max(eu.values()):.3e} median {np.median(list(eu.values())):.3e};"
        f" worst per-leaf fused/unfused ratio {ratio:.3f}; fused vs "
        f"unfused directly worst {max(direct.values()):.3e} median "
        f"{np.median(list(direct.values())):.3e}; BN running statistics, "
        f"worst {max(state.values()):.3e} (rtol {RESNET_RTOL:.0e})")
    if bad or s_bad or not torch.isfinite(lf):
        raise AssertionError(f"resnet_train: the fused gradients or BN "
                             f"state are off: gradients {bad}, BN state "
                             f"{s_bad}")
    # the timed steps, through fit, as a user trains
    losses = []
    for _ in range(RESNET_TRAIN["warmup"]):
        fused.fit(ds)
        losses.append(fused._score)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(RESNET_TRAIN["steps"]):
        fused.fit(ds)
        losses.append(fused._score)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    steps, b = RESNET_TRAIN["steps"], RESNET_TRAIN["batch"]
    losses = [float(v) for v in losses]
    per_step = {k: launches[k] / steps for k in TRAIN_KERNELS}
    upd = fused.getLayer("fc").updater
    hw = RESNET_TRAIN["size"]
    log(f"[resnet_train] ResNet-50 {hw}x{hw}x3 f32 B={b}, fusion on, "
        f"{type(upd).__name__}({upd.learningRate}, {upd.momentum}) (the "
        f"zoo's rate is 0.1): "
        f"{wall * 1e3 / steps:.2f} ms/step, {b * steps / wall:.1f} images/s; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps on one batch; launches per step {per_step}")
    wrong = {k: n for k, n in per_step.items() if n != EPILOGUE_PAIRS}
    if wrong:
        raise AssertionError(f"resnet_train: launches per step {wrong}, "
                             f"expected {EPILOGUE_PAIRS} of each")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"resnet_train: loss did not fall: {losses}")
    return ({"ms_per_step": wall * 1e3 / steps, "images_per_s": b * steps
             / wall, "losses": losses, "launches": launches,
             "launches_per_step": per_step,
             "grad_fused_vs_f64_worst": max(ef.values()),
             "grad_unfused_vs_f64_worst": max(eu.values()),
             "grad_fused_unfused_ratio_worst": ratio,
             "grad_fused_vs_unfused_worst": max(direct.values()),
             "state_worst_rel": max(state.values()),
             "loss_fused": lf.item(), "loss_unfused": lp.item(),
             "loss_f64": le.item()}, fused, ds)


# -- phase 9: graphs ----------------------------------------------------------
#: the executable store's three capture targets, each against its eager
#: run in turns on this card (eager, graph, graph, eager): BERT serving
#: (the serving phase's 12 requests), ResNet-50 training at B=32 (2 warm-up
#: and GRAPHS["steps"] timed `fit` steps per arm; bit identity over
#: GRAPHS["check_steps"] steps, with cuDNN's deterministic algorithms on:
#: its default weight-gradient convolutions sum in a varying order, so two
#: eager steps already differ in the last bits), and ResNet-50 served
#: through `ParallelInference` with the bucket ladder
GRAPHS = dict(steps=10, check_steps=3, buckets=[1, 2, 4, 8, 16, 32],
              forwards=10)
ARMS = ("eager", "graph", "graph", "eager")
#: the fit A/B: (arm, prefetch depth) in mirrored turns, so that the
#: graph's gain and the prefetch's gain are measured apart (prefetch 0
#: copies each batch from pageable memory when its step starts)
FIT_ARMS = (("eager", 0), ("graph", 0), ("graph", 2), ("eager", 2),
            ("eager", 2), ("graph", 2), ("graph", 0), ("eager", 0))


def _store_clean(st, what):
    """A graph store that served without capturing, degrading or running
    eagerly after its warmup; logs its counts."""
    counts = {k: st[k] for k in ("keys", "captures", "replays",
                                 "live_captures", "eager_calls",
                                 "degradations")}
    log(f"[graphs] {what} store: {counts}")
    bad = {k: st[k] for k in ("live_captures", "degradations",
                              "eager_calls") if st[k]}
    if bad or st["replays"] == 0 or not st["capture"]:
        raise AssertionError(f"graphs: {what}: {bad or st}")


def _graphs_serving(cfg, params, cache_dir):
    reqs = _requests(cfg)
    runs = []
    for arm in ARMS:
        graph = arm == "graph"
        srv = GenerationServer(BertDecoder(cfg, params), cuda_graphs=graph,
                               exec_cache_dir=cache_dir if graph else None,
                               **SERVER)
        try:
            warm = srv.warmup()
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            streams = [h.result(timeout=600)
                       for h in [srv.submit(**r) for r in reqs]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
        # after the shutdown, which delivers the block still in flight
        launches = _counts()
        st = srv.status()
        _fault_free(st, f"graphs: serving {arm}")
        ntok = sum(len(x) for x in streams)
        ex = st["executables"]
        run = {"arm": arm, "wall_s": wall, "tokens": ntok,
               "tokens_per_s": ntok / wall, "blocks": st["steps"],
               "admissions": st["admissions"],
               "per_token_p50_ms": st["per_token_p50_ms"],
               "per_token_p99_ms": st["per_token_p99_ms"],
               "launches": {k: launches[k]
                            for k in ("flash_fwd", "flash_decode")},
               "warmup": warm, "replays": ex["replays"],
               "eager_calls": ex["eager_calls"]}
        log(f"[graphs] serving {arm}: {ntok} tokens in {wall:.3f} s = "
            f"{ntok / wall:.1f} tokens/s; per-token p50 "
            f"{st['per_token_p50_ms']:.3f} ms p99 "
            f"{st['per_token_p99_ms']:.3f} ms; {st['steps']} blocks, "
            f"{st['admissions']} admissions; host calls: "
            f"{ex['replays']} graph replays, {ex['eager_calls']} eager "
            f"calls; launches {run['launches']}; warmup {warm}")
        want = (cfg.num_layers * st["admissions"],
                cfg.num_layers * SERVER["superstep"] * st["steps"])
        if (launches["flash_fwd"], launches["flash_decode"]) != want:
            raise AssertionError(f"graphs: serving {arm} launched "
                                 f"{run['launches']}, expected {want}")
        if graph:
            _store_clean(ex, "serving")
        if runs and streams != runs[0]["streams"]:
            diff = [i for i, (a, b) in enumerate(zip(streams,
                                                     runs[0]["streams"]))
                    if a != b]
            raise AssertionError(f"graphs: serving {arm} streams {diff} "
                                 f"differ from the eager server's")
        runs.append(dict(run, streams=streams))
    first, second = runs[1]["warmup"], runs[2]["warmup"]
    keys = first["executables"]
    log(f"[graphs] serving store: {keys} keys; first warmup compiled "
        f"{first['compiled']} from_disk {first['from_disk']}; second "
        f"(same directory) compiled {second['compiled']} from_disk "
        f"{second['from_disk']} nvcc runs {second['nvcc_runs']}, "
        f"{second['seconds']:.2f} s; every stream equal to the eager "
        f"server's (greedy and sampled)")
    if (first["compiled"], first["from_disk"]) != (keys, 0) or (
            second["compiled"], second["from_disk"],
            second["nvcc_runs"]) != (0, keys, 0):
        raise AssertionError(f"graphs: the serving store's disk tier: "
                             f"{first} then {second}")
    for r in runs:
        del r["streams"]
    return runs


def _graphs_fit():
    fused, plain = _resnet_nets(updater=Nesterovs(RESNET_TRAIN["lr"], 0.9))
    del plain
    ds = _train_batch_resnet()
    n, b = GRAPHS["check_steps"], RESNET_TRAIN["batch"]
    # two eager steps from one state, cuDNN's default algorithms
    one, two = fused.clone(), fused.clone()
    one.fit(ds, cudaGraphs=False)
    two.fit(ds, cudaGraphs=False)
    pairs = list(zip(tensor_leaves(one._params), tensor_leaves(two._params)))
    eager_unequal = sum(not torch.equal(x, y) for x, y in pairs)
    eager_diff = max((x - y).abs().max().item() for x, y in pairs)
    log(f"[graphs] fit: two eager steps from one state, default cuDNN: "
        f"{eager_unequal} of {len(pairs)} parameter tensors differ, by at "
        f"most {eager_diff:.3e}")
    del one, two, pairs
    torch.backends.cudnn.deterministic = True
    try:
        graph, eager = fused.clone(), fused.clone()
        graph.fit([ds] * n)
        eager.fit([ds] * n, prefetch=0, cudaGraphs=False)
        torch.cuda.synchronize()
        unequal = {what: sum(not torch.equal(x, y) for x, y in zip(
            tensor_leaves(getattr(graph, attr)),
            tensor_leaves(getattr(eager, attr))))
            for what, attr in (("parameters", "_params"),
                               ("optimizer state", "_opt_state"),
                               ("BN state", "_state"))}
        scores = (graph.score(), eager.score())
        st = graph.fit_status()
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"[graphs] fit ResNet-50 B={b}, {n} steps, cuDNN deterministic: "
        f"graph vs eager tensors not bit-identical {unequal}; loss "
        f"{scores[0]!r} vs {scores[1]!r}; graph store: {st['captures']} "
        f"capture, {st['replays']} replays, {st['degradations']} "
        f"degradations")
    if any(unequal.values()) or scores[0] != scores[1] or (
            st["captures"], st["replays"], st["degradations"]) != (
                1, n - 1, 0):
        raise AssertionError(f"graphs: the fit step's replays differ from "
                             f"the eager steps: {unequal}, {scores}, {st}")
    del graph, eager
    nets = {"eager": fused.clone(), "graph": fused.clone()}
    del fused
    for arm, net in nets.items():
        net.fit([ds] * RESNET_TRAIN["warmup"], cudaGraphs=arm == "graph")
    torch.cuda.synchronize()
    runs = []
    steps = GRAPHS["steps"]
    for arm, prefetch in FIT_ARMS:
        net = nets[arm]
        _reset_counts()
        t0 = time.perf_counter()
        net.fit([ds] * steps, prefetch=prefetch, cudaGraphs=arm == "graph")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        per_step = {k: launches[k] / steps for k in TRAIN_KERNELS}
        loss = net.score()
        st = net.fit_status()
        runs.append({"arm": arm, "prefetch": prefetch,
                     "ms_per_step": wall * 1e3 / steps,
                     "images_per_s": b * steps / wall, "loss": loss,
                     "launches_per_step": per_step,
                     "replays": None if st is None else st["replays"]})
        log(f"[graphs] fit {arm} (prefetch {prefetch}): "
            f"{wall * 1e3 / steps:.2f} ms/step, {b * steps / wall:.1f} "
            f"images/s, loss {loss:.4f}; launches per step {per_step}")
        if any(v != EPILOGUE_PAIRS for v in per_step.values()) or \
                not np.isfinite(loss):
            raise AssertionError(f"graphs: fit {arm}: {runs[-1]}")
    st = nets["graph"].fit_status()
    if st["captures"] != 1:
        raise AssertionError(f"graphs: the fit step was captured again: "
                             f"{st}")
    _store_clean(st, "fit")
    return {"bit_identity": {"steps": n, "unequal": unequal,
                             "scores": scores,
                             "eager_default_cudnn_unequal": eager_unequal,
                             "eager_default_cudnn_max_diff": eager_diff},
            "runs": runs, "store": {k: st[k] for k in (
                "captures", "replays", "degradations", "eager_calls")}}


def _graphs_inference(cache_dir):
    fused, plain = _resnet_nets()
    del plain
    sizes, images = _resnet_requests()
    n_img = int(sum(sizes))
    want = np.concatenate([fused.output(images[i:i + RESNET["batch"]])
                           .cpu().numpy()
                           for i in range(0, n_img, RESNET["batch"])])
    scale = float(np.abs(want).max())
    # each bucket's replay against the eager forward at the same rows
    store = ExecutableStore(fused)
    buckets = GRAPHS["buckets"]
    feat = images.shape[1:]
    store.warmup([(((bk, *feat), "float32"),) for bk in buckets])
    unequal = []
    for bk in buckets:
        sig = (((bk, *feat), "float32"),)
        x = images[:bk]
        (static,) = store.ensure(sig)
        static.copy_(torch.as_tensor(x, device=DEV))
        got = store.run(("forward", sig))
        if not torch.equal(got, fused.output(x)):
            unequal.append(bk)
    log(f"[graphs] inference buckets {buckets}: replay vs eager forward "
        f"on the same rows, not bit-identical: {unequal or 'none'}")
    if unequal:
        raise AssertionError(f"graphs: buckets {unequal} differ from the "
                             f"eager forward")
    # one B=32 forward, eager against its graph, in turns
    x = torch.as_tensor(images[:RESNET["batch"]], device=DEV)
    sig = (((RESNET["batch"], *feat), "float32"),)
    (static,) = store.ensure(sig)

    def replay():
        static.copy_(x)
        return store.run(("forward", sig))

    forward = []
    for arm in ARMS:
        fn = replay if arm == "graph" else (lambda: fused.output(x))
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(GRAPHS["forwards"]):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        forward.append({"arm": arm, "ms": float(np.mean(times)),
                        "min_ms": float(np.min(times))})
    log("[graphs] one B=32 forward (host clock, mean / min of "
        f"{GRAPHS['forwards']}): " + ", ".join(
            f"{r['arm']} {r['ms']:.3f} / {r['min_ms']:.3f} ms"
            for r in forward))
    del store
    # the 96 images through ParallelInference, eager against the ladder
    runs = []
    for arm in ARMS:
        graph = arm == "graph"
        answers, lat, wall, launches, calls, info = _serve_resnet(
            fused, images, sizes, ladder=buckets if graph else None,
            cache_dir=cache_dir)
        got = np.concatenate(answers)
        err = float(np.abs(got - want).max())
        lat_ms = np.asarray(lat) * 1e3
        st = info["status"]
        run = {"arm": arm, "wall_s": wall, "images_per_s": n_img / wall,
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99)),
               "forwards": calls, "max_abs_err": err,
               "matmul_epilogue": launches["matmul_epilogue"],
               "warmup": info.get("warmup"),
               "aot_fallbacks": st["aot_fallbacks"]}
        log(f"[graphs] inference {arm}: {n_img} images, {calls} forwards, "
            f"{wall:.3f} s = {n_img / wall:.1f} images/s; p50 "
            f"{run['p50_ms']:.2f} ms p99 {run['p99_ms']:.2f} ms; "
            f"matmul_epilogue launches {launches['matmul_epilogue']}; "
            f"max |answer - net.output| = {err:.3e} of max {scale:.3e}"
            + (f"; warmup {info['warmup']}" if graph else ""))
        if got.shape != (n_img, 1000) or not err <= RESNET_RTOL * scale:
            raise AssertionError(f"graphs: inference {arm} answers differ "
                                 f"from net.output by {err}")
        if launches["matmul_epilogue"] != EPILOGUE_PAIRS * calls:
            raise AssertionError(f"graphs: inference {arm}: "
                                 f"{launches['matmul_epilogue']} epilogue "
                                 f"launches over {calls} forwards")
        if graph:
            _store_clean(st["executables"], "inference")
            if st["aot_fallbacks"]:
                raise AssertionError(f"graphs: inference fell back: "
                                     f"{st['aot_error']}")
        runs.append(run)
    first, second = runs[1]["warmup"], runs[2]["warmup"]
    # a store given no signature captures what the manifest records
    third = ExecutableStore(fused, directory=cache_dir).warmup([])
    torch.cuda.synchronize()
    log(f"[graphs] inference disk tier: first warmup {first}; second "
        f"(same directory) {second}; a store given no signature warms "
        f"the manifest's {third}")
    if (first["compiled"], first["from_disk"]) != (len(buckets), 0) or (
            second["compiled"], second["from_disk"],
            second["nvcc_runs"]) != (0, len(buckets), 0) or (
            third["keys"], third["from_disk"], third["compiled"],
            third["nvcc_runs"]) != (len(buckets), len(buckets), 0, 0):
        raise AssertionError(f"graphs: the inference store's disk tier: "
                             f"{first} then {second} then {third}")
    return {"buckets": buckets, "forward": forward, "runs": runs,
            "manifest_warmup": third}


def phase_graphs(cfg, params):
    """The three capture targets against their eager runs."""
    cache = OUT_DIR / "exec_cache"
    shutil.rmtree(cache, ignore_errors=True)
    out = {"serving": _graphs_serving(cfg, params, str(cache / "serving")),
           "fit": _graphs_fit(),
           "inference": _graphs_inference(str(cache / "inference"))}
    shutil.rmtree(cache, ignore_errors=True)
    return out


# -- phase 10: paged, int8 and drafting serving ----------------------------------
#: the paged server: phase 5's knobs, pages of 16 rows, and a pool of 129
#: pages (128 allocatable: half the dense worst case of 8 slots x 32 pages)
PAGED = dict(page_size=16, pool_pages=129, draft=2, steps=16)


def _greedy_continuation(cfg, params, prompt, n):
    """The first n greedy tokens after `prompt`, by the causal full
    forward."""
    ids = [int(t) for t in prompt]
    for _ in range(n):
        h = bert_encode(cfg, params, torch.as_tensor(ids, device=DEV)[None],
                        causal=True)
        ids.append(int(bert_mlm_logits(cfg, params, h[0, -1]).argmax()))
    return ids[len(prompt):]


def _draft_prompt(cfg, params, tries=16, rounds=6):
    """A prompt A + C + B of 113 tokens that holds its own continuation:
    C is the first three greedy tokens after A + C + B, found by iterating
    C to a fixed point. Prompt lookup then drafts C[1:] right after the
    prefill's token C[0]. Random weights seldom repeat a token, so without
    it drafting has nothing to accept."""
    rng = np.random.default_rng(6)
    for attempt in range(tries):
        a = rng.integers(1, cfg.vocab_size, 60)
        b = rng.integers(1, cfg.vocab_size, 50)
        c = _greedy_continuation(cfg, params, np.concatenate([a, b]), 3)
        for r in range(rounds):
            prompt = np.concatenate([a, c, b])
            nxt = _greedy_continuation(cfg, params, prompt, 3)
            if nxt == c:
                log(f"[paged] draft prompt: attempt {attempt}, round {r}, "
                    f"holds its continuation {c}")
                return prompt
            c = nxt
    raise AssertionError("paged: no prompt held its own continuation")


def _paged_requests(cfg, params):
    """12 requests: six share a 64-token system prompt (4 full pages) with
    distinct suffixes; requests 6 and 7 are identical (their tail page is
    shared, then copied on write); prompts run 5-120 tokens with 32-64 new
    tokens, greedy / temperature 0.8 / top-k 40 in turn; request 3 needs
    120 + 64 rows, so the cache grows to rung 512. Greedy request 9's
    prompt is `_draft_prompt`'s, which the drafting server drafts from."""
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, 64)
    twin = rng.integers(1, cfg.vocab_size, 37)
    reqs = []
    for i in range(12):
        if i < 6:
            plen = 120 if i == 3 else int(rng.integers(69, 121))
            prompt = np.concatenate(
                [system, rng.integers(1, cfg.vocab_size, plen - 64)])
        elif i < 8:
            prompt = twin
        else:
            plen = 5 if i == 8 else int(rng.integers(5, 121))
            prompt = rng.integers(1, cfg.vocab_size, plen)
        new = 64 if i == 3 else int(rng.integers(32, 65))
        mode = ("greedy", "temperature", "top_k")[i % 3]
        if i == 9:
            prompt = _draft_prompt(cfg, params)
        reqs.append(dict(prompt=prompt, max_new_tokens=new, method=mode,
                         temperature=0.8,
                         top_k=40 if mode == "top_k" else 0))
    assert any(len(r["prompt"]) + r["max_new_tokens"] > 128 for r in reqs)
    return reqs


def _top2_gap(cfg, params, prompt, stream, j):
    """The margin of the greedy choice at generated token j: top-1 minus
    top-2 logit of the causal full forward over prompt + stream[:j]."""
    ids = torch.as_tensor(np.concatenate([prompt, stream[:j]]),
                          device=DEV)[None]
    h = bert_encode(cfg, params, ids, causal=True)
    top = bert_mlm_logits(cfg, params, h[0, -1]).topk(2).values
    return float(top[0] - top[1])


def _paged_server(cfg, params, reqs, what, check_launches=False, **kw):
    """One server over `reqs`: warmed up, counters at 0, every request
    through it, its store held clean; returns its run."""
    dkw = {k: kw.pop(k) for k in ("kv_dtype", "page_size", "pool_pages")
           if k in kw}
    srv = GenerationServer(BertDecoder(cfg, params, **dkw),
                           **{**SERVER, **kw})
    try:
        srv.warmup()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        streams = [h.result(timeout=600)
                   for h in [srv.submit(**r) for r in reqs]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    # after the shutdown, which delivers the block still in flight: every
    # dispatched block is counted in the launches and in the status
    launches = _counts()
    st = srv.status()
    ntok = sum(len(s) for s in streams)
    run = {"server": what, "wall_s": wall, "tokens": ntok,
           "tokens_per_s": ntok / wall, "blocks": st["steps"],
           "admissions": st["admissions"],
           "token_fetches": st["token_fetches"],
           "per_token_p50_ms": st["per_token_p50_ms"],
           "per_token_p99_ms": st["per_token_p99_ms"],
           "launches": {k: launches[k] for k in ("flash_fwd",
                                                 "flash_decode")},
           "page_pool": st.get("page_pool"),
           "draft_accepts": st["draft_accepts"],
           "draft_rejects": st["draft_rejects"], "streams": streams}
    log(f"[paged] {what}: {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tokens/s; per-token p50 "
        f"{st['per_token_p50_ms']:.3f} ms p99 {st['per_token_p99_ms']:.3f} "
        f"ms; {st['steps']} blocks, {st['admissions']} admissions, "
        f"{st['token_fetches']} token fetches, rung {st['rung']}; launches "
        f"{run['launches']}" + (f"; pool {st['page_pool']}"
                                if st.get("page_pool") else "")
        + (f"; drafts accepted {st['draft_accepts']} rejected "
           f"{st['draft_rejects']}" if st["draft"] else ""))
    _store_clean(st["executables"], what)
    _fault_free(st, f"paged: {what}")
    if st["rung"] != 512:
        raise AssertionError(f"paged: {what} never grew to rung 512")
    if check_launches:
        missing = [k for k, n in run["launches"].items() if n == 0]
        if missing:
            raise AssertionError(f"paged: {what} never launched {missing}")
    return run


def _same(what, reqs, got, want, only=None):
    """Streams that must be equal (all, or those of the `only` indices)."""
    idx = range(len(reqs)) if only is None else only
    diff = [i for i in idx if got[i] != want[i]]
    if diff:
        raise AssertionError(f"paged: {what}: streams {diff} differ")


def _paged_exhaustion(cfg, params):
    """A pool of 3 pages (2 usable, 32 rows) at one rung of 128: a 3-page
    prompt is refused typed before dispatch, the server stays up and
    serves a 1-page prompt."""
    srv = GenerationServer(
        BertDecoder(cfg, params, page_size=PAGED["page_size"],
                    pool_pages=3),
        **{**SERVER, "cache_lengths": [128]})
    try:
        srv.warmup()
        rng = np.random.default_rng(4)
        big = srv.submit(rng.integers(1, cfg.vocab_size, 40),
                         max_new_tokens=8)
        try:
            big.result(timeout=600)
            raise AssertionError("paged: a 3-page prompt was admitted into "
                                 "a pool of 2 pages")
        except PagePoolExhaustedError as e:
            refused = repr(e)
        state = srv.serving_state()["state"]
        small = srv.generate(rng.integers(1, cfg.vocab_size, 9),
                             max_new_tokens=16, timeout=600)
        st = srv.status()
    finally:
        srv.shutdown()
    log(f"[paged] exhaustion: pool of 3 pages refused a 3-page prompt "
        f"({refused}); state {state}; then served a 1-page prompt "
        f"({len(small)} tokens); pool {st['page_pool']}")
    if state != "serving" or len(small) != 16:
        raise AssertionError(f"paged: exhaustion left the server {state}, "
                             f"{len(small)} tokens")
    _store_clean(st["executables"], "exhaustion")
    return {"refused": refused, "served_tokens": len(small),
            "page_pool": st["page_pool"]}


def _int8_logit_error(cfg, params):
    """int8 against fp decode of one prompt over PAGED['steps'] steps on
    the fp server's greedy tokens: the max relative logit error and the
    greedy agreement (printed, not gated)."""
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, 40),
                             device=DEV)
    padded = torch.cat([prompt, prompt.new_zeros(24)])
    decs = [BertDecoder(cfg, params), BertDecoder(cfg, params,
                                                  kv_dtype="int8")]
    caches = [d.init_cache(1, 128) for d in decs]
    logits = [d.prefill(d.model_args(), c, 0, padded, 40)[1][None]
              for d, c in zip(decs, caches)]
    pos = torch.tensor([40], device=DEV)
    err, agree = 0.0, 0
    for _ in range(PAGED["steps"]):
        err = max(err, ((logits[1] - logits[0]).abs().max()
                        / logits[0].abs().max()).item())
        agree += int(logits[1].argmax() == logits[0].argmax())
        tok = logits[0].argmax(dim=-1)
        logits = [d.step(d.model_args(), c, tok, pos)[0]
                  for d, c in zip(decs, caches)]
        pos = pos + 1
    log(f"[paged] int8 against fp decode, one 40-token prompt, "
        f"{PAGED['steps']} steps: max relative logit error {err:.3e}, "
        f"greedy agreement {agree}/{PAGED['steps']}")
    return {"max_rel_logit_err": err, "greedy_agree": agree,
            "steps": PAGED["steps"]}


def _paged_attention_times(cfg):
    """Card times of the plain-PyTorch pieces of the paged and int8 decode,
    beside flash_decode on the same rows: one layer at serving's decode
    shape (8 slots, 12 heads, C = 512, D = 64, f32), the gathers reading
    a pool of 257 pages of 16 rows (the kernel phase's decode case)."""
    b, h, c, d, ps = SERVER["slots"], cfg.num_heads, 512, cfg.head_dim, \
        PAGED["page_size"]
    n = c // ps
    gen = torch.Generator(device=DEV).manual_seed(9)
    kp = torch.randn((b * n + 1, h, ps, d), generator=gen, device=DEV)
    vp = torch.randn_like(kp)
    tab = (torch.randperm(b * n, generator=gen, device=DEV) + 1).reshape(
        b, n)
    q = torch.randn((b, h, 1, d), generator=gen, device=DEV)
    qm = torch.randn((b, h, PAGED["draft"] + 1, d), generator=gen,
                     device=DEV)
    mask = torch.ones((b, c), dtype=torch.bool, device=DEV)
    qmask = torch.ones((b, PAGED["draft"] + 1, c), dtype=torch.bool,
                       device=DEV)
    kc, vc = gather_kv_pages(kp, tab), gather_kv_pages(vp, tab)
    (k8, ks), (v8, vs) = quantize_rows(kc), quantize_rows(vc)
    kp8, ksp = quantize_rows(kp)
    vp8, vsp = quantize_rows(vp)
    f32 = 4
    rows = b * h * c
    cases = {
        "flash_decode (dense view)": (
            lambda: flash_decode(q, kc, vc, mask), 2 * rows * d * f32),
        "gather K and V pages": (
            lambda: (gather_kv_pages(kp, tab), gather_kv_pages(vp, tab)),
            4 * rows * d * f32),
        "paged fp decode (gather + flash_decode)": (
            lambda: flash_attention_decode_paged(q, kp, vp, tab, mask),
            2 * rows * d * f32),
        "int8 decode (scale-folding einsum)": (
            lambda: flash_attention_decode(q, k8, v8, mask, k_scale=ks,
                                           v_scale=vs),
            2 * rows * (d + f32)),
        "paged int8 decode (gathers + einsum)": (
            lambda: flash_attention_decode_paged(
                q, kp8, vp8, tab, mask, k_scale_pool=ksp,
                v_scale_pool=vsp), 2 * rows * (d + f32)),
        f"verify attention d={PAGED['draft'] + 1} (multi-query einsum)": (
            lambda: flash_attention_decode_mq(qm, kc, vc, qmask),
            2 * rows * d * f32),
    }
    out = {}
    for name, (fn, nbytes) in cases.items():
        ms = time_ms(fn)
        lo = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "bound_ms": lo, "bytes": nbytes}
        log(f"[paged] {name} 8x12 C=512 D=64: {ms:.4f} ms, bytes bound "
            f"{lo:.5f} ms")
    return out


def phase_paged(cfg, params):
    """bert_base served from a page pool (fp and int8) and with greedy
    drafting, each against its dense counterpart, the dense fp server in
    turns as the control; pool exhaustion on a small pool; the int8 codec's
    logit error; the card times of the paged and int8 attention pieces."""
    reqs = _paged_requests(cfg, params)
    greedy = [i for i, r in enumerate(reqs) if r["method"] == "greedy"]
    pg = dict(page_size=PAGED["page_size"], pool_pages=PAGED["pool_pages"])
    runs = [_paged_server(cfg, params, reqs, "dense fp (control)")]
    runs.append(_paged_server(cfg, params, reqs, "paged fp",
                              check_launches=True, **pg))
    _same("paged fp against dense fp", reqs, runs[1]["streams"],
          runs[0]["streams"])
    occ = runs[1]["page_pool"]
    if occ["prefix_hits"] < 5 or occ["cow_copies"] < 1 \
            or occ["pages_mapped"] != 0:
        raise AssertionError(f"paged: pool counters {occ}")
    runs.append(_paged_server(cfg, params, reqs, "dense int8",
                              kv_dtype="int8"))
    runs.append(_paged_server(cfg, params, reqs, "paged int8",
                              kv_dtype="int8", **pg))
    _same("paged int8 against dense int8", reqs, runs[3]["streams"],
          runs[2]["streams"])
    runs.append(_paged_server(cfg, params, reqs, "paged fp, draft=2",
                              draft=PAGED["draft"], superstep=1, **pg))
    draft = runs[-1]
    diff = [i for i in greedy if draft["streams"][i] != runs[0]["streams"][i]]
    if diff:
        i = diff[0]
        a, b = draft["streams"][i], runs[0]["streams"][i]
        j = next(t for t in range(len(b)) if a[t] != b[t])
        gap = _top2_gap(cfg, params, reqs[i]["prompt"], b, j)
        raise AssertionError(f"paged: drafted greedy streams {diff} differ "
                             f"from the undrafted ones; request {i} first "
                             f"at token {j} ({a[j]} against {b[j]}), whose "
                             f"top-2 logit gap is {gap:.3e}")
    if draft["draft_accepts"] <= 0:
        raise AssertionError("paged: the drafting server accepted no draft")
    sampled_same = sum(draft["streams"][i] == runs[0]["streams"][i]
                       for i in range(len(reqs)) if i not in greedy)
    runs.append(_paged_server(cfg, params, reqs, "dense fp (control, "
                              "again)"))
    _same("the two dense fp controls", reqs, runs[-1]["streams"],
          runs[0]["streams"])
    int8_vs_fp = sum(runs[2]["streams"][i] == runs[0]["streams"][i]
                     for i in greedy)
    log(f"[paged] greedy streams: paged fp = dense fp, paged int8 = dense "
        f"int8 (all 12 each), drafted = undrafted {len(greedy)}/"
        f"{len(greedy)}; drafted sampled streams equal to undrafted "
        f"{sampled_same}/{len(reqs) - len(greedy)}; int8 greedy streams "
        f"equal to fp {int8_vs_fp}/{len(greedy)}")
    layers, heads, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    pool_bytes = {kv: PAGED["pool_pages"] * cache_page_bytes(
        layers, heads, PAGED["page_size"], hd, kv) for kv in ("fp", "int8")}
    rows = SERVER["slots"] * sum(SERVER["cache_lengths"])
    dense_bytes = {kv: rows // PAGED["page_size"] * cache_page_bytes(
        layers, heads, PAGED["page_size"], hd, kv) for kv in ("fp", "int8")}
    log(f"[paged] cache bytes: pool of {PAGED['pool_pages']} pages fp "
        f"{pool_bytes['fp']} / int8 {pool_bytes['int8']}; dense caches "
        f"(8 slots, rungs 128 + 512) fp {dense_bytes['fp']} / int8 "
        f"{dense_bytes['int8']}")
    exhaustion = _paged_exhaustion(cfg, params)
    int8_err = _int8_logit_error(cfg, params)
    times = _paged_attention_times(cfg)
    for r in runs:
        del r["streams"]
    return {"runs": runs, "exhaustion": exhaustion, "int8_logits": int8_err,
            "attention_ms": times, "pool_bytes": pool_bytes,
            "dense_cache_bytes": dense_bytes,
            "drafted_sampled_identical": sampled_same,
            "int8_greedy_equal_fp": int8_vs_fp}


# -- phase 11: chaos ----------------------------------------------------------
#: the chaos phase: phase 5's server and 12 requests, f32, through the
#: graphs. Fault calls count visits to each site in one run: admissions
#: 1-8 fill the 8 slots, blocks are numbered from the first.
CHAOS = dict(kill_blocks=(3, 9), kill_admission=4, relief_steps=32,
             budget_attempts=2, release_s=1.0,
             monitoring_arms=("off", "on", "on", "off") * 2)


def _cuda_oom(site, call_n):
    """An OOM of the shape torch.cuda.OutOfMemoryError reports."""
    return RuntimeError(f"CUDA out of memory. Tried to allocate 2.00 GiB "
                        f"(injected at {site}, call {call_n})")


def _stamped(make, stamps):
    """A FaultPlan exception factory that notes when each fault fired."""
    def exc(site, call_n):
        stamps.append((time.perf_counter(), site, call_n))
        return make(site, call_n)
    return exc


def _chaos_server(cfg, params, reqs, what, plan=None, dec_kw=None,
                  monitoring=False, stamps=False, after_warmup=None,
                  **kw):
    """One server over `reqs`, warmed up, counters at 0, with `plan`
    installed around the workload; each request resolves to its stream or
    its exception. Returns the run, with the store's counters after the
    warm-up and at the end."""
    srv = GenerationServer(BertDecoder(cfg, params, **(dec_kw or {})),
                           **{**SERVER, **kw})
    mon.disable()
    ev.reset()
    delivered = []
    try:
        srv.warmup()
        torch.cuda.synchronize()
        if after_warmup is not None:
            after_warmup(srv)
        warm = dict(srv._store.stats)
        if monitoring:
            mon.enable()
        _reset_counts()
        t0 = time.perf_counter()
        if plan is not None:
            faults.install_plan(plan)
        try:
            hs = []
            for i, r in enumerate(reqs):
                cb = ((lambda tok, i=i: delivered.append(
                    (time.perf_counter(), i))) if stamps else None)
                hs.append(srv.submit(**r, on_token=cb))
            out = []
            for h in hs:
                try:
                    out.append(h.result(timeout=600))
                except Exception as e:  # noqa: BLE001 — gated by callers
                    out.append(e)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            faults.clear_plan()
        events = ev.snapshot(last=None)["events"]
        state = srv.serving_state()
    finally:
        mon.disable()
        srv.shutdown()
    launches = _counts()
    st = srv.status()
    ntok = sum(len(s) for s in out if isinstance(s, list))
    run = {"server": what, "wall_s": wall, "tokens": ntok,
           "tokens_per_s": ntok / wall,
           "per_token_p50_ms": st["per_token_p50_ms"],
           "per_token_p99_ms": st["per_token_p99_ms"],
           "launches": {k: launches[k] for k in ("flash_fwd",
                                                 "flash_decode")},
           **{k: st[k] for k in ("steps", "admissions", "replays",
                                 "restarts", "errors", "degradations",
                                 "blocks_dropped", "token_fetches")},
           "state": state, "store_after_warmup": warm,
           "store": st["executables"], "fired": (None if plan is None
                                                 else dict(plan.fired))}
    log(f"[chaos] {what}: {ntok} tokens in {wall:.3f} s = "
        f"{ntok / wall:.1f} tokens/s; {st['steps']} blocks, "
        f"{st['admissions']} admissions, {st['replays']} replays, "
        f"{st['restarts']} restarts, {st['blocks_dropped']} blocks dropped, "
        f"{st['token_fetches']} fetches; state {state['state']}; launches "
        f"{run['launches']}" + (f"; fired {run['fired']}" if plan else ""))
    return run, out, events, delivered, srv, hs


def _recovery_clean(run, what):
    """No capture, rebind, degradation, live capture or eager call after
    the warm-up: recovery ran from the warm graphs; and each fetch is a
    delivered block, an admission or a replay."""
    a, b = run["store_after_warmup"], run["store"]
    moved = {k: b[k] - a[k] for k in ("captures", "rebinds",
                                      "degradations", "live_captures",
                                      "eager_calls", "compiled")
             if b[k] != a[k]}
    if moved or not b["capture"] or b["replays"] == a["replays"]:
        raise AssertionError(f"chaos: {what}: the store moved after its "
                             f"warm-up: {moved or b}")
    want = run["steps"] + run["admissions"] + run["replays"]
    if run["token_fetches"] != want:
        raise AssertionError(f"chaos: {what}: {run['token_fetches']} "
                             f"fetches for {want} blocks, admissions and "
                             f"replays")


def _streams_equal(what, got, want, only=None):
    idx = range(len(want)) if only is None else only
    bad = [i for i in idx if got[i] != want[i]]
    if bad:
        raise AssertionError(f"chaos: {what}: streams {bad} differ from "
                             f"the fault-free run's ({got[bad[0]]!r})")


def _replay_points(events, handles):
    """(request index, mode, delivered) of each SERVER_REPLAY event."""
    index = {h.trace_id: i for i, h in enumerate(handles)}
    return [(index.get(e["attrs"]["request"]), e["attrs"]["mode"],
             e["attrs"]["delivered"]) for e in events
            if e["kind"] == ev.SERVER_REPLAY]


@torch.no_grad()
def _replay_logit_gap(cfg, params, req, stream, g):
    """At a prefix replay point (g tokens delivered): the logits of token
    g as the uninterrupted run computed them — a prefill, then g decode
    steps through flash_decode — against the replay's prefill of
    prompt + stream[:g] through flash_fwd. Returns the largest |Δlogit|
    and the top-1 minus top-2 margin of the decode path's logits."""
    dec = BertDecoder(cfg, params)
    margs = dec.model_args()
    prompt = np.asarray(req["prompt"], np.int64)
    plen = len(prompt)
    rung = next(c for c in SERVER["cache_lengths"]
                if c >= plen + req["max_new_tokens"])

    def prefill(ids):
        bucket = next(p for p in SERVER["prompt_buckets"] if p >= len(ids))
        padded = np.zeros(bucket, np.int64)
        padded[:len(ids)] = ids
        cache = dec.init_cache(1, rung)
        _, logits = dec.prefill(margs, cache, 0,
                                torch.as_tensor(padded, device=DEV),
                                len(ids))
        return cache, logits

    cache, _ = prefill(prompt)
    for j in range(g):
        tok = torch.tensor([stream[j]], device=DEV)
        pos = torch.tensor([plen + j], device=DEV)
        step_logits, cache = dec.step(margs, cache, tok, pos)
    _, replay_logits = prefill(np.concatenate([prompt, stream[:g]]))
    a, b = step_logits[0].float(), replay_logits.float()
    top = a.topk(2).values
    return float((a - b).abs().max()), float(top[0] - top[1])


def _case_line(case, run, keys):
    """One JSON line for a chaos case: the numbers that its gate read."""
    print(json.dumps({"chaos": case, **{k: run.get(k) for k in keys}},
                     default=str), flush=True)


def _chaos_kills(cfg, params, reqs, want):
    """Two block kills and one admission kill on the dense server."""
    stamps = []
    exc = _stamped(faults._default_exc, stamps)
    plan = faults.FaultPlan(seed=12)
    for n in CHAOS["kill_blocks"]:
        plan.fail_at(faults.GENERATION_SUPERSTEP, n, exc=exc)
    plan.fail_at(faults.GENERATION_ADMIT, CHAOS["kill_admission"], exc=exc)
    run, out, events, delivered, srv, hs = _chaos_server(
        cfg, params, reqs, "dense kills", plan=plan, monitoring=True,
        stamps=True)
    _streams_equal("dense kills", out, want)
    _recovery_clean(run, "dense kills")
    if run["fired"] != {faults.GENERATION_SUPERSTEP: 2,
                        faults.GENERATION_ADMIT: 1}:
        raise AssertionError(f"chaos: dense kills fired {run['fired']}")
    if not 1 <= run["blocks_dropped"] <= 2:
        raise AssertionError(f"chaos: dense kills dropped "
                             f"{run['blocks_dropped']} blocks")
    missing = [k for k, n in run["launches"].items() if n == 0]
    if missing:
        raise AssertionError(f"chaos: dense kills never launched {missing}")
    recovery_ms = []
    for t, site, call_n in stamps:
        after = [d for d, _ in delivered if d > t]
        if not after:
            raise AssertionError(f"chaos: no token after the fault at "
                                 f"{site} call {call_n}")
        recovery_ms.append({"site": site, "call": call_n,
                            "ms": (min(after) - t) * 1e3})
    points = _replay_points(events, hs)
    modes = {m: sum(1 for _, mm, _ in points if mm == m)
             for m in ("prefix", "regenerate")}
    if len(points) != run["replays"] or None in [i for i, _, _ in points]:
        raise AssertionError(f"chaos: replay events {points} against "
                             f"{run['replays']} replays")
    gaps = []
    for i, mode, g in points:
        if mode != "prefix" or g == 0:
            continue
        err, margin = _replay_logit_gap(cfg, params, reqs[i], want[i], g)
        gaps.append({"request": i, "delivered": g, "max_abs_dlogit": err,
                     "decode_top2_margin": margin})
    kinds = [e["kind"] for e in events]
    if ev.SERVER_DISRUPTED not in kinds or ev.SERVER_RECOVERED not in kinds:
        raise AssertionError(f"chaos: dense kills emitted {kinds}")
    run.update(recovery_ms=recovery_ms, replay_modes=modes,
               replay_points=[list(p) for p in points],
               replay_logit_gaps=gaps,
               max_abs_dlogit=max((x["max_abs_dlogit"] for x in gaps),
                                  default=None))
    log(f"[chaos] dense kills: streams equal the fault-free run's; "
        f"replays {modes}; fault to next delivered token "
        + ", ".join(f"{r['site']}#{r['call']} {r['ms']:.2f} ms"
                    for r in recovery_ms)
        + f"; largest |dlogit| at {len(gaps)} prefix replay points "
        f"{run['max_abs_dlogit']}; store after warm-up: no capture, "
        f"rebind, degradation or eager call")
    return run


def _chaos_paged(cfg, params, reqs, want):
    """A cache.page fault mid-stream on the paged server."""
    plan = faults.FaultPlan(seed=13).fail_at(faults.CACHE_PAGE, 20)
    run, out, _, _, _, _ = _chaos_server(
        cfg, params, reqs, "paged cache.page kill", plan=plan,
        dec_kw=dict(page_size=PAGED["page_size"],
                    pool_pages=PAGED["pool_pages"]))
    _streams_equal("paged kill", out, want)
    _recovery_clean(run, "paged kill")
    mapped = run["state"]["page_pool"]["pages_mapped"]
    if run["fired"] != {faults.CACHE_PAGE: 1} or run["replays"] < 1 \
            or mapped != 0:
        raise AssertionError(f"chaos: paged kill fired {run['fired']}, "
                             f"{run['replays']} replays, {mapped} pages "
                             f"mapped at the end")
    return run


def _chaos_ladder(cfg, params, reqs, want):
    """An OOM-shaped fault at the growth to rung 512: the growing request
    is refused typed, the rest are served, and the pressure relieves."""
    plan = faults.FaultPlan(seed=14).fail_at(faults.CACHE_GROW, 1,
                                             exc=_cuda_oom)
    run, out, _, _, srv, _ = _chaos_server(
        cfg, params, reqs, "ladder (OOM at growth)", plan=plan,
        pressure_relief_steps=CHAOS["relief_steps"],
        pressure_relief_secs=None)
    refused = [i for i, s in enumerate(out)
               if isinstance(s, MemoryPressureError)]
    other = [i for i, s in enumerate(out)
             if not isinstance(s, (list, MemoryPressureError))]
    served = [i for i, s in enumerate(out) if isinstance(s, list)]
    _streams_equal("ladder", out, want, only=served)
    if 3 not in refused or other or run["degradations"] < 2 \
            or run["state"]["state"] != "serving" \
            or run["state"]["pressure"] != 0:
        raise AssertionError(f"chaos: ladder refused {refused}, other "
                             f"errors {other}, state {run['state']}")
    run.update(refused=refused, served=len(served))
    log(f"[chaos] ladder: requests {refused} refused typed "
        f"(MemoryPressureError), {len(served)} served equal to the "
        f"fault-free run; {run['degradations']} degradations; relieved to "
        f"{run['state']['state']} after {CHAOS['relief_steps']} clean "
        f"tokens")
    return run


def _chaos_high_water(cfg, params, reqs, want):
    """memory_high_water just under the reading after the warm-up: the
    telemetry refuses the growth to rung 512."""
    reading = {}

    def set_mark(srv):
        stats = next(iter(_mem.device_memory_stats(srv.device).values()))
        reading.update(stats)
        reading["fraction"] = stats["bytes_in_use"] / stats["bytes_limit"]
        srv.memory_high_water = reading["fraction"] - 1e-3

    run, out, _, _, _, _ = _chaos_server(
        cfg, params, reqs, "high water", after_warmup=set_mark,
        pressure_relief_steps=1 << 30, pressure_relief_secs=None)
    refused = [i for i, s in enumerate(out)
               if isinstance(s, MemoryPressureError)
               and "high-water" in str(s)]
    served = [i for i, s in enumerate(out) if isinstance(s, list)]
    _streams_equal("high water", out, want, only=served)
    if 3 not in refused or len(refused) + len(served) != len(reqs) \
            or run["errors"] or run["state"]["state"] != "degraded":
        raise AssertionError(f"chaos: high water refused {refused}, "
                             f"served {served}, {run['errors']} errors, "
                             f"state {run['state']}")
    run.update(refused=refused, served=len(served), reading=reading)
    log(f"[chaos] high water: device memory after the warm-up "
        f"{reading['bytes_in_use']} of {reading['bytes_limit']} bytes "
        f"({reading['fraction']:.4f}; allocator: allocated "
        f"{reading.get('allocated_bytes')}, reserved "
        f"{reading.get('reserved_bytes')}); mark set to "
        f"{reading['fraction'] - 1e-3:.4f}: growth refused for {refused}, "
        f"{len(served)} served; state degraded")
    return run


def _chaos_budget(cfg, params, reqs):
    """Every admission faults: the restart budget runs out and latches
    ServerDeadError; every open consumer is released within a second."""
    stamps = []
    plan = faults.FaultPlan(seed=15).every(
        faults.GENERATION_ADMIT, 1, exc=_stamped(faults._default_exc, stamps))
    srv = GenerationServer(BertDecoder(cfg, params), **SERVER,
                           restart_policy=RetryPolicy(
                               max_attempts=CHAOS["budget_attempts"],
                               initial_backoff=0.01, max_backoff=0.02))
    released = [None] * len(reqs)
    try:
        srv.warmup()
        with plan:
            hs = [srv.submit(**r) for r in reqs]

            def consume(i):
                try:
                    for _ in hs[i].stream(timeout=60):
                        pass
                except ServerDeadError:
                    released[i] = time.perf_counter()

            threads = [threading.Thread(target=consume, args=(i,))
                       for i in range(len(hs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
        state = srv.serving_state()["state"]
        restarts = srv.stats["restarts"]
    finally:
        srv.shutdown()
    if None in released or state != "dead":
        raise AssertionError(f"chaos: budget: state {state}, consumers "
                             f"released {released}")
    latest = max(released) - stamps[-1][0]
    log(f"[chaos] restart budget: {len(stamps)} admission faults, "
        f"{restarts} restarts, then ServerDeadError; all {len(hs)} "
        f"consumers released, the last {latest * 1e3:.2f} ms after the "
        f"last fault")
    if latest > CHAOS["release_s"]:
        raise AssertionError(f"chaos: budget: a consumer waited "
                             f"{latest:.3f} s")
    return {"faults": len(stamps), "restarts": restarts,
            "release_ms": latest * 1e3, "state": state}


def phase_chaos(cfg, params):
    """Phase 5's server and workload under injected faults: streams equal
    the fault-free run's, recovery from the warm graphs, the
    memory-pressure ladder, the restart budget, and what monitoring
    costs."""
    torch.cuda.empty_cache()    # earlier phases' cached blocks
    reqs = _requests(cfg)
    arms = []
    for arm in CHAOS["monitoring_arms"]:
        run, out, _, _, _, _ = _chaos_server(
            cfg, params, reqs, f"fault-free, monitoring {arm}",
            monitoring=arm == "on")
        if any(not isinstance(s, list) for s in out):
            raise AssertionError(f"chaos: fault-free run failed: {out}")
        _fault_free(run, f"chaos: fault-free, monitoring {arm}")
        if arms:
            _streams_equal(f"monitoring {arm}", out, arms[0][1])
        run["monitoring"] = arm
        arms.append((run, out))
    want = arms[0][1]
    tps = {a: [r["tokens_per_s"] for r, _ in arms if r["monitoring"] == a]
           for a in ("off", "on")}
    ratio = float(np.median(tps["on"]) / np.median(tps["off"]))
    log(f"[chaos] tokens/s, monitoring off {tps['off']} / on {tps['on']} "
        f"(in turns off, on, on, off, twice); median on / median off "
        f"{ratio:.4f}")
    for run, _ in arms:
        _case_line(f"fault-free, monitoring {run['monitoring']}", run,
                   ("tokens", "wall_s", "tokens_per_s", "per_token_p50_ms",
                    "per_token_p99_ms", "steps", "admissions", "launches"))
    kills = _chaos_kills(cfg, params, reqs, want)
    _case_line("dense kills", kills,
               ("fired", "replays", "replay_modes", "restarts",
                "blocks_dropped", "recovery_ms", "max_abs_dlogit",
                "replay_logit_gaps", "launches", "tokens_per_s"))
    paged = _chaos_paged(cfg, params, reqs, want)
    _case_line("paged cache.page kill", paged,
               ("fired", "replays", "blocks_dropped", "launches",
                "tokens_per_s"))
    ladder = _chaos_ladder(cfg, params, reqs, want)
    _case_line("ladder", ladder, ("fired", "refused", "served",
                                  "degradations", "replays", "state"))
    high = _chaos_high_water(cfg, params, reqs, want)
    _case_line("high water", high, ("refused", "served", "degradations",
                                    "reading", "state"))
    budget = _chaos_budget(cfg, params, reqs)
    _case_line("restart budget", budget, ("faults", "restarts",
                                          "release_ms", "state"))
    return {"monitoring": [r for r, _ in arms], "tokens_per_s": tps,
            "monitoring_on_over_off": ratio,
            "kills": kills, "paged": paged, "ladder": ladder,
            "high_water": high, "budget": budget}


# -- phase 12 (--profile) -----------------------------------------------------
#: kernel-name substrings -> the part of a step they belong to
KERNEL_GROUPS = (("flash_fwd_kernel", "flash_fwd"),
                 ("flash_decode_kernel", "flash_decode"),
                 ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                 ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
                 ("matmul_epilogue_kernel", "matmul_epilogue"),
                 ("bottleneck_block_kernel", "bottleneck_block"),
                 ("matmul_stats_kernel", "matmul_stats"),
                 ("bn_grad_stats_kernel", "bn_grad_stats"),
                 ("bn_conv_grads_kernel", "bn_conv_grads"),
                 ("bn_conv_grads_sum_kernel", "BN partial sums (rows 5/7/8)"),
                 ("sum_partials_kernel", "BN partial sums (rows 5/7/8)"),
                 ("layernorm_kernel", "fused_layernorm"),
                 ("nchwtonhwc", "layout (NHWC<->NCHW)"),
                 ("nhwctonchw", "layout (NHWC<->NCHW)"),
                 ("fprop", "conv (cuDNN)"), ("convolve", "conv (cuDNN)"),
                 ("conv2d", "conv (cuDNN)"), ("cudnn", "conv (cuDNN)"),
                 ("implicit_gemm", "conv (cuDNN)"), ("fft", "conv (cuDNN)"),
                 ("pointwise_mult_and_sum", "conv (cuDNN)"),
                 ("pool", "pooling"),
                 ("gemm", "matmul"), ("gemv", "matmul"),
                 ("cutlass", "matmul"), ("multi_tensor", "optimizer"),
                 ("sort", "sort (top-k)"), ("reduce", "reductions"),
                 ("index", "gather/scatter"), ("gather", "gather/scatter"),
                 ("direct_copy", "copies (incl. the page gather's)"),
                 ("elementwise", "elementwise"))


def _busy_us(spans):
    """Length of the union of [start, end) spans: the card's busy time."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


#: cycles of the two spin kernels that open a traced window: a long one
#: (~10 ms) while the profiler settles, then a short marker; only events
#: after the marker are read, since launches in a trace's first
#: milliseconds went unrecorded (a traced ResNet-50 forward showed 32 of
#: its 36 epilogue launches)
SETTLE_CYCLES, MARKER_CYCLES = 20_000_000, 1000


def _profiled(what, run):
    """Run `run()` under torch.profiler: the card's busy and idle share of
    the wall time, and device time by kernel group and by kernel name.
    Returns (stats or None, what `run` returned). Only the card's activity
    is traced, and its raw events are read without building the
    profiler's event tree: host operator events would slow the host loop
    that the idle share measures, and the tree takes longer to build than
    the run itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for cycles in (SETTLE_CYCLES, MARKER_CYCLES):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        t1 = time.perf_counter()
    # (name, start µs, duration µs) of every kernel, copy and fill
    kern = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    marks = [s + dur for name, s, dur in kern if "spin_kernel" in name]
    if marks:
        kern = [k for k in kern if k[1] >= max(marks)]
    else:
        log(f"[profile] {what}: the marker kernel was not recorded; every "
            "event is kept")
    log(f"[profile] {what}: {len(kern)} device events collected in "
        f"{time.perf_counter() - t1:.1f} s")
    if not kern:
        log(f"[profile] {what}: torch.profiler recorded no device kernels: "
            "device time not measured")
        return None, ret
    busy = _busy_us([(s, s + dur) for _, s, dur in kern])
    by_name, by_group = {}, {}
    for name, _, dur in kern:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + dur)
        low = name.lower()
        group = next((g for sub, g in KERNEL_GROUPS if sub in low), "other")
        n, t = by_group.get(group, (0, 0.0))
        by_group[group] = (n + 1, t + dur)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us, "kernels": len(kern),
           "groups": {g: {"count": n, "ms": t / 1e3}
                      for g, (n, t) in sorted(by_group.items(),
                                              key=lambda kv: -kv[1][1])},
           "top": [{"name": n[:120], "count": c, "ms": t / 1e3}
                   for n, (c, t) in top]}
    log(f"[profile] {what} under torch.profiler: wall {out['wall_ms']:.1f} "
        f"ms, card busy {out['device_busy_ms']:.1f} ms, idle share "
        f"{out['idle_share']:.4f}; {len(kern)} kernels")
    for g, d in out["groups"].items():
        log(f"[profile]   {g:<18} {d['count']:>7} kernels "
            f"{d['ms']:>10.3f} ms")
    return out, ret


def phase_profile(cfg, params, resnet_net, resnet_x, train_net, train_ds):
    """Under torch.profiler, eager and through its CUDA graphs: the serving
    phase's workload, one fused B=32 ResNet-50 forward and three fused
    ResNet-50 training steps; the paged phase's workload on the paged fp
    server through its graphs (where the page gather's time shows); and
    three fine-tune steps."""
    serving = {}
    for arm in ("eager", "graph", "paged graph"):
        paged = arm == "paged graph"
        reqs = _paged_requests(cfg, params) if paged else _requests(cfg)
        dkw = (dict(page_size=PAGED["page_size"],
                    pool_pages=PAGED["pool_pages"]) if paged else {})
        srv = GenerationServer(BertDecoder(cfg, params, **dkw),
                               cuda_graphs=arm != "eager", **SERVER)
        try:
            srv.warmup()
            torch.cuda.synchronize()
            prof, _ = _profiled(f"serving {arm}", lambda: [
                h.result(timeout=600)
                for h in [srv.submit(**r) for r in reqs]])
        finally:
            srv.shutdown()
        st = srv.status()
        _fault_free(st, f"profile: serving {arm}")
        if prof is not None:
            steps = st["steps"] * srv.superstep
            ex = st["executables"]
            prof.update(decode_steps=steps, admissions=st["admissions"],
                        kernels_per_decode_step=prof["kernels"] / steps,
                        graph_replays=ex["replays"])
            log(f"[profile] serving {arm}: {steps} decode steps + "
                f"{st['admissions']} prefills "
                f"({prof['kernels_per_decode_step']:.1f} kernels per decode "
                f"step; {ex['replays']} graph replays)")
        serving[arm] = prof
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    step = _trainer(cfg, params, _train_batch(cfg), gen)
    step()
    torch.cuda.synchronize()
    train, _ = _profiled("train (3 steps)",
                         lambda: [step() for _ in range(3)])
    if train is not None:
        train["steps"] = 3
    del step
    store = ExecutableStore(resnet_net)
    sig = ((tuple(resnet_x.shape), "float32"),)
    store.warmup([sig])
    (static,) = store.ensure(sig)

    def replay():
        static.copy_(resnet_x)
        return store.run(("forward", sig))

    resnet = {}
    for arm, fn in (("eager", lambda: resnet_net.output(resnet_x)),
                    ("graph", replay)):
        fn()
        torch.cuda.synchronize()
        resnet[arm], _ = _profiled(f"resnet fused forward B=32 {arm}", fn)
    del store, static
    resnet_train = {}
    for arm, prefetch in (("eager", 0), ("graph", 0), ("graph", 2)):
        graph = arm == "graph"
        train_net.fit(train_ds, cudaGraphs=graph)
        torch.cuda.synchronize()
        name = f"{arm} prefetch {prefetch}"
        resnet_train[name], _ = _profiled(
            f"resnet fused training B=32, 3 steps {name}",
            lambda: train_net.fit([train_ds] * 3, cudaGraphs=graph,
                                  prefetch=prefetch))
        if resnet_train[name] is not None:
            resnet_train[name]["steps"] = 3
    return {"serving": serving, "train": train, "resnet": resnet,
            "resnet_train": resnet_train}


def kernel_line(rows, launches, launches_from):
    """The per-kernel JSON object: each kernel's numbers at its
    representative case, its launches (from the main path's run where it
    has one; `launches_from` names the run), and its error in the checked
    case of the same dtype that came nearest its atol."""
    out = []
    for name, (case, dt) in REPRESENTATIVE.items():
        r = next(x for x in rows
                 if x["name"] == name and x["case"] == case
                 and x["dtype"] == dt)
        worst = max((x for x in rows if x["name"] == name
                     and x["dtype"] == dt),
                    key=lambda x: x["max_abs_err"] / x["atol"])
        src, replaces = SOURCES[name]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": worst["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "case": case,
                    "shape": r["shape"], "dtype": dt,
                    "atol": worst["atol"], "err_case": worst["case"],
                    "launches_from": launches_from[name]})
    return {"kernels": out}


# -- main ---------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only",
                    choices=["kernels", "resnet", "graphs", "paged",
                             "chaos"],
                    default=None,
                    help="stop after the kernel checks, or run the resnet "
                         "serving and training phases right after them, or "
                         "run the graphs, the paged or the chaos phase "
                         "alone after the build (bring-up runs)")
    ap.add_argument("--profile", action="store_true",
                    help="after the resnet phases, profile the serving "
                         "workload, three fine-tune steps, one ResNet-50 "
                         "forward and one ResNet-50 training step (card "
                         "busy/idle share, device time by kernel group)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    seconds = {}

    def timed(phase, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[phase] = time.perf_counter() - t
        return out

    card = timed("card", phase_card)
    build_s = timed("build", phase_build)
    OUT_DIR.mkdir(exist_ok=True)
    if args.only in ("graphs", "paged"):
        cfg = bert_base()
        phase = phase_graphs if args.only == "graphs" else phase_paged
        out = timed(args.only, phase, cfg, init_bert_params(cfg, 0))
        (OUT_DIR / f"smoke_{args.only}.json").write_text(json.dumps(
            {"card": card, args.only: out, "phase_seconds": seconds},
            indent=1))
        log(f"[smoke] by phase " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
        return 0
    if args.only == "chaos":
        cfg = bert_base()
        out = timed("chaos", phase_chaos, cfg, init_bert_params(cfg, 0))
        (OUT_DIR / "smoke_chaos.json").write_text(json.dumps(
            {"card": card, "chaos": out, "phase_seconds": seconds},
            indent=1, default=str))
        log(f"[smoke] by phase " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    rows, kernel_launches = timed("kernels", phase_kernels)
    step36 = step36_summary(rows)
    fwd36 = fwd36_summary(rows)
    step12 = bert_step12_summary(rows)
    if args.only == "kernels":
        (OUT_DIR / "smoke_kernels.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "step36": step36,
             "fwd36": fwd36, "bert_step12": step12}, indent=1))
        return 0
    if args.only == "resnet":
        resnet, _, _ = timed("resnet", phase_resnet)
        resnet_train, _, _ = timed("resnet_train", phase_resnet_train)
        (OUT_DIR / "smoke_resnet.json").write_text(json.dumps(
            {"card": card, "kernels": rows, "step36": step36,
             "fwd36": fwd36, "bert_step12": step12,
             "resnet": resnet, "resnet_train": resnet_train,
             "phase_seconds": seconds}, indent=1))
        return 0
    cfg = bert_base()
    params = timed("params", init_bert_params, cfg, 0)
    encoder = timed("encoder", phase_encoder, cfg, params)
    serving = timed("serving", phase_serving, cfg, params)
    train = timed("train", phase_train, cfg, params)
    resnet, resnet_net, resnet_x = timed("resnet", phase_resnet)
    resnet_train, train_net, train_ds = timed("resnet_train",
                                              phase_resnet_train)
    graphs = timed("graphs", phase_graphs, cfg, params)
    paged = timed("paged", phase_paged, cfg, params)
    chaos = timed("chaos", phase_chaos, cfg, params)
    prof = (timed("profile", phase_profile, cfg, params, resnet_net,
                  resnet_x, train_net, train_ds) if args.profile else None)
    # each kernel's launches from the path that carries it: the forward and
    # decode kernels from serving, the backward pair from training, the
    # epilogue GEMM from ResNet serving; the int8 epilogue and the
    # bottleneck block are entry points no served model calls, so theirs
    # come from the kernel phase and from the res4 check
    launches = {k: serving["launches"][k]
                for k in ("flash_fwd", "flash_decode")}
    launches.update({k: train["launches"][k]
                     for k in ("flash_bwd_dq", "flash_bwd_dkv")})
    launches["matmul_epilogue"] = resnet["launches"]["matmul_epilogue"]
    launches["int8_matmul_epilogue"] = \
        kernel_launches["int8_matmul_epilogue"]
    launches["bottleneck_block"] = resnet["res4_block"]["launches"]
    launches.update({k: resnet_train["launches"][k] for k in TRAIN_KERNELS})
    launches["fused_layernorm"] = kernel_launches["fused_layernorm"]
    launches_from = {"flash_fwd": "bert serving", "flash_decode":
                     "bert serving", "flash_bwd_dq": "bert training (10 "
                     "timed steps)", "flash_bwd_dkv": "bert training (10 "
                     "timed steps)", "matmul_epilogue": "resnet serving "
                     f"({resnet['forwards']} forwards)",
                     "int8_matmul_epilogue": "kernel phase (checks and "
                     "timing; no served model calls it)",
                     "bottleneck_block": "resnet res4_1 check (no served "
                     "model calls it)",
                     "fused_layernorm": "kernel phase (checks and timing; "
                     "no model calls it)"}
    launches_from.update({k: f"resnet training ({RESNET_TRAIN['steps']} "
                          "timed steps)" for k in TRAIN_KERNELS})
    line = kernel_line(rows, launches, launches_from)
    (OUT_DIR / "smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernels": rows,
         "step36": step36, "fwd36": fwd36, "bert_step12": step12,
         "encoder": encoder,
         "serving": serving, "train": train,
         "resnet": resnet, "resnet_train": resnet_train, "graphs": graphs,
         "paged": paged, "chaos": chaos, "profile": prof, "line": line,
         "phase_seconds": seconds, "seconds": time.perf_counter() - t0},
        indent=1, default=str))
    log(f"[smoke] {time.perf_counter() - t0:.1f} s; by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
