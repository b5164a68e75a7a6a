"""Batched token sampling for the decode loop: the port of
`deeplearning4j_tpu/generation/sampling.py`.

Every knob is a per-slot tensor (method id, temperature, top-k), so a
continuous batch with mixed sampling settings samples in one pass.

RNG is an explicit per-slot key column `(S, 2)` of uint32 values (held in
int64 tensors: torch has no full uint32 arithmetic). The keys follow JAX's
threefry2x32 under `jax_threefry_partitionable=True` bit for bit, so a
slot's stream is the same function of its admission key as in the JAX
package: `split_keys` equals `jax.random.split(key, 2)` and the Gumbel
noise equals `jax.random.categorical`'s (the uniform draw is exact; the
logs may differ in the last ulp, so only a near-tie can flip a token).
"""
from __future__ import annotations

import torch

__all__ = ["GREEDY", "SAMPLE", "method_id", "sample_step", "split_keys"]

#: per-slot sampling method ids
GREEDY = 0
SAMPLE = 1     # temperature (+ optional top-k) categorical

_NEG = -1e30
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def method_id(name):
    """'greedy' → GREEDY; 'sample'/'temperature'/'top_k' → SAMPLE."""
    name = str(name).lower()
    if name == "greedy":
        return GREEDY
    if name in ("sample", "temperature", "top_k", "topk"):
        return SAMPLE
    raise ValueError(f"unknown sampling method {name!r}; expected "
                     "'greedy', 'temperature', or 'top_k'")


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32
    values; k1/k2 broadcast against the counters x1/x2."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK32
    x2 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x1, x2


def _hash_iota(keys, n):
    """Threefry of each key over the counters 0..n-1 (the partitionable
    layout: high counter word 0, low word the index). (S, 2) -> two
    (S, n) words."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    return threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)


def split_keys(keys):
    """(S, 2) keys → (new_keys, subkeys), both (S, 2): per row,
    `jax.random.split(key, 2)`."""
    b1, b2 = _hash_iota(keys, 2)
    return (torch.stack([b1[:, 0], b2[:, 0]], dim=1),
            torch.stack([b1[:, 1], b2[:, 1]], dim=1))


def _gumbel(keys, n):
    """(S, n) f32 Gumbel noise of `jax.random.gumbel(key, (n,))` per row
    (mode "low"): 32 random bits → a uniform in [tiny, 1) → -log(-log u)."""
    b1, b2 = _hash_iota(keys, n)
    bits = b1 ^ b2
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample_step(logits, keys, method, temperature, top_k):
    """One batched sampling step.

    - logits: (S, V) float32
    - keys: (S, 2) per-slot rng keys
    - method: (S,) — GREEDY or SAMPLE per slot
    - temperature: (S,) float32 (<= 0 treated as 1.0)
    - top_k: (S,) — 0 (or >= V) disables the top-k filter

    Returns (tokens (S,) int64, new_keys (S, 2)). Greedy slots ignore
    their key (the split still advances, keeping streams aligned)."""
    v = logits.shape[-1]
    greedy_tok = logits.argmax(dim=-1)
    t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    scaled = logits / t
    # top-k threshold: kth-largest value per row (ascending sort, index
    # V-k); ties at the threshold stay in
    k_eff = top_k.clamp(0, v)
    srt = scaled.sort(dim=-1).values
    kth = srt.gather(-1, (v - k_eff).clamp(0, v - 1)[:, None])
    use_k = ((k_eff > 0) & (k_eff < v))[:, None]
    filtered = torch.where(use_k & (scaled < kth), _NEG, scaled)
    new_keys, subkeys = split_keys(keys)
    sampled = (_gumbel(subkeys, v) + filtered).argmax(dim=-1)
    tokens = torch.where(method == GREEDY, greedy_tok, sampled)
    return tokens, new_keys
