"""Signature introspection for the attention mask-arity guards: a copy
of `deeplearning4j_tpu/util/introspect.py` (it imports no JAX).

A padded batch must never silently attend to padding: custom attention
impls (models/bert.py `attn_impl`, parallel/ulysses.py `attn_fn`) have to
DECLARE the mask they receive. The old `inspect.signature(...).bind(...)`
check was satisfied by any `*args`/`**kwargs` catch-all — a
kwargs-swallowing impl would pass the guard and drop the mask on the
floor, the exact failure the check exists to make loud. This helper requires an EXPLICIT parameter, and reports
the calling convention it is actually reachable by, so the guard never
approves an impl the call site cannot invoke.
"""
from __future__ import annotations

import inspect


def explicit_mask_param(fn, names=("mask", "attn_mask", "kv_mask"),
                        positional_slot=None):
    """How can `fn` explicitly receive the mask? Returns

    - ("keyword", name) when a parameter from `names` is callable by
      keyword (POSITIONAL_OR_KEYWORD or KEYWORD_ONLY — bare `**kwargs`
      does NOT count, and neither does a positional-only parameter that
      merely shares the name). Checked FIRST so an impl like
      f(q, k, v, causal=False, mask=None) gets the mask bound to `mask`,
      never mis-bound to `causal` by slot counting;
    - ("positional", None) when `positional_slot` is given and the
      parameter at that slot (POSITIONAL_ONLY or POSITIONAL_OR_KEYWORD —
      `*args` does NOT count) is either named in `names` or has no
      default. A required 4th positional arg IS the mask slot by
      construction of the attn_impl(q, k, v, mask) convention; a
      DEFAULTED 4th positional with a non-mask name (e.g. causal=False)
      is rejected — binding the mask there would silently change an
      unrelated knob;
    - None when neither holds, or the signature is not introspectable
      (builtins, some C callables) — callers refuse both the same way:
      wrap the callable with an explicit signature to use it on masked
      batches.
    """
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    params = sig.parameters
    for n in names:
        p = params.get(n)
        if p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                        p.KEYWORD_ONLY):
            return ("keyword", n)
    if positional_slot is not None:
        positional = [p for p in params.values()
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)]
        if len(positional) >= positional_slot:
            slot = positional[positional_slot - 1]
            if slot.name in names or slot.default is inspect.Parameter.empty:
                return ("positional", None)
    return None


def accepts_explicit_mask(fn, names=("mask", "attn_mask", "kv_mask"),
                          min_positional=None):
    """Boolean convenience over explicit_mask_param: True/False when the
    signature is introspectable, None when it is not."""
    try:
        inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return explicit_mask_param(fn, names,
                               positional_slot=min_positional) is not None
