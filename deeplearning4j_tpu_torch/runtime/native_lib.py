"""ctypes bindings + on-demand build of the native runtime
(runtime/native/dl4j_native.cpp, framework-free C++): a copy of
`deeplearning4j_tpu/runtime/native_lib.py` re-pointed at the port. The
library builds with g++ at first use into `build/native/` beside the
package (named by a hash of the source, so an edited source rebuilds);
without a toolchain the callers fall back to numpy (`available()`).

ctypes releases the GIL during calls, so batch conversion in the native
path truly overlaps Python-side device dispatch (the reference gets the
same overlap from its javacpp worker threads).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "dl4j_native.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                      "native")


def _so_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"libdl4j_native-{digest}.so")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _build(so):
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = _so_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except Exception:
            _build_failed = True
            return None
        c = ctypes
        lib.dl4j_idx_read.restype = c.c_void_p
        lib.dl4j_idx_read.argtypes = [c.c_char_p, c.POINTER(c.c_int64),
                                      c.POINTER(c.c_int32),
                                      c.POINTER(c.c_int32)]
        lib.dl4j_free.argtypes = [c.c_void_p]
        lib.dl4j_u8_to_f32.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                       c.c_float, c.c_float]
        lib.dl4j_gather_batch_u8.argtypes = [c.c_void_p, c.c_int64,
                                             c.c_void_p, c.c_int64,
                                             c.c_void_p, c.c_float, c.c_float]
        lib.dl4j_one_hot.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                     c.c_int64, c.c_void_p]
        lib.dl4j_sub_channel_means.argtypes = [c.c_void_p, c.c_int64,
                                               c.c_int64, c.c_void_p]
        lib.dl4j_resize_bilinear_u8.argtypes = [
            c.c_void_p, c.c_int64, c.c_int64, c.c_int64,
            c.c_void_p, c.c_int64, c.c_int64]
        lib.dl4j_standardize.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                         c.c_void_p, c.c_void_p]
        lib.dl4j_csv_dims.argtypes = [c.c_char_p, c.c_char, c.c_int32,
                                      c.POINTER(c.c_int64),
                                      c.POINTER(c.c_int64)]
        lib.dl4j_csv_parse.restype = c.c_int64
        lib.dl4j_csv_parse.argtypes = [c.c_char_p, c.c_char, c.c_int32,
                                       c.c_int64, c.c_int64, c.c_void_p]
        lib.dl4j_ring_create.restype = c.c_void_p
        lib.dl4j_ring_create.argtypes = [c.c_int64]
        lib.dl4j_ring_push.restype = c.c_int32
        lib.dl4j_ring_push.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
        lib.dl4j_ring_pop.restype = c.c_int64
        lib.dl4j_ring_pop.argtypes = [c.c_void_p, c.POINTER(c.c_void_p)]
        lib.dl4j_ring_size.restype = c.c_int64
        lib.dl4j_ring_size.argtypes = [c.c_void_p]
        lib.dl4j_ring_close.argtypes = [c.c_void_p]
        lib.dl4j_ring_destroy.argtypes = [c.c_void_p]
        lib.dl4j_arena_create.restype = c.c_void_p
        lib.dl4j_arena_create.argtypes = [c.c_int64]
        lib.dl4j_arena_alloc.restype = c.c_void_p
        lib.dl4j_arena_alloc.argtypes = [c.c_void_p, c.c_int64]
        lib.dl4j_arena_reset.argtypes = [c.c_void_p]
        lib.dl4j_arena_used.restype = c.c_int64
        lib.dl4j_arena_used.argtypes = [c.c_void_p]
        lib.dl4j_arena_destroy.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available():
    return get_lib() is not None


# -- numpy-level wrappers ------------------------------------------------
def idx_read(path):
    """Parse an (uncompressed) IDX file natively -> numpy array, or None."""
    lib = get_lib()
    if lib is None or path.endswith(".gz"):
        return None
    dims = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int32()
    dtype_code = ctypes.c_int32()
    ptr = lib.dl4j_idx_read(path.encode(), dims, ctypes.byref(ndim),
                            ctypes.byref(dtype_code))
    if not ptr:
        return None
    shape = tuple(dims[i] for i in range(ndim.value))
    dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
             13: np.float32, 14: np.float64}[dtype_code.value]
    n = int(np.prod(shape))
    buf = (ctypes.c_char * (n * np.dtype(dtype).itemsize)).from_address(ptr)
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    lib.dl4j_free(ptr)
    return arr


def csv_to_floats(path_or_bytes, delimiter=",", skip_rows=0):
    """Parse an all-numeric CSV natively into a float32 (rows, cols) array
    (non-numeric/empty fields become NaN). Returns None when the native
    lib is unavailable — callers fall back to the Python csv module."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(path_or_bytes, str) and os.path.exists(path_or_bytes):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    elif isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        data = str(path_or_bytes).encode()
    data = data + b"\0"
    delim = delimiter.encode()[:1] or b","
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    lib.dl4j_csv_dims(data, delim, skip_rows,
                      ctypes.byref(rows), ctypes.byref(cols))
    r, c = rows.value, cols.value
    if r <= 0 or c <= 0:
        return np.empty((0, 0), np.float32)
    out = np.empty((r, c), np.float32)
    n = lib.dl4j_csv_parse(data, delim, skip_rows, r, c,
                           out.ctypes.data_as(ctypes.c_void_p))
    if n != r * c:
        return None  # inconsistent parse: let the caller use the slow path
    return out


def gather_batch_u8(archive, indices, scale=1.0 / 255.0, bias=0.0, out=None):
    """(N, ...)-uint8 archive + int64 indices -> (B, ...) float32 batch."""
    lib = get_lib()
    item_size = int(np.prod(archive.shape[1:]))
    idx = np.ascontiguousarray(indices, np.int64)
    b = len(idx)
    if out is None:
        out = np.empty((b,) + archive.shape[1:], np.float32)
    if lib is None:
        out[:] = archive[idx].astype(np.float32) * scale + bias
        return out
    lib.dl4j_gather_batch_u8(
        archive.ctypes.data_as(ctypes.c_void_p), item_size,
        idx.ctypes.data_as(ctypes.c_void_p), b,
        out.ctypes.data_as(ctypes.c_void_p), scale, bias)
    return out


def one_hot_u8(labels_u8, indices, n_classes, out=None):
    lib = get_lib()
    idx = np.ascontiguousarray(indices, np.int64)
    b = len(idx)
    if out is None:
        out = np.empty((b, n_classes), np.float32)
    if lib is None:
        out[:] = 0.0
        out[np.arange(b), labels_u8[idx].astype(np.int64)] = 1.0
        return out
    lib.dl4j_one_hot(labels_u8.ctypes.data_as(ctypes.c_void_p),
                     idx.ctypes.data_as(ctypes.c_void_p), b, n_classes,
                     out.ctypes.data_as(ctypes.c_void_p))
    return out


def standardize_inplace(data, mean, std):
    lib = get_lib()
    rows = data.shape[0]
    cols = int(np.prod(data.shape[1:]))
    if lib is None:
        flat = data.reshape(rows, cols)
        flat -= mean
        flat /= std
        return data
    lib.dl4j_standardize(data.ctypes.data_as(ctypes.c_void_p), rows, cols,
                         np.ascontiguousarray(mean, np.float32).ctypes
                         .data_as(ctypes.c_void_p),
                         np.ascontiguousarray(std, np.float32).ctypes
                         .data_as(ctypes.c_void_p))
    return data


def _resize_bilinear_oracle(img_u8, out_h, out_w):
    """numpy reference with EXACTLY the C kernel's math (half-pixel
    centers, clamped edges, float32 lerp order) — the parity gate and the
    no-toolchain fallback are the same function."""
    src = img_u8.astype(np.float32)
    sh, sw, c = src.shape
    scale_y = np.float32(sh) / np.float32(out_h)
    scale_x = np.float32(sw) / np.float32(out_w)
    fy = (np.arange(out_h, dtype=np.float32) + np.float32(0.5)) * scale_y \
        - np.float32(0.5)
    fx = (np.arange(out_w, dtype=np.float32) + np.float32(0.5)) * scale_x \
        - np.float32(0.5)
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    wy = (fy - y0.astype(np.float32)).astype(np.float32)
    wx = (fx - x0.astype(np.float32)).astype(np.float32)
    y0c = np.clip(y0, 0, sh - 1)
    y1c = np.clip(y0 + 1, 0, sh - 1)
    x0c = np.clip(x0, 0, sw - 1)
    x1c = np.clip(x0 + 1, 0, sw - 1)
    v00 = src[y0c[:, None], x0c[None, :], :]
    v01 = src[y0c[:, None], x1c[None, :], :]
    v10 = src[y1c[:, None], x0c[None, :], :]
    v11 = src[y1c[:, None], x1c[None, :], :]
    wxb = wx[None, :, None]
    top = v00 + (v01 - v00) * wxb
    bot = v10 + (v11 - v10) * wxb
    return (top + (bot - top) * wy[:, None, None]).astype(np.float32)


def resize_bilinear_u8(img_u8, out_h, out_w):
    """u8 (H, W, C) -> f32 (out_h, out_w, C) in [0, 255]: the native
    kernel when available (strict-parity-gated against the numpy oracle
    once per process), the oracle otherwise — identical output either
    way."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim == 2:
        img_u8 = img_u8[:, :, None]
    lib = get_lib()
    if lib is None or not _resize_parity_ok():
        return _resize_bilinear_oracle(img_u8, out_h, out_w)
    sh, sw, c = img_u8.shape
    out = np.empty((int(out_h), int(out_w), c), np.float32)
    lib.dl4j_resize_bilinear_u8(
        img_u8.ctypes.data_as(ctypes.c_void_p), sh, sw, c,
        out.ctypes.data_as(ctypes.c_void_p), int(out_h), int(out_w))
    return out


_resize_parity = None


def _resize_parity_ok():
    """One-time gate: the native kernel must match the oracle on a fixed
    random probe (both up- and down-scale) or we never use it."""
    global _resize_parity
    if _resize_parity is not None:
        return _resize_parity
    lib = get_lib()
    if lib is None:
        _resize_parity = False
        return False
    rng = np.random.default_rng(0)
    probe = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    ok = True
    for oh, ow in ((7, 9), (29, 31)):
        want = _resize_bilinear_oracle(probe, oh, ow)
        got = np.empty((oh, ow, 3), np.float32)
        lib.dl4j_resize_bilinear_u8(
            probe.ctypes.data_as(ctypes.c_void_p), 13, 17, 3,
            got.ctypes.data_as(ctypes.c_void_p), oh, ow)
        if not np.allclose(got, want, atol=1e-3):
            ok = False
            break
    _resize_parity = ok
    return ok


class NativeArena:
    """Host staging arena (≡ MemoryWorkspace): bump-alloc + epoch reset."""

    def __init__(self, capacity_bytes):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native lib unavailable")
        self._lib = lib
        self._handle = lib.dl4j_arena_create(capacity_bytes)
        self.capacity = capacity_bytes

    def alloc_f32(self, shape):
        n = int(np.prod(shape))
        ptr = self._lib.dl4j_arena_alloc(self._handle, n * 4)
        if not ptr:
            return np.empty(shape, np.float32)  # arena full: heap fallback
        buf = (ctypes.c_float * n).from_address(ptr)
        return np.frombuffer(buf, np.float32).reshape(shape)

    def reset(self):
        self._lib.dl4j_arena_reset(self._handle)

    def used(self):
        return int(self._lib.dl4j_arena_used(self._handle))

    def close(self):
        if self._handle:
            self._lib.dl4j_arena_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
