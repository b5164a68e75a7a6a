"""The port's native C++ runtime (`runtime/native_lib.py` over its copy
of `dl4j_native.cpp`, built with g++ into build/native/), the workspace
and the op executioner: the contracts of the JAX package's
tests/test_runtime_native.py (less its datavec loaders, which wait for
ROADMAP A18), and the port's functions against the JAX package's on the
same bytes, exactly."""
import os
import struct
import tempfile

import numpy as np
import pytest

from deeplearning4j_tpu_torch.runtime import native_lib



def test_the_library_builds_into_build_native():
    assert native_lib.available(), "g++ must build the native runtime"
    so = native_lib._so_path()
    assert os.path.exists(so)
    assert os.sep + os.path.join("build", "native") + os.sep in so


def _write_idx_u8(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def test_idx_read_native_matches_python():
    arr = (np.arange(2 * 5 * 5) % 256).astype(np.uint8).reshape(2, 5, 5)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t-images-idx3-ubyte")
        _write_idx_u8(p, arr)
        got = native_lib.idx_read(p)
        np.testing.assert_array_equal(got, arr)
        from deeplearning4j_tpu.runtime import native_lib as jnative
        np.testing.assert_array_equal(jnative.idx_read(p), got)


def test_gather_batch_scales():
    arch = (np.arange(6 * 4) % 256).astype(np.uint8).reshape(6, 4)
    out = native_lib.gather_batch_u8(arch, [5, 1, 3], scale=1 / 255.0)
    np.testing.assert_allclose(out, arch[[5, 1, 3]].astype(np.float32) / 255,
                               rtol=1e-6)
    out2 = native_lib.gather_batch_u8(arch, [0], scale=2.0, bias=-1.0)
    np.testing.assert_allclose(out2, arch[[0]].astype(np.float32) * 2 - 1,
                               rtol=1e-6)


def test_one_hot():
    labels = np.array([3, 1, 0, 2], np.uint8)
    oh = native_lib.one_hot_u8(labels, [0, 3], 4)
    np.testing.assert_allclose(oh, [[0, 0, 0, 1], [0, 0, 1, 0]])


def test_standardize_inplace():
    data = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    mean = data.mean(0).astype(np.float32)
    std = data.std(0).astype(np.float32)
    want = (data - mean) / std
    native_lib.standardize_inplace(data, mean, std)
    np.testing.assert_allclose(data, want, rtol=1e-5)


def test_arena_alloc_reset():
    a = native_lib.NativeArena(1 << 16)
    b1 = a.alloc_f32((16,))
    b1[:] = 7.0
    used1 = a.used()
    assert used1 >= 64
    a.reset()
    assert a.used() == 0
    b2 = a.alloc_f32((16,))
    # same memory reused after reset
    assert b2.__array_interface__["data"][0] == b1.__array_interface__["data"][0]
    a.close()


def test_arena_overflow_falls_back():
    a = native_lib.NativeArena(256)
    big = a.alloc_f32((1024,))  # larger than arena: heap fallback
    big[:] = 1.0
    assert big.shape == (1024,)
    a.close()


def test_ring_buffer_roundtrip():
    import ctypes
    lib = native_lib.get_lib()
    ring = lib.dl4j_ring_create(4)
    bufs = []
    for i in range(3):
        buf = ctypes.create_string_buffer(8)
        ctypes.memset(buf, 65 + i, 8)
        bufs.append(buf)
        assert lib.dl4j_ring_push(ring, ctypes.cast(buf, ctypes.c_void_p), 8) == 0
    assert lib.dl4j_ring_size(ring) == 3
    out = ctypes.c_void_p()
    n = lib.dl4j_ring_pop(ring, ctypes.byref(out))
    assert n == 8
    got = ctypes.string_at(out, 8)
    assert got == b"A" * 8
    lib.dl4j_ring_close(ring)
    # drain remaining then closed → -1 (after queue empties)
    lib.dl4j_ring_pop(ring, ctypes.byref(out))
    lib.dl4j_ring_pop(ring, ctypes.byref(out))
    assert lib.dl4j_ring_pop(ring, ctypes.byref(out)) == -1
    # NOTE: ring intentionally not destroyed — dl4j_ring_destroy frees
    # queued buffers with free(), and these are python-owned.


def test_workspace_scope():
    from deeplearning4j_tpu_torch.runtime.workspace import Nd4jWorkspace
    with Nd4jWorkspace("TEST") as ws:
        buf = ws.alloc((32, 32))
        buf[:] = 1.0
        assert ws.bytes_used() >= 32 * 32 * 4
    assert ws.bytes_used() == 0
    ws.close()


def test_executioner_profiling():
    import torch

    from deeplearning4j_tpu_torch import monitoring
    from deeplearning4j_tpu_torch.runtime.executioner import OpExecutioner
    ex = OpExecutioner.getInstance()
    ex.setProfilingMode(True)

    def square_sum(x):
        return torch.sum(x * x)

    monitoring.enable()
    try:
        out = ex.exec(square_sum, torch.ones(8))
        reg = monitoring.get_registry()
        assert reg.get(monitoring.OP_DISPATCHES).value >= 1
    finally:
        monitoring.disable()
        monitoring.get_registry().clear()
    assert float(out) == 8.0
    stats = ex.getProfilingStats()
    assert stats["square_sum"]["count"] >= 1
    assert stats["square_sum"]["total_time_s"] >= 0.0
    ex.setProfilingMode(False)
    assert float(ex.exec(square_sum, torch.ones(3))) == 3.0


class TestNativeCsv:
    """dl4j_csv_parse: single-pass numeric CSV -> float32 matrix, exact
    equality with the Python csv module on the same content."""

    def test_numeric_matches_python_csv(self, tmp_path):
        from deeplearning4j_tpu_torch.runtime import native_lib
        if not native_lib.available():
            pytest.skip("native toolchain unavailable")
        rng = np.random.default_rng(0)
        arr = rng.standard_normal((37, 5)).astype(np.float32)
        lines = ["h1,h2,h3,h4,h5"] + [
            ",".join(f"{v:.6g}" for v in row) for row in arr]
        path = tmp_path / "t.csv"
        path.write_text("\n".join(lines) + "\n")
        got = native_lib.csv_to_floats(str(path), ",", skip_rows=1)
        assert got is not None and got.shape == (37, 5)
        want = np.array([[float(x) for x in l.split(",")]
                         for l in lines[1:]], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_non_numeric_fields_become_nan(self):
        from deeplearning4j_tpu_torch.runtime import native_lib
        if not native_lib.available():
            pytest.skip("native toolchain unavailable")
        got = native_lib.csv_to_floats(b"1.5,abc,3\n,2,\n")
        assert got.shape == (2, 3)
        assert got[0, 0] == 1.5 and np.isnan(got[0, 1]) and got[0, 2] == 3
        # blank fields are NaN and must NOT swallow the next line's number
        assert np.isnan(got[1, 0]) and got[1, 1] == 2 and np.isnan(got[1, 2])

    def test_tab_delim_empty_field_stays_aligned(self):
        # whitespace delimiter + empty field: strtof must not swallow the
        # next field (bounded-field parse)
        from deeplearning4j_tpu_torch.runtime import native_lib
        if not native_lib.available():
            pytest.skip("native toolchain unavailable")
        got = native_lib.csv_to_floats(b"1\t\t3\n4\t5\t6\n", "\t")
        assert got.shape == (2, 3)
        assert got[0, 0] == 1 and np.isnan(got[0, 1]) and got[0, 2] == 3
        assert list(got[1]) == [4, 5, 6]

    def test_trailing_garbage_is_nan_not_truncated(self):
        from deeplearning4j_tpu_torch.runtime import native_lib
        if not native_lib.available():
            pytest.skip("native toolchain unavailable")
        got = native_lib.csv_to_floats(b"1.5abc,2\n3, 4 \n")
        assert np.isnan(got[0, 0]) and got[0, 1] == 2
        assert got[1, 0] == 3 and got[1, 1] == 4  # padded fields still parse

    def test_skip_counts_physical_lines(self):
        from deeplearning4j_tpu_torch.runtime import native_lib
        if not native_lib.available():
            pytest.skip("native toolchain unavailable")
        # blank first line consumes the skip, exactly like csv.reader slicing
        got = native_lib.csv_to_floats(b"\n1,2\n3,4\n", skip_rows=1)
        assert got.shape == (2, 2) and got[0, 0] == 1 and got[1, 1] == 4

    def test_hex_floats_rejected(self):
        from deeplearning4j_tpu_torch.runtime import native_lib
        got = native_lib.csv_to_floats(b"0x10,2\n3,4\n")
        assert np.isnan(got[0, 0]) and got[0, 1] == 2


class TestNativeImageOps:
    def test_bilinear_matches_oracle_many_shapes(self):
        from deeplearning4j_tpu_torch.runtime import native_lib
        if not native_lib.available():
            import pytest
            pytest.skip("native toolchain unavailable")
        rng = np.random.default_rng(7)
        for (sh, sw, c), (dh, dw) in [((8, 8, 3), (16, 16)),
                                      ((64, 48, 3), (17, 29)),
                                      ((5, 5, 1), (10, 3)),
                                      ((224, 224, 3), (64, 64))]:
            img = rng.integers(0, 256, size=(sh, sw, c), dtype=np.uint8)
            got = native_lib.resize_bilinear_u8(img, dh, dw)
            want = native_lib._resize_bilinear_oracle(img, dh, dw)
            assert got.shape == (dh, dw, c)
            np.testing.assert_allclose(got, want, atol=1e-3)

    def test_identity_resize_is_exact(self):
        from deeplearning4j_tpu_torch.runtime import native_lib
        rng = np.random.default_rng(3)
        img = rng.integers(0, 256, size=(12, 9, 3), dtype=np.uint8)
        out = native_lib.resize_bilinear_u8(img, 12, 9)
        np.testing.assert_allclose(out, img.astype(np.float32), atol=1e-4)



# -- against the JAX package: the same bytes, the same answers ------------
def test_functions_match_the_jax_package_exactly():
    from deeplearning4j_tpu.runtime import native_lib as jnative
    rng = np.random.default_rng(9)
    arch = rng.integers(0, 256, size=(20, 28, 28), dtype=np.uint8)
    idx = rng.integers(0, 20, size=7)
    np.testing.assert_array_equal(
        native_lib.gather_batch_u8(arch, idx, scale=1 / 255.0, bias=-0.5),
        jnative.gather_batch_u8(arch, idx, scale=1 / 255.0, bias=-0.5))
    labels = rng.integers(0, 10, size=20).astype(np.uint8)
    np.testing.assert_array_equal(native_lib.one_hot_u8(labels, idx, 10),
                                  jnative.one_hot_u8(labels, idx, 10))
    img = rng.integers(0, 256, size=(37, 23, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native_lib.resize_bilinear_u8(img, 19, 41),
                                  jnative.resize_bilinear_u8(img, 19, 41))
    csv = b"a,b\n1.25,-3\nx,7e-2\n"
    np.testing.assert_array_equal(native_lib.csv_to_floats(csv,
                                                           skip_rows=1),
                                  jnative.csv_to_floats(csv, skip_rows=1))
    data = rng.standard_normal((9, 4)).astype(np.float32)
    a, b = data.copy(), data.copy()
    mean, std = data.mean(0), data.std(0) + 0.1
    native_lib.standardize_inplace(a, mean, std)
    jnative.standardize_inplace(b, mean, std)
    np.testing.assert_array_equal(a, b)
