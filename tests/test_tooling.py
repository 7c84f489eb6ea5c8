"""The compile-cache helper, the stdlib PNG writer and the trace
reduction."""

import io
import os
import sys
import tempfile

import numpy as np
import pytest

from cuburn_tpu import compile_cache
from cuburn_tpu import output as output_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- compile cache ---------------------------------------------------------

def test_cache_dir_from_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/shared/cache")
    assert compile_cache.cache_dir() == "/some/shared/cache"


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_cache_dir_is_fixed_not_temporary(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.cache_dir()
    assert path == compile_cache.cache_dir()      # same every call
    assert str(os.getpid()) not in path
    assert not path.startswith(tempfile.gettempdir())
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_sets_jax_config(monkeypatch):
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/cache")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == "/x/cache"
        assert jax.config.jax_compilation_cache_dir == "/x/cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# -- PNG ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 64)])
def test_encode_png_roundtrip(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (4,), dtype=np.uint8)
    data = output_mod.encode_png(img)
    assert data.startswith(b"\x89PNG\r\n\x1a\n")
    np.testing.assert_array_equal(output_mod.decode_png(data), img)


def test_encode_png_decodes_with_pil():
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(1).integers(0, 256, (9, 11, 4),
                                            dtype=np.uint8)
    dec = np.asarray(Image.open(io.BytesIO(output_mod.encode_png(img))))
    np.testing.assert_array_equal(dec, img)


def test_decode_png_reads_every_filter():
    """PIL's optimizing writer mixes the Sub/Up/Average/Paeth
    scanline filters; the decoder must undo each."""
    Image = pytest.importorskip("PIL.Image")
    y, x = np.mgrid[0:24, 0:40]
    img = np.stack([x * 5, y * 9, (x * y) % 256, 255 - x], -1)\
        .astype(np.uint8)
    for mode, arr in (("RGBA", img), ("RGB", img[..., :3])):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG", optimize=True)
        np.testing.assert_array_equal(
            output_mod.decode_png(buf.getvalue()), arr)


def test_write_image_without_native_or_pil(tmp_path, monkeypatch):
    monkeypatch.setattr(output_mod, "_fastout", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(2).integers(0, 256, (6, 5, 3),
                                            dtype=np.uint8)
    path = tmp_path / "a.png"
    output_mod.write_image(str(path), img)
    dec = output_mod.decode_png(path.read_bytes())
    np.testing.assert_array_equal(dec[..., :3], img)
    assert (dec[..., 3] == 255).all()


def test_jpeg_without_pil_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="JPEG output needs PIL"):
        output_mod.write_image(str(tmp_path / "a.jpg"),
                               np.zeros((2, 2, 4), np.uint8))


# -- trace reduction --------------------------------------------------------

def _trace_summary():
    sys.path.insert(0, os.path.join(ROOT, "bench"))
    try:
        import trace_summary
    finally:
        sys.path.pop(0)
    return trace_summary


def test_busy_union_of_overlapping_intervals():
    ts = _trace_summary()
    assert ts.busy_ns([]) == 0
    assert ts.busy_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert ts.busy_ns([(20, 30), (0, 40)]) == 40


def test_summarize_planes_idle_share_and_ranking():
    ts = _trace_summary()
    planes = [
        ("/host:CPU", [("python", [("x", 0, 10**9)])]),
        ("/device:GPU:0", [
            ("XLA Modules", [("jit_step", 0, 1000)]),
            ("XLA Ops", [("scatter", 0, 300), ("fusion", 300, 100),
                         ("scatter", 800, 200)])]),
    ]
    out = ts.summarize_planes(planes)
    assert list(out) == ["/device:GPU:0"]
    gpu = out["/device:GPU:0"]
    assert gpu["window_ms"] == pytest.approx(1e-3)
    assert gpu["busy_ms"] == pytest.approx(6e-4)
    assert gpu["idle_share"] == pytest.approx(0.4)
    assert gpu["top_ops_ms"][0] == ("scatter", pytest.approx(5e-4))
