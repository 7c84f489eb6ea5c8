"""The plain histogram backends (ops/histogram.py) against a float64
np.add.at reference, render parity of each backend with scatter, the
"auto" choice and the names that are gone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuburn_tpu.models import full_feature, sierpinski
from cuburn_tpu.ops import histogram as hist_mod
from cuburn_tpu.profile import RenderProfile
from cuburn_tpu.render import Renderer

BACKENDS = sorted(hist_mod.BACKENDS)
REMOVED = ["pallas", "pallas_merged", "pallas_win", "pallas_rgb16"]
N_RECORDS = 1 << 14
GEOMETRIES = {"resident": 4096, "large": 1 << 20}


def _records(pattern: str, n_bins: int, seed: int = 0):
    """(addr, rgba) of N_RECORDS flush records; addr n_bins is junk."""
    rng = np.random.default_rng(seed)
    if pattern == "dense":          # every record in a small window
        addr = rng.integers(0, min(n_bins, 512), N_RECORDS)
    elif pattern == "sparse":       # spread over the whole histogram
        addr = rng.integers(0, n_bins, N_RECORDS)
    elif pattern == "hot":          # a few bins take most of the mass
        addr = rng.choice(np.array([0, 7, n_bins // 2, n_bins - 1]),
                          N_RECORDS, p=[0.4, 0.3, 0.2, 0.1])
    elif pattern == "junk":         # mostly masked-off samples
        addr = np.where(rng.random(N_RECORDS) < 0.9, n_bins,
                        rng.integers(0, n_bins, N_RECORDS))
    else:                           # mixed: all of the above
        addr = np.concatenate([
            rng.integers(0, n_bins, N_RECORDS // 2),
            np.full(N_RECORDS // 4, n_bins),
            np.full(N_RECORDS // 8, 3),
            rng.integers(0, min(n_bins, 64), N_RECORDS // 8)])
        rng.shuffle(addr)
    rgba = rng.random((N_RECORDS, 4)).astype(np.float32)
    rgba[:, 3] = 1.0                # density column: unit counts
    return addr.astype(np.int32), rgba


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("weight", [1.0, 0.25])
@pytest.mark.parametrize("pattern",
                         ["dense", "sparse", "hot", "junk", "mixed"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_add_at(backend, pattern, weight, geom):
    """Density exact (integer counts, and weights exact in f32), RGB
    within 1e-5 of bin density — the tolerance the on-card check uses
    — and the starting histogram's mass kept."""
    import chip_smoke
    n_bins = GEOMETRIES[geom]
    addr, rgba = _records(pattern, n_bins)
    rgba = rgba * np.float32(weight)
    start = np.zeros((n_bins + 1, 4), np.float32)
    start[1::97] = 2.0
    out = jax.jit(hist_mod.get_backend(backend))(
        jnp.asarray(start), jnp.asarray(addr), jnp.asarray(rgba))
    ref = chip_smoke.reference_hist(n_bins, addr, rgba) + start
    dens_err, rgb_rel = chip_smoke.hist_errors(out, ref)
    assert dens_err == 0.0
    assert rgb_rel <= chip_smoke.RGB_REL_TOL


def test_sortcum_run_sums_scale_with_bin_not_flush():
    """sortcum's per-bin error follows the bin's own mass: a tiny bin
    sorted after a huge one keeps its value to f32 precision (a
    global prefix-sum difference would lose it to the big run's
    ulp)."""
    addr = jnp.asarray(np.r_[np.zeros(1 << 20), [1]].astype(np.int32))
    rgba = jnp.ones((addr.shape[0], 4), jnp.float32).at[-1].set(1e-3)
    out = np.asarray(hist_mod.accumulate_sortcum(hist_mod.alloc(4),
                                                 addr, rgba))
    assert out[0, 0] == float(1 << 20)
    assert out[1, 0] == np.float32(1e-3)


# -- render parity of each backend with scatter ------------------------

PARITY_PROF = RenderProfile(width=48, height=48, quality=24, batch=1024,
                            iters_per_chunk=8, fuse=8, de_enabled=False,
                            hist_backend="scatter")


def _opacity_genome():
    from cuburn_tpu.genome.spline import Spline
    g = sierpinski()
    g.xforms[1].opacity = Spline(0.5)
    return g


def _animated():
    from cuburn_tpu.models import animated_spark
    return animated_spark()


@pytest.mark.parametrize("mode",
                         ["still", "temporal", "striped", "opacity"])
@pytest.mark.parametrize("backend", ["scatter_sorted", "sortcum"])
def test_render_parity_with_scatter(backend, mode):
    """Same seed, same trajectory stream: per-bin density identical
    and frames within one u8 step of the scatter render."""
    g, prof = sierpinski(), PARITY_PROF
    if mode == "temporal":
        g = _animated()
        prof = dataclasses.replace(prof, temporal_samples=3)
    elif mode == "opacity":
        g = _opacity_genome()
    other = dataclasses.replace(prof, hist_backend=backend)

    def run(p):
        r = Renderer(g, p)
        if mode == "opacity":
            assert r.packed and r.op_bits
        if mode == "striped":
            h, st = r.accumulate_striped(0.3, seed=5, n_stripes=3)
        else:
            h, st = r.accumulate(0.3, seed=5)
        return np.asarray(h), r.finalize_frame(h, 0.3), st

    h_s, img_s, st_s = run(prof)
    h_o, img_o, st_o = run(other)
    assert st_o.plotted_samples == st_s.plotted_samples > 0
    np.testing.assert_array_equal(h_o[:, 3], h_s[:, 3])
    assert np.abs(img_o.astype(int) - img_s.astype(int)).max() <= 1


@pytest.mark.parametrize("backend", ["scatter_sorted", "sortcum"])
def test_sharded_temporal_parity_with_scatter(backend):
    """Motion blur through the 8-device mesh, per backend."""
    from cuburn_tpu.parallel import ShardedRenderer
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    prof = dataclasses.replace(PARITY_PROF, batch=2048,
                               temporal_samples=2)
    g = _animated()
    h_s, st_s = ShardedRenderer(g, prof).accumulate(0.3, seed=5)
    h_o, st_o = ShardedRenderer(g, dataclasses.replace(
        prof, hist_backend=backend)).accumulate(0.3, seed=5)
    assert st_o.plotted_samples == st_s.plotted_samples > 0
    np.testing.assert_array_equal(np.asarray(h_o)[:, 3],
                                  np.asarray(h_s)[:, 3])


# -- the "auto" choice ---------------------------------------------------

def test_auto_backend_is_a_registered_backend():
    assert hist_mod.AUTO_BACKEND in hist_mod.BACKENDS


@pytest.mark.parametrize("size", [(64, 64, 1), (1280, 720, 1),
                                  (1920, 1080, 2)])
def test_auto_resolves_to_scatter_at_every_geometry(size):
    """The race on the card found one winner at 4 MB, 14 MB and 132 MB
    histograms, so "auto" carries no geometry or platform rule."""
    w, h, ss = size
    r = Renderer(full_feature(), RenderProfile(width=w, height=h, ss=ss,
                                               hist_backend="auto"))
    assert r.backend == "scatter"


# -- removed backend names -----------------------------------------------

@pytest.mark.parametrize("name", REMOVED)
def test_removed_backend_rejected_by_profile(name):
    with pytest.raises(ValueError, match="unknown histogram backend"):
        RenderProfile(hist_backend=name)


@pytest.mark.parametrize("name", REMOVED)
def test_removed_backend_rejected_by_cli(name, capsys):
    from cuburn_tpu.main import main
    with pytest.raises(SystemExit) as e:
        main(["gallery:sierpinski", "--hist-backend", name])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert f"invalid choice: {name!r}" in err
    assert "scatter_sorted" in err          # the names that remain


def test_unknown_backend_rejected_by_get_backend():
    with pytest.raises(ValueError, match="unknown histogram backend"):
        hist_mod.get_backend("pallas_win")
