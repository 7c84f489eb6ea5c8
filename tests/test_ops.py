"""Ops-layer tests: RNG, histogram backends, xform math, iteration.

Follows SURVEY.md §4's "do better, cheaply" plan: the reference only had
an MWC self-test kernel and a sort validator; JAX on CPU gives us exact
differential tests for every kernel.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuburn_tpu.ops import histogram as hist_mod
from cuburn_tpu.ops import rng as rng_mod
from cuburn_tpu.ops.camera import CameraSpec, project
from cuburn_tpu.ops.iterate import (init_state, iterate_chunk,
                                    xform_cdf_rows)
from cuburn_tpu.models import sierpinski, full_feature


class TestRng:
    def test_device_matches_host(self):
        """MWCTest equivalent (SURVEY.md §4): device streams reproduce
        an independent host implementation bit-exactly."""
        state = np.asarray(rng_mod.seed(jax.random.PRNGKey(7), 64))
        dev_state = jnp.asarray(state)
        host_state = state.copy()
        for _ in range(100):
            dev_state, dev_bits = rng_mod.next_bits(dev_state)
            host_state, host_bits = rng_mod.host_next_bits(host_state)
            np.testing.assert_array_equal(np.asarray(dev_bits), host_bits)

    def test_uniform_range_and_mean(self):
        state = rng_mod.seed(jax.random.PRNGKey(0), 10000)
        total = []
        for _ in range(20):
            state, u = rng_mod.uniform(state)
            total.append(np.asarray(u))
        u = np.concatenate(total)
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.01
        assert abs(u.var() - 1 / 12) < 0.01

    def test_streams_independent(self):
        """Adjacent lanes should be uncorrelated."""
        state = rng_mod.seed(jax.random.PRNGKey(3), 1000)
        draws = []
        for _ in range(50):
            state, u = rng_mod.uniform(state)
            draws.append(np.asarray(u))
        d = np.stack(draws)          # (50, 1000)
        corr = np.corrcoef(d[:, :-1].ravel(), d[:, 1:].ravel())[0, 1]
        assert abs(corr) < 0.05

    def test_matches_published_xorshift128(self):
        """Pin the generator to Marsaglia (2003) 'Xorshift RNGs'
        xor128: t=x^(x<<11); t^=t>>8; w=(w^(w>>19))^t with the paper's
        seed (123456789, 362436069, 521288629, 88675123).  The literal
        words below were computed from an independent pure-Python
        transcription of the published recurrence — this anchors the
        ALGORITHM, where the host/device differential (which shares
        the transcription) cannot."""
        expected = [3701687786, 458299110, 2500872618,
                    3633119408, 516391518, 2377269574]
        st_host = np.array(
            [[123456789, 362436069, 521288629, 88675123]], np.uint32)
        st_dev = jnp.asarray(st_host)
        for want in expected:
            st_host, b_host = rng_mod.host_next_bits(st_host)
            st_dev, b_dev = rng_mod.next_bits(st_dev)
            assert int(b_host[0]) == want
            assert int(np.asarray(b_dev)[0]) == want

    def test_zero_state_guard(self, monkeypatch):
        """seed() must repair an all-zero state row (xorshift's only
        bad orbit: an all-zero lane stays zero forever).  Force
        jax.random.bits to hand seed() a zero row and check the guard
        actually engages."""
        real_bits = jax.random.bits

        def zeroed_bits(key, shape, dtype):
            out = np.asarray(real_bits(key, shape, dtype)).copy()
            out[3] = 0                      # one all-zero lane
            return jnp.asarray(out)

        monkeypatch.setattr(jax.random, "bits", zeroed_bits)
        state = np.asarray(rng_mod.seed(jax.random.PRNGKey(0), 8))
        assert not np.any(np.all(state == 0, axis=-1)), \
            "guard left an all-zero row"
        # the repaired lane must actually generate entropy
        bits_seen = []
        st = state
        for _ in range(8):
            st, b = rng_mod.host_next_bits(st)
            bits_seen.append(b[3])
        assert np.any(np.asarray(bits_seen) != 0)
        # sanity: without the guard, an all-zero row stays zero forever
        dead = np.zeros((1, 4), np.uint32)
        for _ in range(4):
            dead, db = rng_mod.host_next_bits(dead)
            assert db[0] == 0


class TestHistogram:
    @pytest.mark.parametrize("n_bins,n_pts", [(64, 1000), (1000, 64),
                                              (4096, 30000)])
    def test_backends_agree(self, n_bins, n_pts):
        """Differential test: sortcum vs scatter (SURVEY.md §5 race
        detection row: exact-equality differential test instead).

        Every backend's density is exact; RGB differs only by f32
        reassociation."""
        rng = np.random.RandomState(0)
        addr = jnp.asarray(
            rng.randint(0, n_bins + 1, n_pts), jnp.int32)  # incl junk
        rgba = jnp.asarray(rng.rand(n_pts, 4).astype(np.float32))
        h0 = hist_mod.alloc(n_bins)
        a = hist_mod.accumulate_scatter(h0, addr, rgba)
        b = hist_mod.accumulate_sortcum(h0, addr, rgba)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=0.02)
        # scatter_sorted is a pure reordering of f32 adds: per-bin
        # sums match scatter to reassociation roundoff
        c = hist_mod.accumulate_scatter_sorted(h0, addr, rgba)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(c), rtol=1e-5, atol=1e-3)

    def test_hot_bin(self):
        """Everything lands on one pixel (the contention case the
        reference built its sort pipeline for)."""
        addr = jnp.zeros(10000, jnp.int32)
        rgba = jnp.ones((10000, 4), jnp.float32)
        for backend in ("scatter", "scatter_sorted", "sortcum"):
            h = hist_mod.get_backend(backend)(hist_mod.alloc(16), addr,
                                              rgba)
            np.testing.assert_allclose(np.asarray(h[0]), 10000.0,
                                       rtol=1e-5)
            assert float(jnp.abs(h[1:]).max()) == 0.0

    def test_empty_and_all_junk(self):
        h = hist_mod.alloc(16)
        addr = jnp.full((100,), 16, jnp.int32)   # all junk
        rgba = jnp.ones((100, 4), jnp.float32)
        for backend in ("scatter", "scatter_sorted", "sortcum"):
            out = hist_mod.get_backend(backend)(h, addr, rgba)
            assert float(jnp.abs(hist_mod.finalize(out)).max()) == 0.0

    def test_multidim_input(self):
        """(n_iters, B) shaped chunks flatten correctly."""
        rng = np.random.RandomState(1)
        addr = jnp.asarray(rng.randint(0, 32, (4, 25)), jnp.int32)
        rgba = jnp.asarray(rng.rand(4, 25, 4).astype(np.float32))
        a = hist_mod.accumulate_scatter(hist_mod.alloc(32), addr, rgba)
        b = hist_mod.accumulate_sortcum(hist_mod.alloc(32), addr, rgba)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-4)


class TestCamera:
    def test_center_maps_to_middle(self):
        spec = CameraSpec(100, 100, 1)
        addr, inb = project(spec, jnp.array([0.5, -0.5]),
                            jnp.float32(10.0), jnp.float32(0.0),
                            jnp.array([0.5]), jnp.array([-0.5]))
        assert bool(inb[0])
        assert int(addr[0]) == 50 * 100 + 50

    def test_out_of_bounds_junk(self):
        spec = CameraSpec(10, 10, 2)
        addr, inb = project(spec, jnp.array([0.0, 0.0]),
                            jnp.float32(1.0), jnp.float32(0.0),
                            jnp.array([1e6]), jnp.array([0.0]))
        assert not bool(inb[0])
        assert int(addr[0]) == spec.junk_bin

    def test_rotation(self):
        """+90deg rotate maps world +x direction to up in the image."""
        spec = CameraSpec(100, 100, 1)
        a0, _ = project(spec, jnp.zeros(2), jnp.float32(20.0),
                        jnp.float32(0.0), jnp.array([1.0]),
                        jnp.array([0.0]))
        a90, _ = project(spec, jnp.zeros(2), jnp.float32(20.0),
                         jnp.float32(90.0), jnp.array([1.0]),
                         jnp.array([0.0]))
        y0, x0 = divmod(int(a0[0]), 100)
        y90, x90 = divmod(int(a90[0]), 100)
        assert x0 > 50 and abs(y0 - 50) <= 1   # +x is right...
        assert y90 < 50 and abs(x90 - 50) <= 1  # ...rotates to up

    def test_supersample_addressing(self):
        spec = CameraSpec(8, 8, 2)
        assert spec.n_bins == 256
        assert spec.acc_width == 16

    def test_rot_center_pivot(self):
        """flam3 rot_center: the pivot point stays fixed in the image
        under any rotation; rot_center == center reproduces the
        default rotation exactly."""
        spec = CameraSpec(100, 100, 1)
        center = jnp.array([0.2, -0.1])
        rc = jnp.array([0.7, 0.3])
        ppu = jnp.float32(20.0)
        for deg in (0.0, 37.0, 90.0, 210.0):
            a, inb = project(spec, center, ppu, jnp.float32(deg),
                             rc[:1], rc[1:], rot_center=rc)
            assert bool(inb[0])
            # pivot's pixel is rotation-invariant
            a0, _ = project(spec, center, ppu, jnp.float32(0.0),
                            rc[:1], rc[1:], rot_center=rc)
            assert int(a[0]) == int(a0[0])
        # rot_center defaulting to center == explicit center pivot
        xs = jnp.array([0.9, -0.3, 0.0])
        ys = jnp.array([0.1, 0.6, -0.5])
        a1, _ = project(spec, center, ppu, jnp.float32(55.0), xs, ys)
        a2, _ = project(spec, center, ppu, jnp.float32(55.0), xs, ys,
                        rot_center=center)
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
        # a different pivot genuinely changes the projection
        a3, _ = project(spec, center, ppu, jnp.float32(55.0), xs, ys,
                        rot_center=rc)
        assert not np.array_equal(np.asarray(a1), np.asarray(a3))


class TestIterate:
    def _run(self, genome, batch=512, n_iters=64, seed=0):
        key = genome.structure_key()
        params = jax.tree_util.tree_map(
            jnp.asarray, genome.eval_at(0.0))
        cam = CameraSpec(64, 64, 1)
        cdf = xform_cdf_rows(params)
        state = init_state(jax.random.PRNGKey(seed), batch)
        return iterate_chunk(key, cam, params, cdf, state,
                             params.ppu * (64 / genome.size[0]),
                             n_iters, 16)

    def test_deterministic(self):
        g = sierpinski()
        _, a1, r1 = self._run(g, seed=5)
        _, a2, r2 = self._run(g, seed=5)
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
        np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))

    def test_seed_changes_output(self):
        g = sierpinski()
        _, a1, _ = self._run(g, seed=1)
        _, a2, _ = self._run(g, seed=2)
        assert not np.array_equal(np.asarray(a1), np.asarray(a2))

    def test_fuse_suppresses_early_plots(self):
        g = sierpinski()
        _, addrs, _ = self._run(g, n_iters=8)   # all iters < fuse=16
        cam = CameraSpec(64, 64, 1)
        assert np.all(np.asarray(addrs) == cam.junk_bin)

    def test_points_stay_finite_full_feature(self):
        g = full_feature()
        state, addrs, rgbas = self._run(g, batch=256, n_iters=128)
        assert np.isfinite(np.asarray(state.x)).all()
        assert np.isfinite(np.asarray(state.y)).all()
        assert np.isfinite(np.asarray(rgbas)).all()

    def test_sierpinski_attractor_support(self):
        """Post-fuse points must lie inside the attractor's bounding
        triangle (chaos-game correctness)."""
        g = sierpinski()
        state, _, _ = self._run(g, batch=1024, n_iters=128)
        x = np.asarray(state.x)
        y = np.asarray(state.y)
        assert x.min() >= -1.001 and x.max() <= 1.001
        assert y.min() >= -0.867 and y.max() <= 0.867

    def test_temporal_weight_scales_mass_exactly(self):
        """iterate_accumulate's `weight` must scale every record's
        contribution exactly (the flam3 temporal-filter weight)."""
        from cuburn_tpu.ops.iterate import iterate_accumulate
        g = sierpinski()
        key = g.structure_key()
        params = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.0))
        cam = CameraSpec(64, 64, 1)
        cdf = xform_cdf_rows(params)
        state = init_state(jax.random.PRNGKey(3), 512)
        hist0 = hist_mod.alloc(cam.n_bins)
        ppu = params.ppu * (64 / g.size[0])
        args = (key, cam, "scatter", params, cdf, state, hist0, ppu,
                jnp.int32(2), 16, 8)
        _, h1, n1 = iterate_accumulate(*args, weight=jnp.float32(1.0))
        _, h2, n2 = iterate_accumulate(*args, weight=jnp.float32(0.25))
        np.testing.assert_allclose(np.asarray(h2), np.asarray(h1) * 0.25,
                                   rtol=1e-6)
        assert int(n1) == int(n2)   # counts stay unweighted

    def test_respawn_uniform_2d(self):
        """Badvalue respawn must fill the bi-unit square uniformly in
        BOTH dimensions jointly (flam3 rule, SURVEY.md §3.5) — round 1
        derived ry from rx, putting respawns on a 1-D curve.  Checked
        with a 2-D chi-square over 32x32 cells on 1M hashed pairs."""
        from cuburn_tpu.ops.iterate import respawn_xy
        n = 1 << 20
        rng = np.random.RandomState(11)
        bits = jnp.asarray(
            rng.randint(0, 2**32, n, dtype=np.uint32))
        rx, ry = jax.jit(respawn_xy)(bits)
        rx, ry = np.asarray(rx), np.asarray(ry)
        assert rx.min() >= -1 and rx.max() <= 1
        assert ry.min() >= -1 and ry.max() <= 1
        k = 32
        ix = np.clip(((rx + 1) * 0.5 * k).astype(int), 0, k - 1)
        iy = np.clip(((ry + 1) * 0.5 * k).astype(int), 0, k - 1)
        counts = np.bincount(ix * k + iy, minlength=k * k)
        expected = n / (k * k)
        chi2 = ((counts - expected) ** 2 / expected).sum()
        # dof = 1023; mean 1023, std ~45 — 1300 is > +6 sigma
        assert chi2 < 1300, f"chi2={chi2:.0f} (2-D nonuniform respawn)"
        # and rx must not determine ry: within one rx bucket, ry spreads
        sel = ix == k // 2
        assert sel.sum() > 1000
        assert np.unique(iy[sel]).size == k

    def test_xaos_changes_distribution(self):
        g = full_feature()
        params = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.0))
        cdf = xform_cdf_rows(params)
        c = np.asarray(cdf)
        # xaos row 1 forbids xform 2 (weight 0): rows must differ
        assert not np.allclose(c[0], c[1])
        assert c[1, 1] == pytest.approx(c[1, 2])  # p(xf2 | xf1) = 0


class TestOpacityPackedRecords:
    """Opacity-extended packed records (ops/iterate.py
    opacity_bits_for): genomes with per-xform opacity != 1 keep the
    packed fast path by folding the xform id into an extended-palette
    coordinate whose rows carry rgb*opacity and density=opacity."""

    def _genome(self):
        from cuburn_tpu.genome.spline import Spline
        g = sierpinski()
        g.xforms[1].opacity = Spline(0.5)
        g.xforms[2].opacity = Spline(0.25)
        return g

    def test_matches_full_records(self):
        from cuburn_tpu.ops.iterate import (iterate_accumulate,
                                            opacity_bits_for)
        g = self._genome()
        key = g.structure_key()
        params = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.0))
        cam = CameraSpec(64, 64, 1)
        ob, cb = opacity_bits_for(cam.n_bins, key.n_xforms)
        assert ob == 2 and cb == 8
        cdf = xform_cdf_rows(params)
        ppu = params.ppu * jnp.float32(64 / g.size[0])
        outs = {}
        for packed, op_bits in ((False, 0), (True, ob)):
            state = init_state(jax.random.PRNGKey(6), 1024)
            h0 = hist_mod.alloc(cam.n_bins)
            _, h, n = iterate_accumulate(
                key, cam, "scatter", params, cdf, state, h0, ppu,
                jnp.int32(3), 16, 8, packed=packed, op_bits=op_bits)
            outs[packed] = (np.asarray(h), int(n))
        full, n_full = outs[False]
        pck, n_pck = outs[True]
        assert n_full == n_pck
        # density channel = sum of opacities: EXACT in both paths
        np.testing.assert_allclose(pck[:-1, 3], full[:-1, 3],
                                   rtol=1e-6)
        # rgb differs only by the 8-bit palette-coordinate
        # quantization: up to ~half a palette step PER SAMPLE, so the
        # bound scales with each bin's sample count (density/opacity
        # >= count*0.25 here -> 4*density bounds the count)
        bound = 8e-3 * np.maximum(4.0 * full[:-1, 3:4], 1.0)
        assert (np.abs(pck[:-1, :3] - full[:-1, :3]) <= bound).all()
        # and translucency is real: total mass < plotted count
        assert pck[:-1, 3].sum() < n_pck * 0.999


class TestPackedVsFullRecords:
    """The packed-u32 log path must agree with the full-record path on
    unit-opacity genomes (same trajectories, same flush totals)."""

    def test_histograms_agree(self):
        from cuburn_tpu.ops.iterate import iterate_accumulate
        from cuburn_tpu.ops import histogram as hm
        g = sierpinski()
        key = g.structure_key()
        params = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.0))
        cam = CameraSpec(64, 64, 1)
        cdf = xform_cdf_rows(params)
        state = init_state(jax.random.PRNGKey(4), 1024)
        ppu = params.ppu * jnp.float32(64 / g.size[0])

        outs = {}
        for packed in (True, False):
            h = hm.alloc(cam.n_bins)
            _, h, n = iterate_accumulate(
                key, cam, "scatter", params, cdf, state, h, ppu,
                jnp.int32(4), 16, 16, packed=packed)
            outs[packed] = (np.asarray(h), int(n))
        assert outs[True][1] == outs[False][1]          # same plotted
        a, b = outs[True][0][:-1], outs[False][0][:-1]  # drop junk
        # density identical; colors differ only by 10-bit quantization
        np.testing.assert_allclose(a[:, 3], b[:, 3], atol=1e-3)
        np.testing.assert_allclose(a[:, :3], b[:, :3], atol=2e-3,
                                   rtol=2e-2)


def test_zero_xaos_row_falls_back_to_uniform():
    """An all-forbidding xaos row must select uniformly, not fetch an
    all-zero parameter row with a bogus recorded index (review repro)."""
    from cuburn_tpu.ops.iterate import xform_cdf_rows
    g = sierpinski()
    g.xaos = [[0.0, 0.0, 0.0],
              [1.0, 1.0, 1.0],
              [1.0, 1.0, 1.0]]
    g.__post_init__()
    params = g.eval_at(0.0)
    cdf = np.asarray(xform_cdf_rows(
        jax.tree_util.tree_map(jnp.asarray, params)))
    # row 0 falls back to uniform: strictly increasing, ends at 1
    assert cdf[0, -1] == pytest.approx(1.0)
    assert (np.diff(cdf[0]) > 0).all()
