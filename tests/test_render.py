"""Renderer/pipeline integration tests (SURVEY.md §4 golden-image row):
tiny genomes, fixed PRNG keys, structural and statistical assertions on
the rendered output — the regression corpus the reference only had as
manual eyeballing."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuburn_tpu.models import (animated_spark, classic_swirl,
                               full_feature, sierpinski)
from cuburn_tpu.profile import RenderProfile, get_profile
from cuburn_tpu.render import Renderer

FAST = RenderProfile(width=96, height=96, quality=60, batch=2048,
                     iters_per_chunk=16, fuse=16,
                     hist_backend="scatter", de_enabled=False)


class TestStillRender:
    def test_sierpinski_structure(self):
        """The attractor has the Sierpinski gasket's self-similar
        structure: the middle of the triangle is empty."""
        img, stats = Renderer(sierpinski(), FAST).render_frame(0.0, 1)
        assert img.shape == (96, 96, 4)
        assert stats.retention > 0.5
        lum = img[..., :3].astype(np.float64).sum(-1)
        # the central removed triangle of the gasket must be empty:
        # its center is the centroid (0, -0.289) in world units
        # (corners (+-1,-0.866),(0,0.866); world +y maps down)
        ppu_eff = 220.0 * 96 / 512
        cy = int(round(48 + (-0.289) * ppu_eff))
        assert lum[cy - 1:cy + 2, 47:50].max() == 0.0
        assert lum.sum() > 0
        # symmetry: left-right mirror approximately equal mass
        assert abs(lum[:, :48].sum() - lum[:, 48:].sum()) \
            / lum.sum() < 0.1

    def test_deterministic_given_seed(self):
        r = Renderer(sierpinski(), FAST)
        img1, _ = r.render_frame(0.0, seed=9)
        img2, _ = r.render_frame(0.0, seed=9)
        np.testing.assert_array_equal(img1, img2)

    def test_different_seeds_statistically_same(self):
        r = Renderer(sierpinski(), FAST)
        img1, _ = r.render_frame(0.0, seed=1)
        img2, _ = r.render_frame(0.0, seed=2)
        m1 = img1[..., :3].astype(np.float64).mean()
        m2 = img2[..., :3].astype(np.float64).mean()
        assert m1 == pytest.approx(m2, rel=0.1)

    def test_classic_swirl_renders(self):
        img, stats = Renderer(classic_swirl(), FAST).render_frame(0.0, 1)
        assert img[..., :3].max() > 0
        assert stats.plotted_samples > 0

    def test_full_feature_renders(self):
        img, stats = Renderer(full_feature(), FAST).render_frame(0.0, 1)
        assert img[..., :3].max() > 0

    def test_de_enabled_spreads_sparse_mass(self):
        """DE must blur low-density regions: count lit pixels with and
        without DE at low quality; DE strictly increases coverage."""
        g = sierpinski()
        g.estimator_radius = __import__(
            "cuburn_tpu.genome.spline", fromlist=["Spline"]
        ).Spline(5.0)
        lowq = dataclasses.replace(FAST, quality=8)
        img_de, _ = Renderer(
            g, dataclasses.replace(lowq, de_enabled=True)
        ).render_frame(0.0, 3)
        img_no, _ = Renderer(
            g, dataclasses.replace(lowq, de_enabled=False)
        ).render_frame(0.0, 3)
        lit_de = (img_de[..., :3].sum(-1) > 0).sum()
        lit_no = (img_no[..., :3].sum(-1) > 0).sum()
        assert lit_de > lit_no * 1.2

    def test_supersampling(self):
        prof = dataclasses.replace(FAST, ss=2)
        img, _ = Renderer(sierpinski(), prof).render_frame(0.0, 1)
        assert img.shape == (96, 96, 4)
        assert img[..., :3].max() > 0

    def test_transparent_mode(self):
        prof = dataclasses.replace(FAST, transparent=True)
        img, _ = Renderer(sierpinski(), prof).render_frame(0.0, 1)
        # alpha varies (not all-opaque), background pixels transparent
        assert img[..., 3].min() == 0
        assert img[..., 3].max() > 0


class TestAnimation:
    def test_motion_blur_differs_from_still(self):
        g = animated_spark()
        prof1 = dataclasses.replace(FAST, temporal_samples=1)
        prof4 = dataclasses.replace(FAST, temporal_samples=4)
        img1, _ = Renderer(g, prof1).render_frame(0.5, seed=2)
        img4, s4 = Renderer(g, prof4).render_frame(0.5, seed=2)
        assert s4.plotted_samples > 0
        assert not np.array_equal(img1, img4)

    def test_frames_iterator(self):
        g = animated_spark()
        prof = dataclasses.replace(FAST, fps=4.0, duration=0.75)
        frames = list(Renderer(g, prof).frames(seed=1))
        assert len(frames) == 3
        # animated genome: successive frames differ
        assert not np.array_equal(frames[0][0], frames[-1][0])

    def test_overlapped_frames_bit_identical(self):
        """The cross-frame pipelined driver (frames_overlapped) must
        yield the EXACT frames of the serial driver — the same device
        programs run in the same order; only host synchronization
        moves (SURVEY.md §2b pipeline-overlap row)."""
        g = animated_spark()
        prof = dataclasses.replace(FAST, fps=4.0, duration=1.0,
                                   temporal_samples=2)
        r = Renderer(g, prof)
        serial = list(r.frames(seed=3))
        overlapped = list(r.frames_overlapped(seed=3))
        assert len(serial) == len(overlapped) == 4
        for (a, sa), (b, sb) in zip(serial, overlapped):
            np.testing.assert_array_equal(a, b)
            assert sa.plotted_samples == sb.plotted_samples
            assert sa.total_iters == sb.total_iters

    def test_bench_scripts_import_clean(self):
        """Every bench/ script plus bench.py and chip_smoke.py must at
        least import (all have __main__ guards): the measurement kit
        must not bit-rot between runs on the card."""
        import glob
        import importlib.util
        root = os.path.join(os.path.dirname(__file__), "..")
        scripts = sorted(glob.glob(os.path.join(root, "bench", "*.py")))
        scripts += [os.path.join(root, "bench.py"),
                    os.path.join(root, "chip_smoke.py")]
        assert len(scripts) >= 6
        for path in scripts:
            name = "bench_smoke_" + os.path.basename(path)[:-3]
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)     # raises on rot

    def test_auto_iters_per_chunk(self, monkeypatch):
        """iters_per_chunk=0 resolves to the default measured on the
        card (render.DEFAULT_ITERS_PER_CHUNK) for every backend and
        geometry; explicit profile values and CUBURN_ITERS_PER_CHUNK
        always win, and env "0" means auto like the profile field."""
        from cuburn_tpu.render import (DEFAULT_ITERS_PER_CHUNK,
                                       resolve_iters_per_chunk)
        r = Renderer(sierpinski(), FAST)       # explicit in FAST
        assert r.profile.iters_per_chunk == FAST.iters_per_chunk
        auto = dataclasses.replace(FAST, iters_per_chunk=0)
        for backend in ("auto", "scatter", "scatter_sorted", "sortcum"):
            prof = dataclasses.replace(auto, hist_backend=backend)
            r = Renderer(sierpinski(), prof)
            assert r.profile.iters_per_chunk == DEFAULT_ITERS_PER_CHUNK
        assert resolve_iters_per_chunk(
            dataclasses.replace(auto, width=1920, height=1080,
                                ss=2)) == DEFAULT_ITERS_PER_CHUNK
        assert resolve_iters_per_chunk(
            dataclasses.replace(auto, iters_per_chunk=48)) == 48
        monkeypatch.setenv("CUBURN_ITERS_PER_CHUNK", "24")
        assert resolve_iters_per_chunk(auto) == 24
        assert Renderer(sierpinski(), auto).profile.iters_per_chunk \
            == 24
        monkeypatch.setenv("CUBURN_ITERS_PER_CHUNK", "0")
        assert resolve_iters_per_chunk(auto) == DEFAULT_ITERS_PER_CHUNK

    def test_animated_filter_geometry_sized_to_range_max(self):
        """Static filter geometry (gutter, DE ladder, filter taps)
        must cover the spline MAX over the time range, not t=0
        (regression: a growing estimator_radius clipped DE support at
        later frame times — dark frame edges)."""
        import warnings as _w
        from cuburn_tpu.genome.spline import Spline
        from cuburn_tpu.models import sierpinski
        g = sierpinski()
        g.estimator_radius = Spline([0.0, 2.0, 1.0, 8.0])
        g.spatial_filter = Spline([0.0, 0.3, 1.0, 1.2])
        g.time_range = (0.0, 1.0)
        prof = dataclasses.replace(FAST, de_enabled=True)
        with _w.catch_warnings(record=True) as rec:
            _w.simplefilter("always")
            r = Renderer(g, prof)
        assert r._static_de_r == pytest.approx(8.0 * prof.ss)
        assert r._static_sf == pytest.approx(1.2)
        assert r.cam.gutter >= int(np.ceil(1.5 * 8.0))
        assert any("spatial_filter animates" in str(w.message)
                   for w in rec)

    def test_frames_partitioned_overlap_flag(self):
        g = animated_spark()
        prof = dataclasses.replace(FAST, fps=4.0, duration=0.5)
        r = Renderer(g, prof)
        a = list(r.frames_partitioned(seed=2, overlap=True))
        b = list(r.frames_partitioned(seed=2))
        assert len(a) == len(b)
        for (ia, _), (ib, _) in zip(a, b):
            np.testing.assert_array_equal(ia, ib)

    def test_animated_genome_time_variation(self):
        g = animated_spark()
        r = Renderer(g, FAST)
        img_a, _ = r.render_frame(0.0, seed=5)
        img_b, _ = r.render_frame(1.0, seed=5)
        assert not np.array_equal(img_a, img_b)


class TestTemporalFilter:
    def test_filter_weights_semantics(self):
        """flam3 create_temporal_filter: deltas (i/n - 0.5)*width for
        every type; box = all ones; gaussian peaks at the center;
        exp monotone by sign; all max-normalized to 1."""
        from cuburn_tpu.render import temporal_filter_weights
        d, w, s = temporal_filter_weights(4, "box", 1.0, 0.0)
        np.testing.assert_allclose(d, [-0.5, -0.25, 0.0, 0.25])
        np.testing.assert_allclose(w, 1.0)
        assert s == 1.0
        d, w, s = temporal_filter_weights(8, "gaussian", 2.0, 0.0)
        np.testing.assert_allclose(d, (np.arange(8) / 8 - 0.5) * 2.0)
        assert w.max() == 1.0 and np.argmax(w) == 4
        assert w[0] < w[2] < w[4] and w[7] < w[5]
        assert 0 < s < 1
        _, w, _ = temporal_filter_weights(6, "exp", 1.0, 2.0)
        assert (np.diff(w) > 0).all() and w[-1] == 1.0
        _, w, _ = temporal_filter_weights(6, "exp", 1.0, -2.0)
        assert (np.diff(w) < 0).all() and w[0] == 1.0

    def test_shutter_matches_frames_stepping(self):
        """The motion-blur shutter interval must equal the actual
        per-frame genome-time step of frames() for ANY time_range span
        or explicit duration (round-1 used 1/(fps*span), which is only
        right when span == 1)."""
        g = animated_spark()
        g.time_range = (0.0, 2.0)
        prof = dataclasses.replace(FAST, fps=4.0, temporal_samples=4)
        r = Renderer(g, prof)
        # duration None: n_frames = round(2*4) = 8, step = 2/7
        assert r.frame_dt() == pytest.approx(2.0 / 7.0)
        times, w, s = r._temporal_times(1.0)
        span = max(times) - min(times)
        assert span == pytest.approx((3.0 / 4.0) * r.frame_dt())
        # explicit duration: n_frames = round(3*4) = 12, step = 2/11
        prof_d = dataclasses.replace(prof, duration=3.0)
        r2 = Renderer(g, prof_d)
        assert r2.frame_dt() == pytest.approx(2.0 / 11.0)
        # and frames() really steps by frame_dt
        ts = [1.0 * i / 7 * 2.0 for i in range(8)]
        assert ts[1] - ts[0] == pytest.approx(r.frame_dt())

    def test_gaussian_filter_preserves_brightness(self):
        """sumfilt normalization: a gaussian temporal filter must not
        change overall image brightness vs box (flam3 folds sumfilt
        into k2)."""
        g = animated_spark()
        prof = dataclasses.replace(FAST, temporal_samples=6)
        img_box, _ = Renderer(g, prof).render_frame(0.5, seed=4)
        g2 = animated_spark()
        g2.temporal_filter_type = "gaussian"
        img_g, _ = Renderer(g2, prof).render_frame(0.5, seed=4)
        assert not np.array_equal(img_box, img_g)
        m_box = img_box[..., :3].astype(np.float64).mean()
        m_g = img_g[..., :3].astype(np.float64).mean()
        assert m_g == pytest.approx(m_box, rel=0.15)

    def test_resume_uses_fresh_samples(self):
        """Resuming accumulation with the SAME seed must add new
        samples, not replay the identical stream (round-1 doubled
        density uniformly)."""
        r = Renderer(sierpinski(), FAST)
        h1, _ = r.accumulate(0.0, seed=1)
        h2, _ = r.accumulate(0.0, seed=1, hist0=np.asarray(h1))
        a = np.asarray(h1)[:-1, 3]
        b = np.asarray(h2)[:-1, 3] - a
        # second pass's own contribution must differ from the first
        # (identical streams would give b == a exactly)
        assert not np.array_equal(a, b)
        assert b.sum() == pytest.approx(a.sum(), rel=0.05)


class TestOutput:
    def test_png_roundtrip(self, tmp_path):
        from cuburn_tpu.output import write_image
        from PIL import Image
        img, _ = Renderer(sierpinski(), FAST).render_frame(0.0, 1)
        p = tmp_path / "out.png"
        write_image(str(p), img)
        back = np.asarray(Image.open(p))
        np.testing.assert_array_equal(back, img)

    def test_y4m_sink(self, tmp_path):
        from cuburn_tpu.output import Y4MSink
        p = tmp_path / "out.y4m"
        sink = Y4MSink(str(p), 96, 96, fps=24)
        img = np.zeros((96, 96, 4), np.uint8)
        img[..., 0] = 255
        sink.write_frame(img)
        sink.write_frame(img)
        sink.close()
        data = p.read_bytes()
        assert data.startswith(b"YUV4MPEG2 W96 H96")
        assert data.count(b"FRAME\n") == 2


class TestCLI:
    def test_still_render(self, tmp_path):
        from cuburn_tpu.main import main
        out = tmp_path / "cli.png"
        rc = main(["gallery:sierpinski", "-o", str(out),
                   "--profile", "preview", "--width", "64",
                   "--height", "64", "--quality", "30"])
        assert rc == 0
        assert out.exists()

    def test_striped_cli(self, tmp_path):
        from cuburn_tpu.main import main
        out = tmp_path / "striped.png"
        rc = main(["gallery:sierpinski", "-o", str(out),
                   "--profile", "preview", "--width", "64",
                   "--height", "64", "--quality", "30",
                   "--stripes", "3"])
        assert rc == 0
        from PIL import Image
        img = np.asarray(Image.open(out))
        assert img[..., :3].max() > 0


    def test_banded_cli_matches_unbanded(self, tmp_path):
        """--bands must produce the same image as the whole-frame
        filter (the banding is an exact partition up to float
        reassociation -> <= 1 u8 step)."""
        from cuburn_tpu.main import main
        a = tmp_path / "whole.png"
        b = tmp_path / "banded.png"
        args = ["gallery:classic_swirl", "--profile", "preview",
                "--width", "64", "--height", "64", "--quality", "40"]
        assert main(args + ["-o", str(a)]) == 0
        assert main(args + ["-o", str(b), "--bands", "3"]) == 0
        from PIL import Image
        ia = np.asarray(Image.open(a)).astype(int)
        ib = np.asarray(Image.open(b)).astype(int)
        assert np.abs(ia - ib).max() <= 1

    def test_stripes_resume_rejected(self, tmp_path):
        from cuburn_tpu.main import main
        import pytest as _pytest
        with _pytest.raises(SystemExit, match="not supported"):
            main(["gallery:sierpinski", "-o", str(tmp_path / "x.png"),
                  "--stripes", "2", "--resume-hist", "none.npy"])

    def test_convert(self, capsys):
        from cuburn_tpu.main import main
        rc = main(["gallery:full_feature", "--convert"])
        assert rc == 0
        text = capsys.readouterr().out
        from cuburn_tpu.genome.specs import Genome
        g = Genome.from_json(text)
        assert g.structure_key() == full_feature().structure_key()

    def test_animate_rejects_still_only_flags(self, tmp_path):
        """--save-hist/--resume-hist/--time drive the still path only;
        a checkpoint request with --animate must refuse, not be
        silently ignored."""
        from cuburn_tpu.main import main
        import pytest as _pytest
        base = ["gallery:sierpinski", "--animate",
                "-o", str(tmp_path / "x.y4m")]
        for extra in (["--save-hist", str(tmp_path / "h.npy")],
                      ["--resume-hist", str(tmp_path / "h.npy")],
                      ["--time", "0.5"]):
            with _pytest.raises(SystemExit, match="stills"):
                main(base + extra)

    def test_animate_convert_skips_sequence(self, capsys):
        """--animate --convert on a multi-flame file prints the first
        genome's JSON and exits 0 without building the keyframe
        sequence (which would cost a structure-key pass per edge)."""
        import os
        from cuburn_tpu.main import main
        fixture = os.path.join(os.path.dirname(__file__), "fixtures",
                               "wild_sheep.flam3")
        rc = main([fixture, "--animate", "--convert"])
        assert rc == 0
        from cuburn_tpu.genome.specs import Genome
        Genome.from_json(capsys.readouterr().out)

    def test_flam3_file_input(self, tmp_path):
        from cuburn_tpu.genome.convert import genome_to_flame_xml
        from cuburn_tpu.main import main
        xml = genome_to_flame_xml(classic_swirl())
        p = tmp_path / "g.flam3"
        p.write_text(xml)
        out = tmp_path / "g.png"
        rc = main([str(p), "-o", str(out), "--profile", "preview",
                   "--width", "64", "--height", "64",
                   "--quality", "20"])
        assert rc == 0
        assert out.exists()


class TestStripedAccumulate:
    def test_stripe_camera_packs_at_full_frame_depth(self):
        """Record layout (color/opacity bit splits) must come from the
        FULL frame's bin count even inside a stripe camera
        (regression: at 1080p-ss2-class sizes the whole frame packs
        8-bit palette coordinates while a 4-stripe camera's smaller
        n_bins freed 10 — striped renders disagreed with the
        whole-frame histogram they claim to partition exactly; the
        small-size equality tests below can't see it because both
        resolve to 10 bits there)."""
        from cuburn_tpu.ops.camera import CameraSpec
        from cuburn_tpu.ops.iterate import (color_bits_for,
                                            opacity_bits_for)
        full = CameraSpec(1920, 1080, 2, gutter=24)
        n = 4
        th = -(-full.acc_height // n)
        stripe = CameraSpec(1920, 1080, 2, gutter=24,
                            full_acc_height=full.acc_height,
                            tile_acc_height=th)
        assert stripe.n_bins < full.n_bins          # the trap
        assert stripe.layout_bins == full.n_bins
        assert color_bits_for(stripe.layout_bins) \
            == color_bits_for(full.n_bins)
        assert opacity_bits_for(stripe.layout_bins, 5) \
            == opacity_bits_for(full.n_bins, 5)
        # ...and the depths genuinely diverge without layout_bins
        assert color_bits_for(stripe.n_bins) \
            != color_bits_for(full.n_bins)

    def test_striped_matches_whole_frame_exactly(self):
        """Striped accumulation projects in FULL-frame coordinates, so
        with the same seed it partitions the identical trajectory
        stream across stripe sub-programs — the stitched histogram must
        equal the whole-frame histogram exactly (the 1080p strategy for
        device-memory/dev-worker limits, BASELINE.md configs 3/4)."""
        r = Renderer(full_feature(), FAST)
        whole, st_w = r.accumulate(0.0, seed=7)
        striped, st_s = r.accumulate_striped(0.0, seed=7, n_stripes=3)
        np.testing.assert_array_equal(np.asarray(whole)[:-1],
                                      striped[:-1])
        assert st_s.plotted_samples == st_w.plotted_samples
        assert st_s.total_iters == 3 * st_w.total_iters
        img = r.finalize_frame(striped, 0.0)
        assert img[..., :3].max() > 0

    def test_striped_with_rotation(self):
        """Rotation happens in full-frame projection before the stripe
        offset, so rotated cameras stripe exactly too."""
        from cuburn_tpu.genome.spline import Spline
        g = full_feature()
        g.rotate = Spline(37.0)
        r = Renderer(g, FAST)
        assert not r.cam.no_rotation
        whole, _ = r.accumulate(0.0, seed=8)
        striped, _ = r.accumulate_striped(0.0, seed=8, n_stripes=4)
        np.testing.assert_array_equal(np.asarray(whole)[:-1],
                                      striped[:-1])

    def test_banded_finalize_matches_whole_frame(self):
        """finalize_frame_banded must reproduce finalize_frame up to
        float reassociation (XLA tiles convs differently per program
        shape, flipping u8 rounding on exact boundaries — at most 1
        step): DE on, ss=2, gutter, spatial filter, H not divisible by
        the band count."""
        from cuburn_tpu.genome.spline import Spline
        g = full_feature()
        g.estimator_radius = Spline(5.0)
        g.spatial_filter_shape = "mitchell"
        prof = dataclasses.replace(FAST, width=80, height=88, ss=2,
                                   de_enabled=True)
        r = Renderer(g, prof)
        hist, st = r.accumulate(0.0, seed=6)
        whole = r.finalize_frame(hist, 0.0)
        banded = r.finalize_frame_banded(hist, 0.0, n_bands=3)
        diff = np.abs(banded.astype(int) - whole.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.005

    def test_rgb_only_device_readback_contract(self):
        """Opaque renders read back rgb-only from the device (alpha
        is a constant 255 the host fills in, render._with_alpha) —
        25% fewer final-frame D2H bytes on every filter path; the
        host-facing finalize_frame/overlapped-driver surface stays
        (H, W, 4) with alpha 255, and transparent profiles keep the
        full 4-channel device frame."""
        g = sierpinski()
        r = Renderer(g, FAST)
        hist, _ = r.accumulate(0.0, seed=5)
        dev = r.finalize_frame_device(hist, 0.0)
        assert dev.shape == (FAST.height, FAST.width, 3)
        full = r.finalize_frame(hist, 0.0)
        assert full.shape == (FAST.height, FAST.width, 4)
        assert (full[..., 3] == 255).all()
        np.testing.assert_array_equal(full[..., :3], np.asarray(dev))
        img, _ = next(iter(r.frames_overlapped(seed=5)))
        assert img.shape == (FAST.height, FAST.width, 4)
        assert (img[..., 3] == 255).all()
        rt = Renderer(g, dataclasses.replace(FAST, transparent=True))
        hist_t, _ = rt.accumulate(0.0, seed=5)
        dev_t = rt.finalize_frame_device(hist_t, 0.0)
        assert dev_t.shape == (FAST.height, FAST.width, 4)

    def test_striped_with_supersample_and_gutter(self):
        from cuburn_tpu.genome.spline import Spline
        g = sierpinski()
        g.estimator_radius = Spline(5.0)
        prof = dataclasses.replace(FAST, ss=2, de_enabled=True)
        r = Renderer(g, prof)
        assert r.cam.gutter > 0
        whole, _ = r.accumulate(0.0, seed=2)
        striped, _ = r.accumulate_striped(0.0, seed=2, n_stripes=4)
        np.testing.assert_array_equal(np.asarray(whole)[:-1],
                                      striped[:-1])


class TestDispatchCap:
    def test_capped_dispatches_match_single_dispatch(self):
        """dispatch_iter_cap splits accumulation into several device
        calls carrying state+histogram — identical computation, so the
        result is bit-identical to the single-dispatch render."""
        g = full_feature()
        r1 = Renderer(g, FAST)
        h1, s1 = r1.accumulate(0.0, seed=5)
        prof_c = dataclasses.replace(FAST, dispatch_iter_cap=100_000)
        r2 = Renderer(g, prof_c)
        h2, s2 = r2.accumulate(0.0, seed=5)
        np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
        assert s1.plotted_samples == s2.plotted_samples
        assert s1.total_iters == s2.total_iters

    def test_temporal_capped_matches_uncapped(self):
        """dispatch_iter_cap on a MOTION-BLURRED frame (regression:
        the temporal path ignored the cap and ran T x n_chunks in one
        execution).  The in-program
        loop is sample-major with state threaded, so both host-side
        splits — whole-sample groups, and per-chunk within a sample —
        reproduce the exact uncapped order: bit-identical."""
        g = animated_spark()
        prof = dataclasses.replace(FAST, temporal_samples=4, fps=4.0,
                                   duration=1.0, quality=40,
                                   width=64, height=64)
        r = Renderer(g, prof)
        h0, s0 = r.accumulate(0.5, seed=9)
        per_chunk = prof.batch * prof.iters_per_chunk
        iters_per_sample = prof.total_iters / 4
        n_chunks = int(np.ceil(iters_per_sample / per_chunk))
        per_sample = n_chunks * per_chunk
        # (a) cap admits two samples per call -> sample-group split
        prof_g = dataclasses.replace(prof,
                                     dispatch_iter_cap=2 * per_sample)
        hg, sg = Renderer(g, prof_g).accumulate(0.5, seed=9)
        np.testing.assert_array_equal(np.asarray(h0), np.asarray(hg))
        assert s0.total_iters == sg.total_iters
        # (b) cap below one sample -> per-chunk split inside samples
        assert n_chunks >= 2     # so the chunk split actually splits
        prof_c = dataclasses.replace(prof,
                                     dispatch_iter_cap=per_chunk)
        hc, sc = Renderer(g, prof_c).accumulate(0.5, seed=9)
        np.testing.assert_array_equal(np.asarray(h0), np.asarray(hc))
        assert s0.total_iters == sc.total_iters


class TestCheckpointResume:
    def test_resume_accumulation_doubles_mass(self):
        r = Renderer(sierpinski(), FAST)
        h1, s1 = r.accumulate(0.0, seed=1)
        h2, s2 = r.accumulate(0.0, seed=2, hist0=np.asarray(h1))
        m1 = float(np.asarray(h1)[:-1, 3].sum())
        m2 = float(np.asarray(h2)[:-1, 3].sum())
        assert m2 == pytest.approx(2 * m1, rel=0.05)
        img = r.finalize_frame(h2, 0.0)
        assert img[..., :3].max() > 0

    def test_resume_shape_validation(self):
        r = Renderer(sierpinski(), FAST)
        with pytest.raises(ValueError):
            r.accumulate(0.0, hist0=np.zeros((7, 4), np.float32))

    def test_cli_save_and_resume(self, tmp_path):
        from cuburn_tpu.main import main
        hist_file = str(tmp_path / "ckpt.npy")
        out1 = str(tmp_path / "a.png")
        out2 = str(tmp_path / "b.png")
        base = ["gallery:sierpinski", "--profile", "preview",
                "--width", "64", "--height", "64", "--quality", "20"]
        assert main(base + ["-o", out1, "--save-hist", hist_file]) == 0
        assert main(base + ["-o", out2, "--resume-hist", hist_file,
                            "--seed", "5"]) == 0
        a = np.load(hist_file)
        # accumulator carries the gutter (DE + spatial-filter support)
        from cuburn_tpu.models import sierpinski
        from cuburn_tpu.profile import get_profile
        r = Renderer(sierpinski(), get_profile(
            "preview", width=64, height=64, quality=20))
        assert a.shape == (r.cam.n_bins + 1, 4)


class TestShardedCLI:
    def test_devices_flag(self, tmp_path):
        import jax
        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from cuburn_tpu.main import main
        out = str(tmp_path / "s.png")
        rc = main(["gallery:sierpinski", "-o", out, "--profile",
                   "preview", "--width", "64", "--height", "64",
                   "--quality", "20", "--devices", "4"])
        assert rc == 0
        from PIL import Image
        img = np.asarray(Image.open(out))
        assert img[..., :3].max() > 0

    def test_reduce_scatter_flag(self, tmp_path):
        """--reduce-scatter routes stills through the scattered
        pipeline and refuses the combinations where a full per-chip
        histogram never exists."""
        import jax
        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from cuburn_tpu.main import main
        out = str(tmp_path / "rs.png")
        rc = main(["gallery:sierpinski", "-o", out, "--profile",
                   "preview", "--width", "64", "--height", "64",
                   "--quality", "20", "--devices", "4",
                   "--reduce-scatter"])
        assert rc == 0
        from PIL import Image
        img = np.asarray(Image.open(out))
        assert img[..., :3].max() > 0
        # motion blur runs through the scattered temporal collective
        rc = main(["gallery:animated_spark", "-o", out, "--profile",
                   "preview", "--width", "64", "--height", "64",
                   "--quality", "16", "--devices", "4",
                   "--temporal-samples", "2", "--reduce-scatter"])
        assert rc == 0
        # animation through the scattered overlapped driver
        y4m = str(tmp_path / "rs.y4m")
        rc = main(["gallery:animated_spark", "-o", y4m, "--profile",
                   "preview", "--width", "64", "--height", "64",
                   "--quality", "12", "--devices", "4", "--animate",
                   "--fps", "3", "--duration", "1",
                   "--reduce-scatter"])
        assert rc == 0
        data = open(y4m, "rb").read()
        assert data.count(b"FRAME\n") == 3
        # refusals: no --devices, and full-histogram-only features
        for extra in ([],
                      ["--devices", "4", "--save-hist",
                       str(tmp_path / "h.npy")],
                      ["--devices", "4", "--stripes", "2"]):
            with pytest.raises(SystemExit):
                main(["gallery:sierpinski", "-o", out,
                      "--profile", "preview", "--width", "64",
                      "--height", "64", "--reduce-scatter"] + extra)

    def test_devices_animate_overlapped(self, tmp_path):
        """--devices N --animate goes through the sharded renderer's
        overlapped driver (regression: the CLI used to force
        overlap=False for sharded renderers, bypassing the pipelined
        path it ships)."""
        import jax
        if len(jax.devices()) < 4:
            pytest.skip("needs virtual devices")
        from cuburn_tpu.main import main
        out = str(tmp_path / "s.y4m")
        rc = main(["gallery:animated_spark", "-o", out, "--profile",
                   "preview", "--width", "64", "--height", "64",
                   "--quality", "20", "--devices", "4", "--animate",
                   "--fps", "3", "--duration", "1"])
        assert rc == 0
        data = open(out, "rb").read()
        assert data.startswith(b"YUV4MPEG2")
        assert data.count(b"FRAME") == 3

    def test_metrics_json(self, tmp_path):
        import json
        from cuburn_tpu.main import main
        out = str(tmp_path / "m.png")
        metrics = str(tmp_path / "metrics.jsonl")
        rc = main(["gallery:sierpinski", "-o", out, "--profile",
                   "preview", "--width", "64", "--height", "64",
                   "--quality", "20", "--metrics-json", metrics])
        assert rc == 0
        rec = json.loads(open(metrics).readline())
        assert rec["plotted_samples"] > 0
        assert "iterate_ms" in rec and "retention" in rec


class TestIndependentReference:
    """End-to-end anchor against tests/reference_impl.py — a NumPy
    chaos-game renderer written independently from the flam3 paper, sharing NO
    code or RNG with the device pipeline.  The two render the same
    genome with different random streams, so the comparison is
    distributional: the attractor density fields must agree within
    chaos-game sampling noise (round-1 verdict: 'goldens pin the
    build's own semantics' — this pins them against a second
    implementation)."""

    def _genome(self):
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(1.0, 0.2, 256)
        pal[:, 2] = np.linspace(0.1, 1.0, 256)
        return Genome(
            xforms=[
                XForm(weight=1.0, color=0.1, color_speed=0.6,
                      affine=(0.6, 0.1, 0.3, -0.1, 0.6, 0.1),
                      vars={"spherical": 0.7, "linear": 0.3}),
                XForm(weight=0.7, color=0.9, color_speed=0.4,
                      affine=(-0.4, 0.3, -0.2, 0.3, 0.4, 0.25),
                      vars={"swirl": 0.6, "sinusoidal": 0.4}),
                XForm(weight=0.5, color=0.5, color_speed=0.5,
                      affine=(0.5, 0.0, 0.0, 0.0, 0.5, -0.3),
                      vars={"horseshoe": 1.0}),
            ],
            scale=24.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor")

    def test_density_distribution_matches(self):
        from tests.reference_impl import render_reference
        from cuburn_tpu.profile import RenderProfile
        from cuburn_tpu.render import Renderer

        g = self._genome()
        W = H = 32
        n = 600_000
        ref = render_reference(g, W, H, n, seed=4)
        prof = RenderProfile(width=W, height=H,
                             quality=int(np.ceil(n / (W * H))),
                             batch=4096, iters_per_chunk=16, fuse=20,
                             hist_backend="scatter", de_enabled=False)
        hist, stats = Renderer(g, prof).accumulate(0.0, seed=11)
        ours = np.asarray(hist, np.float64)

        # normalized in-frame density fields
        d_ref = ref[:-1, 3] / ref[:-1, 3].sum()
        d_our = ours[:-1, 3] / ours[:-1, 3].sum()
        # total variation distance between the two attractor measures;
        # two runs of the SAME impl at this budget measure ~0.01-0.02
        tv = 0.5 * np.abs(d_ref - d_our).sum()
        assert tv < 0.05, f"TV distance {tv:.4f}"
        # support agreement (pixels hit)
        occ_r, occ_o = d_ref > 0, d_our > 0
        iou = (occ_r & occ_o).sum() / max((occ_r | occ_o).sum(), 1)
        assert iou > 0.9, f"support IoU {iou:.3f}"
        # per-channel color mass ratios (palette + color_speed chain)
        for ch in range(3):
            rr = ref[:-1, ch].sum() / ref[:-1, 3].sum()
            ro = ours[:-1, ch].sum() / ours[:-1, 3].sum()
            assert abs(rr - ro) < 0.02, (ch, rr, ro)
        # in-frame retention agrees (camera + fuse semantics)
        ret_ref = ref[:-1, 3].sum() / ref[:, 3].sum()
        ret_our = ours[:-1, 3].sum() / ours[:, 3].sum()
        assert abs(ret_ref - ret_our) < 0.03, (ret_ref, ret_our)

    def test_xaos_post_final_distribution_matches(self):
        """Richer anchor: xaos chance matrix, post-affines, and a final
        xform all active — the selection conditioning and display-only
        final semantics must match the independent implementation."""
        from tests.reference_impl import render_reference
        from cuburn_tpu.genome.specs import Genome, XForm
        from cuburn_tpu.profile import RenderProfile
        from cuburn_tpu.render import Renderer

        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.2, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.55, 0.15, 0.25, -0.15, 0.55, 0.1),
                      post=(1.0, 0.0, 0.1, 0.0, 1.0, -0.05),
                      vars={"spherical": 0.8, "linear": 0.2}),
                XForm(weight=0.8, color=0.8, color_speed=0.5,
                      affine=(-0.45, 0.25, -0.2, 0.25, 0.45, 0.3),
                      vars={"sinusoidal": 1.0}),
            ],
            final_xform=XForm(color=0.5, color_speed=0.3,
                              affine=(0.9, 0.1, 0.0, -0.1, 0.9, 0.0),
                              vars={"swirl": 0.5, "linear": 0.5}),
            xaos=[[0.3, 1.0], [1.0, 0.2]],
            scale=22.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor2")
        W = H = 32
        n = 500_000
        ref = render_reference(g, W, H, n, seed=6)
        prof = RenderProfile(width=W, height=H,
                             quality=int(np.ceil(n / (W * H))),
                             batch=4096, iters_per_chunk=16, fuse=20,
                             hist_backend="scatter", de_enabled=False)
        hist, _ = Renderer(g, prof).accumulate(0.0, seed=13)
        ours = np.asarray(hist, np.float64)
        d_ref = ref[:-1, 3] / ref[:-1, 3].sum()
        d_our = ours[:-1, 3] / ours[:-1, 3].sum()
        tv = 0.5 * np.abs(d_ref - d_our).sum()
        assert tv < 0.05, f"TV distance {tv:.4f}"
        for ch in range(3):
            rr = ref[:-1, ch].sum() / ref[:-1, 3].sum()
            ro = ours[:-1, ch].sum() / ours[:-1, 3].sum()
            assert abs(rr - ro) < 0.02, (ch, rr, ro)


def _anchor_compare(g, n, seed_ref, seed_our, tv_bound=0.05, t=0.0):
    """Render genome g through the device pipeline and the independent
    NumPy reference with different seeds; assert the per-bin density
    distributions agree (TV distance) and the channel/density mass
    ratios match."""
    from tests.reference_impl import render_reference
    from cuburn_tpu.profile import RenderProfile
    from cuburn_tpu.render import Renderer
    W, H = g.size
    ref = render_reference(g, W, H, n, seed=seed_ref, t=t)
    prof = RenderProfile(width=W, height=H,
                         quality=int(np.ceil(n / (W * H))),
                         batch=4096, iters_per_chunk=16, fuse=20,
                         hist_backend="scatter", de_enabled=False)
    hist, _ = Renderer(g, prof).accumulate(t, seed=seed_our)
    ours = np.asarray(hist, np.float64)
    d_ref = ref[:-1, 3] / ref[:-1, 3].sum()
    d_our = ours[:-1, 3] / ours[:-1, 3].sum()
    tv = 0.5 * np.abs(d_ref - d_our).sum()
    assert tv < tv_bound, f"TV distance {tv:.4f}"
    for ch in range(3):
        rr = ref[:-1, ch].sum() / ref[:-1, 3].sum()
        ro = ours[:-1, ch].sum() / ours[:-1, 3].sum()
        assert abs(rr - ro) < 0.02, (ch, rr, ro)
        # per-bin COLOR distribution agreement (fuzz-measured at the
        # two-seed floor); skip channels carrying <1% of the mass —
        # their normalized distribution is noise
        if min(rr, ro) > 0.01:
            c_ref = ref[:-1, ch] / ref[:-1, ch].sum()
            c_our = ours[:-1, ch] / ours[:-1, ch].sum()
            ctv = 0.5 * np.abs(c_ref - c_our).sum()
            assert ctv < 1.5 * tv_bound, \
                f"channel {ch} TV {ctv:.4f} (density TV {tv:.4f})"
    return tv


class TestIndependentReferenceExpanded:
    """Round-3 anchor expansion (VERDICT round-2 weak #5): parametric
    (julian, pdj), affine-dependent (popcorn, rings), stochastic
    (gaussian_blur) and two more quirk-bearing simple variations
    (disc, fisheye) exercised END-TO-END against the independent NumPy
    renderer; deepened later in round 3 with the angular family
    (polar, handkerchief, heart, spiral, hyperbolic, diamond, ex) and
    the parametric-quirk family (fan2, rings2, blob, curl) — 24
    variations in the anchor set total."""

    def _compare(self, g, n, seed_ref, seed_our, tv_bound=0.05,
                 t=0.0):
        return _anchor_compare(g, n, seed_ref, seed_our,
                               tv_bound=tv_bound, t=t)

    def test_parametric_and_affine_dependent(self):
        """julian (random-branch parametric), pdj (4-param), popcorn +
        rings (read their own affine's c/f terms)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.9, 0.3, 256)
        pal[:, 1] = np.linspace(0.2, 0.8, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.15, color_speed=0.5,
                      affine=(0.55, 0.1, 0.35, -0.1, 0.55, 0.12),
                      vars={"julian": 0.8, "linear": 0.2},
                      params={"julian_power": 3.0,
                              "julian_dist": 1.0}),
                XForm(weight=0.8, color=0.85, color_speed=0.5,
                      affine=(-0.4, 0.25, -0.22, 0.25, 0.4, 0.28),
                      vars={"pdj": 0.7, "linear": 0.3},
                      params={"pdj_a": 1.2, "pdj_b": -1.9,
                              "pdj_c": 0.6, "pdj_d": 1.4}),
                XForm(weight=0.6, color=0.5, color_speed=0.4,
                      affine=(0.5, 0.0, 0.4, 0.0, 0.5, -0.3),
                      vars={"popcorn": 0.9, "linear": 0.1}),
                XForm(weight=0.5, color=0.35, color_speed=0.6,
                      affine=(0.45, -0.1, 0.5, 0.1, 0.45, 0.05),
                      vars={"rings": 0.8, "linear": 0.2}),
            ],
            scale=10.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_parametric")
        self._compare(g, 500_000, seed_ref=8, seed_our=17)

    def test_stochastic_and_quirks(self):
        """gaussian_blur (pure-RNG point cloud) mixed with disc and
        fisheye (the swapped-output quirk) — stochastic mass and the
        quirk conventions must agree distributionally."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 2] = np.linspace(0.3, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.6, 0.1, 0.2, -0.1, 0.6, 0.1),
                      vars={"disc": 0.7, "linear": 0.3}),
                XForm(weight=0.7, color=0.8, color_speed=0.5,
                      affine=(-0.45, 0.2, -0.15, 0.2, 0.45, 0.2),
                      vars={"fisheye": 0.8, "linear": 0.2}),
                XForm(weight=0.4, color=0.5, color_speed=0.7,
                      affine=(0.5, 0.0, 0.0, 0.0, 0.5, 0.0),
                      vars={"gaussian_blur": 1.0}),
            ],
            scale=9.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_stochastic")
        self._compare(g, 500_000, seed_ref=9, seed_our=23)

    def test_angular_family(self):
        """polar, handkerchief, heart, spiral, hyperbolic, diamond,
        ex — the atan2(x, y) angular family end-to-end (round-3
        anchor deepening; 24 variations in the anchor set total)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.8, 0.2, 256)
        pal[:, 2] = np.linspace(0.2, 0.9, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.1, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"handkerchief": 0.6, "polar": 0.4}),
                XForm(weight=0.8, color=0.6, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"heart": 0.5, "diamond": 0.5}),
                XForm(weight=0.6, color=0.9, color_speed=0.4,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"spiral": 0.4, "hyperbolic": 0.3,
                            "linear": 0.3}),
                XForm(weight=0.5, color=0.3, color_speed=0.6,
                      affine=(0.5, -0.15, 0.15, 0.15, 0.5, 0.0),
                      vars={"ex": 0.7, "linear": 0.3}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_angular")
        self._compare(g, 500_000, seed_ref=10, seed_our=29)

    def test_parametric_quirk_family(self):
        """fan2 + rings2 (the int-cast-truncation folds), blob
        (parametric petals, (sin, cos) order) and curl (complex
        inversion) end-to-end."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.9, 0.3, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.55, 0.1, 0.25, -0.1, 0.55, 0.1),
                      vars={"fan2": 0.8, "linear": 0.2},
                      params={"fan2_x": 0.8, "fan2_y": 0.45}),
                XForm(weight=0.8, color=0.75, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"rings2": 0.7, "linear": 0.3},
                      params={"rings2_val": 0.6}),
                XForm(weight=0.7, color=0.5, color_speed=0.4,
                      affine=(0.45, 0.0, 0.3, 0.0, 0.45, -0.25),
                      vars={"blob": 0.8, "linear": 0.2},
                      params={"blob_low": 0.4, "blob_high": 1.1,
                              "blob_waves": 4.0}),
                XForm(weight=0.6, color=0.35, color_speed=0.6,
                      affine=(0.5, -0.1, 0.2, 0.1, 0.5, 0.05),
                      vars={"curl": 0.9, "linear": 0.1},
                      params={"curl_c1": 0.4, "curl_c2": 0.25}),
            ],
            scale=9.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_quirks")
        self._compare(g, 500_000, seed_ref=12, seed_our=31)

    def test_fold_family(self):
        """fan (affine-dependent (cos,sin) fold) + boarders (the
        stochastic 25/75 cell split) + disc2 (twist offsets) +
        modulus (C-fmod wrap) end-to-end — 8 more anchored variations
        with branch/fold/RNG semantics (32 total)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.3, 0.9, 256)
        pal[:, 1] = np.linspace(0.7, 0.2, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.15, color_speed=0.5,
                      affine=(0.55, 0.1, 0.6, -0.1, 0.55, 0.4),
                      vars={"fan": 0.8, "linear": 0.2}),
                XForm(weight=0.8, color=0.8, color_speed=0.5,
                      affine=(-0.45, 0.2, -0.2, 0.2, 0.45, 0.25),
                      vars={"boarders": 0.9, "linear": 0.1}),
                XForm(weight=0.7, color=0.5, color_speed=0.4,
                      affine=(0.5, 0.0, 0.3, 0.0, 0.5, -0.25),
                      vars={"disc2": 0.7, "linear": 0.3},
                      params={"disc2_rot": 0.5, "disc2_twist": 0.8}),
                XForm(weight=0.6, color=0.35, color_speed=0.6,
                      affine=(0.5, -0.1, 0.2, 0.1, 0.5, 0.05),
                      vars={"modulus": 0.9, "linear": 0.1},
                      params={"modulus_x": 0.7, "modulus_y": 0.5}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_folds")
        self._compare(g, 500_000, seed_ref=14, seed_our=37)

    def test_complex_and_nonlinear_weight_family(self):
        """escher + mobius (complex maps) with lazysusan + whorl —
        the weight-NONLINEAR pair (w inside the formula: branch radius
        r < w, swirl 1/(w-r), un-scaled recenter terms), anchoring
        ops/xform.py's union-evaluation weight gating end-to-end."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.2, 0.8, 256)
        pal[:, 2] = np.linspace(0.9, 0.3, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"escher": 0.7, "linear": 0.3},
                      params={"escher_beta": 0.7}),
                XForm(weight=0.8, color=0.75, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"mobius": 0.9, "linear": 0.1},
                      params={"mobius_re_a": 0.9, "mobius_im_a": 0.1,
                              "mobius_re_b": 0.2, "mobius_im_b": -0.1,
                              "mobius_re_c": 0.15, "mobius_im_c": 0.1,
                              "mobius_re_d": 1.0, "mobius_im_d": 0.0}),
                XForm(weight=0.7, color=0.5, color_speed=0.4,
                      affine=(0.45, 0.0, 0.3, 0.0, 0.45, -0.25),
                      vars={"lazysusan": 0.9},
                      params={"lazysusan_spin": 0.4,
                              "lazysusan_space": 0.3,
                              "lazysusan_twist": 0.5,
                              "lazysusan_x": 0.2,
                              "lazysusan_y": 0.1}),
                XForm(weight=0.6, color=0.35, color_speed=0.6,
                      affine=(0.5, -0.1, 0.2, 0.1, 0.5, 0.05),
                      vars={"whorl": 0.8, "linear": 0.2},
                      params={"whorl_inside": 0.3,
                              "whorl_outside": 0.2}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_nonlinear_w")
        self._compare(g, 500_000, seed_ref=15, seed_our=41)

    def test_root_branch_family(self):
        """juliascope (branch-index parity decides reflection — the
        round-3 bug class, now anchored end-to-end) + wedge_julia
        (random root + wedge fold) + elliptic (clamped sqrts, sign-y
        branch) + bent + waves (affine-dependent b/e/c/f)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.9, 0.4, 256)
        pal[:, 1] = np.linspace(0.3, 0.7, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"juliascope": 0.8, "linear": 0.2},
                      params={"juliascope_power": 3.0,
                              "juliascope_dist": 1.0}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"wedge_julia": 0.7, "linear": 0.3},
                      params={"wedge_julia_angle": 0.6,
                              "wedge_julia_count": 2.0,
                              "wedge_julia_power": 3.0,
                              "wedge_julia_dist": 1.0}),
                XForm(weight=0.7, color=0.5, color_speed=0.4,
                      affine=(0.45, 0.0, 0.3, 0.0, 0.45, -0.25),
                      vars={"elliptic": 0.6, "bent": 0.4}),
                XForm(weight=0.6, color=0.35, color_speed=0.6,
                      affine=(0.5, 0.3, 0.45, 0.1, 0.5, 0.35),
                      vars={"waves": 0.8, "linear": 0.2}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_rootbranch")
        self._compare(g, 500_000, seed_ref=16, seed_our=43)

    def test_pole_family(self):
        """scry + loonie + radial_blur — three more weight-NONLINEAR
        variations (w only in the pole radius / branch radius /
        pseudo-gaussian magnitude; no leading w multiply), anchoring
        the remaining nonlinear-weight code paths (40 variations in
        the anchor set total)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 2] = np.linspace(0.4, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.55, 0.1, 0.25, -0.1, 0.55, 0.1),
                      vars={"scry": 0.8, "linear": 0.2}),
                XForm(weight=0.8, color=0.8, color_speed=0.5,
                      affine=(-0.45, 0.2, -0.2, 0.2, 0.45, 0.25),
                      vars={"loonie": 0.9, "linear": 0.1}),
                XForm(weight=0.6, color=0.5, color_speed=0.6,
                      affine=(0.5, 0.0, 0.1, 0.0, 0.5, -0.2),
                      vars={"radial_blur": 0.6, "linear": 0.4},
                      params={"radial_blur_angle": 0.7}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_poles")
        self._compare(g, 500_000, seed_ref=18, seed_our=47)

    def test_stochastic_cloud_family(self):
        """pie (random slice wedges, w-scaled radius, no leading w
        multiply) + square + blur — input-ignoring stochastic point
        clouds whose SHAPE is pure RNG-convention agreement."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.5, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.55, 0.1, 0.3, -0.1, 0.55, 0.1),
                      vars={"spherical": 0.7, "linear": 0.3}),
                XForm(weight=0.6, color=0.8, color_speed=0.5,
                      affine=(0.5, 0.0, -0.2, 0.0, 0.5, 0.2),
                      vars={"pie": 0.8},
                      params={"pie_slices": 5.0,
                              "pie_rotation": 0.3,
                              "pie_thickness": 0.4}),
                XForm(weight=0.5, color=0.5, color_speed=0.6,
                      affine=(0.5, 0.0, 0.1, 0.0, 0.5, -0.15),
                      vars={"square": 0.7, "blur": 0.5}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_clouds")
        self._compare(g, 500_000, seed_ref=19, seed_our=53)

    def test_cpow_supershape_stripes(self):
        """cpow (complex power, random root branch) + super_shape
        (Gielis superformula with rnd radius blend) + stripes (integer
        snap + parabolic bow)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.8, 0.2, 256)
        pal[:, 2] = np.linspace(0.2, 0.8, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.15, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"cpow": 0.8, "linear": 0.2},
                      params={"cpow_r": 1.2, "cpow_i": 0.3,
                              "cpow_power": 2.0}),
                XForm(weight=0.8, color=0.75, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"super_shape": 0.7, "linear": 0.3},
                      params={"super_shape_m": 4.0,
                              "super_shape_n1": 2.0,
                              "super_shape_n2": 1.3,
                              "super_shape_n3": 0.8,
                              "super_shape_holes": 0.2,
                              "super_shape_rnd": 0.3}),
                XForm(weight=0.6, color=0.4, color_speed=0.6,
                      affine=(0.5, -0.1, 0.2, 0.1, 0.5, 0.05),
                      vars={"stripes": 0.8, "linear": 0.2},
                      params={"stripes_space": 0.4,
                              "stripes_warp": 0.3}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_cpow")
        self._compare(g, 500_000, seed_ref=20, seed_our=59)

    def test_weight_phase_stochastic_family(self):
        """blade + rays + arch — stochastic variations where w sets
        the RANDOM PHASE RANGE itself (and scales the output with no
        clean factoring); 49 variations in the anchor set total."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 2] = np.linspace(0.9, 0.4, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.55, 0.1, 0.3, -0.1, 0.55, 0.1),
                      vars={"blade": 0.6, "linear": 0.4}),
                XForm(weight=0.7, color=0.8, color_speed=0.5,
                      affine=(-0.45, 0.2, -0.2, 0.2, 0.45, 0.25),
                      vars={"rays": 0.5, "linear": 0.5}),
                XForm(weight=0.6, color=0.5, color_speed=0.6,
                      affine=(0.5, 0.0, 0.15, 0.0, 0.5, -0.2),
                      vars={"arch": 0.6, "linear": 0.4}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_wphase")
        self._compare(g, 500_000, seed_ref=21, seed_our=61)

    def test_complex_trig_family(self):
        """sin/cos/tan/sec/csc/cot — the complex-trig sextet (poles
        and all) end-to-end."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.4, 0.9, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"sin": 0.5, "cos": 0.4, "linear": 0.1}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"tan": 0.5, "sec": 0.3, "linear": 0.2}),
                XForm(weight=0.6, color=0.5, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"csc": 0.3, "cot": 0.3, "linear": 0.4}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_ctrig")
        self._compare(g, 500_000, seed_ref=22, seed_our=67)

    def test_complex_hyperbolic_family(self):
        """sinh/cosh/tanh/sech/csch/coth/exp/log — including the coth
        CONJUGATE quirk (flam3 emits +sin 2y; the spec, CLAUDE.md)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.3, 0.8, 256)
        pal[:, 2] = np.linspace(0.8, 0.3, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.15, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"sinh": 0.4, "cosh": 0.4, "linear": 0.2}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"tanh": 0.5, "sech": 0.4, "linear": 0.1}),
                XForm(weight=0.6, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"csch": 0.3, "coth": 0.3, "linear": 0.4}),
                XForm(weight=0.5, color=0.9, color_speed=0.4,
                      affine=(0.4, -0.1, 0.2, 0.1, 0.4, 0.05),
                      vars={"exp": 0.4, "log": 0.3, "linear": 0.3}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_chyper")
        self._compare(g, 500_000, seed_ref=23, seed_our=71)

    def test_simple_shape_family(self):
        """bubble, butterfly (the 4/sqrt(3pi) constant + doubled-y
        radius), cylinder, cosine, exponential, power (r^sin-theta)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.9, 0.5, 256)
        pal[:, 1] = np.linspace(0.2, 0.6, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"bubble": 0.6, "butterfly": 0.4}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"cylinder": 0.5, "cosine": 0.3,
                            "linear": 0.2}),
                XForm(weight=0.6, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"exponential": 0.4, "power": 0.4,
                            "linear": 0.2}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_simple")
        self._compare(g, 500_000, seed_ref=24, seed_our=73)

    def test_preblur_and_pointwise_stochastic(self):
        """pre_blur (the PRE-step slot: perturbs the post-affine point
        before the variation union runs — classic spherical+pre_blur
        combo) + noise (per-point random shrink) + eyefish/tangent/
        cross (74 variations in the anchor set total)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 2] = np.linspace(0.5, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"spherical": 0.8, "pre_blur": 0.5,
                            "linear": 0.2}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"eyefish": 0.6, "noise": 0.4}),
                XForm(weight=0.6, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"tangent": 0.3, "cross": 0.3,
                            "linear": 0.4}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_preblur")
        self._compare(g, 500_000, seed_ref=25, seed_our=79)

    def test_branch_parametric_family_a(self):
        """bent2, bipolar (fmod angle fold), cell (quadrant
        interleave + NEGATED y), rectangles, separation, split."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.3, 0.8, 256)
        pal[:, 2] = np.linspace(0.8, 0.3, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"bent2": 0.5, "bipolar": 0.5},
                      params={"bent2_x": 1.6, "bent2_y": 0.7,
                              "bipolar_shift": 0.4}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"cell": 0.6, "linear": 0.4},
                      params={"cell_size": 0.8}),
                XForm(weight=0.7, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"rectangles": 0.5, "separation": 0.5},
                      params={"rectangles_x": 0.6,
                              "rectangles_y": 0.9,
                              "separation_x": 0.4,
                              "separation_xinside": 0.3,
                              "separation_y": 0.5,
                              "separation_yinside": 0.2}),
                XForm(weight=0.6, color=0.9, color_speed=0.4,
                      affine=(0.4, -0.1, 0.2, 0.1, 0.4, 0.05),
                      vars={"split": 0.7, "linear": 0.3},
                      params={"split_xsize": 0.8,
                              "split_ysize": 1.2}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_brancha")
        self._compare(g, 500_000, seed_ref=26, seed_our=83)

    def test_branch_parametric_family_b(self):
        """splits, popcorn2, waves2, curve, auger (cross-coordinate
        sine terms: dy uses sin(freq*x)) — 85 variations anchored."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.9, 0.4, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"splits": 0.5, "popcorn2": 0.5},
                      params={"splits_x": 0.3, "splits_y": 0.2,
                              "popcorn2_x": 0.4, "popcorn2_y": 0.3,
                              "popcorn2_c": 1.5}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"waves2": 0.7, "linear": 0.3},
                      params={"waves2_scalex": 0.5,
                              "waves2_freqx": 2.0,
                              "waves2_scaley": 0.4,
                              "waves2_freqy": 3.0}),
                XForm(weight=0.7, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"curve": 0.8, "linear": 0.2},
                      params={"curve_xamp": 0.6, "curve_yamp": 0.4,
                              "curve_xlength": 0.9,
                              "curve_ylength": 1.3}),
                XForm(weight=0.6, color=0.9, color_speed=0.4,
                      affine=(0.4, -0.1, 0.2, 0.1, 0.4, 0.05),
                      vars={"auger": 0.7, "linear": 0.3},
                      params={"auger_freq": 3.0, "auger_weight": 0.6,
                              "auger_scale": 0.8, "auger_sym": 0.4}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_branchb")
        self._compare(g, 500_000, seed_ref=27, seed_our=89)

    def test_stochastic_radial_family(self):
        """conic (polar conic from the +x axis), flower (petal-cosine
        radial), parabola (two independent rand draws)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.6, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"conic": 0.7, "linear": 0.3},
                      params={"conic_eccentricity": 0.6,
                              "conic_holes": 0.2}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"flower": 0.6, "linear": 0.4},
                      params={"flower_petals": 5.0,
                              "flower_holes": 0.3}),
                XForm(weight=0.6, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"parabola": 0.8, "linear": 0.2},
                      params={"parabola_height": 0.9,
                              "parabola_width": 0.7}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_radial")
        self._compare(g, 500_000, seed_ref=28, seed_our=97)

    def test_coordinate_map_family(self):
        """edisc (11.57034632 normalization, sign-of-y flip), foci,
        ngon (corner amplification), perspective, polar2."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 1] = np.linspace(0.4, 0.9, 256)
        pal[:, 2] = np.linspace(0.9, 0.4, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"edisc": 0.8, "linear": 0.2}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"foci": 0.4, "linear": 0.6}),
                XForm(weight=0.7, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"ngon": 0.5, "linear": 0.5},
                      params={"ngon_sides": 5.0, "ngon_power": 3.0,
                              "ngon_circle": 1.0,
                              "ngon_corners": 2.0}),
                XForm(weight=0.6, color=0.9, color_speed=0.4,
                      affine=(0.4, -0.1, 0.2, 0.1, 0.4, 0.05),
                      vars={"perspective": 0.6, "polar2": 0.4},
                      params={"perspective_angle": 0.5,
                              "perspective_dist": 2.0}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_coordmap")
        self._compare(g, 500_000, seed_ref=29, seed_our=101)

    def test_wedge_and_convention_family(self):
        """wedge + wedge_sph (slice folds), secant2 + flux + twintrian
        (weight-nonlinear), oscilloscope + unpolar (the documented
        convention pair) — completing the anchor set at 100/100."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 2] = np.linspace(0.3, 0.9, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.2, color_speed=0.5,
                      affine=(0.5, 0.1, 0.3, -0.1, 0.5, 0.1),
                      vars={"wedge": 0.7, "linear": 0.3},
                      params={"wedge_angle": 0.5, "wedge_hole": 0.1,
                              "wedge_count": 3.0,
                              "wedge_swirl": 0.3}),
                XForm(weight=0.7, color=0.7, color_speed=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"wedge_sph": 0.4, "secant2": 0.4,
                            "linear": 0.2},
                      params={"wedge_sph_angle": 0.4,
                              "wedge_sph_count": 2.0,
                              "wedge_sph_hole": 0.1,
                              "wedge_sph_swirl": 0.2}),
                XForm(weight=0.6, color=0.45, color_speed=0.6,
                      affine=(0.45, 0.0, 0.35, 0.0, 0.45, -0.25),
                      vars={"flux": 0.5, "twintrian": 0.3,
                            "linear": 0.2},
                      params={"flux_spread": 0.3}),
                XForm(weight=0.6, color=0.9, color_speed=0.4,
                      affine=(0.4, -0.1, 0.2, 0.1, 0.4, 0.05),
                      vars={"oscilloscope": 0.5, "unpolar": 0.3,
                            "linear": 0.2},
                      params={"oscope_separation": 0.6,
                              "oscope_frequency": 1.5,
                              "oscope_amplitude": 0.8,
                              "oscope_damping": 0.4}),
            ],
            scale=8.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_wedgeconv")
        self._compare(g, 500_000, seed_ref=30, seed_our=103)

    def test_final_image_matches_independent_pipeline(self):
        """Anchor the WHOLE still path at the u8 image level.

        (a) The device finalize (logscale + colorclip + u8, DE and
        spatial filter off) is BIT-IDENTICAL to the independent
        transcription on the device's own histogram — a real attractor
        histogram, not the synthetic ones of test_filters.
        (b) The full cross-implementation image (independent chaos
        game + independent color pipeline vs device render_frame)
        agrees within the two-seed noise floor once both are
        normalized by their own attempted-samples-per-cell
        (render_reference counts IN-FRAME samples toward n while the
        device, like flam3, attempts quality*cells total — an
        accounting difference, not a semantics one; measured floor
        mean ~2.5 u8 steps, cross-impl ~2.1)."""
        import dataclasses
        from tests.reference_impl import (colorclip_reference,
                                          logscale_reference,
                                          render_reference)
        from cuburn_tpu.profile import RenderProfile
        from cuburn_tpu.render import Renderer

        g = TestIndependentReference._genome(None)
        W, H = g.size
        n = 600_000
        q = int(np.ceil(n / (W * H)))
        prof = RenderProfile(width=W, height=H, quality=q, batch=4096,
                             iters_per_chunk=16, fuse=20,
                             hist_backend="scatter", de_enabled=False)
        r = Renderer(g, prof)

        def ref_pipe(h, qpc):
            img = logscale_reference(h[:-1].reshape(H, W, 4),
                                     float(g.brightness(0.0)), qpc)
            u = colorclip_reference(
                img, float(g.gamma(0.0)), float(g.vibrancy(0.0)),
                float(g.highlight_power(0.0)),
                float(g.gamma_threshold(0.0)),
                tuple(float(b(0.0)) for b in g.background))
            return np.round(np.clip(u.reshape(H, W, 4), 0, 1)
                            * 255).astype(np.uint8)

        # (a) same histogram, both pipelines: exact
        hist, stats = r.accumulate(0.0, seed=11)
        ours = np.asarray(r.finalize_frame(hist, 0.0, stats))
        h = np.asarray(hist, np.float64)
        np.testing.assert_array_equal(ours, ref_pipe(h, q))

        # (b) fully independent render, mass-consistent normalization
        ref = render_reference(g, W, H, n, seed=4)
        img_ref = ref_pipe(ref, ref[:, 3].sum() / (W * H))
        img_dev = ref_pipe(h, h[:, 3].sum() / (W * H))
        d = np.abs(img_ref.astype(int) - img_dev.astype(int))[..., :3]
        assert d.mean() < 4.0, d.mean()
        assert np.percentile(d, 95) < 16, np.percentile(d, 95)

    def test_anchor_set_is_complete(self):
        """Every variation in the registry has an independent anchor
        implementation (VERDICT round-2 weak #5, fully closed: 6 ->
        100 of 100)."""
        from cuburn_tpu.genome.variations import VARIATION_PARAMS
        from tests.reference_impl import _VARS
        assert set(_VARS) == set(VARIATION_PARAMS), (
            sorted(set(VARIATION_PARAMS) - set(_VARS)),
            sorted(set(_VARS) - set(VARIATION_PARAMS)))

    def _motion_genome(self):
        from cuburn_tpu.genome.specs import Genome, XForm
        pal_a = np.zeros((256, 3))
        pal_a[:, 0] = np.linspace(0.9, 0.4, 256)
        pal_b = np.zeros((256, 3))
        pal_b[:, 2] = np.linspace(0.3, 1.0, 256)
        g = Genome(
            xforms=[
                XForm(weight=[0.0, 1.0, 1.0, 0.6],
                      color=[0.0, 0.1, 1.0, 0.9], color_speed=0.5,
                      affine=([0.0, 0.5, 1.0, 0.62], 0.1,
                              [0.0, 0.2, 1.0, 0.35], -0.1, 0.5, 0.1),
                      vars={"spherical": [0.0, 0.7, 1.0, 0.4],
                            "linear": 0.3}),
                XForm(weight=0.8, color=0.7, color_speed=0.5,
                      affine=(-0.4, [0.0, 0.15, 1.0, 0.3], -0.2,
                              0.2, 0.4, [0.0, 0.2, 1.0, 0.3]),
                      vars={"sinusoidal": 1.0}),
            ],
            rotate=[0.0, 0.0, 1.0, 70.0],
            rot_center=(0.25, -0.15),
            center=(0.0, [0.0, -0.05, 1.0, 0.05]),
            scale=[0.0, 9.0, 1.0, 11.0],
            size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal_a), (1.0, pal_b)],
            name="anchor_motion", time_range=(0.0, 1.0))
        return g

    def test_opacity_weighting(self):
        """Anchor per-xform opacity (flam3 vis): a translucent and a
        near-invisible xform must scale every accumulator channel by
        their opacity while still moving the point — compared against
        the independent implementation through BOTH device record
        layouts (scatter here; the packed opacity-extended layout is
        pinned bit-exact against scatter elsewhere)."""
        from cuburn_tpu.genome.specs import Genome, XForm
        pal = np.zeros((256, 3))
        pal[:, 0] = np.linspace(0.9, 0.2, 256)
        pal[:, 1] = np.linspace(0.1, 0.8, 256)
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.15, color_speed=0.5,
                      affine=(0.55, 0.1, 0.3, -0.1, 0.55, 0.1),
                      vars={"spherical": 0.7, "linear": 0.3}),
                XForm(weight=0.8, color=0.8, color_speed=0.5,
                      opacity=0.5,
                      affine=(-0.4, 0.2, -0.2, 0.2, 0.4, 0.25),
                      vars={"sinusoidal": 1.0}),
                XForm(weight=0.6, color=0.5, color_speed=0.4,
                      opacity=0.1,
                      affine=(0.5, 0.0, 0.35, 0.0, 0.5, -0.25),
                      vars={"swirl": 0.6, "linear": 0.4}),
            ],
            scale=9.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor_opacity")
        self._compare(g, 500_000, seed_ref=15, seed_our=43)

    def test_animated_mid_time(self):
        """Anchor the TIME axis: splined weights/affines/variation
        weights, palette keyframe lerp, and a rotating camera with an
        off-center rot_center pivot, all evaluated at t=0.4 by both
        implementations (the independent renderer evaluates every
        spline itself — this pins the interpolation and camera
        plumbing, not just t=0 stills)."""
        self._compare(self._motion_genome(), 500_000,
                      seed_ref=14, seed_our=37, t=0.4)

    def test_temporal_samples_match_shutter_sum(self):
        """Anchor MOTION BLUR: the device's single-dispatch temporal
        loop must equal the sum of independent reference renders at
        the flam3 shutter times t + ((i/n) - 0.5)*width*frame_dt
        (box filter: equal weights).  Pins the in-program parameter
        interpolation + temporal weighting end to end."""
        from tests.reference_impl import render_reference
        from cuburn_tpu.profile import RenderProfile
        from cuburn_tpu.render import Renderer
        g = self._motion_genome()
        W, H = g.size
        n = 480_000
        S = 4
        t = 0.5
        prof = RenderProfile(width=W, height=H,
                             quality=int(np.ceil(n / (W * H))),
                             batch=4096, iters_per_chunk=16, fuse=20,
                             temporal_samples=S, fps=4.0, duration=1.0,
                             hist_backend="scatter", de_enabled=False)
        r = Renderer(g, prof)
        times, weights, _sf = r._temporal_times(t)
        assert len(times) == S and np.allclose(weights, 1.0)
        ref = np.zeros((H * W + 1, 4), np.float64)
        for k, tk in enumerate(times):
            ref += render_reference(g, W, H, n // S,
                                    seed=100 + k, t=tk)
        hist, _ = r.accumulate(t, seed=41)
        ours = np.asarray(hist, np.float64)
        d_ref = ref[:-1, 3] / ref[:-1, 3].sum()
        d_our = ours[:-1, 3] / ours[:-1, 3].sum()
        tv = 0.5 * np.abs(d_ref - d_our).sum()
        assert tv < 0.05, f"TV distance {tv:.4f}"
        for ch in range(3):
            rr = ref[:-1, ch].sum() / ref[:-1, 3].sum()
            ro = ours[:-1, ch].sum() / ours[:-1, 3].sum()
            assert abs(rr - ro) < 0.02, (ch, rr, ro)


class TestRandomGenomes:
    """flam3-genome-style random flames: determinism + a fuzz sweep
    over the variation library (every seed must render finite, massy
    frames — the union-evaluation design means one broken variation
    poisons everything)."""

    def test_deterministic(self):
        from cuburn_tpu.genome.randgen import random_genome
        a, b = random_genome(42), random_genome(42)
        assert a.structure_key() == b.structure_key()
        np.testing.assert_array_equal(a.eval_at(0.0).affine,
                                      b.eval_at(0.0).affine)
        assert random_genome(43).structure_key() != a.structure_key() \
            or not np.array_equal(random_genome(43).eval_at(0.0).affine,
                                  a.eval_at(0.0).affine)

    @pytest.mark.parametrize("seed", [1, 2, 3, 5, 8, 13])
    def test_fuzz_renders(self, seed):
        from cuburn_tpu.genome.randgen import random_genome
        from cuburn_tpu.profile import RenderProfile
        g = random_genome(seed, size=(48, 48))
        prof = RenderProfile(width=48, height=48, quality=30,
                             batch=2048, iters_per_chunk=8, fuse=16,
                             hist_backend="scatter", de_enabled=False)
        hist, stats = Renderer(g, prof).accumulate(0.0, seed=seed)
        h = np.asarray(hist)
        assert np.isfinite(h).all(), f"seed {seed}: non-finite"
        assert h[:-1, 3].sum() > 0, f"seed {seed}: empty frame"

    def test_cli_random_spec(self, tmp_path):
        from cuburn_tpu.main import main
        out = tmp_path / "rand.png"
        rc = main(["random:7", "-o", str(out), "--width", "48",
                   "--height", "48", "--quality", "20"])
        assert rc == 0 and out.exists()

    def test_mutate_and_crossover_render(self):
        from cuburn_tpu.genome.randgen import (crossover, mutate,
                                               random_genome)
        from cuburn_tpu.profile import RenderProfile
        a, b = random_genome(1, size=(48, 48)), \
            random_genome(2, size=(48, 48))
        prof = RenderProfile(width=48, height=48, quality=20,
                             batch=2048, iters_per_chunk=8, fuse=16,
                             hist_backend="scatter", de_enabled=False)
        for kind in ("affine", "weights", "colors", "palette",
                     "variation"):
            m = mutate(a, 9, kind)
            m2 = mutate(a, 9, kind)
            # deterministic, evaluable, renders
            np.testing.assert_array_equal(m.eval_at(0.0).affine,
                                          m2.eval_at(0.0).affine)
            h, _ = Renderer(m, prof).accumulate(0.0, seed=1)
            assert np.asarray(h)[:-1, 3].sum() > 0, kind
        c = crossover(a, b, 4)
        h, _ = Renderer(c, prof).accumulate(0.0, seed=1)
        assert np.asarray(h)[:-1, 3].sum() > 0
        with pytest.raises(ValueError, match="mutation kind"):
            mutate(a, 1, "bogus")

    def test_crossover_inherits_camera_fields(self):
        from cuburn_tpu.genome.randgen import crossover, random_genome
        import dataclasses
        a = random_genome(1, size=(48, 48))
        b = random_genome(2, size=(48, 48))
        a = dataclasses.replace(a) if dataclasses.is_dataclass(a) else a
        a.rotate = 90.0
        a.vibrancy = 0.7
        a.__post_init__()
        c = crossover(a, b, seed=5)
        cam_parent = a if abs(c.scale(0) - a.scale(0)) < 1e-9 else b
        assert c.rotate(0) == cam_parent.rotate(0)
        assert c.vibrancy(0) == cam_parent.vibrancy(0)
        assert c.background[0](0) == cam_parent.background[0](0)

    def test_mutate_affine_preserves_animation(self):
        from cuburn_tpu.genome.randgen import mutate
        from cuburn_tpu.models import animated_spark
        g = animated_spark()
        m = mutate(g, 7, "affine")
        s = m.xforms[0].affine[0]       # animated in the source genome
        assert not s.is_constant
        assert s(0.0) != s(1.0)         # still animates
        # jitter applied uniformly: the animation delta is unchanged
        g0 = g.xforms[0].affine[0]
        assert (s(1.0) - s(0.0)) == pytest.approx(g0(1.0) - g0(0.0),
                                                  abs=1e-6)


class TestAnimatePartitioned:
    def test_cli_animate_with_stripes_and_bands(self, tmp_path):
        """--animate must honor --stripes/--bands (review finding:
        they were silently ignored in animation mode)."""
        from cuburn_tpu.main import main
        out = str(tmp_path / "a.y4m")
        rc = main(["gallery:animated_spark", "-o", out, "--animate",
                   "--width", "64", "--height", "64", "--quality",
                   "15", "--fps", "4", "--duration", "0.6",
                   "--stripes", "2", "--bands", "2"])
        assert rc == 0
        data = open(out, "rb").read()
        assert data.startswith(b"YUV4MPEG2")
        assert data.count(b"FRAME\n") == 2

    def test_frames_partitioned_matches_frames(self):
        g = animated_spark()
        prof = dataclasses.replace(FAST, fps=4.0, duration=0.5,
                                   width=64, height=64)
        r = Renderer(g, prof)
        plain = [img for img, _ in r.frames(seed=3)]
        part = [img for img, _ in r.frames_partitioned(
            seed=3, n_stripes=2, n_bands=2)]
        assert len(plain) == len(part) == 2
        for a, b in zip(plain, part):
            # striping is bit-exact, banding within 1 u8 step
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1

    def test_skip_preview_reproduces_full_render_frames(self):
        """profile.skip>1 must render the SAME frames (same per-frame
        seed at the same genome times) as the corresponding frames of
        a skip=1 render (review finding: enumerate-based seeding broke
        preview/final reproducibility)."""
        g = animated_spark()
        prof1 = dataclasses.replace(FAST, fps=4.0, duration=1.0)
        prof2 = dataclasses.replace(prof1, skip=2)
        full = list(Renderer(g, prof1).frames(seed=5))
        prev = list(Renderer(g, prof2).frames(seed=5))
        assert len(full) == 4 and len(prev) == 2
        np.testing.assert_array_equal(prev[0][0], full[0][0])
        np.testing.assert_array_equal(prev[1][0], full[2][0])

    def test_stochastic_variation_distribution_matches(self):
        """julia's random half-turn branch, end to end: the two-branch
        stochastic plumbing must produce the same TWO-lobed attractor
        distribution as the independent implementation."""
        from tests.reference_impl import render_reference
        from cuburn_tpu.genome.specs import Genome, XForm
        from cuburn_tpu.profile import RenderProfile

        pal = np.zeros((256, 3))
        pal[:, 0] = 1.0
        g = Genome(
            xforms=[
                XForm(weight=1.0, color=0.3, color_speed=0.5,
                      affine=(0.7, 0.2, 0.2, -0.2, 0.7, 0.1),
                      vars={"julia": 0.8, "linear": 0.2}),
                XForm(weight=0.6, color=0.7, color_speed=0.5,
                      affine=(0.5, 0.0, -0.3, 0.0, 0.5, 0.2),
                      vars={"sinusoidal": 1.0}),
            ],
            scale=20.0, size=(32, 32), spatial_filter=0.0,
            palettes=[(0.0, pal)], name="anchor3")
        W = H = 32
        n = 400_000
        ref = render_reference(g, W, H, n, seed=8)
        prof = RenderProfile(width=W, height=H,
                             quality=int(np.ceil(n / (W * H))),
                             batch=4096, iters_per_chunk=16, fuse=20,
                             hist_backend="scatter", de_enabled=False)
        hist, _ = Renderer(g, prof).accumulate(0.0, seed=17)
        ours = np.asarray(hist, np.float64)
        d_ref = ref[:-1, 3] / ref[:-1, 3].sum()
        d_our = ours[:-1, 3] / ours[:-1, 3].sum()
        tv = 0.5 * np.abs(d_ref - d_our).sum()
        assert tv < 0.05, f"TV distance {tv:.4f}"


class TestExamples:
    """Every examples/ script must run as written (library-API
    walkthroughs for users switching from cuburn)."""

    @pytest.mark.parametrize("script,args", [
        ("01_still.py", ["out.png"]),
        ("03_blend.py", ["blend"]),
        ("05_checkpoint.py", []),
    ])
    def test_example_runs(self, script, args, tmp_path, monkeypatch):
        import runpy
        import sys
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "argv", [script] + args)
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                    "examples", script),
                       run_name="__main__")

    def test_animation_example(self, tmp_path, monkeypatch):
        import runpy
        import sys
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "argv", ["02_animation.py", "a.y4m"])
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                    "examples", "02_animation.py"),
                       run_name="__main__")
        assert (tmp_path / "a.y4m").read_bytes().startswith(
            b"YUV4MPEG2")

    def test_sequence_example(self, tmp_path, monkeypatch):
        import runpy
        import sys
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "argv", ["06_sequence.py", "s.y4m"])
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                    "examples", "06_sequence.py"),
                       run_name="__main__")
        assert (tmp_path / "s.y4m").exists()

    def test_multichip_example(self, tmp_path, monkeypatch):
        import jax
        if len(jax.devices()) < 2:
            pytest.skip("needs multiple devices")
        import runpy
        import sys
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(sys, "argv", ["04_multichip.py"])
        runpy.run_path(os.path.join(os.path.dirname(__file__), "..",
                                    "examples", "04_multichip.py"),
                       run_name="__main__")
        assert (tmp_path / "multichip.png").exists()


class TestStripedOpacity:
    def test_striped_matches_whole_frame_with_opacity(self):
        """Opacity-extended packed records under striping: the stripe
        camera's smaller n_bins re-derives the packing layout while
        op_bits comes from the full camera — the combination must stay
        bit-exact vs the whole-frame render."""
        from cuburn_tpu.genome.spline import Spline
        g = sierpinski()
        g.xforms[1].opacity = Spline(0.5)
        g.xforms[2].opacity = Spline(0.25)
        prof = dataclasses.replace(FAST, width=64, height=64,
                                   quality=40)
        r = Renderer(g, prof)
        assert r.op_bits > 0          # the extended-record path is on
        h_whole, _ = r.accumulate(0.0, seed=4)
        h_striped, _ = r.accumulate_striped(0.0, seed=4, n_stripes=3)
        np.testing.assert_array_equal(np.asarray(h_whole)[:-1],
                                      np.asarray(h_striped)[:-1])

    def test_striped_temporal_matches_whole_frame(self):
        """Motion blur under striping: temporal samples + tile_row0
        must partition exactly like the whole-frame temporal render."""
        g = animated_spark()
        prof = dataclasses.replace(FAST, width=64, height=64,
                                   quality=30, temporal_samples=3)
        r = Renderer(g, prof)
        h_whole, _ = r.accumulate(0.5, seed=6)
        h_striped, _ = r.accumulate_striped(0.5, seed=6, n_stripes=2)
        np.testing.assert_allclose(np.asarray(h_whole)[:-1],
                                   np.asarray(h_striped)[:-1],
                                   rtol=1e-5, atol=1e-4)


class TestAdversarialGenomes:
    """Badvalue respawn under duress: extreme parameters and expanding
    affines must never leak non-finite values into the image."""

    @pytest.mark.parametrize("seed", [2, 5])
    def test_extreme_params_render_finite(self, seed):
        from cuburn_tpu.genome.randgen import random_genome
        from cuburn_tpu.genome.spline import Spline
        g = random_genome(seed, size=(48, 48))
        for xf in g.xforms:
            xf.params = {k: Spline(float(v(0.0)) * 10.0)
                         for k, v in xf.params.items()}
            xf.__post_init__()
        prof = dataclasses.replace(FAST, width=48, height=48,
                                   quality=25)
        img, stats = Renderer(g, prof).render_frame(0.0, seed=seed)
        assert np.isfinite(img.astype(np.float64)).all()

    def test_expanding_affine_respawns(self):
        """An IFS with an EXPANDING xform flings points to infinity;
        respawn must keep the render alive and the junk bin absorbs
        the escapees."""
        from cuburn_tpu.genome.specs import Genome, XForm
        g = Genome(xforms=[
            XForm(weight=1.0, vars={"linear": 1.0},
                  affine=(3.0, 0.0, 0.1, 0.0, 3.0, 0.1)),   # expands
            XForm(weight=1.0, vars={"spherical": 1.0},
                  affine=(0.5, 0, 0.2, 0, 0.5, 0.1)),
        ], palettes=[(0.0, np.ones((256, 3)))], name="exploder")
        prof = dataclasses.replace(FAST, width=48, height=48,
                                   quality=30)
        hist, stats = Renderer(g, prof).accumulate(0.0, seed=3)
        h = np.asarray(hist)
        assert np.isfinite(h).all()
        assert h[:, 3].sum() > 0         # the render survived

    def test_rotated_striping_bitexact(self):
        """Camera rotation happens in full-frame coordinates before the
        stripe offset subtraction — rotated frames must stripe exactly
        like unrotated ones."""
        from cuburn_tpu.genome.spline import Spline
        g = classic_swirl()
        g.rotate = Spline(33.0)
        prof = dataclasses.replace(FAST, width=64, height=64,
                                   quality=30)
        r = Renderer(g, prof)
        h_whole, _ = r.accumulate(0.0, seed=4)
        h_str, _ = r.accumulate_striped(0.0, seed=4, n_stripes=3)
        np.testing.assert_array_equal(np.asarray(h_whole)[:-1],
                                      np.asarray(h_str)[:-1])

    def test_transparent_banded_finalize_bitexact(self):
        from cuburn_tpu.genome.spline import Spline
        g = classic_swirl()
        g.estimator_radius = Spline(4.0)
        prof = dataclasses.replace(FAST, width=64, height=64,
                                   quality=40, ss=2, de_enabled=True,
                                   transparent=True)
        r = Renderer(g, prof)
        hist, _ = r.accumulate(0.0, seed=3)
        whole = r.finalize_frame(hist, 0.0)
        banded = r.finalize_frame_banded(hist, 0.0, n_bands=3)
        assert np.abs(whole.astype(int) - banded.astype(int)).max() <= 1

    def test_sortcum_backend_render(self):
        """The sort-free prefix-sum backend end to end: equal mass,
        values within its documented cumsum-roundoff bound."""
        g = sierpinski()
        prof_s = dataclasses.replace(FAST, width=64, height=64,
                                     quality=30)
        prof_c = dataclasses.replace(prof_s, hist_backend="sortcum")
        h_s, _ = Renderer(g, prof_s).accumulate(0.0, seed=4)
        h_c, _ = Renderer(g, prof_c).accumulate(0.0, seed=4)
        a, b = np.asarray(h_s), np.asarray(h_c)
        assert a[:, 3].sum() == b[:, 3].sum()
        assert np.abs(a - b).max() < 0.5

    def test_scatter_sorted_backend_render(self):
        """The hinted-scatter backend end to end: density exact vs
        scatter (integer counts), rgb within f32 reassociation."""
        g = sierpinski()
        prof_s = dataclasses.replace(FAST, width=64, height=64,
                                     quality=30)
        prof_o = dataclasses.replace(prof_s,
                                     hist_backend="scatter_sorted")
        h_s, _ = Renderer(g, prof_s).accumulate(0.0, seed=4)
        h_o, _ = Renderer(g, prof_o).accumulate(0.0, seed=4)
        a, b = np.asarray(h_s), np.asarray(h_o)
        np.testing.assert_array_equal(a[:, 3], b[:, 3])
        assert np.abs(a - b).max() < 1e-2

    def test_subframe_duration_still_renders_one_frame(self):
        """duration*fps rounding to 0 must yield ONE frame, not a
        silent empty animation (review finding)."""
        g = animated_spark()
        prof = dataclasses.replace(FAST, fps=4.0, duration=0.1)
        frames = list(Renderer(g, prof).frames(seed=1))
        assert len(frames) == 1


def test_bench_json_driver_contract():
    """bench.py prints ONE JSON line; pin its schema
    (metric/value/unit/vs_baseline, and the device it ran on) by
    running the real script's --smoke path on the CPU.  Without
    --smoke it refuses to measure anywhere but on a GPU."""
    import json
    import subprocess
    import sys
    bench_path = os.path.join(os.path.dirname(__file__), "..",
                              "bench.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, bench_path, "--smoke"],
                       capture_output=True, text=True, timeout=600,
                       env=env)
    line = r.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "ifs_samples_per_sec_per_chip"
    assert rec["unit"] == "samples/s"
    assert rec["value"] > 0
    assert "vs_baseline" in rec
    assert rec["extra"]["platform"] == "cpu"
    assert rec["extra"]["config"].endswith("backend=scatter")
    r = subprocess.run([sys.executable, bench_path], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no GPU" in r.stderr


class TestRandomGenomeAnchorFuzz:
    """Randomized differential fuzz: flam3-genome-style random genomes
    (random structures over the SAFE variation set — random affines,
    posts, finals, xaos, parametric knobs) rendered through BOTH the
    device pipeline and the independent NumPy reference
    (tests/reference_impl.py), compared distributionally.  The fixed
    anchor families pin each variation's formula; this pins the
    COMPOSITION machinery on structures nobody hand-picked.  Seeds are
    fixed for reproducibility; any failure is a real divergence (or a
    too-tight bound) worth investigating, never flake."""

    @pytest.mark.parametrize(
        "seed", [101, 202, 303, 404, 505, 606, 707, 808])
    def test_random_genome_matches_reference(self, seed):
        import dataclasses
        from cuburn_tpu.genome.randgen import random_genome
        g = random_genome(seed, size=(48, 48))
        # gutterless histogram so the device layout matches the
        # reference's W*H bins (same convention as the fixed anchors)
        g = dataclasses.replace(g, spatial_filter=0.0)
        # random attractors vary in in-frame retention; require enough
        # in-frame mass that the TV comparison is meaningful, then
        # compare distributions (bound looser than the hand-framed
        # anchors: arbitrary random framing concentrates mass in fewer
        # bins, raising the two-seed noise floor)
        from tests.reference_impl import render_reference
        ref = render_reference(g, 48, 48, 200_000, seed=seed * 7 + 1)
        if ref[:-1, 3].sum() < 30_000:
            pytest.skip(f"random genome {seed} keeps <15% of mass "
                        "in frame; TV would be noise-dominated")
        # measured two-seed noise floors for these seeds: 0.001-0.017
        # (seed 707 sat at 0.127 until the fuzz exposed the reference
        # harness int-rounding fractional julian powers — the bound is
        # tight enough to catch that class again)
        _anchor_compare(g, 500_000, seed_ref=seed * 7 + 1,
                        seed_our=seed * 11 + 3, tv_bound=0.05)

    @staticmethod
    def _wild_genome(seed):
        """Random composition over the FULL variation registry (not
        just randgen's safe set): three xforms each mixing one
        registry variation (schema-default params) with linear, random
        rotation-scale affines, plus a contractive pure-linear xform
        that keeps the attractor bounded even for expansive
        variations."""
        from cuburn_tpu.genome.palette import builtin_palette
        from cuburn_tpu.genome.specs import Genome, XForm
        from cuburn_tpu.genome.variations import VARIATION_PARAMS
        from cuburn_tpu.ops.variations import VARIATION_IMPLS
        rng = np.random.RandomState(0xB1D ^ seed)
        names = list(rng.choice(sorted(VARIATION_IMPLS), size=3,
                                replace=False))
        xforms = []
        for nm in names:
            ang = rng.uniform(0, 2 * np.pi)
            s = rng.uniform(0.3, 0.6)
            ca, sa = np.cos(ang) * s, np.sin(ang) * s
            aff = (ca, -sa, rng.uniform(-.6, .6),
                   sa, ca, rng.uniform(-.6, .6))
            params = {a: float(d)
                      for a, d in VARIATION_PARAMS.get(nm, ())}
            xforms.append(XForm(
                weight=float(rng.uniform(0.4, 1.0)),
                color=float(rng.uniform(0, 1)), color_speed=0.5,
                affine=aff,
                vars={nm: float(rng.uniform(0.3, 0.6)),
                      "linear": 0.4},
                params=params))
        xforms.append(XForm(weight=0.8, color=0.5, color_speed=0.5,
                            affine=(0.4, 0.0, 0.0, 0.0, 0.4, 0.0),
                            vars={"linear": 1.0}))
        return Genome(xforms=xforms, scale=7.0, size=(48, 48),
                      spatial_filter=0.0,
                      palettes=[(0.0, builtin_palette(seed))],
                      name=f"wild_{seed}")

    @pytest.mark.parametrize("seed", [1, 2, 4, 6, 8, 10, 14])
    def test_wild_registry_composition_matches_reference(self, seed):
        """Fuzz over the FULL registry: arbitrary three-variation
        compositions must agree with the independent reference.
        Measured cross-pipeline TVs for these seeds sit at their
        two-seed noise floors (0.002-0.032); the covered sets include
        weight-nonlinear (twintrian, scry, lazysusan), pre_blur as a
        drawn 'variation', complex-trig, and parametric-default
        combinations no hand-written anchor pairs up."""
        from tests.reference_impl import render_reference
        g = self._wild_genome(seed)
        ref = render_reference(g, 48, 48, 150_000, seed=seed * 13 + 5)
        if ref[:-1, 3].sum() < 25_000:
            pytest.skip(f"wild genome {seed} keeps <17% of mass "
                        "in frame; TV would be noise-dominated")
        _anchor_compare(g, 400_000, seed_ref=seed * 13 + 5,
                        seed_our=seed * 17 + 7, tv_bound=0.05)

    @pytest.mark.parametrize("seed", [11, 22, 33, 44])
    def test_random_opacity_matches_reference(self, seed):
        """Per-xform opacity fuzz: random genomes with random non-unit
        opacities (vis-scaled contributions) must agree with the
        reference — the opacity axis randomized, not just the single
        hand-built anchor.  Measured TVs 0.0007-0.0098 at floors
        0.001-0.012."""
        import dataclasses
        from cuburn_tpu.genome.randgen import random_genome
        g = dataclasses.replace(random_genome(seed, size=(48, 48)),
                                spatial_filter=0.0)
        rng = np.random.RandomState(seed)
        xfs = [dataclasses.replace(
                   x, opacity=float(rng.uniform(0.2, 1.0)))
               for x in g.xforms]
        g = dataclasses.replace(g, xforms=xfs)
        _anchor_compare(g, 500_000, seed_ref=seed * 7 + 1,
                        seed_our=seed * 11 + 3, tv_bound=0.05)

    @staticmethod
    def _param_genome(nm, seed):
        """Single parametric variation with JITTERED params (x0.5-1.7
        plus additive noise; powers flip sign 35% of the time, values
        near zero pushed off the pole) over a stabilizing linear
        xform — probes branch/abs/trunc conventions at parameter
        values no hand-written anchor chose."""
        import zlib
        from cuburn_tpu.genome.palette import builtin_palette
        from cuburn_tpu.genome.specs import Genome, XForm
        from cuburn_tpu.genome.variations import VARIATION_PARAMS
        rng = np.random.RandomState(
            (0xFA2 ^ (seed * 1000003)
             ^ zlib.crc32(nm.encode())) & 0x7FFFFFFF)
        params = {}
        for attr, d in VARIATION_PARAMS[nm]:
            v = d * rng.uniform(0.5, 1.7) + rng.uniform(-0.3, 0.3)
            if attr.endswith("_power") and rng.rand() < 0.35:
                v = -v
            if abs(v) < 0.05:
                v = 0.35
            params[attr] = float(v)
        ang = rng.uniform(0, 2 * np.pi)
        ca, sa = np.cos(ang) * 0.5, np.sin(ang) * 0.5
        xforms = [
            XForm(weight=1.0, color=0.3, color_speed=0.5,
                  affine=(ca, -sa, 0.3, sa, ca, 0.1),
                  vars={nm: 0.55, "linear": 0.4}, params=params),
            XForm(weight=0.8, color=0.7, color_speed=0.5,
                  affine=(0.45, 0.1, -0.2, -0.1, 0.45, 0.25),
                  vars={"linear": 1.0}),
        ]
        return Genome(xforms=xforms, scale=7.0, size=(48, 48),
                      spatial_filter=0.0,
                      palettes=[(0.0, builtin_palette(seed))],
                      name=f"pf_{nm}_{seed}")

    @pytest.mark.parametrize("nm", sorted(
        n for n, ps in __import__(
            "cuburn_tpu.genome.variations",
            fromlist=["VARIATION_PARAMS"]).VARIATION_PARAMS.items()
        if ps))
    def test_parametric_knob_fuzz(self, nm):
        """Every parametric variation at randomized (non-default,
        possibly negative-power, fractional) parameter values must
        match the independent reference distributionally.  This is the
        axis where the fractional-julian-power bug lived; a 2-seed
        survey over all 39 parametric variations measured every TV at
        its noise floor (max 0.023 at 400k samples)."""
        from tests.reference_impl import render_reference
        g = self._param_genome(nm, 1)
        ref = render_reference(g, 48, 48, 100_000, seed=11)
        if ref[:-1, 3].sum() < 17_000:
            pytest.skip(f"{nm} param draw keeps <17% of mass in "
                        "frame; TV would be noise-dominated")
        _anchor_compare(g, 250_000, seed_ref=11, seed_our=23,
                        tv_bound=0.06)
