"""The frame pipeline: genome + profile -> rendered frames.

Equivalent of the reference's cuburn/render.py Renderer/RenderManager
(SURVEY.md §2 layer 4, §3.1 call stack).  Where cuburn compiles a CUDA
module per genome and drives kernel launches over streams, this builds
one jitted XLA program per (StructureKey, CameraSpec, chunk geometry)
and drives it over chunks; JAX's async dispatch provides the
compute/transfer overlap that cuburn got from CUDA streams (SURVEY.md
§2b pipeline-overlap row).

Per frame (mirroring §3.1):
  eval genome splines at frame time(s)      [host, cheap]
  for each temporal sample: chunked { iterate + accumulate }  [device]
  logscale -> density estimation -> colorclip -> downsample   [device]
  u8 readback                                                  [host]
"""

from __future__ import annotations


import functools
import os
import sys
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cuburn_tpu.genome.specs import Genome, GenomeParams, StructureKey
from cuburn_tpu.ops import histogram as hist_mod
from cuburn_tpu.ops.camera import CameraSpec
from cuburn_tpu.ops import de as de_mod
from cuburn_tpu.ops.filtering import (colorclip, downsample, logscale,
                                      to_u8)
from cuburn_tpu.ops.iterate import (IterState, color_bits_for,
                                    init_state, iterate_accumulate,
                                    xform_cdf_rows)
from cuburn_tpu.profile import RenderProfile


def _spline_range_max(sp, time_range) -> float:
    """Max of a genome spline over the render's time range (33-point
    sample + both endpoints) — sizes static filter geometry so
    animated estimator/filter splines don't get clipped to their t=0
    value."""
    t0, t1 = time_range
    if sp.is_constant or t1 <= t0:
        return float(sp(t0))
    ts = np.linspace(t0, t1, 33)
    return float(np.max(sp.evaluate(ts)))


def temporal_filter_weights(n: int, ftype: str = "box",
                            width: float = 1.0,
                            filter_exp: float = 0.0):
    """flam3's create_temporal_filter (flam3.c): per-temporal-sample
    shutter offsets and contribution weights.

    Returns (deltas (n,), weights (n,), sumfilt):
      deltas   — sample times in frame-interval units, centered on the
                 frame time: (i/n - 0.5) * width  (flam3's exact rule)
      weights  — filter values normalized so max == 1; each sample's
                 histogram contribution is scaled by its weight
      sumfilt  — mean weight: the factor flam3 folds into k2 so overall
                 brightness is independent of the filter shape
    """
    i = np.arange(n, dtype=np.float64)
    deltas = (i / n - 0.5) * width
    if n <= 1:
        return np.zeros(1), np.ones(1), 1.0
    if ftype in ("gaussian", "gauss"):
        half = n / 2.0
        # flam3 evaluates its gaussian spatial kernel (support 1.5,
        # exp(-2x^2)) at 1.5*|i-half|/half; the sqrt(2/pi) prefactor
        # cancels under max-normalization
        x = 1.5 * np.abs(i - half) / half
        w = np.exp(-2.0 * x * x)
    elif ftype == "exp":
        slpx = (i + 1.0) / n if filter_exp >= 0 else (n - i) / n
        w = slpx ** abs(filter_exp)
    elif ftype == "box":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown temporal filter type {ftype!r}")
    w = w / w.max()
    return deltas, w, float(w.mean())


@dataclass
class FrameStats:
    """Per-frame observability record (SURVEY.md §5 metrics row)."""
    plotted_samples: int = 0
    total_iters: int = 0
    iterate_s: float = 0.0
    filter_s: float = 0.0

    @property
    def retention(self) -> float:
        return self.plotted_samples / max(self.total_iters, 1)

    @property
    def samples_per_sec(self) -> float:
        return self.plotted_samples / max(self.iterate_s, 1e-9)


# The whole per-frame accumulation is ONE device program: the chunk
# loop lives inside iterate_accumulate's scan, the histogram flush
# inside the scan body.  One dispatch per frame — essential both for
# device-memory traffic (no materialized point records) and for
# dispatch latency (SURVEY.md §2b pipeline-overlap row).


@functools.partial(jax.jit, static_argnames=("cam", "transparent",
                                             "de_on", "de_static_r",
                                             "spatial_filter",
                                             "filter_shape",
                                             "earlyclip"))
def _filter_frame(cam: CameraSpec, transparent: bool, de_on: bool,
                  hist, params: GenomeParams, quality_per_cell,
                  de_static_r: float = 9.0,
                  spatial_filter: float = 0.0,
                  filter_shape: str = "gaussian",
                  earlyclip: bool = False):
    """logscale -> DE -> downsample -> colorclip -> u8, one fused jit
    (earlyclip swaps the last two stages, flam3's pre-2008 order)."""
    img = hist.reshape(cam.acc_height, cam.acc_width, 4)
    raw_density = img[..., 3]
    img = logscale(img, params.brightness, quality_per_cell)
    if de_on:
        img = de_mod.density_filter(
            img, raw_density,
            params.estimator_radius * cam.ss,
            params.estimator_minimum * cam.ss,
            params.estimator_curve,
            static_max_radius=de_static_r)
    # flam3 order: the supersample downsample happens BEFORE colorclip
    # (rect.c folds the spatial filter into DE accumulation, then
    # colorclips output-res pixels) — and it's cheaper: gamma at 1/ss^2
    # the pixels.  The gutter is consumed inside downsample so the
    # filtered decimation reads real border context.
    # earlyclip restores flam3's pre-2008 order (rect.c earlyclip
    # block): colorclip EVERY supersampled bucket after DE, filter the
    # already-clipped rgba, then only clip — negative filter lobes
    # (mitchell/catrom/sinc) can leave [0,1].  Background/alpha
    # compose per BUCKET in that order, exactly as the rect.c block
    # stores composed values back into `accumulate`.
    if earlyclip:
        img = colorclip(
            img, params.gamma, params.vibrancy, params.highlight_power,
            params.gamma_threshold, params.background, transparent)
        img = downsample(img, cam.ss, spatial_filter, filter_shape,
                         gutter=cam.gutter)
        img = jnp.clip(img, 0.0, 1.0)
    else:
        img = downsample(img, cam.ss, spatial_filter, filter_shape,
                         gutter=cam.gutter)
        img = colorclip(
            img, params.gamma, params.vibrancy, params.highlight_power,
            params.gamma_threshold, params.background, transparent)
    u8 = to_u8(img)
    # opaque output reads back rgb only (alpha is a constant 255 the
    # host fills in, render._with_alpha): the final u8 D2H is a real
    # slice of the binding-size still wall (bench/bandsweep.py) and
    # this cuts it 25% — same contract as _filter_banded_device
    return u8 if transparent else u8[..., :3]


def _with_alpha(img_np: np.ndarray) -> np.ndarray:
    """Pad a device-side rgb-only u8 frame to RGBA (alpha=255) — the
    host half of the opaque rgb-only readback contract."""
    if img_np.shape[-1] == 3:
        out = np.empty(img_np.shape[:-1] + (4,), np.uint8)
        out[..., :3] = img_np
        out[..., 3] = 255
        return out
    return img_np


def band_margin(de_on: bool, de_r: float, spatial_filter: float,
                filter_shape: str, ss: int) -> int:
    """Vertical context rows a band filter needs: 1.5x the (capped)
    static DE radius + the spatial filter's half-width, rounded up to
    an ss multiple.  The ONE margin formula shared by
    finalize_frame_banded, the sharded band filter, and the
    reduce-scatter mode — these paths must never compute different
    supports."""
    de_half = (int(np.ceil(1.5 * min(max(de_r, 0.0),
                                     de_mod.MAX_RADIUS_CAP)))
               if de_on else 0)
    pad = 0
    if spatial_filter > 0:
        from cuburn_tpu.ops.filtering import spatial_filter_taps
        pad = (spatial_filter_taps(filter_shape, spatial_filter,
                                   ss).shape[0] - ss) // 2
    return ss * int(np.ceil((de_half + pad + 1) / ss))


@functools.partial(jax.jit, static_argnames=(
    "ss", "margin", "gutter_x", "transparent", "de_on",
    "de_static_r", "spatial_filter", "filter_shape", "skip_empty",
    "earlyclip"))
def _filter_band(hist_band, params: GenomeParams, quality_per_cell,
                 ss: int, margin: int, gutter_x: int,
                 transparent: bool, de_on: bool, de_static_r: float,
                 spatial_filter: float, filter_shape: str,
                 skip_empty: bool = False, earlyclip: bool = False):
    """_filter_frame on one horizontal band of the accumulator.

    hist_band: (band_rows + 2*margin, acc_w, 4) with `margin` rows of
    real context above/below (zero-filled only past the accumulator's
    own bounds — exactly what the full-frame filter sees there).  Every
    filter stage is local (DE radius <= MAX_RADIUS_CAP, spatial filter
    half-width), so with margin >= those supports the band outputs
    equal the corresponding rows of the full-frame filter up to float
    reassociation — lets 1080p-class frames filter as several small
    programs (Renderer.finalize_frame_banded).  The margin doubles as
    the band's vertical gutter for the filtered decimation."""
    img = hist_band
    raw_density = img[..., 3]
    img = logscale(img, params.brightness, quality_per_cell)
    if de_on:
        img = de_mod.density_filter(
            img, raw_density,
            params.estimator_radius * ss,
            params.estimator_minimum * ss,
            params.estimator_curve,
            static_max_radius=de_static_r,
            skip_empty=skip_empty)
    # earlyclip: flam3's pre-2008 order (clip per bucket, then filter)
    # — see _filter_frame.  colorclip is per-bucket-local, so banding
    # stays exact under either order.
    if earlyclip:
        img = colorclip(
            img, params.gamma, params.vibrancy, params.highlight_power,
            params.gamma_threshold, params.background, transparent)
        img = downsample(img, ss, spatial_filter, filter_shape,
                         gutter=(margin, gutter_x))
        img = jnp.clip(img, 0.0, 1.0)
    else:
        img = downsample(img, ss, spatial_filter, filter_shape,
                         gutter=(margin, gutter_x))
        img = colorclip(
            img, params.gamma, params.vibrancy, params.highlight_power,
            params.gamma_threshold, params.background, transparent)
    return to_u8(img)


def _to_device(params: GenomeParams) -> GenomeParams:
    return jax.tree_util.tree_map(jnp.asarray, params)


@functools.partial(jax.jit, static_argnames=("acc_w",))
def _merge_stripe(full, stripe, row0, rows, acc_w: int):
    """Add a stripe's logical histogram rows [0, rows) into the full
    device histogram at row offset row0 (traced — one compiled program
    serves every stripe).  Rows past `rows` (the last stripe's
    overhang beyond the frame) are masked off, matching the full-frame
    render exactly (those points fail its bounds test)."""
    mask = (jnp.arange(stripe.shape[0]) < rows * acc_w)
    cur = jax.lax.dynamic_slice(
        full, (row0 * acc_w, 0), (stripe.shape[0], 4))
    return jax.lax.dynamic_update_slice(
        full, cur + stripe * mask[:, None], (row0 * acc_w, 0))


@functools.partial(jax.jit, static_argnames=(
    "n_bands", "band_rows", "margin", "ss", "gutter_x", "transparent",
    "de_on", "de_static_r", "spatial_filter", "filter_shape",
    "skip_empty", "earlyclip"))
def _filter_banded_device(himg, params: GenomeParams, quality_per_cell,
                          n_bands: int, band_rows: int, margin: int,
                          ss: int, gutter_x: int, transparent: bool,
                          de_on: bool, de_static_r: float,
                          spatial_filter: float, filter_shape: str,
                          skip_empty: bool = False,
                          earlyclip: bool = False):
    """ALL bands of finalize_frame_banded in ONE device program: a
    lax.map over band starts whose body is the band-sized _filter_band
    (programs stay small — the reason banding exists — while the
    histogram image never leaves the device and the whole filter costs
    ONE dispatch instead of n_bands).  Returns (n_bands, band_rows/ss,
    W, C) u8 — C=3 for opaque output (alpha is a constant 255 the host
    fills in, so readback bytes drop 25%), C=4 transparent."""
    acc_h, acc_w = himg.shape[0], himg.shape[1]
    need_h = gutter_x + n_bands * band_rows + 2 * margin
    pad_bot = max(0, need_h - margin - acc_h)
    padded = jnp.pad(himg, ((margin, pad_bot), (0, 0), (0, 0)))

    def band_at(start):
        # padded coords: original row r sits at r + margin, so the
        # slice [start - margin, ...) begins at `start`
        block = jax.lax.dynamic_slice(
            padded, (start, 0, 0),
            (band_rows + 2 * margin, acc_w, 4))
        out = _filter_band(block, params, quality_per_cell, ss,
                           margin, gutter_x, transparent, de_on,
                           de_static_r, spatial_filter, filter_shape,
                           skip_empty=skip_empty, earlyclip=earlyclip)
        return out if transparent else out[..., :3]

    starts = gutter_x + band_rows * jnp.arange(n_bands,
                                               dtype=jnp.int32)
    return jax.lax.map(band_at, starts)


# samples/s is flat within ~4% from 8 to 128 iterations per flush
# (2^20 to 2^24 records at the default batch) on an H100 at 512², 720p
# and 1080p-ss2 (bench/histrace.py --ks)
DEFAULT_ITERS_PER_CHUNK = 32


def resolve_iters_per_chunk(profile: RenderProfile) -> int:
    """Iterations per histogram flush (records per flush = batch *
    iters_per_chunk): CUBURN_ITERS_PER_CHUNK if set and > 0, else the
    profile's value if > 0, else DEFAULT_ITERS_PER_CHUNK."""
    env = os.environ.get("CUBURN_ITERS_PER_CHUNK")
    if env and int(env) > 0:   # "0" = auto, like the profile field
        return int(env)
    if profile.iters_per_chunk > 0:
        return profile.iters_per_chunk
    return DEFAULT_ITERS_PER_CHUNK


class Renderer:
    """Renders frames of one genome under one profile.

    Compiled programs are cached by JAX on (structure key, camera,
    chunk geometry) — re-rendering at new times / seeds / spline values
    never recompiles (SURVEY.md §7: trace-time specialization)."""

    def __init__(self, genome: Genome, profile: RenderProfile):
        import os
        if profile.dispatch_iter_cap is None:
            env_cap = os.environ.get("CUBURN_DISPATCH_ITER_CAP")
            if env_cap:
                import dataclasses as _dc
                profile = _dc.replace(profile,
                                      dispatch_iter_cap=int(env_cap))
        self.genome = genome
        self.profile = profile
        self.key = genome.structure_key()
        no_rot = genome.rotate.is_constant and genome.rotate(0.0) == 0.0
        # static filter geometry is sized to the spline MAX over the
        # genome's time range, not t=0: an animated estimator_radius
        # or spatial_filter would otherwise undersize the gutter, DE
        # ladder and filter taps for later frames (dark clipped
        # edges).  The per-frame TRACED estimator params still drive
        # the DE band assignment, so DE animates correctly under a
        # range-max ladder; the spatial-filter WIDTH however is baked
        # into the compiled taps and stays at the range max.
        self._static_de_r = _spline_range_max(
            genome.estimator_radius, genome.time_range) * profile.ss
        self._static_sf = _spline_range_max(
            genome.spatial_filter, genome.time_range)
        if not genome.spatial_filter.is_constant:
            import warnings
            warnings.warn(
                "spatial_filter animates; the filter width is fixed "
                "at the time-range maximum "
                f"({self._static_sf:.3g}) for the whole render "
                "(taps are compiled constants)")
        de_r0 = self._static_de_r
        # gutter: DE blur must not clip at the frame border, and the
        # spatial filter's decimation must read REAL border context
        # (flam3 sizes its gutter to DE radius + filter half-width;
        # zero-padded edges render dark).  DE kernel support is 1.5x
        # the radius (3 sigma at sigma=r/2, ops/de.py band_ladder) —
        # the gutter must cover the full support or edge pixels lose
        # DE mass
        gutter = (int(np.ceil(1.5 * min(de_r0, de_mod.MAX_RADIUS_CAP)))
                  if (profile.de_enabled and de_r0 > 0) else 0)
        sf0 = self._static_sf
        if sf0 > 0:
            from cuburn_tpu.ops.filtering import spatial_filter_taps
            gutter += (spatial_filter_taps(
                genome.spatial_filter_shape, sf0,
                profile.ss).shape[0] - profile.ss) // 2
        self.cam = CameraSpec(profile.width, profile.height, profile.ss,
                              no_rotation=no_rot, gutter=gutter)
        # packed single-u32 log records: unit opacities pack as
        # addr+color; varying opacities fold the xform id into an
        # opacity-extended palette coordinate (ops/iterate.py
        # opacity_bits_for) when the record fits 32 bits.
        from cuburn_tpu.ops.iterate import opacity_bits_for
        unit_op = all(xf.opacity.is_constant and xf.opacity(0.0) == 1.0
                      for xf in genome.xforms)
        self.op_bits = 0
        if unit_op:
            self.packed = color_bits_for(self.cam.n_bins) > 0
        else:
            ob, cb = opacity_bits_for(self.cam.n_bins,
                                      len(genome.xforms))
            self.packed = cb > 0
            self.op_bits = ob
        self.backend = (hist_mod.AUTO_BACKEND
                        if profile.hist_backend == "auto"
                        else profile.hist_backend)
        import dataclasses as _dc
        self.profile = _dc.replace(
            profile, iters_per_chunk=resolve_iters_per_chunk(profile))

    # -- frame rendering -------------------------------------------------

    def render_frame(self, t: float = 0.0, seed: int = 0,
                     hist0: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, FrameStats]:
        """Render one frame at genome time t.  Returns (u8 image
        (H, W, 4), FrameStats).

        `hist0`: optional logical (n_bins+1, 4) histogram to resume
        accumulation from (checkpoint/resume for very-high-quality
        stills, SURVEY.md §5); pair with `last_hist`."""
        hist, stats = self.accumulate(t, seed, hist0)
        img = self.finalize_frame(hist, t, stats)
        return img, stats

    def accumulate(self, t: float = 0.0, seed: int = 0,
                   hist0: Optional[np.ndarray] = None,
                   ) -> Tuple[np.ndarray, FrameStats]:
        """Run the chaos game for one frame's quality budget; returns
        the *logical* (n_bins+1, 4) histogram and stats.

        Stats-accurate mode: ends in a hard host readback so
        FrameStats.iterate_s is true device time.  The overlapped
        animation driver (frames_overlapped) uses accumulate_async
        instead — dispatch only, sync deferred to the sink."""
        stats = FrameStats()
        t0 = time.perf_counter()
        hist, n_plot, n_iter = self.accumulate_async(t, seed, hist0)
        stats.plotted_samples += int(n_plot)
        stats.total_iters += n_iter
        jax.block_until_ready(hist)
        stats.iterate_s = time.perf_counter() - t0
        return hist, stats

    def accumulate_async(self, t: float = 0.0, seed: int = 0,
                         hist0: Optional[np.ndarray] = None):
        """Dispatch one frame's accumulation WITHOUT any host sync.

        Returns (logical hist, plotted-count device scalar,
        total_iters int) — all device values still in flight.  This is
        the throughput-mode half of cuburn's 2-stream overlap
        (cuburn/render.py iter(N) ‖ filter/copy(N-1), SURVEY.md §2b
        pipeline row): the caller may dispatch further frames before
        reading any of them back.  (A provided `hist0` still costs one
        readback for the seed-freshening mass mix.)"""
        prof, cam = self.profile, self.cam

        eff_seed = seed * 7919
        if hist0 is not None:
            hist0 = jnp.asarray(hist0, jnp.float32)
            if hist0.shape != (cam.n_bins + 1, 4):
                raise ValueError(
                    f"resume histogram shape {hist0.shape} != "
                    f"{(cam.n_bins + 1, 4)}")
            # Resuming with an unchanged seed would replay the exact
            # same trajectory stream, doubling density instead of
            # adding new samples; mix the resumed mass (which grows
            # every pass) into the seed so each pass is fresh.
            mass = int(min(float(np.asarray(hist0[:, 3].sum())),
                           2.0 ** 62))
            eff_seed = (eff_seed ^ (mass * 0x9E3779B9)) & 0x7FFFFFFF
            hist = hist0
        else:
            hist = hist_mod.alloc(cam.n_bins)
        ts_times, ts_weights, _sumfilt = self._temporal_times(t)
        if len(ts_times) == 1:
            params = _to_device(self.genome.eval_at(ts_times[0]))
            hist, n_plot, n_iter = self._accumulate_sample(
                params, hist, seed=eff_seed,
                iters=prof.total_iters)
        else:
            # motion blur: every temporal sample inside one dispatch,
            # parameters interpolated by the packed-knot evaluator,
            # contributions weighted by the flam3 temporal filter
            hist, n_plot, n_iter = self._accumulate_temporal(
                ts_times, ts_weights, hist, seed=eff_seed,
                iters_per_sample=prof.total_iters / len(ts_times))
        return hist, n_plot, n_iter

    def accumulate_striped(self, t: float = 0.0, seed: int = 0,
                           n_stripes: int = 4,
                           ) -> Tuple[np.ndarray, FrameStats]:
        """accumulate(), but as n_stripes horizontal sub-programs.

        Each stripe is a CameraSpec covering a row band of the full
        accumulator, projected in FULL-frame coordinates so the stripes
        partition points exactly like a whole-frame render with the
        same seed (ops/camera.py tile fields).  Every stripe replays
        the full trajectory stream, so device time is ~n_stripes x a
        whole-frame render — the trade for never materializing the full
        histogram in one program (frames beyond device memory)."""
        prof, cam = self.profile, self.cam
        stats = FrameStats()
        full_h = cam.acc_height
        th = -(-full_h // n_stripes)
        # The full histogram stays ON DEVICE and stripes merge via a
        # traced dynamic-slice add (no per-stripe host round trip).
        # Padded so the LAST stripe's slice window fits without
        # dynamic_slice's start-clamping shifting it; masked tail adds
        # land in the padding and are cropped on return
        pad_rows = max(cam.n_bins + 1,
                       n_stripes * th * cam.acc_width)
        full = jnp.zeros((pad_rows, 4), jnp.float32)
        # ONE static camera for every stripe; the row offset flows in
        # as a traced value so all stripes share a single compiled
        # program (no per-stripe recompile)
        scam = CameraSpec(
            prof.width, prof.height, prof.ss,
            no_rotation=cam.no_rotation, gutter=cam.gutter,
            full_acc_height=full_h, tile_acc_height=th)
        t0 = time.perf_counter()
        for s in range(n_stripes):
            row0 = jnp.int32(s * th)
            hist = hist_mod.alloc(scam.n_bins)
            ts_times, ts_weights, _sf = self._temporal_times(t)
            saved_cam = self.cam
            self.cam = scam
            try:
                if len(ts_times) == 1:
                    params = _to_device(self.genome.eval_at(ts_times[0]))
                    hist, n_plot, n_iter = self._accumulate_sample(
                        params, hist, seed=seed * 7919,
                        iters=prof.total_iters, tile_row0=row0)
                else:
                    hist, n_plot, n_iter = self._accumulate_temporal(
                        ts_times, ts_weights, hist, seed=seed * 7919,
                        iters_per_sample=prof.total_iters
                        / len(ts_times), tile_row0=row0)
            finally:
                self.cam = saved_cam
            rows = min(th, full_h - s * th)
            # per-stripe junk counts points in OTHER stripes too, so
            # it doesn't aggregate meaningfully; leave full[-1] at 0
            full = _merge_stripe(
                full, hist[:scam.n_bins], jnp.int32(s * th),
                jnp.int32(rows), cam.acc_width)
            stats.plotted_samples += int(n_plot)
            stats.total_iters += n_iter
        full = full[:cam.n_bins + 1]
        jax.block_until_ready(full)
        stats.iterate_s = time.perf_counter() - t0
        return full, stats

    def finalize_frame(self, hist, t: float = 0.0,
                       stats: Optional[FrameStats] = None) -> np.ndarray:
        """logscale -> DE -> colorclip -> downsample a logical
        histogram into a u8 frame."""
        t1 = time.perf_counter()
        img = _with_alpha(np.asarray(self.finalize_frame_device(hist,
                                                                t)))
        if stats is not None:
            stats.filter_s = time.perf_counter() - t1
        return img

    def finalize_frame_device(self, hist, t: float = 0.0):
        """finalize_frame without the device->host readback: returns
        the u8 frame as a device array still in flight (the overlapped
        driver reads it back only when the NEXT frame's work has been
        dispatched — cuburn's async D2H copy, SURVEY.md §3.1).
        Opaque profiles return (H, W, 3) — alpha is a constant the
        host fills in (_with_alpha); transparent return (H, W, 4)."""
        prof, cam = self.profile, self.cam
        params = _to_device(self.genome.eval_at(t))
        # flam3 folds the temporal filter's mean weight (sumfilt) into
        # k2 so brightness is independent of the filter shape
        _times, _w, sumfilt = self._temporal_times(t)
        q_cell = jnp.float32(prof.quality * sumfilt / (cam.ss * cam.ss))
        de_r = self._static_de_r
        return _filter_frame(
            cam, prof.transparent, self._de_on(params),
            hist_mod.finalize(jnp.asarray(hist)), params, q_cell,
            de_static_r=de_r if de_r > 0 else 9.0,
            spatial_filter=self._static_sf,
            filter_shape=self.genome.spatial_filter_shape,
            earlyclip=self.genome.earlyclip)

    def finalize_frame_banded(self, hist, t: float = 0.0,
                              stats: Optional[FrameStats] = None,
                              n_bands: int = 4,
                              skip_empty: Optional[bool] = None
                              ) -> np.ndarray:
        """finalize_frame as n_bands horizontal sub-programs.

        Every filter stage is local and bands carry enough real context
        rows to cover the DE and spatial-filter supports, so outputs
        match the whole-frame filter up to float reassociation (XLA
        tiles convs differently per program shape; <= 1 u8 step on
        rounding boundaries) — the filter-side counterpart of
        accumulate_striped for frames whose full filter program
        exceeds device limits."""
        prof, cam = self.profile, self.cam
        t1 = time.perf_counter()
        params = _to_device(self.genome.eval_at(t))
        _times, _w, sumfilt = self._temporal_times(t)
        q_cell = jnp.float32(prof.quality * sumfilt
                             / (cam.ss * cam.ss))
        de_r = self._static_de_r
        de_static = de_r if de_r > 0 else 9.0
        de_on = self._de_on(params)
        sf = self._static_sf
        shape = self.genome.spatial_filter_shape
        ss, g = cam.ss, cam.gutter
        H, W = prof.height, prof.width
        h_band = -(-H // n_bands)
        band_rows = h_band * ss
        margin = band_margin(de_on, de_r, sf, shape, ss)
        acc_h, acc_w = cam.acc_height, cam.acc_width
        # The whole banding runs DEVICE-side: slicing with lax.dynamic_slice on a zero-padded device image
        # keeps programs band-sized (the reason banding exists) while
        # data never leaves the device until the final u8 readback.
        if skip_empty is None:
            skip_empty = os.environ.get("CUBURN_DE_SKIP_EMPTY") == "1"
        himg = jnp.asarray(hist, jnp.float32)[:-1]\
            .reshape(acc_h, acc_w, 4)
        bands = _filter_banded_device(
            himg, params, q_cell, n_bands, band_rows, margin, ss, g,
            prof.transparent, de_on, de_static, sf, shape,
            skip_empty=bool(skip_empty),
            earlyclip=self.genome.earlyclip)
        out = np.zeros((H, W, 4), np.uint8)
        if not prof.transparent:
            out[..., 3] = 255       # device program returns rgb only
        ch = 4 if prof.transparent else 3
        bands_np = np.asarray(bands)       # one D2H for all bands
        for b in range(n_bands):
            rows = min(h_band, H - b * h_band)
            if rows > 0:
                out[b * h_band:b * h_band + rows, :, :ch] = \
                    bands_np[b][:rows]
        if stats is not None:
            stats.filter_s = time.perf_counter() - t1
        return out

    def _de_on(self, params) -> bool:
        return (self.profile.de_enabled and
                float(params.estimator_radius) > 0.0)

    def frame_dt(self) -> float:
        """The per-frame genome-time step — MUST match frames()'s
        stepping exactly so the motion-blur shutter covers precisely
        one inter-frame interval for any time_range span or explicit
        duration (round-1 hard-coded 1/(fps*span), wrong off the unit
        range)."""
        t0, t1 = self.genome.time_range
        prof = self.profile
        if prof.duration is not None:
            n_frames = max(1, int(round(prof.duration * prof.fps)))
        else:
            n_frames = max(1, int(round((t1 - t0) * prof.fps)))
        if n_frames > 1:
            return (t1 - t0) / (n_frames - 1)
        # single frame: no inter-frame step exists; use the whole range
        # (or one nominal frame at fps for a still node)
        return (t1 - t0) if t1 > t0 else 1.0 / prof.fps

    def _temporal_times(self, t: float):
        """Genome evaluation times + flam3 temporal-filter weights for
        one frame's shutter (SURVEY.md §1 item 7).  Returns
        (times, weights (n,), sumfilt)."""
        n = self.profile.temporal_samples
        g = self.genome
        if n <= 1:
            return [t], np.ones(1), 1.0
        deltas, weights, sumfilt = temporal_filter_weights(
            n, g.temporal_filter_type,
            float(g.temporal_filter_width(t)),
            float(g.temporal_filter_exp(t)))
        dt = self.frame_dt()
        return [t + float(d) * dt for d in deltas], weights, sumfilt

    def _accumulate_sample(self, params, hist, seed: int, iters: float,
                           tile_row0=None):
        """Run the chaos game for ~`iters` iterations into hist."""
        prof, cam, key = self.profile, self.cam, self.key
        cdf_rows = xform_cdf_rows(params)
        # Cap the trajectory batch so every point lives >= ~8x fuse
        # iterations; otherwise warmup dominates and retention craters
        # (cuburn equivalent: ntemporal/npoints balancing in render.py).
        batch = prof.batch
        min_life = 8 * max(prof.fuse, 1)
        while batch > 1024 and iters / batch < min_life:
            batch //= 2
        state = init_state(jax.random.PRNGKey(seed), batch)
        ppu = params.ppu * jnp.float32(
            prof.width / self.genome.size[0])
        per_chunk = batch * prof.iters_per_chunk
        n_chunks = max(1, int(np.ceil(iters / per_chunk)))
        # split into capped device calls when configured (state and
        # histogram carry over; one compiled program serves all calls)
        cap = (max(1, prof.dispatch_iter_cap // per_chunk)
               if prof.dispatch_iter_cap else n_chunks)
        plotted = jnp.float32(0.0)
        left = n_chunks
        while left > 0:
            k = min(left, cap)
            state, hist, n = iterate_accumulate(
                key, cam, self.backend, params, cdf_rows, state, hist,
                ppu, jnp.int32(k), prof.iters_per_chunk, prof.fuse,
                packed=self.packed, tile_row0=tile_row0,
                op_bits=self.op_bits)
            plotted = plotted + n
            left -= k
        return hist, plotted, n_chunks * per_chunk

    def _accumulate_temporal(self, ts_times, ts_weights, hist,
                             seed: int, iters_per_sample: float,
                             tile_row0=None):
        from cuburn_tpu.ops.interp import pack_genome
        from cuburn_tpu.ops.iterate import iterate_accumulate_temporal
        prof, cam, key = self.profile, self.cam, self.key
        if not hasattr(self, "_packed_genome"):
            self._packed_genome = pack_genome(self.genome)
        params_T = self._packed_genome.eval_params(
            np.asarray(ts_times, np.float32))
        factor = jnp.float32(prof.width / self.genome.size[0])
        ppu_T = params_T.ppu * factor

        total = iters_per_sample * len(ts_times)
        batch = prof.batch
        min_life = 8 * max(prof.fuse, 1)
        while batch > 1024 and total / batch < min_life:
            batch //= 2
        state = init_state(jax.random.PRNGKey(seed), batch)
        per_chunk = batch * prof.iters_per_chunk
        n_chunks = max(1, int(np.ceil(iters_per_sample / per_chunk)))
        T = len(ts_times)
        weights = jnp.asarray(ts_weights, jnp.float32)
        per_sample = n_chunks * per_chunk
        cap = prof.dispatch_iter_cap

        if not cap or per_sample * T <= cap:
            state, hist, plotted = iterate_accumulate_temporal(
                key, cam, self.backend, params_T, state, hist, ppu_T,
                jnp.int32(n_chunks), prof.iters_per_chunk, prof.fuse,
                packed=self.packed, weights_T=weights,
                tile_row0=tile_row0, op_bits=self.op_bits)
            return hist, plotted, per_sample * T

        # dispatch_iter_cap binds (it bounds single executions for
        # motion blur too).  The in-program loop is
        # sample-major with state threaded through, so splitting it
        # host-side — by whole-sample groups, or per-chunk within a
        # sample when even one sample exceeds the cap — reproduces
        # the EXACT uncapped execution order: results are
        # bit-identical (tests/test_render.py TestDispatchCap).
        plotted = jnp.float32(0.0)
        if per_sample <= cap:
            g = max(1, int(cap // per_sample))   # samples per call
            for s0 in range(0, T, g):
                sl = slice(s0, min(s0 + g, T))
                p_sl = jax.tree_util.tree_map(lambda a: a[sl],
                                              params_T)
                state, hist, n = iterate_accumulate_temporal(
                    key, cam, self.backend, p_sl, state, hist,
                    ppu_T[sl], jnp.int32(n_chunks),
                    prof.iters_per_chunk, prof.fuse,
                    packed=self.packed, weights_T=weights[sl],
                    tile_row0=tile_row0, op_bits=self.op_bits)
                plotted = plotted + n
            return hist, plotted, per_sample * T

        # a single sample exceeds the cap: chunk-split each sample
        # through the single-sample program with its temporal weight
        from cuburn_tpu.ops.iterate import xform_cdf_rows as _cdf
        cap_chunks = max(1, int(cap // per_chunk))
        for k in range(T):
            params_k = jax.tree_util.tree_map(lambda a: a[k],
                                              params_T)
            cdf_k = _cdf(params_k)
            left = n_chunks
            while left > 0:
                c = min(left, cap_chunks)
                state, hist, n = iterate_accumulate(
                    key, cam, self.backend, params_k, cdf_k, state,
                    hist, ppu_T[k], jnp.int32(c),
                    prof.iters_per_chunk, prof.fuse,
                    packed=self.packed, weight=weights[k],
                    tile_row0=tile_row0, op_bits=self.op_bits)
                plotted = plotted + n
                left -= c
        return hist, plotted, per_sample * T

    # -- animation -------------------------------------------------------

    def frame_times(self):
        """(frame_index, genome_time) pairs frames() steps through
        (profile fps/skip over the genome's time range).  The index is
        the UNSKIPPED frame number so a skip>1 preview renders the
        exact frames (same per-frame seed) of the full render."""
        prof = self.profile
        t0, t1 = self.genome.time_range
        if prof.duration is not None:
            # max(1, ...): a sub-frame duration still renders one
            # frame (matching frame_dt), never a silent empty video
            n_frames = max(1, int(round(prof.duration * prof.fps)))
        else:
            n_frames = max(1, int(round((t1 - t0) * prof.fps)))
        return [(i, t0 + (t1 - t0) * (i / max(n_frames - 1, 1))
                 if n_frames > 1 else t0)
                for i in range(0, n_frames, prof.skip)]

    def frames(self, seed: int = 0) -> Iterator[Tuple[np.ndarray,
                                                      FrameStats]]:
        """Yield frames across the genome's time range at profile fps.

        cuburn's RenderManager analog: one compile serves every frame
        (SURVEY.md §3.2)."""
        return self.frames_partitioned(seed=seed)

    def frames_overlapped(self, seed: int = 0
                          ) -> Iterator[Tuple[np.ndarray, FrameStats]]:
        """frames() in throughput mode: cross-frame pipeline overlap.

        The JAX counterpart of cuburn's 2-stream scheduling
        (iter of frame N overlapping filter + D2H copy of frame N-1,
        cuburn/render.py, SURVEY.md §2b pipeline row / §3.1 async
        D2H):  frame N's ENTIRE device pipeline (accumulate + filter)
        is dispatched before frame N-1 is read back, so the device
        never idles on the host's readback + encode, and the host's
        encode of N-1 runs while the device computes N.  JAX's async
        dispatch provides the streams; the only sync point is the
        np.asarray at yield, by which time the next frame's work is
        queued.

        Frame images match frames() (the same programs run in the
        same order; only host synchronization moves): bit-identical
        on the CPU, within one u8 step on the GPU, whose atomic
        scatter-add sums RGB in a different order on every run.
        FrameStats differences in this mode: iterate_s holds the
        frame-to-frame PIPELINE wall time (dispatch-to-dispatch, i.e.
        what an encoder actually waits), and filter_s only the final
        readback."""
        pending = None
        t_prev = time.perf_counter()
        for i, t in self.frame_times():
            hist, n_plot, n_iter = self.accumulate_async(t, seed + i)
            img_dev = self.finalize_frame_device(hist, t)
            now = time.perf_counter()
            if pending is not None:
                yield self._resolve_pending(pending, now - t_prev)
            t_prev = now
            pending = (img_dev, n_plot, n_iter)
        if pending is not None:
            yield self._resolve_pending(
                pending, time.perf_counter() - t_prev)

    @staticmethod
    def _resolve_pending(pending, wall_s: float):
        img_dev, n_plot, n_iter = pending
        stats = FrameStats()
        t1 = time.perf_counter()
        img = _with_alpha(np.asarray(img_dev))
        stats.filter_s = time.perf_counter() - t1
        stats.plotted_samples = int(n_plot)
        stats.total_iters = int(n_iter)
        stats.iterate_s = wall_s
        return img, stats

    def frames_partitioned(self, seed: int = 0, n_stripes: int = 0,
                           n_bands: int = 0, overlap: bool = False
                           ) -> Iterator[Tuple[np.ndarray, FrameStats]]:
        """frames() through the exact frame-partitioning paths: striped
        accumulation and/or banded filtering per frame — animations of
        frames whose whole-frame programs exceed device limits (the
        CLI's --animate --stripes/--bands).  With neither partition it
        IS frames(); `overlap` then switches to the cross-frame
        pipelined driver (frames_overlapped; identical images).
        Partitioned paths sync per sub-program by design, so overlap
        does not apply to them."""
        if overlap and not (n_stripes and n_stripes > 1) \
                and not (n_bands and n_bands > 1):
            yield from self.frames_overlapped(seed=seed)
            return
        for i, t in self.frame_times():
            if n_stripes and n_stripes > 1:
                hist, stats = self.accumulate_striped(
                    t, seed + i, n_stripes=n_stripes)
            elif n_bands and n_bands > 1:
                hist, stats = self.accumulate(t, seed + i)
            else:
                yield self.render_frame(t, seed=seed + i)
                continue
            if n_bands and n_bands > 1:
                img = self.finalize_frame_banded(hist, t, stats,
                                                 n_bands=n_bands)
            else:
                img = self.finalize_frame(hist, t, stats)
            yield img, stats
