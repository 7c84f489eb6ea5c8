"""The chaos-game iteration kernel: the hot loop of the renderer.

JAX equivalent of the reference's generated iter kernel
(cuburn/code/iter.py, SURVEY.md §3.5): where cuburn runs one point per
CUDA thread with divergent branches, this advances a batch of B
trajectories in SIMD lockstep under `lax.scan`:

  per iteration, for every point:
    u      = rng.uniform()
    xf     = branch-free CDF selection (xaos-conditioned on the
             previous xform when present)
    (x,y)  = post( sum_v w_v * V_v( affine * (x,y) ) )   [ops/xform.py]
    c      = c*(1-speed) + xf.color*speed
    badvalue (non-finite / |x|>1e10) -> respawn in bi-unit square,
             restart fuse (flam3 rule)
    if age >= fuse: plot final-xform copy through the camera,
             palette-lookup rgba * opacity -> (addr, rgba) record

cuburn's intra-warp point shuffle is unnecessary here — there is no
warp divergence on SIMD; per-lane independent RNG streams provide the
decorrelation instead (SURVEY.md §2b parallelism table).

Two drivers over the step body:
  * iterate_accumulate — flushes records into the histogram inside the
    scan body (no HBM round-trip of point records; the rendering path).
  * iterate_chunk     — collects (addr, rgba) chunks for tests and for
    accumulators that want bigger flushes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cuburn_tpu.genome.specs import GenomeParams, StructureKey
from cuburn_tpu.ops import histogram as hist_mod
from cuburn_tpu.ops import rng as rng_mod
from cuburn_tpu.ops.camera import CameraSpec, project
from cuburn_tpu.ops.xform import (apply_final_xform, apply_xforms,
                                  build_xform_table, select_and_fetch)

BADVALUE_LIMIT = np.float32(1e10)


@dataclass
class IterState:
    """Per-trajectory mutable state (all (B,) except rng (B, 4));
    batch leads every leaf so shard_map can shard the whole pytree with
    one PartitionSpec prefix (parallel/shard.py)."""
    x: jnp.ndarray
    y: jnp.ndarray
    color: jnp.ndarray
    last_xf: jnp.ndarray   # int32
    age: jnp.ndarray       # int32, iterations since (re)spawn
    rng: jnp.ndarray       # (B, 4) uint32


jax.tree_util.register_dataclass(
    IterState, data_fields=["x", "y", "color", "last_xf", "age", "rng"],
    meta_fields=[])


def init_state(key: jax.Array, batch: int) -> IterState:
    """Fresh trajectories: uniform in the bi-unit square, random color,
    age 0 (must run `fuse` warmup iterations before plotting)."""
    kp, kc, kr = jax.random.split(key, 3)
    xy = jax.random.uniform(kp, (2, batch), jnp.float32, -1.0, 1.0)
    color = jax.random.uniform(kc, (batch,), jnp.float32)
    return IterState(
        x=xy[0], y=xy[1], color=color,
        last_xf=jnp.zeros((batch,), jnp.int32),
        age=jnp.zeros((batch,), jnp.int32),
        rng=rng_mod.seed(kr, batch))


def xform_cdf_rows(params: GenomeParams) -> jnp.ndarray:
    """(N, N) row-normalized CDFs: row i is the selection CDF over next
    xforms given previous xform i (weights row-conditioned by xaos,
    SURVEY.md §1 item 2).  Clamped at zero: smooth sequence
    interpolation can overshoot fading weights slightly negative."""
    probs = jnp.maximum(params.weights[None, :], 0.0) \
        * jnp.maximum(params.xaos, 0.0)
    # a row summing to zero (an all-forbidding xaos row, or smooth
    # interpolation driving every weight to 0) would produce an
    # all-zero CDF whose one-hot fetch selects NOTHING while the
    # recorded index says n-1; fall back to uniform selection instead
    row_sum = probs.sum(axis=1, keepdims=True)
    probs = jnp.where(row_sum > 0, probs, 1.0)
    cdf = jnp.cumsum(probs, axis=1)
    total = jnp.maximum(cdf[:, -1:], np.float32(1e-20))
    return cdf / total


def _palette_rgb(palette, color):
    """Linear-interp palette lookup; palette (256, 3), color in [0,1].
    Equivalent of cuburn's palette texture fetch."""
    f = jnp.clip(color, 0.0, 1.0) * np.float32(255.0)
    i0 = jnp.floor(f).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, 255)
    frac = (f - i0.astype(jnp.float32))[..., None]
    return (jnp.take(palette, i0, axis=0) * (1.0 - frac) +
            jnp.take(palette, i1, axis=0) * frac)


def color_bits_for(n_bins: int) -> int:
    """Palette-coordinate bits available when packing (addr, color)
    into one uint32 log record; 0 if packing is impossible."""
    addr_bits = int(np.ceil(np.log2(n_bins + 2)))
    bits = min(10, 32 - addr_bits)
    return bits if bits >= 8 else 0


def quantize_color(color_bits: int, pcolor):
    """Palette coordinate in [0, 1] -> u32 quantized to 2^color_bits
    levels (>= the 256 native flam3 entries, so no fidelity loss
    beyond the reference's own storage)."""
    levels = np.float32((1 << color_bits) - 1)
    q = jnp.clip(pcolor, 0.0, 1.0) * levels + 0.5
    # via int32: the quantized value fits 31 bits, so the hop is exact
    return q.astype(jnp.int32).astype(jnp.uint32)


def pack_records(color_bits: int, addr, pcolor):
    """(addr, color) -> one uint32 per plotted sample: cuburn's packed
    writeback-log entry."""
    return (addr.astype(jnp.uint32) << np.uint32(color_bits)) \
        | quantize_color(color_bits, pcolor)


def unpack_records(color_bits: int, palette_hi, packed):
    """Packed records -> (addr (int32), rgba (..., 4)).

    palette_hi is the palette pre-resampled to 2^color_bits entries
    (exact linear interpolation baked in).  A 4-column palette carries
    its own density/alpha weight per row (the opacity-extended palette
    of opacity_bits_for); a 3-column one gets density 1 appended."""
    addr = (packed >> np.uint32(color_bits)).astype(jnp.int32)
    q = (packed & np.uint32((1 << color_bits) - 1)).astype(jnp.int32)
    rgb = jnp.take(palette_hi, q, axis=0)
    if palette_hi.shape[-1] == 4:
        return addr, rgb
    ones = jnp.ones(rgb.shape[:-1] + (1,), rgb.dtype)
    return addr, jnp.concatenate([rgb, ones], axis=-1)


def expand_palette(palette, color_bits: int):
    """Resample the (256, 3) palette to 2^color_bits entries with the
    same linear interpolation _palette_rgb applies."""
    n = 1 << color_bits
    coords = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
    return _palette_rgb(palette, coords)


def opacity_bits_for(n_bins: int, n_xforms: int):
    """(op_bits, color_bits) for the opacity-extended packed record
    `addr << (ob+cb) | xform_id << cb | color` used when per-xform
    opacities are not all 1 (the reference restricted its packed log
    to unit opacity; folding the xform id into the palette coordinate
    keeps the fast deferred-write path for translucent xforms).
    Returns (0, 0) when the record doesn't fit 32 bits."""
    addr_bits = int(np.ceil(np.log2(n_bins + 2)))
    ob = max(1, int(np.ceil(np.log2(max(n_xforms, 2)))))
    cb = min(8, 32 - addr_bits - ob)
    return (ob, cb) if cb >= 8 else (0, 0)


def extend_palette_opacity(palette_hi, opacity, op_bits: int):
    """(2^cb, 3) palette + (N,) opacities -> (2^(ob+cb), 4) extended
    palette: row (xf << cb | q) = [rgb*op_xf, op_xf]; rows for xform
    ids >= N are zero."""
    k = palette_hi.shape[0]
    pal4 = jnp.concatenate(
        [palette_hi, jnp.ones((k, 1), palette_hi.dtype)], axis=1)
    n_slots = 1 << op_bits
    op = jnp.zeros((n_slots,), jnp.float32).at[
        :opacity.shape[0]].set(jnp.clip(opacity, 0.0, 1.0))
    return (op[:, None, None] * pal4[None]).reshape(n_slots * k, 4)


def respawn_xy(bits: jnp.ndarray):
    """Badvalue respawn position, uniform in the bi-unit square
    (flam3's rule, SURVEY.md §3.5): two INDEPENDENT murmur-style hashes
    of the selection draw's word, so (rx, ry) pairs fill the square
    instead of lying on a 1-D curve (round-1 derived ry from rx).  A
    remix is used rather than two fresh RNG draws because the draws
    would be spent every iteration on the SIMD common path; the hashed
    pair passes 2-D chi-square uniformity (tests/test_ops.py)."""
    h1 = bits * jnp.uint32(0x9E3779B9)
    h1 = h1 ^ (h1 >> jnp.uint32(15))
    h2 = (bits ^ jnp.uint32(0x5BD1E995)) * jnp.uint32(0xC2B2AE35)
    h2 = h2 ^ (h2 >> jnp.uint32(13))
    inv24 = np.float32(1.0 / (1 << 24))
    # via int32: the values fit 24 bits, so the hop is exact
    rx = (h1 >> jnp.uint32(8)).astype(jnp.int32)\
        .astype(jnp.float32) * inv24 * 2.0 - 1.0
    ry = (h2 >> jnp.uint32(8)).astype(jnp.int32)\
        .astype(jnp.float32) * inv24 * 2.0 - 1.0
    return rx, ry


def iterate_step(
    key: StructureKey,
    cam: CameraSpec,
    fuse: int,
    params: GenomeParams,
    cdf_rows: jnp.ndarray,
    ppu: jnp.ndarray,
    state: IterState,
    tile_row0=None,
):
    """One chaos-game iteration for every trajectory (SURVEY.md §3.5).

    Returns (new_state, addr (B,) int32, pcolor (B,), opacity (B,));
    non-plottable records carry the junk-bin address.  Palette lookup
    happens at flush time (ops/iterate.py records_to_rgba), not here —
    mirroring cuburn's packed log records, which store a palette
    coordinate rather than resolved colors (SURVEY.md §1 deferred
    writeback)."""
    stream = rng_mod.RngStream(state.rng)
    bits = stream.bits()
    u = (bits >> jnp.uint32(8)).astype(jnp.int32)\
        .astype(jnp.float32) * np.float32(1.0 / (1 << 24))
    table = build_xform_table(key, params)   # loop-invariant, hoisted
    idx, prow = select_and_fetch(key, cdf_rows, table, state.last_xf, u)

    nx, ny, ncolor, opacity = apply_xforms(
        key, params, prow, state.x, state.y, state.color, stream)

    bad = ~(jnp.isfinite(nx) & jnp.isfinite(ny)) \
        | (jnp.abs(nx) > BADVALUE_LIMIT) \
        | (jnp.abs(ny) > BADVALUE_LIMIT)
    rx, ry = respawn_xy(bits)
    nx = jnp.where(bad, rx, nx)
    ny = jnp.where(bad, ry, ny)
    ncolor = jnp.where(bad, u, ncolor)
    age = jnp.where(bad, 0, state.age + 1)

    # plot (display-only final xform on a copy)
    px, py, pcolor = apply_final_xform(
        key, params, nx, ny, ncolor, stream)
    if key.cam_mode:
        # Apophysis-7X 3-D camera (statically elided when every cam_*
        # spline is zero); mode 2 spends two draws on the DOF blur
        from cuburn_tpu.ops.camera import project_3d
        if key.cam_mode >= 2:
            px, py = project_3d(params.cam3d, px, py,
                                stream.uniform(), stream.uniform())
        else:
            px, py = project_3d(params.cam3d, px, py)
    addr, in_bounds = project(
        cam, params.center, ppu, params.rotate, px, py,
        tile_row0=tile_row0, rot_center=params.rot_center)
    visible = (age >= fuse) & in_bounds & (opacity > 0.0)
    addr = jnp.where(visible, addr, cam.junk_bin)

    new_state = IterState(
        x=nx, y=ny, color=ncolor, last_xf=idx, age=age,
        rng=stream.state)
    return new_state, addr, pcolor, opacity


@partial(jax.jit, static_argnames=("key", "cam", "n_iters", "fuse"))
def iterate_chunk(
    key: StructureKey,
    cam: CameraSpec,
    params: GenomeParams,
    cdf_rows: jnp.ndarray,
    state: IterState,
    ppu: jnp.ndarray,
    n_iters: int,
    fuse: int,
    tile_row0=None,
):
    """Advance every trajectory n_iters steps, collecting plot records.

    Returns (new_state, addr (n_iters, B) int32, rgba (n_iters, B, 4)).
    NOTE: materializes n_iters x B full records in HBM; prefer
    iterate_accumulate (packed records) for rendering."""

    def body(state, _):
        state, addr, pcolor, opacity = iterate_step(
            key, cam, fuse, params, cdf_rows, ppu, state,
            tile_row0=tile_row0)
        opacity = jnp.clip(opacity, 0.0, 1.0)
        rgb = _palette_rgb(params.palette, pcolor)
        rgba = jnp.concatenate(
            [rgb * opacity[:, None], opacity[:, None]], axis=1)
        return state, (addr, rgba)

    new_state, (addrs, rgbas) = jax.lax.scan(
        body, state, None, length=n_iters)
    return new_state, addrs, rgbas


@partial(jax.jit,
         static_argnames=("key", "cam", "iters_per_flush", "fuse",
                          "backend", "packed", "op_bits"))
def iterate_accumulate(
    key: StructureKey,
    cam: CameraSpec,
    backend: str,
    params: GenomeParams,
    cdf_rows: jnp.ndarray,
    state: IterState,
    hist: jnp.ndarray,
    ppu: jnp.ndarray,
    n_chunks,
    iters_per_flush: int,
    fuse: int,
    packed: bool = True,
    weight=None,
    tile_row0=None,
    op_bits: int = 0,
):
    """Advance n_chunks * iters_per_flush steps, flushing the histogram
    once per chunk — the rendering path.

    `op_bits` (static, from opacity_bits_for) enables the
    opacity-extended packed record for genomes whose per-xform
    opacities are not all 1: the selected xform's id is folded into
    the palette coordinate and the flush resolves rgb*opacity and
    density=opacity from an extended palette — translucent xforms
    keep the fast deferred-write path.

    `weight` (traced scalar, default 1) scales every record's
    contribution — the flam3 temporal-filter weight of this genome
    evaluation within the shutter interval (flam3 rect.c temporal
    filter application; SURVEY.md §1 item 7).  Sample *counts* stay
    unweighted (they are observability, not mass).

    Mirrors the reference's deferred-writeback amortization
    (cuburn/code/iter.py log buffer, SURVEY.md §1): the histogram is
    touched once per iters_per_flush * B samples instead of per
    iteration (per-step flushes measured ~3x slower: scan-carry traffic
    on the multi-MB histogram dominates), and with `packed=True` each
    log record is ONE uint32 (address + quantized palette coordinate)
    — cuburn's packed writeback entry — cutting log-buffer HBM traffic
    5x vs (addr, rgba) records.  Genomes with non-unit per-xform
    opacity pack via `op_bits` (see below); `packed=False` falls back
    to full (addr, rgba) records.

    `n_chunks` is a *traced* value (fori_loop, not scan), so one
    compiled program serves every quality setting.

    Returns (new_state, hist, plotted_count)."""
    if packed and op_bits:
        # layout_bins, not n_bins: a stripe camera must pack color at
        # the FULL frame's depth or striped != whole-frame
        _ob, cbits = opacity_bits_for(cam.layout_bins, key.n_xforms)
        tot_bits = op_bits + cbits
    else:
        cbits = color_bits_for(cam.layout_bins) if packed else 0
        tot_bits = cbits
    accumulate = hist_mod.get_backend(backend)
    w = jnp.float32(1.0) if weight is None else \
        jnp.asarray(weight, jnp.float32)

    if cbits:
        palette_hi = expand_palette(params.palette, cbits)
        if op_bits:
            palette_hi = extend_palette_opacity(
                palette_hi, params.opacity, op_bits)

        def chunk_body(_, carry):
            state, hist, n = carry

            def body(state, __):
                state, addr, pcolor, opacity = iterate_step(
                    key, cam, fuse, params, cdf_rows, ppu, state,
                    tile_row0=tile_row0)
                if op_bits:
                    # opacity-extended layout: the selected xform id
                    # splices between the address and the color
                    rec = (addr.astype(jnp.uint32)
                           << np.uint32(tot_bits)) \
                        | (state.last_xf.astype(jnp.uint32)
                           << np.uint32(cbits)) \
                        | quantize_color(cbits, pcolor)
                else:
                    rec = pack_records(cbits, addr, pcolor)
                return state, rec

            state, packed_recs = jax.lax.scan(
                body, state, None, length=iters_per_flush)
            addrs, rgbas = unpack_records(tot_bits, palette_hi,
                                          packed_recs)
            hist = accumulate(hist, addrs, rgbas * w)
            # f32 counter: an int32 carry wraps past 2^31 plotted
            # samples (one 4K-class call exceeds it); per-chunk sums
            # stay int32-exact, the running total is stats
            n = n + jnp.sum(addrs != cam.junk_bin).astype(jnp.float32)
            return state, hist, n
    else:
        def chunk_body(_, carry):
            state, hist, n = carry
            state, addrs, rgbas = iterate_chunk(
                key, cam, params, cdf_rows, state, ppu,
                iters_per_flush, fuse, tile_row0=tile_row0)
            hist = accumulate(hist, addrs, rgbas * w)
            n = n + jnp.sum(
                addrs != cam.junk_bin).astype(jnp.float32)
            return state, hist, n

    return jax.lax.fori_loop(
        0, n_chunks, chunk_body, (state, hist, jnp.float32(0.0)))


@partial(jax.jit,
         static_argnames=("key", "cam", "iters_per_flush", "fuse",
                          "backend", "packed", "op_bits"))
def iterate_accumulate_temporal(
    key: StructureKey,
    cam: CameraSpec,
    backend: str,
    params_T: GenomeParams,   # every leaf has leading temporal axis T
    state: IterState,
    hist: jnp.ndarray,
    ppu_T: jnp.ndarray,       # (T,)
    n_chunks_per_sample,
    iters_per_flush: int,
    fuse: int,
    packed: bool = True,
    weights_T=None,           # (T,) temporal-filter weights
    tile_row0=None,
    op_bits: int = 0,
):
    """Accumulate all temporal samples of a motion-blurred frame in ONE
    device program (SURVEY.md §2b temporal-sample parallelism row: fold
    samples into the device-side loop instead of cuburn's sequential
    kernel launches).  Genome parameters per sample come from the
    packed-knot interpolator (ops/interp.py).  Trajectories carry over
    between samples (the attractor moves smoothly within a shutter
    interval; no re-fuse needed).  `weights_T` applies flam3's temporal
    filter: sample i's histogram contribution is scaled by
    weights_T[i] (render.temporal_filter_weights)."""
    if weights_T is None:
        weights_T = jnp.ones_like(ppu_T)

    def sample_body(carry, inputs):
        state, hist, n = carry
        params_t, ppu, w_t = inputs
        cdf_rows = xform_cdf_rows(params_t)
        state, hist, dn = iterate_accumulate(
            key, cam, backend, params_t, cdf_rows, state, hist, ppu,
            n_chunks_per_sample, iters_per_flush, fuse, packed=packed,
            weight=w_t, tile_row0=tile_row0, op_bits=op_bits)
        return (state, hist, n + dn), None

    (state, hist, n), _ = jax.lax.scan(
        sample_body, (state, hist, jnp.float32(0.0)),
        (params_T, ppu_T, weights_T))
    return state, hist, n
