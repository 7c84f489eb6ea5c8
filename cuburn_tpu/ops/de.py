"""Adaptive density-estimation filtering as dense convolutions.

Equivalent of the reference's DE kernel (cuburn/code/filtering.py
density_est, SURVEY.md §2b item 6): flam3's adaptive blur where each
accumulator cell splats its (log-scaled) energy with a Gaussian whose
radius *shrinks* with the cell's own density:

    r(d) = clamp(max_radius / d^curve, min_radius, max_radius)

A direct port would be a data-dependent scatter (cuburn's scatter-style
kernel); here we instead use the **banded decomposition**, which is
exactly equivalent in structure and maps onto dense convs:

    quantize r into K geometric levels r_k
    out = sum_k  separable_gaussian_blur(img * [band(px) == k], r_k)

Each source pixel contributes through its own radius band, preserving
flam3's scatter semantics (per-SOURCE radius, not per-dest), while all
the work is K separable convolutions — dense, fusable, vector-friendly
(SURVEY.md §7 "hard parts" item 2 names this fallback; here it is the
primary implementation).

The band *ladder* (radii and per-band kernel tap counts) is built from
a STATIC max radius — the Renderer samples the genome's
estimator_radius once — so each band's kernel length is exactly what
its radius needs (the sharp bands cost almost nothing) and nothing
retraces when the traced estimator parameters animate; those still
drive the per-pixel band assignment.

Radius is measured in accumulator (supersampled) pixels; callers
pre-scale genome estimator_radius by ss.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

N_BANDS = 8
MAX_RADIUS_CAP = 24          # absolute clamp on DE radius, px
MIN_BAND_RADIUS = 0.5        # radii below this are effectively identity

# ---- pyramid (scale-space) execution of the wide bands (round 5) ----
# A band of radius r costs H*W*(2*ceil(1.5 r)+1)*2 conv MACs at full
# resolution, so the widest rungs dominate DE compute at binding sizes.
# Blurring a WIDE Gaussian at 1/f resolution is the classic pyramid
# identity: box-downsample by f (variance (f^2-1)/12), blur with a
# coarse Gaussian, reconstruct with repeat + triangle (linear interp
# between block centers; variance ~(f^2-1)/12 + f^2/6) — the coarse
# sigma is chosen so the COMPOSED kernel's variance equals the target
# Gaussian's:  (f*sigma_c)^2 + f^2/3 ~= sigma^2.  Validated against
# the direct per-source splat by the banded-vs-direct rel-L2 harness
# (tests/test_filters.py) and the DE mass/monotonicity invariants.
# CUBURN_PYRAMID_DE=0 restores full-resolution bands.
import os as _os

PYRAMID_DE = _os.environ.get("CUBURN_PYRAMID_DE", "1") != "0"
PYRAMID_MIN_HALF = 8          # bands narrower than this stay direct
PYRAMID_COARSE_HALF = 4       # target coarse-scale half-width
# the pyramid is a ~2% rel-L2 approximation (validated, bounded), so
# it engages only where the wide bands' conv cost actually binds:
# accumulators >= this many lanes WIDE (1080p-ss2-class frames and
# up).  The gate is on WIDTH, not pixels: banded filtering slices the
# frame into row bands that keep the full width, so a width gate
# keeps the banded and whole-frame paths on the SAME code path (their
# equality contract).  Below it the banded DE keeps its
# exact-on-rung contract (tests/test_filters.py).
PYRAMID_MIN_WIDTH = int(_os.environ.get(
    "CUBURN_PYRAMID_MIN_WIDTH", "2048"))


def _sep_blur_band(img, radius: float, half: int):
    """One band's separable Gaussian, octave-downsampled when wide
    AND the frame is binding-size (see PYRAMID_MIN_WIDTH)."""
    if (not PYRAMID_DE or half < PYRAMID_MIN_HALF
            or img.shape[1] < PYRAMID_MIN_WIDTH):
        return _sep_blur(img, _gaussian_taps(radius, half), half)
    o = int(np.floor(np.log2(half / PYRAMID_COARSE_HALF)))
    f = 1 << max(o, 0)
    if f <= 1:
        return _sep_blur(img, _gaussian_taps(radius, half), half)
    sigma = max(radius * 0.5, 1e-3)
    # composed down/up variance correction (see module comment); the
    # 0.25 floor keeps the coarse kernel a real blur if the caller
    # ever shrinks the ladder under PYRAMID_MIN_HALF's radius
    sigma_c = float(np.sqrt(max(sigma * sigma - f * f / 3.0, 0.25))) / f
    r_c = 2.0 * sigma_c
    half_c = max(int(np.ceil(1.5 * r_c)), 1)
    H, W, C = img.shape
    Hp, Wp = -(-H // f) * f, -(-W // f) * f
    x = jnp.pad(img, ((0, Hp - H), (0, Wp - W), (0, 0)))
    # box down (mean keeps per-cell scale; mass/f^2)
    x = x.reshape(Hp // f, f, Wp // f, f, C).mean(axis=(1, 3))
    x = _sep_blur(x, _gaussian_taps(r_c, half_c), half_c)
    # repeat + normalized triangle = linear interpolation between
    # block centers (mass * f^2 — net mass preserved); zero-pad edges,
    # the same convention as the direct conv path
    x = jnp.repeat(jnp.repeat(x, f, axis=0), f, axis=1)
    tri = np.maximum(
        1.0 - np.abs(np.arange(-(f - 1), f, dtype=np.float32)) / f, 0.0)
    x = _sep_blur(x, jnp.asarray(tri / f), f - 1)
    return x[:H, :W]


@functools.lru_cache(maxsize=None)
def band_ladder(static_max_radius: float):
    """Static geometric radius ladder + per-band tap counts.

    Returns (radii tuple, taps tuple); band 0 is the widest."""
    max_r = float(np.clip(static_max_radius, MIN_BAND_RADIUS,
                          MAX_RADIUS_CAP))
    g = (MIN_BAND_RADIUS / max_r) ** (1.0 / (N_BANDS - 1))
    radii = tuple(max_r * g ** k for k in range(N_BANDS))
    # Gaussian sigma = r/2, support to 3 sigma = 1.5 r
    taps = tuple(int(np.ceil(1.5 * r)) for r in radii)
    return radii, taps


def _gaussian_taps(radius: float, half: int):
    x = np.arange(-half, half + 1, dtype=np.float32)
    sigma = max(radius * 0.5, 1e-3)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray(k / k.sum())


def _sep_blur(img, taps, half: int):
    """Separable blur of (H, W, C) with static 1-D taps on both axes."""
    if half == 0:
        return img
    H, W, C = img.shape
    x = img.transpose(2, 0, 1)[None]          # (1, C, H, W)
    n = 2 * half + 1
    kh = jnp.broadcast_to(taps[None, None, :, None], (C, 1, n, 1))
    kw = jnp.broadcast_to(taps[None, None, None, :], (C, 1, 1, n))
    dn = jax.lax.conv_dimension_numbers(
        x.shape, kh.shape, ("NCHW", "OIHW", "NCHW"))
    x = jax.lax.conv_general_dilated(
        x, kh, (1, 1), [(half, half), (0, 0)], dimension_numbers=dn,
        feature_group_count=C)
    x = jax.lax.conv_general_dilated(
        x, kw, (1, 1), [(0, 0), (half, half)], dimension_numbers=dn,
        feature_group_count=C)
    return x[0].transpose(1, 2, 0)


def radius_for_density(density, max_radius, min_radius, curve):
    """flam3's estimator formula, vectorized (density in raw counts)."""
    d = jnp.maximum(density, 1.0)
    r = max_radius / jnp.power(d, curve)
    return jnp.clip(r, min_radius, jnp.maximum(max_radius, min_radius))


def density_filter_direct(img, density, max_radius, min_radius, curve):
    """GROUND TRUTH: direct per-source-radius Gaussian splat.

    The literal flam3 scatter semantics (cuburn/code/filtering.py
    density_est, SURVEY.md §2b item 8): every accumulator cell splats
    its energy through a separable Gaussian of ITS OWN radius
    r(d) = clamp(max_radius / d^curve, min, max), using the same
    sigma = r/2, support 1.5r convention as the banded path.  O(H·W·r²)
    host loops — for tiny images in differential tests
    (tests/test_filters.py::test_de_matches_direct) and debugging only.

    Measured banded-vs-direct error at N_BANDS=8 (random images,
    32x32): relative L2 ~0.020 with two-rung interpolation (was
    ~0.05-0.12 under hard nearest-rung assignment); when every source
    radius hits a ladder rung exactly the two agree to f32 precision.
    Both clip kernels at image edges identically.
    """
    img = np.asarray(img, np.float64)
    density = np.asarray(density, np.float64)
    H, W, C = img.shape
    r_px = np.asarray(radius_for_density(
        jnp.asarray(density),
        jnp.clip(jnp.float32(max_radius), 0.0, MAX_RADIUS_CAP),
        jnp.float32(min_radius), jnp.float32(curve)))
    out = np.zeros_like(img)
    for y in range(H):
        for x in range(W):
            if not img[y, x].any():
                continue
            r = max(float(r_px[y, x]), MIN_BAND_RADIUS)
            half = int(np.ceil(1.5 * r))
            if half == 0:
                out[y, x] += img[y, x]
                continue
            t = np.asarray(_gaussian_taps(r, half), np.float64)
            y0, y1 = max(y - half, 0), min(y + half + 1, H)
            x0, x1 = max(x - half, 0), min(x + half + 1, W)
            ky = t[y0 - (y - half):y1 - (y - half)]
            kx = t[x0 - (x - half):x1 - (x - half)]
            out[y0:y1, x0:x1] += np.einsum(
                "i,j,c->ijc", ky, kx, img[y, x])
    return out


def density_filter(img, density, max_radius, min_radius, curve,
                   static_max_radius: float = None,
                   skip_empty: bool = False):
    """Banded adaptive DE blur with two-rung interpolation.

    img     (H, W, 4) log-scaled premultiplied rgba
    density (H, W)    raw accumulator counts (pre-logscale)
    max_radius/min_radius/curve: traced flam3 estimator params (drive
        the per-pixel rung weights)
    static_max_radius: compile-time radius that fixes the band ladder;
        defaults to MAX_RADIUS_CAP-clamped 9 (flam3 default) when the
        caller doesn't supply one.
    skip_empty: wrap each band's convs in a lax.cond on band occupancy
        — bands that hold zero mass skip both convolutions entirely
        (pays off at binding sizes where the wide bands are often
        empty; costs one cheap reduction per band).

    Two-rung interpolation: flam3 blurs every pixel with its EXACT
    radius; quantizing to the nearest ladder rung misplaced ~8% of the
    energy (rel L2 vs the direct splat).  Splatting each pixel into its
    TWO adjacent rungs with linear hat weights in log-radius (the
    ladder is geometric, so rung position is linear in log r) makes
    the radius error second-order in the rung spacing — measured rel
    L2 vs direct drops to ~0.02-0.03 — at the SAME conv count: the
    per-band input just carries fractional weights instead of a 0/1
    mask.  [cuburn/code/filtering.py density_est per-source radius,
    SURVEY.md §2b item 8]"""
    if static_max_radius is None:
        static_max_radius = 9.0
    radii, taps = band_ladder(static_max_radius)

    r_px = radius_for_density(
        density, jnp.clip(max_radius, 0.0, MAX_RADIUS_CAP),
        min_radius, curve)
    logr = jnp.log(jnp.maximum(r_px, MIN_BAND_RADIUS))
    log_g = float(np.log(radii[1] / radii[0])) if N_BANDS > 1 else 0.0
    if log_g == 0.0:
        # degenerate ladder (max radius at the MIN_BAND_RADIUS clamp):
        # all rungs equal, everything through band 0
        u = jnp.zeros_like(logr)
    else:
        # rung coordinate: radii[k] = radii[0] * g^k, so a radius r
        # sits at u = (log r - log radii[0]) / log g, linear in log r
        u = jnp.clip((logr - np.float32(np.log(radii[0])))
                     / np.float32(log_g), 0.0, N_BANDS - 1.0)

    out = jnp.zeros_like(img)
    # taps[k] >= 1 always (radii are clamped to MIN_BAND_RADIUS=0.5,
    # ceil(1.5*0.5)=1), so every band is a real (if near-identity) conv
    for k in range(N_BANDS):
        # linear hat: weight 1 at rung k, 0 beyond the neighbors;
        # every pixel's weights over all rungs sum to exactly 1
        w = jnp.maximum(1.0 - jnp.abs(u - k), 0.0)[..., None]
        src = img * w.astype(img.dtype)
        if skip_empty:
            out = out + jax.lax.cond(
                jnp.any(w > 0),
                lambda s=src, k=k: _sep_blur_band(s, radii[k], taps[k]),
                lambda s=src: jnp.zeros_like(s))
        else:
            out = out + _sep_blur_band(src, radii[k], taps[k])
    return out
