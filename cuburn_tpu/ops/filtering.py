"""Tonemap and color pipeline: logscale, colorclip, downsample.

Equivalent of the reference's cuburn/code/filtering.py kernels
(SURVEY.md §2b): these are pure elementwise/reduction ops, so they are
expressed directly in XLA (jit-fused), which compiles them to fused
elementwise kernels (SURVEY.md §2b checklist items 5/7).
The adaptive density-estimation filter lives in ops/de.py.

Functional forms follow flam3 (rect.c), with colors kept in [0,1]
floats instead of flam3's 0..255 integer white levels:

  logscale:  ls(d) = k1 * log(1 + d*k2) / d,
             k1 = brightness * 268/256,  k2 = ss^2 / quality
             (quality = plotted samples per output pixel, so d*k2 is
             density normalized to its uniform-coverage expectation)
  colorclip: per pixel: alpha = gamma(d) with linear segment below
             gamma_threshold; vibrancy blends alpha-driven gamma
             against per-channel gamma; highlight_power controls how
             >1 channels desaturate toward white; optional background
             blend and alpha un-premultiply.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

EPS = np.float32(1e-9)


def logscale(hist, brightness, quality_per_cell):
    """hist (..., 4) raw accumulator -> log-scaled (premultiplied) rgba.

    quality_per_cell = quality / ss^2: expected samples per accumulator
    cell; brightness per genome."""
    d = hist[..., 3:4]
    k1 = brightness * np.float32(268.0 / 256.0)
    k2 = 1.0 / jnp.maximum(quality_per_cell, EPS)
    ls = k1 * jnp.log1p(d * k2) / jnp.maximum(d, EPS)
    return hist * ls


def _calc_alpha(density, inv_gamma, linrange):
    """flam3_calc_alpha: power curve with a linear segment below
    gamma_threshold (flam3 rect.c)."""
    linrange = jnp.maximum(linrange, EPS)
    funcval = jnp.power(linrange, inv_gamma)
    frac = density / linrange
    lin = (1.0 - frac) * density * (funcval / linrange) \
        + frac * jnp.power(jnp.maximum(density, EPS), inv_gamma)
    nonlin = jnp.power(jnp.maximum(density, EPS), inv_gamma)
    alpha = jnp.where(density < linrange, lin, nonlin)
    return jnp.where(density > 0.0, alpha, 0.0)


def _rgb_to_hsv(rgb):
    return jnp.stack(_rgb_to_hsv_tuple(*(rgb[..., i] for i in range(3))),
                     axis=-1)


def _rgb_to_hsv_tuple(r, g, b):
    maxc = jnp.maximum(jnp.maximum(r, g), b)
    minc = jnp.minimum(jnp.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = jnp.where(maxc > 0, delta / jnp.maximum(maxc, EPS), 0.0)
    safe_delta = jnp.maximum(delta, EPS)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = jnp.where(r == maxc, bc - gc,
                  jnp.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = jnp.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(hsv):
    h, s, v = (hsv[..., i] for i in range(3))
    i = jnp.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [p, p, t, v, v, q])
    return jnp.stack([r, g, b], axis=-1)


def colorclip(img, gamma, vibrancy, highlight_power, gamma_threshold,
              background, transparent: bool = False):
    """img (..., 4) log-scaled premultiplied rgba -> (..., 4) in [0,1].

    Follows flam3 rect.c's final accumulation loop (see module
    docstring).  `background` is (3,)."""
    inv_gamma = 1.0 / jnp.maximum(gamma, EPS)
    d = img[..., 3]
    rgb = img[..., :3]

    alpha = _calc_alpha(d, inv_gamma, gamma_threshold)
    alpha = jnp.clip(alpha, 0.0, 1.0)
    ls = vibrancy * alpha / jnp.maximum(d, EPS)

    # highlight handling (flam3_calc_newrgb, with 255 -> 1.0 white level)
    maxa = jnp.max(rgb, axis=-1) * ls
    maxc = jnp.max(rgb, axis=-1)
    newls = 1.0 / jnp.maximum(maxc, EPS)
    hp = highlight_power

    # case 1: highpow >= 0 and maxa > 1: rescale to white then desaturate
    lsratio = jnp.power(jnp.maximum(newls / jnp.maximum(ls, EPS), EPS),
                        jnp.maximum(hp, 0.0))
    rgb_hi = rgb * newls[..., None]
    hsv = _rgb_to_hsv(rgb_hi)
    hsv = hsv.at[..., 1].multiply(lsratio)
    rgb_hi = _hsv_to_rgb(hsv)

    # case 2: highpow < 0 (or maxa <= 1): blend of newls and ls
    adjhlp = jnp.clip(-hp, 0.0, 1.0)
    adjhlp = jnp.where(maxa <= 1.0, 1.0, adjhlp)
    k = (1.0 - adjhlp) * newls + adjhlp * ls
    rgb_lo = rgb * k[..., None]

    use_hi = (hp >= 0.0) & (maxa > 1.0)
    newrgb = jnp.where(use_hi[..., None], rgb_hi, rgb_lo)

    # vibrancy blend: add (1 - vib) * per-channel gamma; no epsilon
    # inside the pow — flam3 takes pow(0, g) = 0, and an epsilon
    # lifts pure-black pixels to a nonzero floor (u8 value 1 at
    # gamma 4) on every vibrancy < 1 render
    newrgb = newrgb + (1.0 - vibrancy) * \
        jnp.power(jnp.maximum(rgb, 0.0), inv_gamma)

    if transparent:
        newrgb = newrgb / jnp.maximum(alpha[..., None], EPS)
        out_a = alpha
    else:
        newrgb = newrgb + (1.0 - alpha[..., None]) * background
        out_a = jnp.ones_like(alpha)
    out = jnp.concatenate(
        [jnp.clip(newrgb, 0.0, 1.0), out_a[..., None]], axis=-1)
    return out


# -- flam3 spatial filter kernel family --------------------------------------
# (flam3 filters.c flam3_create_spatial_filter; each entry is
# (support, f(x)) with x in [0, support]).  The supersample reduction
# correlates the accumulator with the separable 2-D kernel at stride
# ss — flam3's filtered decimation, not a blur-then-box approximation.

def _sinc(x):
    x = np.where(x == 0, 1e-9, x) * np.pi
    return np.sin(x) / x


def _mitchell(x, b=1.0 / 3.0, c=1.0 / 3.0):
    ax = np.abs(x)
    p0 = (6.0 - 2.0 * b) / 6.0
    p2 = (-18.0 + 12.0 * b + 6.0 * c) / 6.0
    p3 = (12.0 - 9.0 * b - 6.0 * c) / 6.0
    q0 = (8.0 * b + 24.0 * c) / 6.0
    q1 = (-12.0 * b - 48.0 * c) / 6.0
    q2 = (6.0 * b + 30.0 * c) / 6.0
    q3 = (-b - 6.0 * c) / 6.0
    return np.where(
        ax < 1.0, p0 + ax * ax * (p2 + ax * p3),
        np.where(ax < 2.0, q0 + ax * (q1 + ax * (q2 + ax * q3)), 0.0))


def _catrom(x):
    ax = np.abs(x)
    return np.where(
        ax < 1.0, 1.0 - ax * ax * (2.5 - 1.5 * ax),
        np.where(ax < 2.0,
                 2.0 - ax * (4.0 - ax * (2.5 - 0.5 * ax)), 0.0))


def _quadratic(x):
    ax = np.abs(x)
    return np.where(ax < 0.5, 0.75 - ax * ax,
                    np.where(ax < 1.5, 0.5 * (ax - 1.5) ** 2, 0.0))


def _bspline(x):
    ax = np.abs(x)
    return np.where(
        ax < 1.0, (4.0 + ax * ax * (-6.0 + 3.0 * ax)) / 6.0,
        np.where(ax < 2.0, ((2.0 - ax) ** 3) / 6.0, 0.0))


SPATIAL_FILTERS = {
    "gaussian": (1.5, lambda x: np.exp(-2.0 * x * x)),
    "box": (0.5, lambda x: (np.abs(x) < 0.5).astype(np.float64)),
    "triangle": (1.0, lambda x: np.maximum(1.0 - np.abs(x), 0.0)),
    "hermite": (1.0, lambda x: np.where(
        np.abs(x) < 1.0,
        (2.0 * np.abs(x) - 3.0) * x * x + 1.0, 0.0)),
    "bell": (1.5, _quadratic),
    "quadratic": (1.5, _quadratic),
    "b_spline": (2.0, _bspline),
    "mitchell": (2.0, _mitchell),
    "catrom": (2.0, _catrom),
    "lanczos2": (2.0, lambda x: np.where(np.abs(x) < 2.0,
                                         _sinc(x) * _sinc(x / 2.0),
                                         0.0)),
    "lanczos3": (3.0, lambda x: np.where(np.abs(x) < 3.0,
                                         _sinc(x) * _sinc(x / 3.0),
                                         0.0)),
    "blackman": (1.0, lambda x: 0.42 + 0.5 * np.cos(np.pi * x)
                 + 0.08 * np.cos(2.0 * np.pi * x)),
    "hamming": (1.0, lambda x: 0.54 + 0.46 * np.cos(np.pi * x)),
    "hanning": (1.0, lambda x: 0.5 + 0.5 * np.cos(np.pi * x)),
}


def spatial_filter_taps(shape: str, radius: float, ss: int):
    """flam3's spatial filter row (flam3_create_spatial_filter): width
    fw = 2 * support * ss * radius accumulator pixels, rounded up with
    parity matched to ss so output-pixel centers align; samples at
    cell centers with spacing 2*support/fw in kernel coordinates
    (flam3's `adjust` stretch — the round-up padding falls into the
    kernel tail); sum-normalized."""
    if shape not in SPATIAL_FILTERS:
        raise ValueError(f"unknown spatial filter {shape!r}; have "
                         f"{sorted(SPATIAL_FILTERS)}")
    support, fn = SPATIAL_FILTERS[shape]
    fw = 2.0 * support * ss * radius
    fwidth = int(fw) + 1
    if (fwidth ^ ss) & 1:
        fwidth += 1
    fwidth = max(fwidth, ss)
    # flam3's `adjust`: the rounded-up discrete window spans fwidth
    # accumulator px but the continuous kernel only fw, so tap
    # coordinates stretch by fwidth/fw — the spacing stays
    # 2*support/fw per px and the round-up padding lands in the
    # kernel's tail (zero for the finite-support shapes) instead of
    # compressing the kernel and over-blurring
    adjust = support * fwidth / fw if fw > 0 else 1.0
    x = ((2.0 * np.arange(fwidth) + 1.0) / fwidth - 1.0) * adjust
    t = fn(np.abs(x)).astype(np.float64)
    s = t.sum()
    if s <= 0:
        raise ValueError(
            f"degenerate spatial filter {shape!r} radius {radius}")
    return (t / s).astype(np.float32)


def downsample(img, ss: int, spatial_filter: float = 0.0,
               filter_shape: str = "gaussian", gutter=0):
    """Supersample reduction: gutter-framed accumulator -> (H, W, C).

    `spatial_filter` (static, output-pixel units) is flam3's `filter`
    attribute and `filter_shape` its kernel family: each output pixel
    is the kernel-weighted window of accumulator cells, stride ss
    (flam3 rect.c filtered accumulation).  flam3 applies the filter
    even at ss == 1 (a 3-tap kernel at the 0.5-gaussian default);
    radius <= 0 degenerates to a plain box average (identity at
    ss == 1).

    `gutter` (acc px; int, or (gy, gx) for banded callers) is REAL
    border context around the frame: the filtered path keeps `pad` of
    it so frame-edge output pixels read true accumulator data — flam3
    sizes its gutter to include the filter half-width for exactly this
    (round-2 review: zero-padded edges rendered systematically dark).
    Any shortfall (gutter < pad) is zero-padded.  The box path crops
    the gutter exactly."""
    gy, gx = (gutter, gutter) if isinstance(gutter, int) else gutter
    H, W, C = img.shape
    if not spatial_filter or spatial_filter <= 0.0:
        img = img[gy:H - gy if gy else H, gx:W - gx if gx else W]
        if ss == 1:
            return img
        hs, ws, c = img.shape
        h, w = hs // ss, ws // ss
        return img.reshape(h, ss, w, ss, c).mean(axis=(1, 3))
    taps = jnp.asarray(
        spatial_filter_taps(filter_shape, float(spatial_filter), ss))
    fwidth = taps.shape[0]
    pad = (fwidth - ss) // 2
    # keep exactly `pad` of gutter context (zero-pad any shortfall)
    py, px = max(pad - gy, 0), max(pad - gx, 0)
    img = img[max(gy - pad, 0):H - gy + pad,
              max(gx - pad, 0):W - gx + pad]
    if py or px:
        img = jnp.pad(img, ((py, py), (px, px), (0, 0)))
    x = img.transpose(2, 0, 1)[None]               # (1, C, H, W)
    kh = jnp.broadcast_to(taps[None, None, :, None], (C, 1, fwidth, 1))
    kw = jnp.broadcast_to(taps[None, None, None, :], (C, 1, 1, fwidth))
    dn = jax.lax.conv_dimension_numbers(
        x.shape, kh.shape, ("NCHW", "OIHW", "NCHW"))
    x = jax.lax.conv_general_dilated(
        x, kh, (ss, 1), [(0, 0), (0, 0)], dimension_numbers=dn,
        feature_group_count=C)
    x = jax.lax.conv_general_dilated(
        x, kw, (1, ss), [(0, 0), (0, 0)], dimension_numbers=dn,
        feature_group_count=C)
    return x[0].transpose(1, 2, 0)


def to_u8(img):
    """float [0,1] -> uint8 with rounding."""
    return jnp.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)
