"""Branch-free xform application over the whole point batch.

JAX replacement for the reference's generated `apply_xf_<i>`
device functions (cuburn/code/iter.py, SURVEY.md §2b): instead of
divergent per-thread branches on the chosen xform — which would lower to
`lax.switch`-style masked evaluation of *every xform's whole body* — we
exploit that all xforms share one code shape and **gather parameters by
xform index**:

    affine row, variation weights, parametric knobs, color, speed
        = table[xf_idx]                      # (B, ...) gathers

then evaluate each *distinct* variation in the genome's union set exactly
once per point, with per-point weights (zero where that xform doesn't
use the variation).  Compute cost is one "super-xform" = the union of
used variations, independent of xform count — strictly better on SIMD
than per-xform masking (SURVEY.md §7 "hard parts" item 3).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cuburn_tpu.genome.specs import StructureKey
from cuburn_tpu.ops import variations as V
from cuburn_tpu.ops.rng import RngStream

PI = np.float32(np.pi)


def _apply_affine(aff, x, y):
    a, b, c, d, e, f = (aff[..., i] for i in range(6))
    return a * x + b * y + c, d * x + e * y + f


def _param_accessor(param_slots, gathered_params):
    """Build P(attr) -> per-point array, resolving packed slots."""
    slot_of = {attr: i for i, (_v, attr) in enumerate(param_slots)}

    def P(attr: str):
        return gathered_params[..., slot_of[attr]]
    return P


def apply_variation_stack(
    var_names: Tuple[str, ...],
    param_slots,
    tx, ty,
    var_weights,       # (..., V) gathered per-point weights
    var_params,        # (..., P) gathered per-point parametric knobs
    affine_rows,       # (..., 6) the xform's own affine (for waves etc.)
    rng: RngStream,
):
    """Evaluate the weighted variation sum at (tx, ty) (post-affine)."""
    P = _param_accessor(param_slots, var_params)
    aff = tuple(affine_rows[..., i] for i in range(6))

    # pre_blur perturbs the input point before the variation sum
    # (SURVEY.md §2c) and before the precalc values are derived.
    if "pre_blur" in var_names:
        i = var_names.index("pre_blur")
        w_pb = var_weights[..., i]
        g = w_pb * rng.gaussian_ish()
        a = 2.0 * PI * rng.uniform()
        tx = tx + g * jnp.cos(a)
        ty = ty + g * jnp.sin(a)

    ctx = V.make_ctx(tx, ty, aff, rng)
    ox = jnp.zeros_like(tx)
    oy = jnp.zeros_like(ty)
    for i, name in enumerate(var_names):
        if name == "pre_blur":
            continue
        dx, dy = V.VARIATION_IMPLS[name](ctx, var_weights[..., i], P)
        ox = ox + dx
        oy = oy + dy
    return ox, oy


def build_xform_table(key: StructureKey, params):
    """Assemble every per-xform parameter into one (N, K) matrix so a
    single one-hot matmul fetches ALL of a point's parameters at once.

    Column layout: [affine 0:6][color][speed][opacity]
                   [post 9:15 when has_post][var_weights][var_params].
    The concat is loop-invariant — XLA hoists it out of the iteration
    loop — and the fetch is one matmul instead of N scalar gathers
    (the vectorized answer to cuburn's per-thread parameter reads)."""
    cols = [params.affine,
            params.color[:, None], params.color_speed[:, None],
            params.opacity[:, None]]
    if key.has_post:
        cols.append(params.post)
    cols.append(params.var_weights)
    cols.append(params.var_params)
    return jnp.concatenate(cols, axis=1)


def select_and_fetch(key: StructureKey, cdf_rows, table, last_xf, u):
    """Branch-free xform selection + parameter fetch, fused.

    Builds the step matrix S[b, j] = (u_b >= cdf_j), derives both the
    selected index (for xaos conditioning next step) and the one-hot
    row (S_{j-1} - S_j), and fetches the point's parameter row with one
    (B, N) @ (N, K) matmul.  Returns (xf_idx, row (B, K))."""
    n = key.n_xforms
    # HIGHEST precision on both matmuls: at the default precision a
    # float32 matmul may run in TF32 on the GPU's tensor cores (10
    # mantissa bits), which would silently quantize every fetched
    # genome parameter and CDF threshold each iteration
    hp = jax.lax.Precision.HIGHEST
    if key.has_xaos:
        rows_oh = jax.nn.one_hot(last_xf, n, dtype=u.dtype)   # (B, N)
        cdf = jnp.matmul(rows_oh, cdf_rows, precision=hp)     # (B, N)
        step = (u[:, None] >= cdf).astype(u.dtype)
    else:
        step = (u[:, None] >= cdf_rows[0][None, :]).astype(u.dtype)
    idx = jnp.minimum(jnp.sum(step, axis=1).astype(jnp.int32), n - 1)
    shifted = jnp.concatenate(
        [jnp.ones_like(step[:, :1]), step[:, :-1]], axis=1)
    onehot = shifted - step          # exactly one 1.0 per row
    row = jnp.matmul(onehot, table, precision=hp)  # (B, K)
    return idx, row


def apply_xforms(
    key: StructureKey,
    params,            # GenomeParams
    row,               # (B, K) fetched parameter rows
    x, y, color,       # (B,) point state
    rng: RngStream,
):
    """One chaos-game step body: affine -> variations -> post -> color.

    `row` comes from select_and_fetch (column layout of
    build_xform_table).  Returns (nx, ny, ncolor, opacity)."""
    n_vars = len(key.variations)
    n_par = max(len(key.param_slots), 1)
    aff = row[:, 0:6]
    xf_color = row[:, 6]
    speed = row[:, 7]
    opacity = row[:, 8]
    off = 9
    if key.has_post:
        post = row[:, off:off + 6]
        off += 6
    vw = row[:, off:off + n_vars]
    vp = row[:, off + n_vars:off + n_vars + n_par]

    tx, ty = _apply_affine(aff, x, y)
    ox, oy = apply_variation_stack(
        key.variations, key.param_slots, tx, ty, vw, vp, aff, rng)

    if key.has_post:
        ox, oy = _apply_affine(post, ox, oy)

    ncolor = color * (1.0 - speed) + xf_color * speed
    return ox, oy, ncolor, opacity


def apply_final_xform(key: StructureKey, params, x, y, color,
                      rng: RngStream):
    """Display-only final xform (SURVEY.md §3.5: applied to a copy of the
    point for plotting; never fed back).  Broadcast single-row params."""
    if key.final_variations is None:
        return x, y, color
    aff = jnp.broadcast_to(params.final_affine, x.shape + (6,))
    vw = jnp.broadcast_to(params.final_var_weights,
                          x.shape + params.final_var_weights.shape)
    vp = jnp.broadcast_to(params.final_var_params,
                          x.shape + params.final_var_params.shape)
    tx, ty = _apply_affine(aff, x, y)
    ox, oy = apply_variation_stack(
        key.final_variations, key.final_param_slots,
        tx, ty, vw, vp, aff, rng)
    if key.final_has_post:
        post = jnp.broadcast_to(params.final_post, x.shape + (6,))
        ox, oy = _apply_affine(post, ox, oy)
    speed = params.final_color_speed
    ncolor = color * (1.0 - speed) + params.final_color * speed
    return ox, oy, ncolor
