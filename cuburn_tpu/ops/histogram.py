"""Histogram accumulation: plotted points -> (n_bins+1, 4) f32 buckets.

The reference accumulates through a deferred-writeback pipeline
(cuburn/code/sort.py radix sort + segmented write kernel, SURVEY.md §1
"famous optimization").  Here accumulation backends are plain XLA
programs, pluggable and differential-tested against each other:

  * `scatter`  — XLA scatter-add (`hist.at[addr].add(rgba)`), which the
    GPU backend lowers to atomic adds, so RGB sums change in their last
    bits from run to run there.  Always available; the correctness
    baseline (SURVEY.md §7 stage 1).
  * `scatter_sorted` — lax.sort by address, then scatter-add with the
    `indices_are_sorted` hint: the reference's sort-then-write order,
    with XLA's scatter as the write kernel.
  * `sortcum`  — lax.sort by address, a segmented prefix sum that
    restarts at every new address, and ONE write per distinct bin
    (unique addresses: no two updates contend for a bin).

"auto" resolves to AUTO_BACKEND.

The histogram layout is (n_bins + 1, 4) float32: RGB + density, with a
junk bin at index n_bins receiving masked/out-of-bounds points
(branch-free masking; see ops/camera.py).  Density can exceed 2^24 so
the histogram is always f32, never bf16 (SURVEY.md §3.5 numerics note).
Density adds are integer counts (or temporal weights that are exact in
f32), so every backend's density is exact in any add order; RGB sums
differ between backends only by f32 reassociation.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp


def alloc(n_bins: int) -> jnp.ndarray:
    """Allocate a zeroed histogram with its junk bin."""
    return jnp.zeros((n_bins + 1, 4), dtype=jnp.float32)


def finalize(hist: jnp.ndarray) -> jnp.ndarray:
    """Drop the junk bin."""
    return hist[:-1]


# ---------------------------------------------------------------------------
# scatter backend
# ---------------------------------------------------------------------------

def accumulate_scatter(hist, addr, rgba):
    """XLA scatter-add of rgba rows at addr.  addr may contain the junk
    bin index; rgba (B, 4) f32."""
    return hist.at[addr.reshape(-1)].add(rgba.reshape(-1, 4))


def _sort_by_addr(addr, rgba):
    flat_rgba = rgba.reshape(-1, 4)
    sa, r, g, b, d = jax.lax.sort(
        (addr.reshape(-1), flat_rgba[:, 0], flat_rgba[:, 1],
         flat_rgba[:, 2], flat_rgba[:, 3]), num_keys=1)
    return sa, jnp.stack([r, g, b, d], axis=1)


def accumulate_scatter_sorted(hist, addr, rgba):
    """Sort rows by address, then scatter-add with the
    `indices_are_sorted` hint (equal addresses are adjacent, so a
    lowering may merge their updates before touching memory)."""
    sa, rgba_s = _sort_by_addr(addr, rgba)
    return hist.at[sa].add(rgba_s, indices_are_sorted=True)


# ---------------------------------------------------------------------------
# sortcum backend: sort + segmented prefix sum + one write per bin
# ---------------------------------------------------------------------------

def accumulate_sortcum(hist, addr, rgba):
    """Sort-based accumulation with one update per distinct bin.

    1. sort (addr, rgba) by addr                         [lax.sort]
    2. segmented inclusive prefix sum that restarts at every new
       address, so the last row of each run holds that bin's total
       (a tree-ordered f32 sum of the run alone: its error scales with
       the bin's own mass, not with the whole flush's)
    3. add each run total to its bin: run ends have unique addresses,
       every other row is diverted to a scratch slot past the junk bin
    """
    n_bins_p1 = hist.shape[0]
    sa, vals = _sort_by_addr(addr, rgba)
    starts = jnp.concatenate([jnp.ones((1,), bool), sa[1:] != sa[:-1]])

    def combine(left, right):
        f_l, v_l = left
        f_r, v_r = right
        return f_l | f_r, jnp.where(f_r[..., None], v_r, v_l + v_r)

    _, run_sums = jax.lax.associative_scan(combine, (starts, vals))
    is_end = jnp.concatenate([sa[:-1] != sa[1:], jnp.ones((1,), bool)])
    idx = jnp.where(is_end, sa, n_bins_p1)
    padded = jnp.concatenate([hist, jnp.zeros((1, 4), hist.dtype)])
    return padded.at[idx].add(run_sums)[:n_bins_p1]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

BACKENDS = {
    "scatter": accumulate_scatter,
    "scatter_sorted": accumulate_scatter_sorted,
    "sortcum": accumulate_sortcum,
}


def get_backend(name: str):
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown histogram backend {name!r}; have {sorted(BACKENDS)}")


# scatter won the race on an NVIDIA H100 (700 W limit) at 512², 720p
# and 1080p-ss2 histograms (4 MB to 132 MB) by ~4.4x over both sorted
# backends (bench/histrace.py), so "auto" needs no rule on geometry.
AUTO_BACKEND = "scatter"
