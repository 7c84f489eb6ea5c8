"""Per-trajectory RNG streams for the chaos game.

Behavioral equivalent of the reference's MWC RNG (cuburn/code/mwc.py,
SURVEY.md §2b): every trajectory owns an independent, seedable,
cheap-per-draw random stream.  cuburn keeps {mult, state, carry} per
CUDA thread and multiply-with-carry steps it; this uses a per-lane
**xorwow-style xorshift128** (four uint32 words of state per lane, ~6
32-bit vector ops per draw, no 64-bit multiplies), seeded from JAX's counter-based threefry so that seeding quality
is cryptographic even though per-step generation is cheap.

Like cuburn's MWCTest self-test kernel, tests/test_rng.py cross-checks
the device streams against an independent host (numpy) implementation
bit-exactly, and checks stream independence / uniformity statistics.

All functions are shape-polymorphic over the lane batch B and fully
vectorized; state is a (B, 4) uint32 array (a plain pytree leaf; batch
leads so multi-chip sharding specs treat it like every other
per-trajectory array — see parallel/shard.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# 1/2^24 — uniforms are built from the top 24 bits so they are exact f32.
_INV24 = np.float32(1.0 / (1 << 24))


def seed(key: jax.Array, n: int) -> jax.Array:
    """Create per-lane RNG state (n, 4) uint32 from a JAX PRNG key.

    Uses threefry to fill the state, then guards against the all-zero
    fixed point (xorshift's only bad orbit)."""
    bits = jax.random.bits(key, (n, 4), dtype=jnp.uint32)
    # Any lane with an all-zero row would stay zero forever: force a
    # nonzero word. (Probability 2^-128 per lane, but cheap to be exact.)
    row_zero = jnp.all(bits == 0, axis=-1)
    bits = bits.at[:, 0].set(
        jnp.where(row_zero, jnp.uint32(0x9E3779B9), bits[:, 0]))
    return bits


def next_bits(state: jax.Array):
    """Advance every lane one step: returns (new_state, bits (B,) uint32).

    Marsaglia xorshift128: x^=x<<11; x^=x>>8; w^=w>>19; w^=x; rotate words.
    """
    x, y, z, w = (state[..., 0], state[..., 1], state[..., 2],
                  state[..., 3])
    t = x ^ (x << 11)
    t = t ^ (t >> 8)
    w_new = (w ^ (w >> 19)) ^ t
    new_state = jnp.stack([y, z, w, w_new], axis=-1)
    return new_state, w_new


def uniform(state: jax.Array):
    """(new_state, u) with u ~ U[0,1) float32, one per lane."""
    state, bits = next_bits(state)
    # via int32: top-24-bit values are exact either way
    u = (bits >> jnp.uint32(8)).astype(jnp.int32)\
        .astype(jnp.float32) * _INV24
    return state, u


class RngStream:
    """Trace-time helper threading RNG state through variation bodies.

    The reference plumbs `mwc_next(rs)` calls through generated CUDA
    (SURVEY.md §2c: stochastic variations consume RNG inside their
    bodies).  Here, variation implementations call `stream.uniform()`
    as many times as they statically need; the Python-level state
    mutation happens at trace time, so the number of draws is fixed by
    the genome's structure key and the whole thing stays jittable.
    """

    def __init__(self, state: jax.Array):
        self.state = state

    def uniform(self) -> jax.Array:
        self.state, u = uniform(self.state)
        return u

    def bits(self) -> jax.Array:
        self.state, b = next_bits(self.state)
        return b

    def gaussian_ish(self) -> jax.Array:
        """Sum-of-4-uniforms minus 2: flam3/cuburn's cheap approximate
        Gaussian used by gaussian_blur / radial_blur / pre_blur."""
        return (self.uniform() + self.uniform() +
                self.uniform() + self.uniform() - 2.0)


# --------------------------------------------------------------------------
# Host reference implementation (for MWCTest-style differential tests)
# --------------------------------------------------------------------------

def host_next_bits(state: np.ndarray):
    """Numpy mirror of next_bits, bit-exact. state: (B, 4) uint32."""
    x, y, z, w = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    t = x ^ (x << np.uint32(11))
    t = t ^ (t >> np.uint32(8))
    w_new = (w ^ (w >> np.uint32(19))) ^ t
    return np.stack([y, z, w, w_new], axis=-1), w_new
