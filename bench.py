#!/usr/bin/env python
"""Benchmark driver: prints ONE JSON line with the headline metric.

Metric (BASELINE.md north star): IFS samples/sec/chip — plotted,
post-fuse, in-bounds samples per second of warm device time, on the
benchmark config-3 genome (full variation features: parametric
variations, final xform, xaos), through Renderer.accumulate at 512²,
with the 1920x1080 figure, the iterate-only ceiling and the
DE+colorize latency as extra fields.

vs_baseline: ratio against 400e6 samples/s — the recalled
cuburn-on-GTX-580-class figure (BASELINE.md marks all reference numbers
*recalled, unverified*; BASELINE.json `published` was empty).  Treat the
ratio as indicative, the absolute value as the measurement.

Measures only on a GPU; `--smoke` runs tiny sizes on any device to
check the script itself (its numbers are not measurements).

Usage: python bench.py [--smoke]
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

RECALLED_BASELINE_SAMPLES_PER_SEC = 400e6


def _timed_accumulate(renderer, shots: int):
    """Warm once, then time `shots` accumulations; returns the stats
    of every timed shot."""
    renderer.accumulate(0.2, seed=1)
    return [renderer.accumulate(0.2, seed=2 + i)[1] for i in range(shots)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes on any device (checks the script)")
    args = ap.parse_args(argv)

    from cuburn_tpu.compile_cache import enable_compile_cache
    from cuburn_tpu.models import full_feature
    from cuburn_tpu.profile import RenderProfile
    from cuburn_tpu.render import Renderer, _filter_frame

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.smoke:
        print(f"bench.py: no GPU (JAX found {dev.platform!r}); "
              "use --smoke to check the script elsewhere",
              file=sys.stderr)
        sys.exit(1)
    extra = {"platform": dev.platform, "device_kind": dev.device_kind,
             "device_count": len(jax.devices())}

    # ---- headline: accumulate throughput, config-3 genome, 512² ----
    g = full_feature()
    if args.smoke:
        prof = RenderProfile(width=128, height=128, quality=64,
                             batch=1 << 12, iters_per_chunk=16,
                             de_enabled=False)
    else:
        prof = RenderProfile(width=512, height=512, quality=2000,
                             de_enabled=False)
    r = Renderer(g, prof)
    shots = _timed_accumulate(r, 2)
    st = shots[-1]
    samples_per_sec = st.samples_per_sec
    extra["samples_per_sec_shots"] = [s.samples_per_sec for s in shots]
    extra["iterate_ms"] = st.iterate_s * 1e3
    extra["total_iters"] = st.total_iters
    extra["plotted"] = st.plotted_samples
    extra["retention"] = st.retention
    extra["config"] = (f"full_feature {prof.width}x{prof.height} "
                       f"B={prof.batch} backend={r.backend}")

    # ---- roofline context: iterate-only ceiling ----
    # The chaos game with records DISCARDED (jnp.sum sink) bounds any
    # histogram backend from above; flush_frac says how much of the
    # full loop the flush costs.
    from cuburn_tpu.ops.iterate import (init_state, iterate_step,
                                        xform_cdf_rows)
    key, cam = g.structure_key(), r.cam
    params = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.2))
    cdf = xform_cdf_rows(params)
    ppu = params.ppu * jnp.float32(prof.width / g.size[0])
    K = r.profile.iters_per_chunk
    n_chunks = max(1, st.total_iters // (prof.batch * K))

    @jax.jit
    def iterate_only(state, n):
        def chunk(_, carry):
            state, acc = carry

            def body(state, __):
                state, addr, _pc, _op = iterate_step(
                    key, cam, prof.fuse, params, cdf, ppu, state)
                return state, jnp.sum(addr)

            state, sums = jax.lax.scan(body, state, None, length=K)
            return state, acc + jnp.sum(sums)

        return jax.lax.fori_loop(0, n, chunk, (state, jnp.int32(0)))

    out = iterate_only(init_state(jax.random.PRNGKey(0), prof.batch),
                       jnp.int32(n_chunks))
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = iterate_only(out[0], jnp.int32(n_chunks))
    jax.block_until_ready(out)
    dt_iter = time.perf_counter() - t0
    iters = n_chunks * prof.batch * K
    extra["iterate_only_iters_per_s"] = iters / dt_iter
    dt_full = st.iterate_s * iters / max(st.total_iters, 1)
    extra["flush_frac"] = max(0.0, 1.0 - dt_iter / dt_full)

    # ---- secondary: DE + colorclip latency (north star < 50 ms) ----
    hist, _ = r.accumulate(0.2, seed=9)
    q_cell = jnp.float32(1000.0)
    img = _filter_frame(cam, False, True, hist[:-1], params, q_cell)
    jax.block_until_ready(img)
    t0 = time.perf_counter()
    img = _filter_frame(cam, False, True, hist[:-1], params, q_cell)
    jax.block_until_ready(img)
    extra["de_colorize_ms"] = (time.perf_counter() - t0) * 1e3

    # ---- north star: config-3 genome at 1920x1080 ----
    if not args.smoke:
        r1080 = Renderer(g, RenderProfile(width=1920, height=1080,
                                          quality=1000,
                                          de_enabled=False))
        shots = _timed_accumulate(r1080, 2)
        extra["samples_per_sec_1080p"] = shots[-1].samples_per_sec
        extra["samples_per_sec_1080p_shots"] = [
            s.samples_per_sec for s in shots]
        extra["retention_1080p"] = shots[-1].retention
        extra["backend_1080p"] = r1080.backend

    print(json.dumps({
        "metric": "ifs_samples_per_sec_per_chip",
        "value": samples_per_sec,
        "unit": "samples/s",
        "vs_baseline": samples_per_sec / RECALLED_BASELINE_SAMPLES_PER_SEC,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
