#!/usr/bin/env python
"""Benchmark suite: the five binding configurations of BASELINE.md.

Runs each config end-to-end (accumulate + filters) in this one
process and prints one JSON record per config plus a summary line.

  1. sierpinski 512^2, 1M samples, log tonemap (affine-only)
  2. classic variations + palette + gamma/vibrancy, 720p
  3. full variation set + parametric + final xform + xaos, 1080p
  4. adaptive DE + 2x supersampling at quality 2000, 1080p
  5. animated spline sequence with temporal-sample motion blur, 720p

Measures only on a GPU; `--quick` runs every config at 1/10 of its
samples and a third of its width and height on any device, to check
the script (its numbers are not measurements).

Usage: python bench/configs.py [--quick] [--config N] [--shots S]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config_profile(idx: int, quick: bool):
    """(genome, RenderProfile) of config idx at its true size, or the
    --quick reduction of it."""
    from cuburn_tpu.models import (animated_spark, classic_swirl,
                                   full_feature, sierpinski)
    from cuburn_tpu.profile import RenderProfile
    scale = 0.1 if quick else 1.0

    def sz(x):
        return max(64, int(x / 3) // 16 * 16) if quick else x

    common = dict(batch=(1 << 12) if quick else (1 << 17))
    if idx == 1:
        g, w, h = sierpinski(), sz(512), sz(512)
        kw = dict(quality=max(4, int(1_000_000 * scale) // (w * h) + 1),
                  de_enabled=False)
    elif idx == 2:
        g, w, h = classic_swirl(), sz(1280), sz(720)
        kw = dict(quality=max(8, int(500 * scale)), de_enabled=False)
    elif idx == 3:
        g, w, h = full_feature(), sz(1920), sz(1080)
        kw = dict(quality=max(8, int(1000 * scale)), de_enabled=False)
    elif idx == 4:
        g, w, h = classic_swirl(), sz(1920), sz(1080)
        kw = dict(ss=2, quality=max(8, int(2000 * scale)),
                  de_enabled=True)
    elif idx == 5:
        g, w, h = animated_spark(), sz(1280), sz(720)
        kw = dict(quality=max(8, int(200 * scale)), temporal_samples=4,
                  de_enabled=False)
    else:
        raise ValueError(f"no config {idx}; have 1-5")
    return g, RenderProfile(width=w, height=h, **common, **kw)


def run_config(idx: int, quick: bool, shots: int = 2):
    from cuburn_tpu.render import Renderer
    g, prof = config_profile(idx, quick)
    r = Renderer(g, prof)
    r.render_frame(0.2, seed=1)         # warm: compile every program
    rates = []
    for shot in range(shots):
        t0 = time.perf_counter()
        img, stats = r.render_frame(0.2, seed=2 + shot)
        wall = time.perf_counter() - t0
        rates.append(stats.samples_per_sec)
    rec = {
        "config": idx, "genome": g.name,
        "size": f"{prof.width}x{prof.height}", "ss": prof.ss,
        "quality": prof.quality,
        "temporal_samples": prof.temporal_samples,
        "plotted_samples": stats.plotted_samples,
        "samples_per_sec": stats.samples_per_sec,
        "retention": stats.retention,
        "iterate_ms": stats.iterate_s * 1e3,
        "filter_ms": stats.filter_s * 1e3,
        "frame_wall_s": wall,
        "backend": r.backend,
        "samples_per_sec_shots": rates,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="reduced sizes on any device (checks the script)")
    ap.add_argument("--config", type=int, help="run only config N (1-5)")
    ap.add_argument("--shots", type=int, default=2)
    args = ap.parse_args()

    import jax

    from cuburn_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.quick:
        print(f"configs.py: no GPU (JAX found {dev.platform!r}); use "
              "--quick to check the script elsewhere", file=sys.stderr)
        sys.exit(1)
    recs = [run_config(i, args.quick, args.shots)
            for i in ([args.config] if args.config else (1, 2, 3, 4, 5))]
    print(json.dumps({"summary": "best_samples_per_sec",
                      "value": max(r["samples_per_sec"] for r in recs),
                      "completed": [r["config"] for r in recs],
                      "device_kind": dev.device_kind}))


if __name__ == "__main__":
    main()
