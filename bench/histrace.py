#!/usr/bin/env python
"""Race the histogram backends through the Renderer on one device.

For each geometry (512² ss1, 720p ss1, 1080p ss2 with the DE gutter)
and each plain backend (ops/histogram.py), render the full_feature
genome's accumulation with a warm program and report plotted samples
per second of device time.  A second sweep varies the flush size
(iterations per chunk) for each backend at each geometry.

Prints one JSON line per measurement, then a summary line naming the
winner per geometry.  The numbers come from whatever device JAX
picks: run it on the accelerator being measured.

Usage: python -u bench/histrace.py [--iters N] [--shots S]
           [--geoms 512,720p,1080p] [--ks 16,32,64]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GEOMETRIES = {
    "512": dict(width=512, height=512, ss=1, de_enabled=False),
    "720p": dict(width=1280, height=720, ss=1, de_enabled=False),
    "1080p": dict(width=1920, height=1080, ss=2, de_enabled=True),
}
BACKENDS = ("scatter", "scatter_sorted", "sortcum")


def race_one(genome, geom, backend, k, iters, shots, batch):
    import dataclasses

    from cuburn_tpu.profile import RenderProfile
    from cuburn_tpu.render import Renderer
    g = GEOMETRIES[geom]
    pixels = g["width"] * g["height"]
    prof = RenderProfile(quality=max(1, iters // pixels), batch=batch,
                         iters_per_chunk=k, hist_backend=backend, **g)
    r = Renderer(genome, prof)
    t0 = time.perf_counter()
    Renderer(genome, dataclasses.replace(prof, quality=1)).accumulate(
        0.2, seed=1)
    compile_s = time.perf_counter() - t0
    rates = []
    for shot in range(shots):
        _, st = r.accumulate(0.2, seed=2 + shot)
        rates.append(st.samples_per_sec)
    return {"geom": geom, "n_bins": r.cam.n_bins,
            "hist_mb": round((r.cam.n_bins + 1) * 16 / 2**20, 1),
            "backend": r.backend, "iters_per_chunk": k, "batch": batch,
            "records_per_flush": batch * k,
            "plotted": st.plotted_samples,
            "samples_per_sec": max(rates), "shots": rates,
            "first_call_s": round(compile_s, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400_000_000,
                    help="chaos-game iterations per timed shot")
    ap.add_argument("--shots", type=int, default=2)
    ap.add_argument("--geoms", default="512,720p,1080p")
    ap.add_argument("--backends", default=",".join(BACKENDS))
    ap.add_argument("--ks", default="32",
                    help="iterations per chunk to sweep")
    ap.add_argument("--batch", type=int, default=1 << 17)
    ap.add_argument("--out", help="also append the JSON lines here")
    args = ap.parse_args()

    import jax

    from cuburn_tpu.compile_cache import enable_compile_cache
    from cuburn_tpu.models import full_feature
    enable_compile_cache()
    dev = jax.devices()[0]
    genome = full_feature()
    best = {}
    for geom in args.geoms.split(","):
        for backend in args.backends.split(","):
            for k in (int(x) for x in args.ks.split(",")):
                rec = race_one(genome, geom, backend, k, args.iters,
                               args.shots, args.batch)
                rec["device"] = dev.device_kind
                line = json.dumps(rec)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
                cur = best.get(geom)
                if cur is None or rec["samples_per_sec"] > \
                        cur["samples_per_sec"]:
                    best[geom] = rec
    print(json.dumps({"winners": {
        g: (r["backend"], r["iters_per_chunk"], r["samples_per_sec"])
        for g, r in best.items()}, "device": dev.device_kind}))


if __name__ == "__main__":
    main()
