#!/usr/bin/env python
"""Measure cross-frame pipeline overlap: serial frames() vs the
double-buffered frames_overlapped() on a real animation, PNG encode
included per frame (the host work the overlap is supposed to hide —
cuburn/render.py 2-stream iter(N) ‖ filter/copy(N-1), SURVEY.md §3.1).

Usage: python bench/overlap.py [n_frames=8] [dim=512] [quality=150]
Emits per-driver wall clocks and the overlap speedup.
"""


import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dim = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    quality = int(sys.argv[3]) if len(sys.argv) > 3 else 150

    import dataclasses

    import numpy as np

    from cuburn_tpu.compile_cache import enable_compile_cache
    from cuburn_tpu.models import animated_spark
    from cuburn_tpu.output import encode_png
    from cuburn_tpu.profile import RenderProfile
    from cuburn_tpu.render import Renderer

    enable_compile_cache()
    g = animated_spark()
    prof = RenderProfile(width=dim, height=dim, quality=quality,
                         fps=float(n_frames),
                         duration=1.0, temporal_samples=1)
    r = Renderer(g, prof)

    def run(driver, label):
        # warm: compile both programs once
        imgs = []
        t0 = time.perf_counter()
        n = 0
        for img, stats in driver(seed=1):
            encode_png(np.asarray(img))
            imgs.append(np.asarray(img))
            n += 1
        dt = time.perf_counter() - t0
        print(json.dumps({"driver": label, "frames": n,
                          "wall_s": round(dt, 2),
                          "ms_per_frame": round(dt / n * 1e3, 1)}))
        return dt, imgs

    # one throwaway frame to absorb compile time for both paths
    next(iter(r.frames(seed=0)))
    next(iter(r.frames_overlapped(seed=0)))

    # timed runs use different seeds, so neither pass replays the
    # other's exact inputs
    t_serial, imgs_s = run(r.frames, "serial")
    t_overlap, _ = run(lambda seed: r.frames_overlapped(seed=seed + 1),
                       "overlapped")
    # same frames: one untimed overlapped pass at the serial seed
    # (within 1 u8 on a GPU, whose atomic adds reorder RGB sums)
    imgs_o = [np.asarray(img) for img, _ in r.frames_overlapped(seed=1)]
    delta = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                for a, b in zip(imgs_s, imgs_o))
    print(json.dumps({
        "max_u8_delta_vs_serial": delta,
        "speedup": round(t_serial / t_overlap, 3)}))


if __name__ == "__main__":
    main()
