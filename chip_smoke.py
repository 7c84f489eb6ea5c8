#!/usr/bin/env python
"""Render on one GPU through the normal entry points and check the
results.

    python chip_smoke.py             # phases 0-5 on one card
    python chip_smoke.py --cards 4   # only the multi-card phase

Phase 0  device check: exits non-zero before any other work unless
         JAX's first device is a GPU; prints the card's name and
         power limit, the JAX version and XLA_FLAGS.
Phase 1  still frame through the CLI: gallery:full_feature, profile
         1080p (1920x1080, ss2, q1000, DE), PNG + --metrics-json; run
         twice in this process (cold, then warm).
Phase 2  animation through the CLI: gallery:animated_spark --animate
         at 1280x720, 4 temporal samples, 6 frames to y4m (the
         overlapped frame driver).
Phase 3  histogram accumulation at real width: one flush of 2^22
         packed records from iterate_step at the 1080p-ss2 bin count,
         through every backend of ops/histogram.py, against np.add.at
         in float64.
Phase 4  whole pipeline, GPU against the CPU device of this same
         process: density TV distance within the two-seed noise rule,
         and one histogram through the filter chain on both devices.
Phase 5  determinism: the same seed twice on the GPU.

Any failed check raises, so the exit code is non-zero.  The last line
of standard output is one JSON object: {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# histogram comparison: RGB error per bin relative to its density.
# XLA's GPU scatter adds with atomics, so the f32 add order changes
# from run to run; density adds are integers and stay exact.
RGB_REL_TOL = 1e-5
# GPU-vs-CPU density: TV <= max(TV_FLOOR_FACTOR * two-seed floor,
# TV_MIN) — the chaos game is chaotic, so one ulp of difference
# decorrelates trajectories and only the attractor measure must agree
TV_FLOOR_FACTOR = 4.0
TV_MIN = 0.03
# share of 1080p pixels that must be non-black
MIN_NONBLACK_SHARE = 0.05
# rendered files land here, inside the checkout
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out", "chip_smoke")


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card phase on 4 cards")
    return ap.parse_args(argv)


def log(phase: str, **fields):
    print(f"{phase}: {json.dumps(fields)}", flush=True)


# ---------------------------------------------------------------------------
# comparisons (pure numpy; exercised by the CPU tests)
# ---------------------------------------------------------------------------

def density(hist) -> np.ndarray:
    """Normalised density of a logical (n_bins+1, 4) histogram, junk
    bin dropped."""
    d = np.asarray(hist, np.float64)[:-1, 3]
    return d / max(d.sum(), 1e-300)


def tv(a, b) -> float:
    """Total-variation distance of two histograms' density measures."""
    return 0.5 * float(np.abs(density(a) - density(b)).sum())


def tv_limit(floor: float) -> float:
    return max(TV_FLOOR_FACTOR * floor, TV_MIN)


def reference_hist(n_bins: int, addr, rgba) -> np.ndarray:
    """np.add.at accumulation in float64: the plain reference."""
    ref = np.zeros((n_bins + 1, 4), np.float64)
    np.add.at(ref, np.asarray(addr).reshape(-1),
              np.asarray(rgba, np.float64).reshape(-1, 4))
    return ref


def hist_errors(out, ref) -> tuple:
    """(max density error over every bin incl. junk, max RGB error
    relative to bin density over the real bins)."""
    out = np.asarray(out, np.float64)
    dens_err = float(np.abs(out[:, 3] - ref[:, 3]).max())
    rgb = np.abs(out[:-1, :3] - ref[:-1, :3]) \
        / np.maximum(ref[:-1, 3:4], 1.0)
    return dens_err, float(rgb.max())


def u8_delta(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32)
                      - np.asarray(b, np.int32)).max())


def nonblack_share(img) -> float:
    return float((np.asarray(img)[..., :3].max(axis=-1) > 0).mean())


def read_y4m(path: str):
    """(width, height, [Y plane (H, W) u8 per frame]) of a 4:4:4 y4m
    file as output.Y4MSink writes it."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"\n")
    fields = head.split()
    check(fields[0] == b"YUV4MPEG2", f"{path}: not a y4m file")
    w = int(next(x[1:] for x in fields if x.startswith(b"W")))
    h = int(next(x[1:] for x in fields if x.startswith(b"H")))
    frame = len(b"FRAME\n") + 3 * w * h
    check(len(body) % frame == 0, f"{path}: truncated frame")
    planes = []
    for i in range(len(body) // frame):
        chunk = body[i * frame:(i + 1) * frame]
        check(chunk.startswith(b"FRAME\n"), f"{path}: bad frame {i}")
        planes.append(np.frombuffer(chunk[6:6 + w * h], np.uint8)
                      .reshape(h, w))
    return w, h, planes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase0(cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r})", file=sys.stderr)
        sys.exit(1)
    check(len(devs) >= cards, f"need {cards} cards, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log("phase0", jax=jax.__version__, devices=len(devs),
        device_kind=devs[0].device_kind,
        xla_flags=os.environ.get("XLA_FLAGS", ""))
    return devs


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations while
    active."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0

    def _listen(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.seconds += duration

    def __enter__(self):
        import jax
        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self._listen)


def phase1(out_dir: str):
    from cuburn_tpu.main import main as cli
    from cuburn_tpu.output import decode_png
    from cuburn_tpu.profile import get_profile
    prof = get_profile("1080p")
    png = os.path.join(out_dir, "full_feature_1080p.png")
    metrics = os.path.join(out_dir, "phase1_metrics.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    argv = ["gallery:full_feature", "--profile", "1080p", "-o", png,
            "--metrics-json", metrics]
    walls = []
    for _ in range(2):
        with CompileClock() as clock:
            t0 = time.perf_counter()
            check(cli(argv) == 0, "phase 1: CLI returned non-zero")
            walls.append((time.perf_counter() - t0, clock.seconds))
    with open(png, "rb") as f:
        img = decode_png(f.read())
    check(img.shape[:2] == (prof.height, prof.width),
          f"phase 1: PNG is {img.shape}, want {prof.width}x"
          f"{prof.height}")
    share = nonblack_share(img)
    check(share >= MIN_NONBLACK_SHARE,
          f"phase 1: only {share:.4f} of the pixels are non-black")
    cold, warm = (json.loads(line) for line in open(metrics))
    log("phase1", samples_per_sec=warm["samples_per_sec"],
        iterate_s=warm["iterate_ms"] / 1e3,
        filter_s=warm["filter_ms"] / 1e3,
        first_call_compile_s=walls[0][1],
        first_call_wall_s=walls[0][0], warm_wall_s=walls[1][0],
        cold_iterate_s=cold["iterate_ms"] / 1e3,
        cold_filter_s=cold["filter_ms"] / 1e3,
        plotted_samples=warm["plotted_samples"], nonblack_share=share)


def phase2(out_dir: str):
    from cuburn_tpu.main import main as cli
    from cuburn_tpu.profile import get_profile
    prof = get_profile("720p")
    y4m = os.path.join(out_dir, "animated_spark_720p.y4m")
    t0 = time.perf_counter()
    check(cli(["gallery:animated_spark", "--animate", "--profile",
               "720p", "--temporal-samples", "4", "--fps", "6",
               "--duration", "1", "-o", y4m]) == 0,
          "phase 2: CLI returned non-zero")
    wall = time.perf_counter() - t0
    w, h, planes = read_y4m(y4m)
    check((w, h) == (prof.width, prof.height),
          f"phase 2: frames are {w}x{h}")
    check(len(planes) == 6, f"phase 2: {len(planes)} frames, want 6")
    lit = [float((p > 0).mean()) for p in planes]
    check(min(lit) > 0.0, f"phase 2: a black frame: {lit}")
    log("phase2", frames=len(planes), wall_s=wall,
        min_nonblack_share=min(lit))


def phase3():
    import jax
    import jax.numpy as jnp

    from cuburn_tpu.models import full_feature
    from cuburn_tpu.ops import histogram as hist_mod
    from cuburn_tpu.ops.iterate import (expand_palette, init_state,
                                        iterate_step, pack_records,
                                        unpack_records, xform_cdf_rows)
    from cuburn_tpu.profile import get_profile
    from cuburn_tpu.render import Renderer

    g = full_feature()
    prof = get_profile("1080p")
    r = Renderer(g, prof)
    check(r.packed and not r.op_bits,
          "phase 3: full_feature should pack unit-opacity records")
    cam, key = r.cam, r.key
    from cuburn_tpu.ops.iterate import color_bits_for
    cbits = color_bits_for(cam.n_bins)
    params = jax.tree_util.tree_map(jnp.asarray, g.eval_at(0.0))
    cdf = xform_cdf_rows(params)
    ppu = params.ppu * jnp.float32(prof.width / g.size[0])
    batch, k = 1 << 17, 32          # 2^22 records: one default flush

    @jax.jit
    def one_flush(state):
        def step(state, _):
            state, addr, pcolor, _op = iterate_step(
                key, cam, prof.fuse, params, cdf, ppu, state)
            return state, pack_records(cbits, addr, pcolor)
        state, _ = jax.lax.scan(step, state, None, length=prof.fuse)
        _, recs = jax.lax.scan(step, state, None, length=k)
        return unpack_records(cbits, expand_palette(params.palette,
                                                    cbits), recs)

    addr, rgba = one_flush(init_state(jax.random.PRNGKey(3), batch))
    addr_np, rgba_np = np.asarray(addr), np.asarray(rgba)
    check(addr_np.size == 1 << 22, f"phase 3: {addr_np.size} records")
    ref = reference_hist(cam.n_bins, addr_np, rgba_np)
    plotted = int((addr_np != cam.junk_bin).sum())
    check(plotted > addr_np.size // 2,
          f"phase 3: only {plotted} of the records are plotted")
    for name, fn in hist_mod.BACKENDS.items():
        out = jax.jit(fn)(hist_mod.alloc(cam.n_bins), addr, rgba)
        dens_err, rgb_rel = hist_errors(out, ref)
        log("phase3", backend=name, n_bins=cam.n_bins,
            records=int(addr_np.size), plotted=plotted,
            max_density_err=dens_err, max_rgb_err_rel=rgb_rel)
        check(dens_err == 0.0,
              f"phase 3: {name} density differs by {dens_err}")
        check(rgb_rel <= RGB_REL_TOL,
              f"phase 3: {name} rgb error {rgb_rel} > {RGB_REL_TOL}")


def phase4():
    import jax

    from cuburn_tpu.models import classic_swirl, full_feature
    from cuburn_tpu.profile import RenderProfile
    from cuburn_tpu.render import Renderer

    cpu = jax.devices("cpu")[0]
    prof = RenderProfile(width=128, height=128, quality=366)

    def render(genome, seed, device=None):
        r = Renderer(genome, prof)
        if device is None:
            hist, st = r.accumulate(0.0, seed=seed)
        else:
            with jax.default_device(device):
                hist, st = r.accumulate(0.0, seed=seed)
        return r, np.asarray(hist), st

    for genome in (full_feature(), classic_swirl()):
        r, h_gpu, st = render(genome, 11)
        _, h_cpu, _ = render(genome, 11, cpu)
        _, h_cpu2, _ = render(genome, 12, cpu)
        floor = tv(h_cpu, h_cpu2)
        d = tv(h_gpu, h_cpu)
        log("phase4", genome=genome.name, samples=st.plotted_samples,
            tv_gpu_cpu=d, tv_cpu_two_seeds=floor, limit=tv_limit(floor))
        check(d <= tv_limit(floor),
              f"phase 4: {genome.name} GPU-vs-CPU TV {d} > "
              f"{tv_limit(floor)}")
    # one histogram through the filter chain (logscale, DE, downsample,
    # colorclip, u8) on both devices
    img_gpu = np.asarray(r.finalize_frame_device(h_cpu, 0.0))
    with jax.default_device(cpu):
        img_cpu = np.asarray(r.finalize_frame_device(h_cpu, 0.0))
    delta = u8_delta(img_gpu, img_cpu)
    log("phase4", filter_genome=r.genome.name, max_u8_delta=delta)
    check(delta <= 1, f"phase 4: filter GPU vs CPU differs by {delta}")


def phase5():
    from cuburn_tpu.models import full_feature
    from cuburn_tpu.profile import RenderProfile
    from cuburn_tpu.render import Renderer
    r = Renderer(full_feature(), RenderProfile(width=512, height=512,
                                               quality=200))
    (h1, _), (h2, _) = (r.accumulate(0.0, seed=5) for _ in range(2))
    h1, h2 = np.asarray(h1), np.asarray(h2)
    dens_equal = bool(np.array_equal(h1[:, 3], h2[:, 3]))
    delta = u8_delta(r.finalize_frame(h1), r.finalize_frame(h2))
    log("phase5", density_bit_equal=dens_equal, max_u8_delta=delta)
    check(dens_equal, "phase 5: density differs between two runs")
    check(delta <= 1, f"phase 5: images differ by {delta} u8 steps")


def multi_card_phase(n: int):
    """ShardedRenderer over n cards at 1080p ss2 in its three modes,
    against a single-card render of the same genome."""
    import jax

    from cuburn_tpu.models import full_feature
    from cuburn_tpu.parallel import ShardedRenderer, make_mesh
    from cuburn_tpu.profile import get_profile
    from cuburn_tpu.render import Renderer

    g, prof = full_feature(), get_profile("1080p")
    single = Renderer(g, prof)
    h_a, st_single = single.accumulate(0.0, seed=21)
    h_b, _ = single.accumulate(0.0, seed=22)
    h_a, h_b = np.asarray(h_a), np.asarray(h_b)
    floor = tv(h_a, h_b)
    limit = tv_limit(floor)
    sr = ShardedRenderer(g, prof, mesh=make_mesh(n))
    check(sr.n_devices == n, f"mesh has {sr.n_devices} devices")

    t0 = time.perf_counter()
    h_rep, st_rep = sr.accumulate(0.0, seed=21)
    img_rep = sr.finalize_frame(h_rep, 0.0, st_rep)
    t_rep = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_sc, st_sc = sr.render_frame_scattered(0.0, seed=21)
    t_sc = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_st, st_st = sr.accumulate_striped(0.0, seed=21)
    img_st = sr.finalize_frame(h_st, 0.0, st_st)
    t_st = time.perf_counter() - t0

    d_rs = u8_delta(img_rep, img_sc)
    tv_rep, tv_st = tv(h_rep, h_a), tv(h_st, h_a)
    # the scattered mode keeps no full histogram: its frame is held
    # to the replicated frame, whose histogram is held to one card
    log("multi", cards=n, tv_floor_single=floor, limit=limit,
        plotted_single=st_single.plotted_samples,
        plotted_replicated=st_rep.plotted_samples,
        plotted_scattered=st_sc.plotted_samples,
        plotted_striped=st_st.plotted_samples,
        tv_replicated_vs_single=tv_rep, tv_striped_vs_single=tv_st,
        max_u8_replicated_vs_scattered=d_rs,
        wall_s_replicated=t_rep, wall_s_scattered=t_sc,
        wall_s_striped=t_st,
        device_kind=jax.devices()[0].device_kind)
    check(st_rep.plotted_samples == st_sc.plotted_samples,
          "replicated and scattered plotted counts differ")
    check(d_rs <= 1, f"replicated vs scattered differ by {d_rs} u8")
    check(tv_rep <= limit, f"replicated TV {tv_rep} > {limit}")
    check(tv_st <= limit, f"striped TV {tv_st} > {limit}")
    check(nonblack_share(img_st) >= MIN_NONBLACK_SHARE,
          "striped frame is black")


def main(argv=None) -> int:
    args = parse_args(argv)
    devs = phase0(args.cards)
    import cuburn_tpu  # noqa: F401  (fails outside a checkout)
    from cuburn_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    if args.cards > 1:
        multi_card_phase(args.cards)
    else:
        phase1(OUT_DIR)
        phase2(OUT_DIR)
        phase3()
        phase4()
        phase5()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
