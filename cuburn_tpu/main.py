"""CLI front end.

Equivalent of the reference's main.py (SURVEY.md §2 layer 6): load or
convert a genome, pick a profile, drive the render loop, write outputs.

    cuburn-tpu genome.flam3 -o out.png --profile preview
    cuburn-tpu gallery:sierpinski -o out.png
    cuburn-tpu anim.json -o out.y4m --animate --profile 720p
    cuburn-tpu genome.flam3 --convert            # flam3 XML -> JSON
"""

from __future__ import annotations

import argparse
import json

import sys
import time

from cuburn_tpu.compile_cache import enable_compile_cache
from cuburn_tpu.ops.histogram import BACKENDS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuburn-tpu",
        description="JAX fractal flame renderer "
                    "(flam3/cuburn-compatible)")
    p.add_argument("genome",
                   help="genome file (.flam3/.flame XML or .json), or "
                        "gallery:<name>")
    p.add_argument("-o", "--output", default="out.png",
                   help="output path (.png/.jpg still, .y4m/.mp4 video)")
    p.add_argument("--profile", default="preview",
                   help="render profile name")
    p.add_argument("--width", type=int, help="override profile width")
    p.add_argument("--height", type=int, help="override profile height")
    p.add_argument("--quality", type=int,
                   help="override samples per output pixel")
    p.add_argument("--ss", type=int, help="override supersampling")
    p.add_argument("--time", type=float, default=0.0,
                   help="genome time for stills")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-overlap", action="store_true",
                   help="disable cross-frame pipeline overlap in "
                        "--animate (overlap yields the same frames; "
                        "disable only for per-frame device timings)")
    p.add_argument("--animate", action="store_true",
                   help="render the full time range as video")
    p.add_argument("--temporal-samples", type=int,
                   help="genome evaluations per frame (motion blur)")
    p.add_argument("--fps", type=float,
                   help="override profile frames per second")
    p.add_argument("--duration", type=float,
                   help="override animation duration in seconds")
    p.add_argument("--hist-backend", choices=["auto", *sorted(BACKENDS)],
                   help="histogram accumulation backend")
    p.add_argument("--no-de", action="store_true",
                   help="disable density-estimation filtering")
    p.add_argument("--blend", metavar="GENOME2",
                   help="build an animated edge genome sweeping from "
                        "GENOME to GENOME2 (use with --animate)")
    p.add_argument("--no-harmonize", action="store_true",
                   help="skip sequence structure harmonization (one "
                        "compile per edge instead of one total; keeps "
                        "packed opacity records when padding would "
                        "overflow their bit budget)")
    p.add_argument("--loops", type=float, default=0.0,
                   help="insert a loop segment per keyframe in"
                        " sequences: animate-flagged xforms spin this"
                        " many turns in place (flam3-animate loops)")
    p.add_argument("--blend-spin", type=float, default=0.0,
                   help="extra full camera rotations across the edge")
    p.add_argument("--convert", action="store_true",
                   help="convert genome to cuburn-tpu JSON and exit")
    p.add_argument("--flame-index", type=int, default=0,
                   help="which <flame> to use from a multi-flame file")
    p.add_argument("--stats", action="store_true",
                   help="print per-frame render statistics")
    p.add_argument("--metrics-json",
                   help="append one JSON metrics record per frame to "
                        "this file (SURVEY.md §5 observability)")
    p.add_argument("--devices", type=int,
                   help="shard the frame across N local devices "
                        "(trajectory DP + one histogram reduce)")
    p.add_argument("--reduce-scatter", action="store_true",
                   help="with --devices N: reduce-scatter the "
                        "histogram instead of replicating it (each "
                        "device owns only its filter band's block — "
                        "~half the interconnect bytes, 1/n residency; stills "
                        "and animations, incl. motion blur; no "
                        "checkpoints/stripes/bands)")
    p.add_argument("--save-hist",
                   help="write the raw f32 accumulation histogram to "
                        "this .npy (checkpoint for high-quality stills)")
    p.add_argument("--resume-hist",
                   help="resume accumulation from a saved histogram")
    p.add_argument("--stripes", type=int, default=0,
                   help="render the frame as N horizontal sub-programs"
                        " (exact partition; for frames whose histogram"
                        " exceeds device limits)")
    p.add_argument("--bands", type=int, default=0,
                   help="filter the frame as N horizontal sub-programs"
                        " (pairs with --stripes for frames whose full"
                        " filter program exceeds device limits)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU backend")
    p.add_argument("--trace-dir",
                   help="capture a jax.profiler trace (Perfetto) of the "
                        "render into this directory")
    p.add_argument("--cam-angle-units", default="",
                   choices=("", "degrees", "radians"),
                   help="how to read cam_yaw/cam_pitch in flam3 XML "
                        "(default: the file's cam_angle_units attr, "
                        "else radians with a >2*pi magnitude warning)")
    return p


def _append_metrics(path, record):
    import json as _json
    with open(path, "a") as f:
        f.write(_json.dumps(record) + "\n")


def _stats_record(frame_idx, t, stats):
    return {
        "frame": frame_idx, "time": t,
        "plotted_samples": stats.plotted_samples,
        "total_iters": stats.total_iters,
        "retention": round(stats.retention, 4),
        "samples_per_sec": round(stats.samples_per_sec, 1),
        "iterate_ms": round(stats.iterate_s * 1e3, 2),
        "filter_ms": round(stats.filter_s * 1e3, 2),
    }


def load_genome(spec: str, index: int, angle_units: str = ""):
    from cuburn_tpu.genome.convert import load_genomes
    from cuburn_tpu.models import get_genome
    if spec.startswith("gallery:"):
        try:
            return get_genome(spec.split(":", 1)[1])
        except ValueError as e:
            raise SystemExit(str(e))
    if spec.startswith("random:"):
        # flam3-genome-style deterministic random flame
        from cuburn_tpu.genome.randgen import random_genome
        try:
            seed_val = int(spec.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"random:<seed> needs an integer, "
                             f"got {spec!r}")
        return random_genome(seed_val)
    try:
        genomes = load_genomes(spec, angle_units=angle_units)
    except FileNotFoundError:
        raise SystemExit(f"genome file not found: {spec}")
    except Exception as e:
        raise SystemExit(f"could not parse {spec}: "
                         f"{type(e).__name__}: {e}")
    if not genomes:
        raise SystemExit(f"no genomes found in {spec}")
    if index >= len(genomes):
        raise SystemExit(
            f"flame index {index} out of range ({len(genomes)} found)")
    return genomes[index]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    genome = load_genome(args.genome, args.flame_index,
                         angle_units=args.cam_angle_units)
    sequence = None
    if args.blend:
        from cuburn_tpu.genome.blend import blend_genomes
        target = load_genome(args.blend, 0,
                             angle_units=args.cam_angle_units)
        genome = blend_genomes(genome, target, spin=args.blend_spin)
    elif (args.animate and not args.convert
          and not args.genome.startswith("gallery:")):
        # multi-flame file + --animate = keyframe sequence (the
        # flam3-animate workflow): blend consecutive stills into
        # edges (skipped under --convert, which exits before
        # rendering — harmonizing a sequence just to discard it costs
        # a structure-key pass per edge)
        from cuburn_tpu.genome.convert import load_genomes
        try:
            all_genomes = load_genomes(
                args.genome, angle_units=args.cam_angle_units)
        except Exception:
            all_genomes = []
        if len(all_genomes) > 1:
            from cuburn_tpu.genome.blend import blend_sequence
            sequence = blend_sequence(all_genomes, spin=args.blend_spin,
                                      loops=args.loops,
                                      harmonize=not args.no_harmonize)

    if args.convert:
        print(genome.to_json())
        return 0

    if args.animate and (args.save_hist or args.resume_hist
                         or args.time):
        # these drive the still path only; silently ignoring a
        # checkpoint request is worse than refusing it
        raise SystemExit(
            "--save-hist/--resume-hist/--time apply to stills; "
            "they have no effect with --animate")
    if args.reduce_scatter:
        if not (args.devices and args.devices > 1):
            raise SystemExit("--reduce-scatter requires --devices N>1")
        if (args.stripes > 1 or args.bands > 1
                or args.save_hist or args.resume_hist):
            raise SystemExit(
                "--reduce-scatter is incompatible with stripes/bands/"
                "checkpoints — each chip never holds a full "
                "histogram")

    from cuburn_tpu import output as output_mod
    from cuburn_tpu.profile import get_profile
    from cuburn_tpu.render import Renderer

    overrides = {}
    for field in ("width", "height", "quality", "ss"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    if args.temporal_samples is not None:
        overrides["temporal_samples"] = args.temporal_samples
    if args.fps is not None:
        overrides["fps"] = args.fps
    if args.duration is not None:
        overrides["duration"] = args.duration
    if args.hist_backend is not None:
        overrides["hist_backend"] = args.hist_backend
    if args.no_de:
        overrides["de_enabled"] = False
    prof = get_profile(args.profile, **overrides)

    if args.devices and args.devices > 1:
        from cuburn_tpu.parallel import ShardedRenderer, make_mesh
        renderer = ShardedRenderer(genome, prof,
                                   mesh=make_mesh(args.devices))
    else:
        renderer = Renderer(genome, prof)

    trace_ctx = None
    if args.trace_dir:
        import jax
        jax.profiler.start_trace(args.trace_dir)
        trace_ctx = args.trace_dir

    # stop_trace in a finally: a mid-render failure (an error,
    # Ctrl-C) must still flush the partial Perfetto
    # trace -- exactly when it is most useful
    try:
        if args.animate:
            sink = output_mod.make_video_sink(
                args.output, prof.width, prof.height, prof.fps)
            n = 0
            t0 = time.time()

            def run_frames(r, seed):
                # frames_partitioned degenerates to frames() when neither
                # partition count exceeds 1; unpartitioned animations
                # default to the cross-frame overlapped driver (identical
                # images, device never waits on encode) — sharded
                # renderers included: their finalize_frame_device routes
                # through the collective band filter
                overlap = not args.no_overlap
                if args.reduce_scatter:
                    if overlap:
                        return r.frames_overlapped_scattered(seed=seed)
                    return ((r.render_frame_scattered(t, seed=seed + i))
                            for i, t in r.frame_times())
                return r.frames_partitioned(
                    seed=seed, n_stripes=args.stripes, n_bands=args.bands,
                    overlap=overlap)

            def frame_iter():
                if sequence is None:
                    yield from run_frames(renderer, args.seed)
                    return
                import dataclasses as _dc
                total_len = sequence[-1][2] - sequence[0][1]
                total_s = prof.duration or 2.0 * len(sequence)
                for k, (edge, s, e) in enumerate(sequence):
                    # segment wall time proportional to its keyframe span
                    # (flam3 `time` attributes set the spacing)
                    seg_prof = _dc.replace(
                        prof, duration=total_s * (e - s) / total_len)
                    seg_renderer = (type(renderer))(edge, seg_prof) \
                        if not hasattr(renderer, "mesh") else \
                        type(renderer)(edge, seg_prof, mesh=renderer.mesh)
                    frames = run_frames(seg_renderer, args.seed + k)
                    if k > 0:
                        # each edge spans [0, 1] inclusive and edge k's
                        # t=1 pose IS edge k+1's t=0 pose — dropping the
                        # first frame of every later segment avoids one
                        # stuttered duplicate frame per interior keyframe
                        next(frames, None)
                    yield from frames

            try:
                for img, stats in frame_iter():
                    sink.write_frame(img)
                    n += 1
                    if args.stats:
                        print(f"frame {n}: {stats.samples_per_sec/1e6:.1f} "
                              f"Msamples/s, retention "
                              f"{stats.retention:.2f}", file=sys.stderr)
                    if args.metrics_json:
                        _append_metrics(args.metrics_json,
                                        _stats_record(n, None, stats))
            finally:
                sink.close()
            dt = time.time() - t0
            print(f"wrote {n} frames to {args.output} in {dt:.1f}s "
                  f"({n / max(dt, 1e-9):.2f} fps)")
        else:
            import numpy as np
            if args.resume_hist and args.stripes and args.stripes > 1:
                raise SystemExit(
                    "--resume-hist is not supported with --stripes "
                    "(striped accumulation rebuilds the histogram "
                    "from scratch)")
            hist0 = None
            if args.resume_hist:
                try:
                    hist0 = np.load(args.resume_hist)
                except FileNotFoundError:
                    raise SystemExit(
                        f"resume histogram not found: {args.resume_hist}")
            def finalize(hist, stats):
                if args.bands and args.bands > 1:
                    return renderer.finalize_frame_banded(
                        hist, args.time, stats, n_bands=args.bands)
                return renderer.finalize_frame(hist, args.time, stats)

            if args.stripes and args.stripes > 1:
                hist, stats = renderer.accumulate_striped(
                    args.time, args.seed, n_stripes=args.stripes)
                if args.save_hist:
                    np.save(args.save_hist, np.asarray(hist))
                img = finalize(hist, stats)
            elif args.save_hist or args.resume_hist or args.bands > 1:
                hist, stats = renderer.accumulate(args.time, args.seed,
                                                  hist0=hist0)
                if args.save_hist:
                    np.save(args.save_hist, np.asarray(hist))
                img = finalize(hist, stats)
            elif args.reduce_scatter:
                img, stats = renderer.render_frame_scattered(
                    args.time, seed=args.seed)
            else:
                img, stats = renderer.render_frame(args.time,
                                                   seed=args.seed)
            output_mod.write_image(args.output, img)
            if args.stats:
                print(f"iterate {stats.iterate_s*1e3:.1f} ms "
                      f"({stats.samples_per_sec/1e6:.1f} Msamples/s, "
                      f"retention {stats.retention:.2f}); "
                      f"filters {stats.filter_s*1e3:.1f} ms",
                      file=sys.stderr)
            if args.metrics_json:
                _append_metrics(args.metrics_json,
                                _stats_record(0, args.time, stats))
            print(f"wrote {args.output}")

    finally:
        if trace_ctx:
            import jax
            jax.profiler.stop_trace()
            print(f"trace written to {trace_ctx}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
