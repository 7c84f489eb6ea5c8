"""cuburn_tpu — a fractal-flame renderer on JAX.

A from-scratch rebuild of the capabilities of stevenrobertson/cuburn
(flam3-compatible GPU fractal-flame renderer) on JAX/XLA.

Where cuburn generates per-genome CUDA at runtime (cuburn/code/iter.py,
per SURVEY.md §2b), this framework specializes a traced JAX program per
genome *structure key* and keeps every animated parameter as a runtime
array, so animation never retraces.  Where cuburn scatters plotted points
into its histogram with atomics plus a custom radix sort
(cuburn/code/sort.py), this framework accumulates with sort + segment
reduction expressed in plain XLA programs, and scales across devices
by sharding trajectories with `shard_map` and reducing histograms with
one collective.

Layering mirrors SURVEY.md §2:
  genome/   — flam3-compatible schema, splines, XML conversion, palettes,
              keyframe blending (reference layer 3: cuburn/genome/)
  ops/      — the "native" kernel layer: RNG, variations, chaos-game
              iterate, histogram accumulation, logscale / DE / colorclip
              filters (reference layer 2: cuburn/code/)
  render.py — frame pipeline orchestration (reference layer 4:
              cuburn/render.py)
  profile.py, output.py, main.py — presets, sinks, CLI (layers 5-6)
  parallel/ — multi-chip shard_map rendering + frame farm (layer 7: dist/)
  models/   — built-in genome gallery incl. the benchmark configs
"""

__version__ = "0.1.0"

from cuburn_tpu.genome.specs import Genome, XForm  # noqa: F401
