"""Device ops: the JAX equivalent of cuburn's generated CUDA layer.

Reference mapping (SURVEY.md §2b native-component checklist):
  rng.py        <- cuburn/code/mwc.py        (per-trajectory RNG streams)
  variations.py <- cuburn/code/variations.py (flam3 variation bodies)
  xform.py      <- cuburn/code/iter.py apply_xf_* (gather-based, branch-free)
  iterate.py    <- cuburn/code/iter.py iter kernel (chaos game loop)
  histogram.py  <- cuburn/code/sort.py + write kernel (accumulation)
  camera.py     <- iter.py camera transform
  filtering.py  <- cuburn/code/filtering.py (logscale, DE, colorclip)
  interp.py     <- cuburn/code/interp.py (packed-knot spline evaluation)
"""
