"""Genome layer: flam3-compatible schema, splines, conversion, palettes.

JAX-side equivalent of the reference's cuburn/genome/ package
(SURVEY.md §2 layer 3).  Everything here is host-side plain Python /
numpy; device code only ever sees evaluated parameter pytrees.
"""

from cuburn_tpu.genome.spline import Spline
from cuburn_tpu.genome.specs import Genome, XForm, GenomeParams

__all__ = ["Spline", "Genome", "XForm", "GenomeParams"]
