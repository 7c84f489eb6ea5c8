"""Camera: world coordinates -> supersampled accumulator addresses.

Equivalent of the camera transform inside the reference's iter kernel
(cuburn/code/iter.py plot step, SURVEY.md §3.5): apply the genome camera
(center, pixels-per-unit, rotation) to a plotted point, test bounds, and
produce a flat accumulator address.

Conventions (pinned by the golden-image tests):
  * Image row 0 is the top; world +y maps downward (flame-editor
    convention).
  * `rotate` (degrees) rotates the *image* counterclockwise, i.e. world
    points are rotated clockwise about the camera center before
    projection.
  * The accumulator is (H*ss) x (W*ss); address = py * (W*ss) + px.
    Out-of-bounds points are diverted to a junk bin at index
    (W*ss)*(H*ss) — branch-free masking, discarded at readout.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class CameraSpec:
    """Static camera geometry (part of the jit trace shape).

    `no_rotation=True` statically elides the rotation math (set by the
    Renderer when the genome's rotate spline is constantly zero — the
    common case; the trace-time equivalent of cuburn not emitting
    rotation code when unused).

    `gutter` is a border margin (in accumulator pixels) around the
    image so density-estimation blur doesn't clip at the frame edge —
    flam3's gutter (rect.c); the filter stage crops it after DE.

    `tile_row0`/`full_acc_height` make this camera a horizontal STRIPE
    of a taller frame: projection happens in FULL-frame pixel
    coordinates (identical float math to the untiled camera), then the
    integer stripe offset is subtracted — so a frame rendered as
    stripes partitions points EXACTLY as the whole-frame render would
    (Renderer.accumulate_striped; lets histograms larger than device
    memory, or larger than the fragile dev worker survives, render as
    several smaller programs)."""
    width: int          # output width, pixels
    height: int         # output height, pixels
    ss: int = 1         # supersampling factor
    no_rotation: bool = False
    gutter: int = 0
    tile_row0: int = 0          # stripe's first row in full acc pixels
    full_acc_height: int = 0    # 0 = untiled
    tile_acc_height: int = 0    # stripe's own acc rows (0 = untiled)

    @property
    def acc_width(self) -> int:
        return self.width * self.ss + 2 * self.gutter

    @property
    def acc_height(self) -> int:
        if self.tile_acc_height:
            return self.tile_acc_height
        return self.height * self.ss + 2 * self.gutter

    @property
    def n_bins(self) -> int:
        return self.acc_width * self.acc_height

    @property
    def layout_bins(self) -> int:
        """Bin count that determines the PACKED-RECORD layout
        (color/opacity bit splits): the FULL frame's, even for a
        stripe camera — a striped render must quantize palette
        coordinates at exactly the depth of the whole-frame render it
        partitions, or the histograms disagree (the stripe's smaller
        n_bins would otherwise free extra color bits)."""
        if self.full_acc_height:
            return self.acc_width * self.full_acc_height
        return self.n_bins

    @property
    def junk_bin(self) -> int:
        return self.n_bins


def project_3d(cam3d, x, y, u1=None, u2=None):
    """Apophysis-7X / Ember 3-D camera: pitch/yaw rotation of the
    z-augmented point cloud, perspective divide, depth-of-field blur.

    `cam3d` is the (5,) traced vector [yaw, pitch, perspective, zpos,
    dof] (yaw/pitch in RADIANS — the Ember/fractorium XML convention;
    genome/convert.py documents the ambiguity vs editors that write
    degrees).  Published algorithm (fractorium Ember/Renderer Proj
    templates; flam3's own tree never shipped these attrs — they are
    the Apophysis-7X extension every modern renderer honors):

        z  = pz - zpos                     (pz == 0 here: the flam3 2-D
                                            variation set never writes z,
                                            so the z=0 plane is projected
                                            — exactly what Apophysis does
                                            for 2-D flames)
        (x1, y1)  = Rz(-yaw) (x, y)        ; yaw spins about the z axis
        y2 = y1 cos(pitch) - z sin(pitch)  ; pitch tilts about the x axis
        d  = y1 sin(pitch) + z cos(pitch)  ; depth along the view axis
        zr = 1 - perspective * d
        dr = u1 * 0.1 * dof * z ; t = u2 * 2pi      (DOF, when dof != 0)
        out = ((x1 + dr cos t) / zr, (y2 + dr sin t) / zr)

    `u1`/`u2`: per-point uniforms in [0,1) for the DOF blur; None
    statically elides it (StructureKey.cam_mode < 2).  Runs BEFORE the
    2-D camera (rotate/zoom/center), matching Ember's accumulation
    order.  zr <= 0 (points at/behind the eye plane) produces inf/NaN
    or mirrored coordinates exactly like the reference; the projected
    result feeds `project`'s NaN-rejecting bounds masks.
    """
    yaw, pitch, persp, zpos, dof = (cam3d[i] for i in range(5))
    z = -zpos
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    x1 = x * cy + y * sy
    y1 = y * cy - x * sy
    y2 = y1 * cp - z * sp
    depth = y1 * sp + z * cp
    zr = 1.0 - persp * depth
    if u1 is not None:
        dr = u1 * (np.float32(0.1) * dof * z)
        t = u2 * np.float32(2.0 * np.pi)
        x1 = x1 + dr * jnp.cos(t)
        y2 = y2 + dr * jnp.sin(t)
    return x1 / zr, y2 / zr


def project(spec: CameraSpec, center, ppu, rotate_deg, x, y,
            tile_row0=None, rot_center=None):
    """World point arrays -> (addr (int32), in_bounds (bool)).

    `ppu` is the genome's pixels-per-unit at *nominal* resolution; the
    caller pre-scales it by (render_width / genome_width) so profiles can
    re-render at any resolution (reference: profile-applied camera,
    cuburn/profile.py).

    `rot_center` (flam3 `rot_center` attr): the world point the
    rotation pivots on; None/same-as-center = flam3's default (rotate
    about the image center).  The image window stays centered on
    `center` either way — only the pivot of the spin moves.

    `tile_row0` (traced int32) overrides spec.tile_row0 so every stripe
    of a striped render shares ONE compiled program.
    """
    if spec.no_rotation:
        rx = x - center[0]
        ry = y - center[1]
    else:
        rc = center if rot_center is None else rot_center
        dx = x - rc[0]
        dy = y - rc[1]
        theta = -rotate_deg * np.float32(np.pi / 180.0)
        ct, st = jnp.cos(theta), jnp.sin(theta)
        # rotate about rot_center, then translate so the window is
        # still centered on `center`
        rx = ct * dx - st * dy + (rc[0] - center[0])
        ry = st * dx + ct * dy + (rc[1] - center[1])
    ppu_ss = ppu * np.float32(spec.ss)
    full_h = spec.full_acc_height or spec.acc_height
    px = rx * ppu_ss + np.float32(spec.acc_width * 0.5)
    py = ry * ppu_ss + np.float32(full_h * 0.5)
    row0 = spec.tile_row0 if tile_row0 is None else tile_row0
    # bounds on the FLOAT coordinates: the final xform can emit
    # NaN/Inf (iterate_step's badvalue guard runs before it), and
    # f32->int32 of NaN is implementation-defined (often 0 — a
    # hot-corner artifact at pixel (0,0)); NaN fails every float
    # comparison, so these masks reject it before the cast matters
    row0f = jnp.asarray(row0, px.dtype) if not isinstance(row0, int) \
        else np.float32(row0)
    in_bounds = ((px >= 0) & (px < spec.acc_width) &
                 (py >= row0f) & (py < row0f + spec.acc_height))
    ix = jnp.floor(px).astype(jnp.int32)
    iy = jnp.floor(py).astype(jnp.int32) - row0
    addr = jnp.where(in_bounds, iy * spec.acc_width + ix, spec.junk_bin)
    return addr, in_bounds
