"""Intra-frame multi-chip rendering: shard_map over a device mesh.

JAX replacement for the reference's single-GPU-per-frame model
(SURVEY.md §2b parallelism table, last row): instead of farming whole
frames, a frame's trajectory batch is sharded across every chip of a
`jax.sharding.Mesh`; each chip runs the identical chaos-game program on
its shard and accumulates a *local* partial histogram; one `psum` over
the interconnect per frame (not per chunk!) produces the full histogram.  The filter
stages then run on the (replicated) histogram.

This is the renderer's entire collective footprint — the histogram
reduce (SURVEY.md §2b distributed-communication row).

The chunk loop lives *inside* the shard_map region so partial
histograms never masquerade as replicated values between calls; the
reduction happens exactly once, on the way out.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuburn_tpu.genome.specs import Genome, StructureKey

from cuburn_tpu.ops import histogram as hist_mod
from cuburn_tpu.ops.camera import CameraSpec
from cuburn_tpu.ops.iterate import (IterState, init_state,
                                    iterate_accumulate,
                                    iterate_accumulate_temporal,
                                    xform_cdf_rows)
from cuburn_tpu.profile import RenderProfile

BATCH_AXIS = "batch"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the first n (default all) local devices.

    Trajectory parallelism is the data parallelism of this problem
    (SURVEY.md §2b): a 1-D axis suffices.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (BATCH_AXIS,))


@functools.partial(
    jax.jit,
    static_argnames=("key", "cam", "backend", "mesh",
                     "n_iters", "fuse", "packed", "op_bits"))
def sharded_accumulate(
    key: StructureKey,
    cam: CameraSpec,
    backend: str,
    mesh: Mesh,
    params,
    cdf_rows,
    state: IterState,
    hist,
    ppu,
    n_chunks: int,
    n_iters: int,
    fuse: int,
    packed: bool = True,
    tile_row0=None,
    op_bits: int = 0,
    weight=None,
):
    """Run n_chunks x n_iters chaos-game steps across the mesh.

    state is sharded on the batch axis; params/hist are replicated.
    Returns (state', hist', plotted_count) with hist' fully reduced
    (replicated) — the one collective per call.

    `n_chunks` is TRACED (as on one chip): quality or dispatch-cap
    changes must not recompile the multi-chip program.
    """
    if tile_row0 is None:
        tile_row0 = jnp.int32(0)
    n_chunks = jnp.int32(n_chunks)
    w = jnp.float32(1.0) if weight is None \
        else jnp.asarray(weight, jnp.float32)

    def device_body(params, cdf_rows, state, hist, ppu, tile_row0,
                    n_chunks, w):
        # accumulate into ZEROS and add the (replicated) input hist
        # after the psum: summing the input replica n_devices times
        # would multiply resumed checkpoint mass by the mesh size.
        state, delta, n = iterate_accumulate(
            key, cam, backend, params, cdf_rows, state,
            jnp.zeros_like(hist), ppu, n_chunks, n_iters, fuse,
            packed=packed, weight=w, tile_row0=tile_row0,
            op_bits=op_bits)
        # the single collective: reduce the partial histograms
        hist = hist + jax.lax.psum(delta, BATCH_AXIS)
        plotted = jax.lax.psum(n, BATCH_AXIS)
        return state, hist, plotted

    # check_vma=False: the replicated zero histogram and plot counter
    # become device-varying inside iterate_accumulate's private loop
    # carries; the explicit psums above restore replication on the way
    # out, which the static vma checker can't see through the shared
    # single-chip code path.
    shard = jax.shard_map(
        device_body, mesh=mesh,
        in_specs=(P(), P(), P(BATCH_AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(BATCH_AXIS), P(), P()),
        check_vma=False,
    )
    return shard(params, cdf_rows, state, hist, ppu, tile_row0,
                 n_chunks, w)


@functools.partial(
    jax.jit,
    static_argnames=("key", "cam", "backend", "mesh",
                     "n_iters", "fuse", "packed", "op_bits"))
def sharded_accumulate_temporal(
    key: StructureKey,
    cam: CameraSpec,
    backend: str,
    mesh: Mesh,
    params_T,                 # every leaf has leading temporal axis T
    state: IterState,
    hist,
    ppu_T,                    # (T,)
    weights_T,                # (T,) temporal-filter weights
    n_chunks: int,
    n_iters: int,
    fuse: int,
    packed: bool = True,
    tile_row0=None,
    op_bits: int = 0,
):
    """Motion-blurred frame across the mesh in ONE dispatch: every
    temporal sample's accumulation happens inside the shard_map region
    (device-side scan over interpolated params), with one psum on the
    way out — the same single-collective contract as
    sharded_accumulate.

    `n_chunks` is TRACED, as in sharded_accumulate."""
    if tile_row0 is None:
        tile_row0 = jnp.int32(0)
    n_chunks = jnp.int32(n_chunks)

    def device_body(params_T, state, hist, ppu_T, weights_T,
                    tile_row0, n_chunks):
        # zeros + add-after-psum: see sharded_accumulate (resumed
        # checkpoint mass must not be multiplied by the mesh size)
        state, delta, n = iterate_accumulate_temporal(
            key, cam, backend, params_T, state, jnp.zeros_like(hist),
            ppu_T, n_chunks, n_iters, fuse, packed=packed,
            weights_T=weights_T, tile_row0=tile_row0, op_bits=op_bits)
        hist = hist + jax.lax.psum(delta, BATCH_AXIS)
        plotted = jax.lax.psum(n, BATCH_AXIS)
        return state, hist, plotted

    shard = jax.shard_map(
        device_body, mesh=mesh,
        in_specs=(P(), P(BATCH_AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(BATCH_AXIS), P(), P()),
        check_vma=False,
    )
    return shard(params_T, state, hist, ppu_T, weights_T, tile_row0,
                 n_chunks)


@functools.partial(
    jax.jit,
    static_argnames=("key", "cam", "backend", "mesh", "n_iters",
                     "fuse", "packed", "op_bits", "band_rows", "margin",
                     "pad_bot"))
def sharded_accumulate_scattered(
    key: StructureKey,
    cam: CameraSpec,
    backend: str,
    mesh: Mesh,
    params,
    cdf_rows,
    state: IterState,
    myblocks,                 # (n, block_rows, acc_w, 4) P(BATCH_AXIS)
    ppu,
    n_chunks: int,
    n_iters: int,
    fuse: int,
    band_rows: int,
    margin: int,
    pad_bot: int,
    packed: bool = True,
    op_bits: int = 0,
    weight=None,
):
    """sharded_accumulate with a reduce-scatter instead of the psum:
    device k ends up owning ONLY the reduced rows its filter band
    needs (band k's acc rows ± the DE/spatial margin, baked into the
    block slicing so no halo exchange is ever required).

    Interconnect cost is ~half the replicated psum's (reduce-scatter
    moves (n-1)/n of the array once vs psum's 2(n-1)/n), and the
    post-reduction per-chip residency is ~1/n of the histogram — the
    ROADMAP.md multi-chip alternative for replica-sized frames
    (138 MB/chip at 1080p ss2).  The pre-reduction delta is still
    full-size per chip: trajectory sharding lets any chip plot
    anywhere, so that term is inherent to the decomposition.

    Exactness: block k of the scatter equals rows of psum(delta) —
    with unit `weight`, density (integer counts in f32) is exact; RGB
    may differ from the replicated path only by f32 reduction-order
    ulps.  A non-unit `weight` (the temporal per-chunk fallback's
    flam3 filter weight) scales the whole delta, so density then
    carries the same ulp-level reassociation caveat as RGB.

    `n_chunks` is TRACED, as in sharded_accumulate."""
    n = mesh.devices.size
    n_chunks = jnp.int32(n_chunks)
    w = jnp.float32(1.0) if weight is None \
        else jnp.asarray(weight, jnp.float32)

    scatter_delta = _make_block_scatter(cam, n, band_rows, margin,
                                        pad_bot)

    def device_body(params, cdf_rows, state, myblock, ppu, n_chunks,
                    w):
        zero = hist_mod.alloc(cam.n_bins)
        state, delta, n_plot = iterate_accumulate(
            key, cam, backend, params, cdf_rows, state, zero, ppu,
            n_chunks, n_iters, fuse, packed=packed, weight=w,
            op_bits=op_bits)
        mine = scatter_delta(delta)
        plotted = jax.lax.psum(n_plot, BATCH_AXIS)
        return state, (myblock[0] + mine)[None], plotted

    shard = jax.shard_map(
        device_body, mesh=mesh,
        in_specs=(P(), P(), P(BATCH_AXIS), P(BATCH_AXIS), P(), P(),
                  P()),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P()),
        check_vma=False,
    )
    return shard(params, cdf_rows, state, myblocks, ppu, n_chunks, w)


def _make_block_scatter(cam, n, band_rows, margin, pad_bot):
    """The scattered modes' shared reduction: slice the local delta
    into the n overlapping filter-context blocks and psum_scatter so
    device k receives reduced block k."""
    acc_h, acc_w = cam.acc_height, cam.acc_width
    block_rows = band_rows + 2 * margin
    gutter = cam.gutter

    def scatter_delta(delta):
        img = delta[:cam.n_bins].reshape(acc_h, acc_w, 4)
        img = jnp.pad(img, ((margin, pad_bot), (0, 0), (0, 0)))
        # block k = the padded rows band k's filter needs (the same
        # slice the replicated finalize takes from the full replica)
        blocks = jnp.stack([
            jax.lax.dynamic_slice(
                img, (gutter + k * band_rows, 0, 0),
                (block_rows, acc_w, 4))
            for k in range(n)])
        return jax.lax.psum_scatter(blocks, BATCH_AXIS,
                                    scatter_dimension=0)

    return scatter_delta


@functools.partial(
    jax.jit,
    static_argnames=("key", "cam", "backend", "mesh", "n_iters",
                     "fuse", "packed", "op_bits", "band_rows", "margin",
                     "pad_bot"))
def sharded_accumulate_temporal_scattered(
    key: StructureKey,
    cam: CameraSpec,
    backend: str,
    mesh: Mesh,
    params_T,
    state: IterState,
    myblocks,
    ppu_T,
    weights_T,
    n_chunks: int,
    n_iters: int,
    fuse: int,
    band_rows: int,
    margin: int,
    pad_bot: int,
    packed: bool = True,
    op_bits: int = 0,
):
    """sharded_accumulate_temporal with the reduce-scatter reduction:
    motion blur through the scattered mode, one dispatch, one
    psum_scatter on the way out."""
    n = mesh.devices.size
    n_chunks = jnp.int32(n_chunks)
    scatter_delta = _make_block_scatter(cam, n, band_rows, margin,
                                        pad_bot)

    def device_body(params_T, state, myblock, ppu_T, weights_T,
                    n_chunks):
        zero = hist_mod.alloc(cam.n_bins)
        state, delta, n_plot = iterate_accumulate_temporal(
            key, cam, backend, params_T, state, zero, ppu_T,
            n_chunks, n_iters, fuse, packed=packed,
            weights_T=weights_T, op_bits=op_bits)
        mine = scatter_delta(delta)
        plotted = jax.lax.psum(n_plot, BATCH_AXIS)
        return state, (myblock[0] + mine)[None], plotted

    shard = jax.shard_map(
        device_body, mesh=mesh,
        in_specs=(P(), P(BATCH_AXIS), P(BATCH_AXIS), P(), P(), P()),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS), P()),
        check_vma=False,
    )
    return shard(params_T, state, myblocks, ppu_T, weights_T,
                 n_chunks)


from cuburn_tpu.render import Renderer


class ShardedRenderer(Renderer):
    """Multi-chip render.Renderer: same API and output contract, but
    the per-frame accumulation shards trajectories across every chip of
    the mesh and reduces partial histograms with one psum.

    Scaling model per SURVEY.md §5 long-context row: each chip owns a
    full histogram replica (HBM-resident), trajectories shard across
    chips, psum once per accumulate call."""

    def __init__(self, genome: Genome, profile: RenderProfile,
                 mesh: Optional[Mesh] = None):
        super().__init__(genome, profile)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = int(self.mesh.devices.size)
        if profile.batch % self.n_devices:
            raise ValueError(
                f"batch {profile.batch} must divide over "
                f"{self.n_devices} devices")

    def _halved_batch(self, iters: float) -> int:
        """The base renderer's trajectory-lifetime batch cap, with a
        per-device floor AND divisibility kept (halving 8200 over 8
        devices would otherwise break the P(BATCH_AXIS) sharding)."""
        prof = self.profile
        batch = prof.batch
        min_life = 8 * max(prof.fuse, 1)
        while (batch > 1024 * self.n_devices
               and iters / batch < min_life
               and (batch // 2) % self.n_devices == 0):
            batch //= 2
        return batch

    def _chunked_cap_loop(self, params, carry, seed: int, iters: float,
                          call):
        """The shared seed/batch/dispatch-cap chunk loop behind the
        replicated and scattered single-sample paths — ONE copy of the
        cap derivation so the two modes can't drift.  `call(params,
        cdf_rows, state, carry, ppu, k)` -> (state, carry', n)
        (n_chunks is traced, so all capped calls share one compiled
        program)."""
        prof = self.profile
        cdf_rows = xform_cdf_rows(params)
        batch = self._halved_batch(iters)
        state = init_state(jax.random.PRNGKey(seed), batch)
        state = jax.device_put(
            state, NamedSharding(self.mesh, P(BATCH_AXIS)))
        ppu = params.ppu * jnp.float32(
            prof.width / self.genome.size[0])
        per_chunk = batch * prof.iters_per_chunk
        n_chunks = max(1, int(np.ceil(iters / per_chunk)))
        cap = (max(1, prof.dispatch_iter_cap // per_chunk)
               if prof.dispatch_iter_cap else n_chunks)
        plotted = jnp.float32(0.0)
        left = n_chunks
        while left > 0:
            k = min(left, cap)
            state, carry, n = call(params, cdf_rows, state, carry,
                                   ppu, k)
            plotted = plotted + n
            left -= k
        return carry, plotted, n_chunks * per_chunk

    def _accumulate_sample(self, params, hist, seed: int, iters: float,
                           tile_row0=None):
        def call(params, cdf_rows, state, hist, ppu, k):
            return sharded_accumulate(
                key, cam, self.backend, self.mesh, params, cdf_rows,
                state, hist, ppu, k, prof.iters_per_chunk,
                prof.fuse, packed=self.packed, tile_row0=tile_row0,
                op_bits=self.op_bits)
        prof, cam, key = self.profile, self.cam, self.key
        return self._chunked_cap_loop(params, hist, seed, iters, call)

    def accumulate_striped(self, t: float = 0.0, seed: int = 0,
                           n_stripes: Optional[int] = None):
        """Stripe-PARALLEL accumulation: each chip renders a different
        horizontal stripe of the frame from the SAME trajectory stream
        (replicated state, per-chip tile_row0), so the histogram needs
        NO collective — stripes are disjoint bins, stitched on host.

        Where single-chip striping costs n_stripes x the iterate time,
        here the n chips absorb it: a frame too big for one device
        renders in ~one whole-frame time on n chips.  Bit-identical to
        Renderer.accumulate_striped with the same seed."""
        from cuburn_tpu.render import FrameStats, _to_device
        prof, cam = self.profile, self.cam
        n = n_stripes if n_stripes is not None else self.n_devices
        if n != self.n_devices:
            # stripe-parallel wants one stripe per chip; other counts
            # run stripes sequentially with trajectory sharding
            return super().accumulate_striped(t, seed, n_stripes=n)
        ts_times, ts_weights, _sf = self._temporal_times(t)
        if len(ts_times) > 1:
            # motion blur: fall back to sequential stripes, each
            # sharding trajectories across the mesh
            return super().accumulate_striped(t, seed, n_stripes=n)
        stats = FrameStats()
        full_h = cam.acc_height
        th = -(-full_h // n)
        scam = CameraSpec(
            prof.width, prof.height, prof.ss,
            no_rotation=cam.no_rotation, gutter=cam.gutter,
            full_acc_height=full_h, tile_acc_height=th)
        import time as _time
        t0 = _time.perf_counter()
        params = _to_device(self.genome.eval_at(ts_times[0]))
        cdf_rows = xform_cdf_rows(params)
        # the base renderer's EXACT trajectory-lifetime halving rule
        # (no per-device floor: the stream here is REPLICATED, not
        # sharded) — required for the bit-identity contract below
        batch = prof.batch
        min_life = 8 * max(prof.fuse, 1)
        while batch > 1024 and prof.total_iters / batch < min_life:
            batch //= 2
        state = init_state(jax.random.PRNGKey(seed * 7919), batch)
        hist0 = hist_mod.alloc(scam.n_bins)
        n_chunks = max(1, int(np.ceil(
            prof.total_iters / (batch * prof.iters_per_chunk))))
        key, backend, packed, ob = (self.key, self.backend,
                                    self.packed, self.op_bits)
        ppu = params.ppu * jnp.float32(prof.width / self.genome.size[0])
        ipc, fuse = prof.iters_per_chunk, prof.fuse

        def device_body(params, cdf_rows, state, hist, ppu):
            row0 = jax.lax.axis_index(BATCH_AXIS) * th
            state, hist, n_plot = iterate_accumulate(
                key, scam, backend, params, cdf_rows, state, hist,
                ppu, jnp.int32(n_chunks), ipc, fuse, packed=packed,
                tile_row0=row0.astype(jnp.int32), op_bits=ob)
            return hist[None], n_plot[None]

        shard = jax.shard_map(
            device_body, mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
            check_vma=False,
        )
        hists, plots = shard(params, cdf_rows, state, hist0, ppu)
        # stitch ON DEVICE (render._merge_stripe): host-side assembly
        # cost a D2H per stripe + a full re-upload before filtering
        from cuburn_tpu.render import _merge_stripe
        pad_rows = max(cam.n_bins + 1, n * th * cam.acc_width)
        full = jnp.zeros((pad_rows, 4), jnp.float32)
        for s in range(n):
            rows = min(th, full_h - s * th)
            full = _merge_stripe(full, hists[s][:scam.n_bins],
                                 jnp.int32(s * th), jnp.int32(rows),
                                 cam.acc_width)
        full = full[:cam.n_bins + 1]
        jax.block_until_ready(full)
        stats.plotted_samples = int(np.asarray(plots).sum())
        stats.total_iters = n_chunks * batch * ipc * n
        stats.iterate_s = _time.perf_counter() - t0
        return full, stats

    def finalize_frame(self, hist, t: float = 0.0, stats=None):
        """Sharded filtering: after the accumulate psum every chip
        holds the full histogram, so each filters its own horizontal
        band (with enough context rows for the DE/spatial supports —
        exactly finalize_frame_banded's banding) and the u8 bands
        gather back.  No extra collective beyond the output gather;
        filter wall time scales ~1/n_devices."""
        import time as _time
        from cuburn_tpu.render import _with_alpha
        t1 = _time.perf_counter()
        out = _with_alpha(np.asarray(self.finalize_frame_device(hist,
                                                                t)))
        if stats is not None:
            stats.filter_s = _time.perf_counter() - t1
        return out

    def _band_geometry(self, de_on: bool):
        """Static per-renderer band-filter geometry shared by the
        replicated and scattered paths: (h_band, band_rows, margin,
        block_rows, pad_bot) — output rows per device, their acc rows,
        the DE+spatial context margin, the context block height, and
        the bottom padding that keeps every block slice in bounds."""
        from cuburn_tpu.render import band_margin
        prof, cam = self.profile, self.cam
        ss, g = cam.ss, cam.gutter
        h_band = -(-prof.height // self.n_devices)
        band_rows = h_band * ss
        margin = band_margin(de_on, self._static_de_r,
                             self._static_sf,
                             self.genome.spatial_filter_shape, ss)
        bot = max(margin + self.n_devices * band_rows
                  - (cam.acc_height - g), 0)
        return h_band, band_rows, margin, band_rows + 2 * margin, bot

    def finalize_frame_device(self, hist, t: float = 0.0):
        """Sharded finalize_frame WITHOUT the host readback (returns
        the u8 frame as a device array — (H, W, 3) opaque / (H, W, 4)
        transparent, see render._with_alpha) — lets the overlapped
        animation driver (frames_overlapped) pipeline the sharded
        filter exactly like the single-device one."""
        from cuburn_tpu.render import (_filter_band, _to_device,
                                       de_mod)
        prof, cam = self.profile, self.cam
        n = self.n_devices
        H, W, ss, g = prof.height, prof.width, cam.ss, cam.gutter
        h_band = -(-H // n)
        if n == 1 or h_band < 2:
            return super().finalize_frame_device(hist, t)
        params = _to_device(self.genome.eval_at(t))
        _times, _w, sumfilt = self._temporal_times(t)
        q_cell = jnp.float32(prof.quality * sumfilt
                             / (cam.ss * cam.ss))
        de_r = self._static_de_r
        de_static = de_r if de_r > 0 else 9.0
        de_on = self._de_on(params)
        sf = self._static_sf
        shape = self.genome.spatial_filter_shape
        h_band, band_rows, margin, _block, _bot = \
            self._band_geometry(de_on)
        acc_h, acc_w = cam.acc_height, cam.acc_width
        img = jnp.asarray(hist)[:-1].reshape(acc_h, acc_w, 4)
        # pad so every band's +-margin slice is in bounds
        img = jnp.pad(img, ((margin, _bot), (0, 0), (0, 0)))

        ch = 4 if prof.transparent else 3        # rgb-only readback

        def device_band(img, params, q_cell):
            k = jax.lax.axis_index(BATCH_AXIS)
            lo = g + k * band_rows - margin      # acc coords
            block = jax.lax.dynamic_slice(
                img, (lo + margin, 0, 0),
                (band_rows + 2 * margin, acc_w, 4))
            band = _filter_band(
                block, params, q_cell, ss, margin,
                g, prof.transparent, de_on, de_static, sf, shape,
                earlyclip=self.genome.earlyclip)
            return band[None, ..., :ch]          # (1, h_band, W, ch)

        shard = jax.shard_map(
            device_band, mesh=self.mesh,
            in_specs=(P(), P(), P()),
            out_specs=P(BATCH_AXIS),
            check_vma=False,
        )
        bands = shard(img, params, q_cell)       # (n, h_band, W, ch)
        return bands.reshape(n * h_band, W, ch)[:H]

    # -- reduce-scatter mode ------------------------------------------------
    # Alternative to the replicated psum (ROADMAP.md multi-chip): the
    # reduction scatters each device the exact context block its
    # filter band needs — ~half the interconnect bytes, 1/n post-reduction
    # residency, no full histogram replica ever materialized after
    # the collective.  Exact for density; RGB within reduction-order
    # ulps of the replicated path.

    def accumulate_scattered_async(self, t: float = 0.0,
                                   seed: int = 0):
        """Dispatch one frame's reduce-scatter accumulation WITHOUT
        any host sync (the throughput-mode half, mirroring
        accumulate_async).  Returns (myblocks, plotted device scalar,
        total_iters int)."""
        from cuburn_tpu.render import _to_device
        prof, cam = self.profile, self.cam
        params = _to_device(self.genome.eval_at(t))
        de_on = self._de_on(params)
        h_band, band_rows, margin, block_rows, pad_bot = \
            self._band_geometry(de_on)
        n = self.n_devices
        myblocks = jnp.zeros((n, block_rows, cam.acc_width, 4),
                             jnp.float32)
        myblocks = jax.device_put(
            myblocks, NamedSharding(self.mesh, P(BATCH_AXIS)))
        geom = (band_rows, margin, pad_bot)
        ts_times, ts_weights, _sumfilt = self._temporal_times(t)
        if len(ts_times) == 1:
            return self._scattered_single(
                params, myblocks, seed * 7919, geom)
        return self._scattered_temporal(
            ts_times, ts_weights, myblocks, seed * 7919, geom)

    def accumulate_scattered(self, t: float = 0.0, seed: int = 0):
        """One frame's accumulation with the reduce-scatter reduction.
        Returns (myblocks (n, block_rows, acc_w, 4) device array where
        row k is device k's reduced filter-context block, stats).
        Motion blur runs through the scattered temporal collective;
        histogram resume is not supported in this mode (no chip ever
        holds a full histogram — use the replicated default)."""
        import time as _time
        from cuburn_tpu.render import FrameStats as _FS
        stats = _FS()
        t0 = _time.perf_counter()
        myblocks, plotted, total = self.accumulate_scattered_async(
            t, seed)
        jax.block_until_ready(myblocks)
        stats.plotted_samples = int(np.asarray(plotted))
        stats.total_iters = total
        stats.iterate_s = _time.perf_counter() - t0
        return myblocks, stats

    def _scattered_single(self, params, myblocks, seed, geom):
        prof, cam, key = self.profile, self.cam, self.key
        band_rows, margin, pad_bot = geom

        def call(params, cdf_rows, state, blocks, ppu, k):
            return sharded_accumulate_scattered(
                key, cam, self.backend, self.mesh, params, cdf_rows,
                state, blocks, ppu, k, prof.iters_per_chunk,
                prof.fuse, band_rows, margin, pad_bot,
                packed=self.packed, op_bits=self.op_bits)
        return self._chunked_cap_loop(params, myblocks, seed,
                                      prof.total_iters, call)

    def _temporal_cap_ladder(self, ts_times, ts_weights, carry, seed,
                             iters_per_sample, call_temporal,
                             call_single):
        """The shared sample-major dispatch-cap ladder behind the
        replicated and scattered temporal paths — ONE copy of the
        uncapped / sample-group / per-chunk-fallback branching so the
        modes can't drift.  `call_temporal(p_T, ppu_s, w_s, state,
        carry, nc)` runs the in-program temporal collective on a
        sample slice; `call_single(params_k, cdf_k, state, carry,
        ppu_k, c, w_k)` runs the weighted plain collective for the
        per-chunk fallback (sample-major state threading makes every
        split identical to the uncapped execution)."""
        from cuburn_tpu.ops.interp import pack_genome
        prof = self.profile
        if not hasattr(self, "_packed_genome"):
            self._packed_genome = pack_genome(self.genome)
        params_T = self._packed_genome.eval_params(
            np.asarray(ts_times, np.float32))
        ppu_T = params_T.ppu * jnp.float32(
            prof.width / self.genome.size[0])
        T = len(ts_times)
        batch = self._halved_batch(iters_per_sample * T)
        state = init_state(jax.random.PRNGKey(seed), batch)
        state = jax.device_put(
            state, NamedSharding(self.mesh, P(BATCH_AXIS)))
        per_chunk = batch * prof.iters_per_chunk
        n_chunks = max(1, int(np.ceil(iters_per_sample / per_chunk)))
        weights = jnp.asarray(ts_weights, jnp.float32)
        per_sample = n_chunks * per_chunk
        cap = prof.dispatch_iter_cap
        total = per_sample * T

        if not cap or total <= cap:
            state, carry, plotted = call_temporal(
                params_T, ppu_T, weights, state, carry, n_chunks)
            return carry, plotted, total

        plotted = jnp.float32(0.0)
        if per_sample <= cap:
            g = max(1, int(cap // per_sample))
            for s0 in range(0, T, g):
                sl = slice(s0, min(s0 + g, T))
                p_sl = jax.tree_util.tree_map(lambda a: a[sl],
                                              params_T)
                state, carry, n = call_temporal(
                    p_sl, ppu_T[sl], weights[sl], state, carry,
                    n_chunks)
                plotted = plotted + n
            return carry, plotted, total

        cap_chunks = max(1, int(cap // per_chunk))
        for k in range(T):
            params_k = jax.tree_util.tree_map(lambda a: a[k],
                                              params_T)
            cdf_k = xform_cdf_rows(params_k)
            left = n_chunks
            while left > 0:
                c = min(left, cap_chunks)
                state, carry, n = call_single(
                    params_k, cdf_k, state, carry, ppu_T[k], c,
                    weights[k])
                plotted = plotted + n
                left -= c
        return carry, plotted, total

    def _scattered_temporal(self, ts_times, ts_weights, myblocks,
                            seed, geom):
        """Motion blur in scattered mode: the shared cap ladder,
        accumulating into the carried per-device blocks instead of a
        replicated histogram."""
        prof, cam, key = self.profile, self.cam, self.key
        band_rows, margin, pad_bot = geom

        def call_temporal(p_T, ppu_s, w_s, state, blocks, nc):
            return sharded_accumulate_temporal_scattered(
                key, cam, self.backend, self.mesh, p_T, state,
                blocks, ppu_s, w_s, nc, prof.iters_per_chunk,
                prof.fuse, band_rows, margin, pad_bot,
                packed=self.packed, op_bits=self.op_bits)

        def call_single(params_k, cdf_k, state, blocks, ppu_k, c,
                        w_k):
            return sharded_accumulate_scattered(
                key, cam, self.backend, self.mesh, params_k, cdf_k,
                state, blocks, ppu_k, c, prof.iters_per_chunk,
                prof.fuse, band_rows, margin, pad_bot,
                packed=self.packed, op_bits=self.op_bits,
                weight=w_k)

        return self._temporal_cap_ladder(
            ts_times, ts_weights, myblocks, seed,
            prof.total_iters / len(ts_times), call_temporal,
            call_single)

    def finalize_frame_scattered(self, myblocks, t: float = 0.0,
                                 stats=None):
        """Filter the scattered blocks where they live: each device
        runs _filter_band on its own reduced block (no collective at
        all — the margins were baked in by the scatter) and the u8
        bands gather back."""
        import time as _time
        from cuburn_tpu.render import _with_alpha
        t1 = _time.perf_counter()
        out = _with_alpha(np.asarray(
            self.finalize_frame_scattered_device(myblocks, t)))
        if stats is not None:
            stats.filter_s = _time.perf_counter() - t1
        return out

    def finalize_frame_scattered_device(self, myblocks,
                                        t: float = 0.0):
        """finalize_frame_scattered WITHOUT the host readback —
        returns the u8 frame as a device array for the overlapped
        driver ((H, W, 3) opaque / (H, W, 4) transparent)."""
        from cuburn_tpu.render import _filter_band, _to_device
        prof, cam = self.profile, self.cam
        n = self.n_devices
        params = _to_device(self.genome.eval_at(t))
        _times, _w, sumfilt = self._temporal_times(t)
        q_cell = jnp.float32(prof.quality * sumfilt
                             / (cam.ss * cam.ss))
        de_on = self._de_on(params)
        de_r = self._static_de_r
        de_static = de_r if de_r > 0 else 9.0
        sf = self._static_sf
        shape = self.genome.spatial_filter_shape
        h_band, band_rows, margin, block_rows, _bot = \
            self._band_geometry(de_on)

        ch = 4 if prof.transparent else 3        # rgb-only readback

        def device_band(myblock, params, q_cell):
            band = _filter_band(
                myblock[0], params, q_cell, cam.ss, margin,
                cam.gutter, prof.transparent, de_on, de_static, sf,
                shape, earlyclip=self.genome.earlyclip)
            return band[None, ..., :ch]

        shard = jax.shard_map(
            device_band, mesh=self.mesh,
            in_specs=(P(BATCH_AXIS), P(), P()),
            out_specs=P(BATCH_AXIS),
            check_vma=False,
        )
        bands = shard(myblocks, params, q_cell)
        return bands.reshape(n * h_band, prof.width,
                             ch)[:prof.height]

    def frames_overlapped_scattered(self, seed: int = 0):
        """frames_overlapped through the reduce-scatter mode: frame
        N's scattered accumulate + block filtering are dispatched
        before frame N-1's u8 readback (the only sync point), exactly
        like the base overlapped driver.  Frames match serial
        render_frame_scattered calls at the same per-frame seeds, as
        in Renderer.frames_overlapped."""
        import time as _time
        pending = None
        t_prev = _time.perf_counter()
        for i, t in self.frame_times():
            blocks, n_plot, n_iter = self.accumulate_scattered_async(
                t, seed + i)
            img_dev = self.finalize_frame_scattered_device(blocks, t)
            now = _time.perf_counter()
            if pending is not None:
                yield self._resolve_pending(pending, now - t_prev)
            t_prev = now
            pending = (img_dev, n_plot, n_iter)
        if pending is not None:
            yield self._resolve_pending(
                pending, _time.perf_counter() - t_prev)

    def render_frame_scattered(self, t: float = 0.0, seed: int = 0):
        """render_frame through the reduce-scatter mode: same output
        contract as render_frame, matching the replicated path within
        f32 reduction-order ulps (<=1 u8 step; density additionally
        exact for stills — motion-blurred densities carry the flam3
        temporal weights, so they share the ulp caveat)."""
        myblocks, stats = self.accumulate_scattered(t, seed)
        img = self.finalize_frame_scattered(myblocks, t, stats)
        return img, stats

    def _accumulate_temporal(self, ts_times, ts_weights, hist, seed,
                             iters_per_sample, tile_row0=None):
        """Single-dispatch sharded motion blur: packed-knot interp
        feeds every temporal sample inside the shard_map region; the
        shared cap ladder splits when dispatch_iter_cap binds."""
        prof, cam, key = self.profile, self.cam, self.key

        def call_temporal(p_T, ppu_s, w_s, state, hist, nc):
            return sharded_accumulate_temporal(
                key, cam, self.backend, self.mesh, p_T, state, hist,
                ppu_s, w_s, nc, prof.iters_per_chunk, prof.fuse,
                packed=self.packed, tile_row0=tile_row0,
                op_bits=self.op_bits)

        def call_single(params_k, cdf_k, state, hist, ppu_k, c, w_k):
            return sharded_accumulate(
                key, cam, self.backend, self.mesh, params_k, cdf_k,
                state, hist, ppu_k, c, prof.iters_per_chunk,
                prof.fuse, packed=self.packed, tile_row0=tile_row0,
                op_bits=self.op_bits,
                weight=w_k)

        return self._temporal_cap_ladder(
            ts_times, ts_weights, hist, seed, iters_per_sample,
            call_temporal, call_single)
