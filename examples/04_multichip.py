"""Shard one frame's trajectories across every local device.

On a CPU host, simulate a mesh first:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/04_multichip.py
"""
import jax

from cuburn_tpu.models import get_genome
from cuburn_tpu.output import write_image
from cuburn_tpu.parallel import ShardedRenderer, make_mesh
from cuburn_tpu.profile import get_profile

mesh = make_mesh()                          # all local devices
print(f"mesh: {mesh.devices.size} x {jax.devices()[0].platform}")

genome = get_genome("full_feature")
profile = get_profile("preview", quality=100, batch=1 << 13)
renderer = ShardedRenderer(genome, profile, mesh=mesh)

img, stats = renderer.render_frame(0.0, seed=1)
write_image("multichip.png", img)
print(f"{stats.plotted_samples / 1e6:.1f} M samples across "
      f"{mesh.devices.size} devices")

# reduce-scatter mode: the histogram reduction hands each device only
# the block its filter band needs (~half the interconnect bytes, 1/n
# post-reduction residency) — race both modes on a real slice
img_rs, stats_rs = renderer.render_frame_scattered(0.0, seed=1)
import numpy as np
assert np.abs(img_rs.astype(int)
              - np.asarray(img).astype(int)).max() <= 1
print(f"reduce-scatter mode: {stats_rs.plotted_samples / 1e6:.1f} M "
      "samples, frame matches the replicated reduction")
