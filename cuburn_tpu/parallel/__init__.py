"""Multi-chip and multi-host parallel rendering.

Reference mapping (SURVEY.md §2b parallelism table):
  shard.py — intra-frame: trajectories sharded across devices with
             shard_map, per-device partial histograms reduced with
             one psum (the only collective the renderer needs).
  farm.py  — inter-frame: frame-level job distribution across
             processes/hosts (the reference's zmq dist/ farm).
"""

from cuburn_tpu.parallel.shard import (ShardedRenderer, make_mesh)

__all__ = ["ShardedRenderer", "make_mesh"]
