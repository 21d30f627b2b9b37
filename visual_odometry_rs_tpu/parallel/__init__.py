"""Scaling layer (green-field; no reference counterpart — SURVEY §2.3).

- ``mesh``: device meshes + batch sharding helpers
- ``batch``: fully-fused batched multi-sequence tracking (DP over a 'data'
  mesh axis; communication-free SPMD)
- ``sharded``: candidate-point-sharded LM reductions (TP analog; one psum
  per iteration across the devices)
- ``ba``: sliding-window bundle adjustment with Schur-complement reduction,
  point-sharded across chips
- ``pose_graph``: loop-closure pose-graph optimization

Pipeline parallelism is intentionally absent this round: the tracker's
dependency chain is sequential per sequence and DP over sequences saturates
chips without pipelining (SURVEY §2.3 marks PP optional for parity).
Multi-host execution uses the same code paths: initialize with
``jax.distributed.initialize()`` and build meshes over ``jax.devices()``.
"""

from . import ba, batch, mesh, pose_graph, sharded  # noqa: F401
