"""visual_odometry_rs_tpu — a JAX direct visual odometry framework.

A from-scratch JAX/XLA re-design of the capabilities of the Rust crate
`visual-odometry-rs` (mpizenberg/visual-odometry-rs): direct (photometric)
RGB-D visual odometry with DSO-style sparse candidate points, multi-scale mean
pyramids, inverse-compositional Lucas-Kanade image alignment on se(3), and
Levenberg-Marquardt minimization — plus the scaling layer the reference does
not have: batched multi-sequence tracking, device meshes, and sharded
residual/Hessian reductions.

Layer map (mirrors reference `src/lib.rs:12-15`, re-designed for fixed-shape accelerator programs):

- ``utils``    : dtype policy, small helpers, visualization (ref ``misc::``)
- ``math``     : Lie groups so3/se3, pose algebra, generic LM optimizer
                 harness (ref ``math::``)
- ``ops``      : image compute ops — pyramids, gradients, bilinear sampling —
                 as fused XLA ops (the hot kernels of
                 ref ``core::multires``/``core::gradient``)
- ``core``     : camera model, inverse depth, candidate selection
                 (ref ``core::``)
- ``models``   : end-to-end estimation models: the se3 RGB-D tracker and the
                 2D affine aligner (ref ``core::track``, ``examples/optim_affine-2d``)
- ``dataset``  : TUM RGB-D parsing/loading + synthetic sequences
                 (ref ``dataset::tum_rgbd``)
- ``parallel`` : meshes, sharding, batched/sharded tracking (green-field;
                 no reference counterpart)
- ``eval``     : trajectory metrics (ATE/RPE) — delegated to an external repo
                 by the reference, in-repo here
- ``cli``      : ``vors-track`` equivalent binary (ref ``src/bin/vors_track.rs``)
"""

__version__ = "0.1.0"

from . import math, ops, core, models, dataset, parallel, utils, eval  # noqa: F401,E402
