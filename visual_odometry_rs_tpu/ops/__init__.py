"""Image compute ops: pyramids, gradients, bilinear sampling.

The fixed-shape kernel layer replacing the reference's per-pixel Rust loops
(``src/core/multires.rs``, ``src/core/gradient.rs``, and the interpolation in
``src/core/track/lm_optimizer.rs:227-251``).
"""

from . import gradient, interp, pyramid  # noqa: F401
