"""Dtype policy and small type aliases.

The reference fixes ``Float = f32`` for the entire crate
(``src/misc/type_aliases.rs:10``); f32 is also the natural accelerator compute dtype
for this workload (bilinear sampling of 8-bit images and 6x6 normal
equations), so we keep the same policy.  Images are carried as integer arrays
(u8 pixels, i16/i32 gradients) exactly like the reference so that pyramid and
gradient arithmetic keeps integer semantics.
"""

import jax.numpy as jnp

# Compute dtype for all floating point math (ref: misc/type_aliases.rs:10).
Float = jnp.float32

# Integer dtypes used by image ops (ref: core/multires.rs, core/gradient.rs).
Pixel = jnp.uint8
Grad = jnp.int16
GradSq = jnp.uint16
Depth16 = jnp.uint16
