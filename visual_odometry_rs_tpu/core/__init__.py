"""Core VO building blocks: camera model, inverse depth, candidate selection.

Fixed-shape JAX analog of reference ``src/core/`` (minus the tracker itself,
which lives in ``models/`` as the flagship estimation model).
"""

from . import camera, inverse_depth  # noqa: F401
from .candidates import coarse_to_fine  # noqa: F401
