"""Domain-independent math: Lie groups and the iterative-optimizer harness.

JAX analog of reference ``src/math/`` (optimizer, se3, so3) plus the
pose algebra that nalgebra provided to the reference for free.
"""

from . import optimizer, pose, se3, so3  # noqa: F401
from .pose import Pose  # noqa: F401
