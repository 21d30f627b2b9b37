"""Small shared utilities: dtype policy, interop, visualization, colormap.

JAX analog of reference ``src/misc/``.
"""

from . import types  # noqa: F401
