"""Shared CLI plumbing."""

from __future__ import annotations

import argparse
import os
import pathlib

# fixed per checkout: the cache directory is part of every entry's key, so a
# directory that moves between runs never hits
DEFAULT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def add_compilation_cache_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--compilation-cache",
        metavar="DIR",
        help="persistent XLA compilation cache directory (default: "
        "<checkout>/.jax_cache; JAX_COMPILATION_CACHE_DIR, when set, wins): "
        "the first run compiles, later runs with the same config reuse it",
    )


def enable_compilation_cache(directory: str | None = None) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``directory`` when
    given, else to the fixed ``DEFAULT_CACHE_DIR``.  Call it before the
    first compilation.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    path = directory or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def apply_compilation_cache(args) -> None:
    """``enable_compilation_cache`` with the CLI's ``--compilation-cache``."""
    enable_compilation_cache(getattr(args, "compilation_cache", None))


def parse_level_iterations(spec, nb_levels: int):
    """Parse ``--level-iterations "N0,N1,..."`` into a per-level tuple.

    ``None``/empty returns ``None`` (reference-exact single cap).  Raises
    ``SystemExit`` with a usage message on malformed input, like argparse.
    """
    if not spec:
        return None
    try:
        caps = tuple(int(tok) for tok in str(spec).split(","))
    except ValueError:
        raise SystemExit(
            f"--level-iterations must be comma-separated integers, got {spec!r}"
        )
    if len(caps) != nb_levels or any(c < 1 for c in caps):
        raise SystemExit(
            f"--level-iterations needs {nb_levels} caps >= 1 (one per "
            f"pyramid level, finest first), got {spec!r}"
        )
    return caps
