"""Shared argparse → EnvConfig plumbing for the CLI entry points."""

from __future__ import annotations

import argparse
import json

from .config import (EnvConfig, large_config, medium_config, shelves_config,
                     small_config)

_PRESETS = {
    "small": small_config,
    "medium": medium_config,
    "large": large_config,
    "shelves": shelves_config,
}


def add_env_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--env", choices=sorted(_PRESETS), default="medium",
                   help="preset: small=5x5/2ag, medium=9x9/4ag, large=15x15/8ag")
    p.add_argument("--env-config", default=None,
                   help="JSON dict of EnvConfig overrides")
    p.add_argument("--global-obs", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")


def apply_backend_args(args) -> None:
    """Must run before any jax computation; safe to call multiple times."""
    if getattr(args, "cpu", False):
        import os

        # Both knobs: the env var must be set before jax initializes,
        # and the config update covers the case where jax is already
        # imported but no backend is live yet.
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()


def env_config_from_args(args) -> EnvConfig:
    overrides = json.loads(args.env_config) if args.env_config else {}
    if getattr(args, "global_obs", False):
        overrides["global_obs"] = True
    return _PRESETS[args.env](**overrides)
