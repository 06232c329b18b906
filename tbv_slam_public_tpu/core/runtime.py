"""Process-level runtime settings shared by the entry points (CLI, bench,
chip smoke test): the persistent compilation cache and a description of
the accelerator the process runs on."""
from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as is (JAX reads it
    itself) and nothing is set in code.  Otherwise the cache lives at the
    fixed ``<repo>/.jax_cache``: the path is part of the cache key, so it
    must not depend on the process, the time or a temporary directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def nvidia_smi_cards() -> List[str]:
    """``name, power.limit`` of every visible NVIDIA card, as nvidia-smi
    reports them (empty without nvidia-smi).  Starts no JAX runtime."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def device_info() -> Dict[str, object]:
    """Platform, device kind and count as JAX reports them, plus the card's
    name and power limit where nvidia-smi can read them."""
    import jax

    devs = jax.devices()
    cards = nvidia_smi_cards() if devs[0].platform == "gpu" else []
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs), card=cards[0] if cards else None)


def visible_gpus() -> Optional[List[str]]:
    """CUDA device ids a child process may be pinned to, found without
    starting JAX in this process (which would reserve most of a card's
    memory).  None for a CPU-only run (``JAX_PLATFORMS=cpu`` or no card).
    """
    if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return None
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [d.strip() for d in visible.split(",") if d.strip()]
        return ids or None
    n = len(nvidia_smi_cards())
    return [str(i) for i in range(n)] if n else None
