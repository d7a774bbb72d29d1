"""Where a run happens: the persistent compile cache and the card's identity.

``setup_compile_cache`` places JAX's persistent compilation cache. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache goes to the fixed ``<checkout>/.jax_cache``
(the path is part of what makes a later run hit, so it never depends on a
temp name, a pid or the time).

``gpu_identity`` reads the card's name and power limit from ``nvidia-smi``.
A measurement is only comparable with another on a card of the same name and
limit, so benchmark output carries both; a missing reading is an error, never
a default.
"""

from __future__ import annotations

import os
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def compile_cache_dir(environ=None) -> str:
    """The compile-cache directory a run uses: the environment's
    ``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    env = os.environ if environ is None else environ
    return env.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that directory. Sets nothing when the variable is set."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_gpu_identity(text: str) -> list[tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> [(name, power_limit)] per card, e.g.
    ``[("NVIDIA H100 80GB HBM3", "700.00 W")]``. Raises ValueError on a line
    without both fields or with an unreadable limit ("[N/A]")."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        name, limit = name.strip(), limit.strip()
        if not sep or not name or not limit.endswith("W"):
            raise ValueError(f"unreadable nvidia-smi line: {line!r}")
        float(limit[:-1])  # "[N/A] W" and the like raise here
        cards.append((name, limit))
    if not cards:
        raise ValueError("nvidia-smi reported no card")
    return cards


def gpu_identity() -> list[tuple[str, str]]:
    """(name, power limit) of every card, read from ``nvidia-smi``. Raises
    if the tool is missing or its answer cannot be read."""
    out = subprocess.run(NVIDIA_SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return parse_gpu_identity(out)


def require_gpu():
    """The first JAX device, which must be a GPU; raises SystemExit(1)
    otherwise, so no measurement ever runs on a CPU fallback."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r} "
                         f"({dev.device_kind}); refusing to measure")
    return dev
