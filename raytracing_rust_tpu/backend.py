"""What the current JAX backend offers this renderer, in one place.

Every choice that depends on the machine goes through here: whether the
Pallas kernels can compile (`gpu_kernels`), where the compile cache lives
(`init_compile_cache`), the dense-scan/BVH crossover (`bvh_min_prims`),
and the card label that measurements carry (`card_label`).
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Primitive count from which the XLA tier's per-lane BVH traversal beats
# its dense [lanes, P] scan, per backend. CPU: measured ~1.5-2k
# (DESIGN.md "Large scenes"). GPU: on one H100 at a full-card image
# (tools/bench_large.py, 400x400x4) the two tie at 30k primitives; dense
# wins below (4.8x at 3k), the BVH above (2.2x at 100k); PERF.md.
_BVH_MIN_PRIMS = {"cpu": 2048, "gpu": 30000}


def gpu_kernels() -> bool:
    """True when the default backend is a CUDA GPU, the one place the
    Triton-route Pallas kernels compile. Elsewhere they run only in
    interpret mode, which a caller must ask for explicitly."""
    return jax.default_backend() == "gpu"


def bvh_min_prims() -> int:
    """Auto-BVH threshold for the default backend."""
    return _BVH_MIN_PRIMS.get(jax.default_backend(), _BVH_MIN_PRIMS["cpu"])


def init_compile_cache() -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when that is set, else at `<checkout>/.jax_cache`. Returns the path.
    The one place any entry point sets a cache directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_label() -> str:
    """The first card's name and power limit as `nvidia-smi` reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"); a card may be capped below its
    maximum, so every number taken on it carries this label."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()
