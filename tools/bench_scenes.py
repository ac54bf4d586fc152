#!/usr/bin/env python
"""Per-scene throughput at the reference's own render configs.

BASELINE.md's table pins each scene's (resolution, spp) as hard-coded in
the reference's tests (tests/test.rs); this sweeps all of them (GPU
kernel where it covers the scene, else the XLA tier — the engine is
printed) and prints best-of-3 primary rays/s. Depth 50 everywhere
(src/color.rs:9).

    python tools/bench_scenes.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from raytracing_rust_tpu.backend import init_compile_cache  # noqa: E402
from raytracing_rust_tpu.models.builders import PRESETS  # noqa: E402
from raytracing_rust_tpu.render import render_auto  # noqa: E402

CONFIGS = [
    # (scene, nx, ny, spp) — reference test configs (tests/test.rs)
    ("cornell_box", 800, 800, 100),
    ("cornell_smoke", 800, 800, 100),
    ("final_scene", 800, 800, 100),
    ("random_spheres", 1280, 720, 100),
    ("simple_light", 1280, 720, 100),
    ("earth", 1280, 720, 10),
    ("two_perlin_spheres", 1280, 720, 10),
    ("two_spheres", 1280, 720, 10),
]


def main() -> int:
    init_compile_cache()
    for name, nx, ny, spp in CONFIGS:
        preset = PRESETS[name]
        scene = preset.build()
        cam = preset.camera()
        render_auto(scene, cam, nx, ny, 2, seed=9)  # compile
        best = float("inf")
        for r in range(3):
            t0 = time.perf_counter()
            _, engine = render_auto(scene, cam, nx, ny, spp, seed=r)
            best = min(best, time.perf_counter() - t0)
        rays = nx * ny * spp
        print(f"{name}: {nx}x{ny}x{spp} engine={engine} best {best:.2f}s = "
              f"{rays / best / 1e6:.1f}M rays/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
