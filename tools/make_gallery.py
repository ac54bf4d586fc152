#!/usr/bin/env python
"""Render the README gallery (docs/gallery/*.png).

All eight reference scenes at gallery resolution with high sample
counts, so the gallery shows converged images rather than Monte Carlo
speckle (GPU kernel where it covers the scene, else the XLA tier).

    python tools/make_gallery.py [outdir]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from raytracing_rust_tpu.backend import init_compile_cache  # noqa: E402
from raytracing_rust_tpu.models.builders import PRESETS  # noqa: E402
from raytracing_rust_tpu.render import render_auto  # noqa: E402
from raytracing_rust_tpu.utils import image_io  # noqa: E402

# (scene, nx, ny, spp): 16:9 scenes at 416x234, square scenes at 360x360;
# spp tuned per scene's convergence rate
CONFIGS = [
    ("random_spheres", 416, 234, 1000),
    ("two_spheres", 416, 234, 1000),
    ("two_perlin_spheres", 416, 234, 1000),
    ("earth", 416, 234, 1000),
    ("simple_light", 416, 234, 2000),
    ("cornell_box", 360, 360, 4000),
    ("cornell_smoke", 360, 360, 4000),
    ("final_scene", 360, 360, 1500),
]


def main() -> int:
    init_compile_cache()
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "docs", "gallery")
    os.makedirs(outdir, exist_ok=True)
    for name, nx, ny, spp in CONFIGS:
        preset = PRESETS[name]
        scene = preset.build()
        cam = preset.camera()
        t0 = time.perf_counter()
        img, engine = render_auto(scene, cam, nx, ny, spp, seed=0)
        dt = time.perf_counter() - t0
        path = os.path.join(outdir, f"{name}.png")
        image_io.write_png(path, img)
        print(f"{name}: {nx}x{ny}x{spp} engine={engine} in {dt:.1f}s "
              f"-> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
