#!/usr/bin/env python
"""Large-scene scaling: dense scan vs BVH vs the GPU kernel across prim
counts (reference src/bvh.rs:9-94 exists exactly for this regime).

Measures end-to-end render() wall (best of `--reps`) on the CURRENT
backend for each n in --n: the dense-XLA tier, the BVH-XLA tier, and —
on a GPU — the Pallas kernel. Rays/s = nx·ny·spp / wall. One JSON line
per prim count. The default image, 400×400 at 4 spp, fills the card on
every tier: BVH dispatches at render()'s 65,536-lane cap, dense ones of
262,144 lanes, 1,250 kernel blocks for an H100's 132 SMs. A toy image
leaves most of a GPU idle and biases the comparison toward the wide
dense scan.

    python tools/bench_large.py                 # default backend
    python tools/bench_large.py --cpu --nx 64 --ny 36 --spp 4
    python tools/bench_large.py --n 1000 30000

The auto-BVH thresholds in backend.py (_BVH_MIN_PRIMS) are set from it.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+",
                    default=[1000, 3000, 10000, 30000, 100000])
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=400)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-dense-above", type=int, default=10**9,
                    help="skip the dense tier above this prim count")
    args = ap.parse_args()

    import json

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from raytracing_rust_tpu.backend import (card_label, gpu_kernels,
                                             init_compile_cache)
    from raytracing_rust_tpu.models.builders import (big_spheres,
                                                     big_spheres_camera)
    from raytracing_rust_tpu.render import render

    init_compile_cache()
    on_gpu = gpu_kernels()
    card = card_label() if on_gpu else jax.devices()[0].device_kind
    print(f"backend: {card}  config "
          f"{args.nx}x{args.ny} spp {args.spp} depth {args.depth} "
          f"(best of {args.reps})")
    rays = args.nx * args.ny * args.spp

    def timed(fn):
        fn()  # compile + warm
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            img = fn()
            np.asarray(img)
            best = min(best, time.perf_counter() - t0)
        return best, img

    for n in args.n:
        scene = big_spheres(n)
        P = scene.num_prims
        cam = big_spheres_camera(n, args.nx, args.ny)
        row = {}
        means = {}
        if P <= args.skip_dense_above:
            t, img = timed(lambda: render(scene, cam, args.nx, args.ny,
                                          args.spp, max_depth=args.depth,
                                          use_bvh=False))
            row["dense"] = rays / t
            means["dense"] = float(np.asarray(img).mean())
        t, img = timed(lambda: render(scene, cam, args.nx, args.ny,
                                      args.spp, max_depth=args.depth,
                                      use_bvh=True))
        row["bvh"] = rays / t
        means["bvh"] = float(np.asarray(img).mean())
        if on_gpu:
            from raytracing_rust_tpu.ops.pallas_tracer import render_pallas
            t, img = timed(lambda: render_pallas(
                scene, cam, args.nx, args.ny, args.spp,
                max_depth=args.depth))
            row["pallas"] = rays / t
            means["pallas"] = float(np.asarray(img).mean())
        print(json.dumps({"prims": P, "rays_per_sec": row, "mean": means}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
