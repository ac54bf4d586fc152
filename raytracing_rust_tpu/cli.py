"""Command-line entry point.

The reference's "CLI" is `cargo test -- --test-threads=1` (reference
tests/test.rs:28,525-838): each #[test] sets up a logger, builds a scene and
camera from hard-coded constants, renders, and writes output/<scene>.ppm.
Here that's `python -m raytracing_rust_tpu render --scene <name>` with the
same presets, plus overrides the reference hard-codes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="raytracing_rust_tpu",
        description="Differentiable Monte Carlo path tracer (JAX)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene preset")
    r.add_argument("--scene", required=True)
    r.add_argument("--nx", type=int, default=None)
    r.add_argument("--ny", type=int, default=None)
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--max-depth", type=int, default=50,
                   help="bounce cap (reference src/color.rs:9)")
    r.add_argument("--out", default=None,
                   help="output path (.ppm or .png); default output/<scene>.ppm")
    r.add_argument("--sharded", action="store_true",
                   help="shard over all visible devices")
    r.add_argument("--engine", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="auto = the GPU kernel when a GPU is present and "
                        "the scene is supported, else the XLA wavefront "
                        "tier; pallas = the GPU kernel or an error")
    r.add_argument("--bvh", action="store_true",
                   help="use the flat BVH in the XLA tier (reference "
                        "src/bvh.rs analogue)")
    r.add_argument("--checkpoint", default=None,
                   help=".npz path for resumable rendering (both the "
                        "XLA tier and the GPU kernel)")
    r.add_argument("--rr-depth", type=int, default=None,
                   help="start Russian roulette at this bounce (opt-in, "
                        "unbiased; the reference always runs to the cap)")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the render to DIR")
    r.add_argument("--timers", action="store_true",
                   help="print per-phase wall times (scene build, "
                        "compile-carrying first dispatch, steady "
                        "dispatches, encode)")
    r.add_argument("--log", default="log/log.log")
    r.add_argument("--no-progress", action="store_true")

    ls = sub.add_parser("scenes", help="list scene presets")

    b = sub.add_parser("bench", help="throughput benchmark (see bench.py)")
    b.add_argument("--scene", default="cornell_box_baseline")
    b.add_argument("--spp", type=int, default=None)

    args = ap.parse_args(argv)

    from .backend import gpu_kernels, init_compile_cache
    from .models.builders import PRESETS

    init_compile_cache()

    if args.cmd == "scenes":
        for name, p in PRESETS.items():
            print(f"{name:24s} {p.nx}x{p.ny} spp={p.spp}")
        return 0

    if args.cmd == "bench":
        # same friendly validation as the render path (a typo'd scene
        # otherwise dies with a raw KeyError inside benchlib.run)
        if args.scene not in PRESETS:
            print(f"unknown scene {args.scene!r}; try: "
                  f"{', '.join(PRESETS)}", file=sys.stderr)
            return 2
        if args.spp is not None and args.spp <= 0:
            print(f"--spp must be positive (got {args.spp})",
                  file=sys.stderr)
            return 2
        from . import benchlib
        result = benchlib.run(scene=args.scene, spp=args.spp)
        print(benchlib.to_json(result))
        return 0

    # render
    if args.scene not in PRESETS:
        print(f"unknown scene {args.scene!r}; try: {', '.join(PRESETS)}",
              file=sys.stderr)
        return 2

    from .utils.logger import Logger, LogLevel
    from .utils.progress import ProgressBar
    from .utils import image_io

    log = Logger(args.log, LogLevel.DEBUG)
    log.write(f"render scene={args.scene}")

    preset = PRESETS[args.scene]
    nx = preset.nx if args.nx is None else args.nx
    ny = preset.ny if args.ny is None else args.ny
    spp = preset.spp if args.spp is None else args.spp
    if min(nx, ny, spp) <= 0:
        print(f"nx/ny/spp must be positive (got {nx}x{ny} spp={spp})",
              file=sys.stderr)
        return 2
    if args.sharded and (args.checkpoint or args.bvh
                         or args.engine == "pallas"):
        print("--sharded supports neither --checkpoint, --bvh, nor "
              "--engine pallas (it is the GSPMD XLA path)",
              file=sys.stderr)
        return 2
    preset = type(preset)(**{**preset.__dict__, "nx": nx, "ny": ny})

    from .utils.timers import Timers
    timers = Timers()
    with timers.phase("scene_build"):
        scene = preset.build()
        cam = preset.camera()

    progress = None if args.no_progress else ProgressBar(args.scene)
    profiler = None
    if args.profile:
        import jax
        jax.profiler.start_trace(args.profile)
        profiler = args.profile
    t0 = time.time()
    try:
        if args.sharded:
            engine = "xla_sharded"
            from .parallel.sharding import make_mesh, render_sharded
            img = render_sharded(scene, cam, nx, ny, spp, make_mesh(),
                                 seed=args.seed, max_depth=args.max_depth,
                                 rr_depth=args.rr_depth, progress=progress,
                                 timers=timers)
        else:
            from .render import render, render_auto
            kw = dict(seed=args.seed, max_depth=args.max_depth,
                      rr_depth=args.rr_depth, checkpoint=args.checkpoint,
                      timers=timers, progress=progress)
            if args.engine == "pallas":
                if not gpu_kernels():
                    # one clear line; the kernel never drops to interpret
                    # mode or to the XLA tier
                    print("--engine pallas requires a CUDA GPU "
                          "(the kernel is compiled by Triton)",
                          file=sys.stderr)
                    return 2
                if args.bvh:
                    # the flat BVH is an XLA-tier feature (the kernel
                    # scans primitives without one)
                    print("--bvh requires the xla engine", file=sys.stderr)
                    return 2
                from .ops.pallas_tracer import UnsupportedScene, render_pallas
                try:
                    img, engine = render_pallas(scene, cam, nx, ny, spp,
                                                **kw), "pallas"
                except UnsupportedScene as e:
                    print(f"pallas engine: {e}", file=sys.stderr)
                    return 2
            elif args.engine == "xla" or args.bvh:
                img, engine = render(scene, cam, nx, ny, spp,
                                     use_bvh=args.bvh or None,  # False → auto
                                     **kw), "xla"
            else:
                img, engine = render_auto(scene, cam, nx, ny, spp, **kw)
            log.write(f"engine={engine}")
    finally:
        dt = time.time() - t0
        if profiler:
            import jax
            jax.profiler.stop_trace()
            log.write(f"profiler trace -> {profiler}")

    out = args.out or os.path.join("output", f"{args.scene}.ppm")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with timers.phase("encode"):
        if out.endswith(".png"):
            image_io.write_png(out, img)
        else:
            image_io.write_ppm(out, img)

    rays = nx * ny * spp
    print(f"{args.scene}: {nx}x{ny} spp={spp} engine={engine} in {dt:.1f}s "
          f"({rays / dt / 1e6:.2f}M primary rays/s) -> {out}")
    if args.timers:
        print(timers.report())
        log.write(f"timers: {timers.summary()}")
    log.write(f"rendered {args.scene} in {dt:.1f}s -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
