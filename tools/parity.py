#!/usr/bin/env python
"""Tier parity on the GPU: the Pallas kernel against the XLA wavefront.

Every reference preset renders on BOTH tiers with independent random
streams, and the image means must agree within Monte Carlo error (the
per-config tolerances below are sized to the noise at each config's
spp). Presets the kernel does not cover (UnsupportedScene) render twice
on the XLA tier instead, with different seeds, so the sweep still shows
they run on the card. A BVH config and a Russian-roulette config cover
those paths too. Also: the fused gradient tier against the XLA scan on
bit-identical draws, and kernel checkpoint/resume.

    python tools/parity.py [--quick] [--json PATH]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from raytracing_rust_tpu.models.builders import PRESETS  # noqa: E402
from raytracing_rust_tpu.ops.pallas_tracer import (  # noqa: E402
    UnsupportedScene, render_pallas)
from raytracing_rust_tpu.render import render  # noqa: E402

CONFIGS = {
    # key: (scene, nx, ny, spp, depth, mean rel tolerance, options)
    "two_spheres": ("two_spheres", 96, 54, 64, 12, 0.02, {}),
    "random_spheres": ("random_spheres", 96, 54, 64, 12, 0.02, {}),
    "random_spheres_bvh": ("random_spheres", 48, 27, 48, 10, 0.03,
                           {"use_bvh": True}),
    "two_perlin_spheres": ("two_perlin_spheres", 96, 54, 64, 12, 0.02, {}),
    "simple_light": ("simple_light", 96, 54, 128, 12, 0.04, {}),
    "cornell_box": ("cornell_box", 64, 64, 128, 16, 0.04, {}),
    "cornell_box_rr": ("cornell_box", 64, 64, 128, 16, 0.05,
                       {"rr_depth": 6}),
    "cornell_smoke": ("cornell_smoke", 64, 64, 128, 16, 0.04, {}),
    "earth": ("earth", 96, 54, 64, 12, 0.02, {}),
    "final_scene": ("final_scene", 48, 48, 48, 10, 0.05, {}),
}


def check_config(key: str, quick: bool = False) -> dict:
    """Render one config on both tiers → a record with the engine that
    rendered side A ("pallas", or "xla" when the kernel does not cover
    the scene), both means, rel error, tolerance and pass."""
    name, nx, ny, spp, depth, tol, opts = CONFIGS[key]
    if quick:
        spp = max(16, spp // 4)
        tol *= 2
    preset = PRESETS[name]
    scene = preset.build()
    cam = preset.camera()
    # the XLA side renders uncompacted: one program to compile instead of
    # three, and the image is bit-identical to the compacted path
    # (tests/test_integrator.py::test_render_compaction_bit_identical)
    xla = dict(max_depth=depth, compact=False, **opts)
    engine = "pallas"
    t0 = time.time()
    try:
        a = render_pallas(scene, cam, nx, ny, spp, seed=0, max_depth=depth,
                          rr_depth=opts.get("rr_depth"))
    except UnsupportedScene as e:
        engine = f"xla ({e})"
        a = render(scene, cam, nx, ny, spp, seed=2, **xla)
    ta = time.time() - t0
    t0 = time.time()
    b = render(scene, cam, nx, ny, spp, seed=1, **xla)
    tb = time.time() - t0
    ma, mb = float(a.mean()), float(b.mean())
    rel = abs(ma - mb) / max(mb, 1e-6)
    ok = bool(np.isfinite(a).all() and np.isfinite(b).all() and rel < tol)
    return {"check": key, "pass": ok, "engine": engine, "mean_a": ma,
            "mean_xla": mb, "rel": rel, "tol": tol, "nx": nx, "ny": ny,
            "spp": spp, "depth": depth, "seconds_a": ta, "seconds_xla": tb}


def check_grad_tier(n: int = 8192, max_depth: int = 3) -> dict:
    """Fused gradient kernels against the XLA scan on BIT-IDENTICAL
    lane-keyed draws: the same estimator, so the primal agrees to f32
    reordering error and the gradients leaf by leaf, at the tolerances
    of tests/test_pallas_grad.py (abs 2e-4 primal, 5e-4 × leaf scale
    for gradients). The scene is that file's small_scene — every
    material family, spheres and rects — at depth 3: the in-kernel vjp
    unrolls bounces × prims, and this size keeps its compile short."""
    import jax
    import jax.numpy as jnp
    from raytracing_rust_tpu.models.scene import SceneBuilder, BG_SKY
    from raytracing_rust_tpu.ops.integrator import trace
    from raytracing_rust_tpu.ops.pallas_grad import (fast_grad_config,
                                                     trace_fast)
    bld = SceneBuilder(background=BG_SKY)
    bld.rect("zx", -3, -3, 3, 3, 0.0,
             bld.lambertian(bld.solid(0.7, 0.7, 0.7)))
    bld.rect("zx", -1, -1, 1, 1, 5.0,
             bld.diffuse_light(bld.solid(4.0, 4.0, 4.0)), flip=True)
    bld.sphere((0.9, 1.0, 0.5), 0.8,
               bld.metal(bld.solid(0.8, 0.7, 0.6), 0.2))
    bld.sphere((-1.0, 0.8, 0.6), 0.7, bld.dielectric(1.5))
    scene = bld.build()
    cfg = fast_grad_config(scene)
    rng = np.random.default_rng(3)
    o = jnp.asarray(np.tile(np.array([0., 2., 8.], np.float32), (n, 1)))
    d = jnp.asarray(np.stack([rng.uniform(-.7, .7, n),
                              rng.uniform(-.45, .25, n),
                              -np.ones(n)], -1).astype(np.float32))
    key = jax.random.key(7)
    with jax.default_matmul_precision("highest"):
        want, gx = jax.value_and_grad(lambda s: jnp.mean(trace(
            s, o, d, jnp.zeros(n), key, max_depth=max_depth,
            differentiable=True)), allow_int=True)(scene)
        got, gp = jax.value_and_grad(lambda s: jnp.mean(trace_fast(
            s, o, d, key, max_depth=max_depth, lane_keyed_draws=True,
            cfg=cfg)), allow_int=True)(scene)
    prim_err = abs(float(got) - float(want))
    grad_err = 0.0
    for leaf in ("prim_data", "mat_param", "tex_color", "xf_offset",
                 "xf_sin", "xf_cos"):
        a = np.asarray(getattr(gx, leaf))
        b = np.asarray(getattr(gp, leaf))
        scale = max(float(np.abs(a).max()), 1e-3)
        grad_err = max(grad_err, float(np.abs(a - b).max()) / scale)
    ok = bool(np.isfinite(float(got)) and prim_err < 2e-4
              and grad_err < 5e-4)
    return {"check": "fast_grad_tier", "pass": ok, "n": n,
            "depth": max_depth, "primal_abs_diff": prim_err,
            "grad_rel_max": grad_err}


def check_checkpoint_resume() -> dict:
    """A kernel render stopped after 2 of 4 sample chunks resumes from
    its .npz and finishes byte-equal to an uninterrupted run."""
    import tempfile
    preset = PRESETS["cornell_box"]
    scene = preset.build()
    cam = preset.camera()
    kw = dict(seed=4, max_depth=12, spp_chunk=16)
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck.npz")
        full = render_pallas(scene, cam, 64, 64, 64, **kw)
        render_pallas(scene, cam, 64, 64, 64, checkpoint=ck,
                      _stop_after_chunks=2, **kw)
        saved = os.path.exists(ck)
        resumed = render_pallas(scene, cam, 64, 64, 64, checkpoint=ck, **kw)
    ok = bool(saved and np.array_equal(resumed, full))
    return {"check": "pallas_checkpoint_resume", "pass": ok, "saved": saved}


def main() -> int:
    from raytracing_rust_tpu.backend import init_compile_cache
    init_compile_cache()
    quick = "--quick" in sys.argv
    json_path = None
    if "--json" in sys.argv:
        i = sys.argv.index("--json") + 1
        if i >= len(sys.argv) or sys.argv[i].startswith("--"):
            print("usage: parity.py [--quick] [--json PATH]",
                  file=sys.stderr)
            return 2
        json_path = sys.argv[i]
    results = [check_config(k, quick) for k in CONFIGS]
    results += [check_grad_tier(), check_checkpoint_resume()]
    for r in results:
        print(json.dumps(r))
    failures = sum(not r["pass"] for r in results)
    print("PARITY PASS" if failures == 0 else f"PARITY FAIL ({failures})")
    if json_path:
        import jax
        with open(json_path, "w") as f:
            json.dump({"pass": failures == 0, "quick": quick,
                       "device": str(jax.devices()[0]),
                       "checks": results}, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
