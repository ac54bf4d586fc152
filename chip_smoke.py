#!/usr/bin/env python
"""Quickest proof that the renderer runs on one CUDA GPU, end to end.

    python chip_smoke.py               # one card: all single-card phases
    python chip_smoke.py --four-cards  # four cards: the multi-device path

Single-card phases, each printing JSON lines tagged with the card's name
and power limit:

1. device   — JAX's device and `nvidia-smi` name and power limit;
2. compile  — both Pallas kernels compiled at their production widths,
              with `memory_analysis()` (the gradient kernels inside the
              production step, whose one compile phase 5 reports);
3. forward  — cornell_box 800×800, 500 spp, depth 50 through the normal
              entry point (engine auto); the kernel's per-channel mean
              radiance before gamma and clamp within 1% of the XLA
              tier's at 800×800×64 and of the C++ reference mirror's;
4. parity   — every preset of tools/parity.py, kernel against XLA tier
              (or XLA against XLA where the kernel does not cover it);
5. gradient — the production inverse-render step on the fused kernels
              and on the XLA scan: finite, falling losses; fused-tier
              gradients against the XLA scan on identical draws;
6. timings  — each kernel against the plain version XLA compiles.

`--four-cards` runs only render_sharded and train_step_sharded on a
four-GPU (dp, sp) mesh against one card, and render_pallas split over
four devices against one.

The last line is one JSON object: {"ok": true, "device": {...}}. Any
failed check raises, so the script exits non-zero and prints no result.
Without a GPU it stops at once.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CARD = "unknown"

# cornell_box's per-channel mean radiance before gamma and clamp, from the
# C++ mirror of the reference (native/ref_tracer.cpp, f64) at 256×256, two
# seeds × 500 spp, depth 50: standard error 0.07% per channel. The
# image mean of unclipped radiance depends on neither resolution nor spp.
CORNELL_MIRROR_MEANS = (0.17516, 0.16299, 0.15108)
LUMA = (0.2126, 0.7152, 0.0722)    # Rec. 709 luma weights


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def radiance(render_fn, scene, cam, nx, ny, spp, seed, **kw):
    """Per-pixel mean radiance before gamma and clamp, f64 [nx·ny, 3]. Both
    tiers write their raw sums to the checkpoint file and nowhere else; a
    clamped image would bias the noisier render low."""
    import tempfile

    import numpy as np
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "sums.npz")
        render_fn(scene, cam, nx, ny, spp, seed=seed, checkpoint=ck, **kw)
        return np.load(ck)["sums"].astype(np.float64) / spp


def phase_compile():
    """The forward kernel at the headline widths. The gradient kernels'
    compile is the production step's, reported by phase 5 under this
    phase's name: that program compiles once (it takes minutes)."""
    import numpy as np
    from raytracing_rust_tpu.models.builders import PRESETS
    from raytracing_rust_tpu.ops import pallas_tracer as pt

    p = PRESETS["cornell_box"]
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(p.build())
    cam = pt.build_camera_record(p.camera())
    params = np.asarray([0, 0, 500, 0], np.int32)
    t0 = time.perf_counter()
    compiled = pt._trace_call.lower(
        tab, cam, params, atlas, n_sph=n_sph, feats=feats, nx=p.nx,
        ny=p.ny, max_depth=50, rr_depth=None, perlin_seed=0, atlas_hw=hw,
        n_tiles=-(-p.nx * p.ny // pt.BLOCK)).compile()
    emit("compile", kernel="rt_forward", config="cornell_box 800x800",
         block=pt.BLOCK, seconds=time.perf_counter() - t0,
         memory_analysis=str(compiled.memory_analysis()))


def phase_forward():
    """Headline render through the CLI's entry point, and the kernel's
    unclipped radiance against the XLA tier's and the C++ reference
    mirror's; returns the kernel's and the XLA tier's rays/s for phase 6."""
    import numpy as np
    from raytracing_rust_tpu.models.builders import PRESETS
    from raytracing_rust_tpu.ops.pallas_tracer import render_pallas
    from raytracing_rust_tpu.render import render, render_auto

    p = PRESETS["cornell_box"]
    scene, cam = p.build(), p.camera()
    nx, ny = p.nx, p.ny
    render_auto(scene, cam, nx, ny, 2, seed=1)   # compile
    walls = []
    for rep in range(3):
        t0 = time.perf_counter()
        img, engine = render_auto(scene, cam, nx, ny, 500, seed=rep)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    check(engine == "pallas", f"cornell_box rendered on {engine}")
    check(np.isfinite(img).all() and img.shape == (ny, nx, 3),
          "forward image not finite or wrong shape")
    emit("forward", engine=engine, config="cornell_box 800x800 500spp "
         "depth 50", wall_seconds=wall, wall_seconds_all_reps=walls,
         rays_per_sec=nx * ny * 500 / wall,
         display_mean=float(img.mean()))

    render(scene, cam, nx, ny, 64, seed=5)        # compile the XLA tier
    xla_walls = []
    for rep in range(3):
        t0 = time.perf_counter()
        render(scene, cam, nx, ny, 64, seed=10 + rep)
        xla_walls.append(time.perf_counter() - t0)
    xla_wall = min(xla_walls)
    emit("forward", engine="xla", config="cornell_box 800x800 64spp "
         "depth 50", wall_seconds=xla_wall, wall_seconds_all_reps=xla_walls,
         rays_per_sec=nx * ny * 64 / xla_wall)

    k = radiance(render_pallas, scene, cam, nx, ny, 500, seed=20)
    x = radiance(render, scene, cam, nx, ny, 64, seed=21)
    km, xm = k.mean(0), x.mean(0)
    d = k - x                   # pixels are independent: SE from the spread
    rel = (km - xm) / xm
    z = d.mean(0) / (d.std(0, ddof=1) / np.sqrt(len(d)))
    mirror = np.asarray(CORNELL_MIRROR_MEANS)
    rel_mirror = (km - mirror) / mirror
    emit("forward", check="unclipped radiance", config="cornell_box "
         "800x800, kernel 500spp, xla 64spp", mean_kernel=km.tolist(),
         mean_xla=xm.tolist(), mean_mirror=mirror.tolist(),
         rel_xla=rel.tolist(), z_xla=z.tolist(),
         rel_mirror=rel_mirror.tolist(),
         luminance_kernel=float(km @ LUMA),
         luminance_mirror=float(mirror @ LUMA), tol=0.01)
    check((np.abs(rel) < 0.01).all(), f"kernel vs XLA radiance rel {rel}")
    check((np.abs(rel_mirror) < 0.01).all(),
          f"kernel vs reference mirror radiance rel {rel_mirror}")
    return nx * ny * 500 / wall, nx * ny * 64 / xla_wall


def phase_parity():
    from tools.parity import CONFIGS, check_checkpoint_resume, check_config
    for key in CONFIGS:
        r = check_config(key)
        emit("parity", **r)
        check(r["pass"], f"parity {key}: {r}")
    r = check_checkpoint_resume()
    emit("parity", **r)
    check(r["pass"], "kernel checkpoint/resume")


def phase_gradient():
    """Fused tier and XLA scan on the production step; returns both
    sample-paths/s for phase 6."""
    import numpy as np
    from raytracing_rust_tpu.benchlib import grad_throughput
    from tools.parity import check_grad_tier

    out = {}
    for engine in ("auto", "xla"):
        r = grad_throughput(reps=3, engine=engine)
        losses = np.asarray(r.pop("grad_losses"))
        emit("compile", kernel=("rt_grad_fwd+rt_grad_bwd"
                                if r["grad_engine"] == "pallas_fused"
                                else "xla remat scan"),
             config=r["grad_config"],
             seconds=r.pop("grad_compile_seconds"),
             memory_analysis=r.pop("grad_memory_analysis"))
        emit("gradient", **r, first_chunk_loss=float(losses[:10].mean()),
             last_chunk_loss=float(losses[-10:].mean()))
        check(np.isfinite(losses).all(), f"{engine}: non-finite loss")
        check(losses[-10:].mean() < losses[:10].mean(),
              f"{engine}: loss did not fall")
        out[r["grad_engine"]] = r["grad_samples_per_sec"]
    check("pallas_fused" in out, "production step did not use the kernels")
    r = check_grad_tier()
    emit("gradient", **r)
    check(r["pass"], f"fused gradients vs XLA scan: {r}")
    return out["pallas_fused"], out["xla_scan"]


def four_cards():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from raytracing_rust_tpu.models.builders import PRESETS
    from raytracing_rust_tpu.ops.pallas_tracer import render_pallas
    from raytracing_rust_tpu.parallel.sharding import (make_mesh,
                                                       render_sharded,
                                                       train_step_sharded)

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    p = PRESETS["cornell_box"]
    scene, cam = p.build(), p.camera()
    nx = ny = 256
    mesh4 = make_mesh(devs, dp=2, sp=2)
    mesh1 = make_mesh(devs[:1], dp=1, sp=1)
    t0 = time.perf_counter()
    img4 = render_sharded(scene, cam, nx, ny, 16, mesh4, seed=3)
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    img1 = render_sharded(scene, cam, nx, ny, 16, mesh1, seed=3)
    t1 = time.perf_counter() - t0
    diff = float(np.abs(img4 - img1).max())
    emit("four_cards", check="render_sharded", mesh="dp2 x sp2",
         config=f"cornell_box {nx}x{ny} 16spp depth 50", max_abs_diff=diff,
         tol=1e-5, seconds_4=t4, seconds_1=t1)
    check(diff <= 1e-5, f"render_sharded 4 vs 1 max diff {diff}")

    pix = jnp.arange(4096, dtype=jnp.int32) * 7 % (nx * ny)
    key = jax.random.key(5)
    target = jnp.full((4096, 3), 0.1, jnp.float32)
    step = jax.jit(train_step_sharded,
                   static_argnames=("nx", "ny", "spp", "max_depth", "mesh"))
    res = {}
    for name, mesh in (("4", mesh4), ("1", mesh1)):
        loss, g = step(scene, cam, pix, key, target, nx=nx, ny=ny, spp=8,
                       max_depth=6, mesh=mesh)
        res[name] = (float(loss), np.asarray(g.tex_color),
                     np.asarray(g.prim_data))
    l_rel = abs(res["4"][0] - res["1"][0]) / abs(res["1"][0])
    g_rel = max(float(np.abs(res["4"][i] - res["1"][i]).max()
                      / max(np.abs(res["1"][i]).max(), 1e-12))
                for i in (1, 2))
    emit("four_cards", check="train_step_sharded", mesh="dp2 x sp2",
         loss_rel=l_rel, grad_rel=g_rel, tol=1e-5)
    check(l_rel <= 1e-5 and g_rel <= 1e-5,
          f"train_step_sharded 4 vs 1: loss {l_rel}, grads {g_rel}")

    a = render_pallas(scene, cam, 400, 400, 64, seed=9, devices=devs)
    b = render_pallas(scene, cam, 400, 400, 64, seed=9, devices=devs[:1])
    diff = float(np.abs(a - b).max())
    from raytracing_rust_tpu.ops.pallas_tracer import BLOCK, tile_bounds
    bounds = tile_bounds(-(-400 * 400 // BLOCK), 4)
    spans = [bounds[i + 1] - bounds[i] for i in range(4)]
    emit("four_cards", check="render_pallas split", tiles_per_device=spans,
         max_abs_diff=diff, tol=1e-6)
    check(diff <= 1e-6 and min(spans) > 0,
          f"render_pallas 4 vs 1: diff {diff}, spans {spans}")


def main() -> int:
    global CARD
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    from raytracing_rust_tpu.backend import card_label, init_compile_cache

    init_compile_cache()
    CARD = card_label()
    n = len(jax.devices())
    print(f"card: {CARD}", flush=True)
    emit("device", platform=dev.platform, kind=dev.device_kind, count=n)
    if "--four-cards" in sys.argv:
        four_cards()
    else:
        t = time.perf_counter()
        phase_compile()
        fwd_kernel, fwd_xla = phase_forward()
        phase_parity()
        grad_kernel, grad_xla = phase_gradient()
        emit("timings", forward_kernel_rays_per_sec=fwd_kernel,
             forward_xla_rays_per_sec=fwd_xla,
             forward_speedup=fwd_kernel / fwd_xla,
             grad_kernel_paths_per_sec=grad_kernel,
             grad_xla_paths_per_sec=grad_xla,
             grad_speedup=grad_kernel / grad_xla,
             total_seconds=time.perf_counter() - t)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
