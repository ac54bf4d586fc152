#!/usr/bin/env python
"""Inverse rendering at production scale: recover scene parameters by
gradient descent through the full path tracer.

A 200×200 target image of a cornell-style box is optimized against with
Adam on an L2 photometric loss over random pixel blocks (spp 64 per step,
`parallel.sharding.train_step_sharded` on a dp×sp device mesh — GSPMD
psum-reduces the parameter gradients, the ray-tracing analogue of DP
gradient sync). TWO parameter groups are recovered simultaneously: the
tall box's albedo (3 channels) and the ceiling light's emission (scalar) —
wall pixels pin the emission, box pixels then pin the albedo. Gradients
flow through `trace(differentiable=True)`'s rematerialized bounce scan.
This is the capability the reference renderer fundamentally lacks: its
scene parameters are opaque to any optimizer.

The per-step target radiance is rendered with the SAME pixel block, lane
layout, and RNG key as the candidate: an L2 between two INDEPENDENT MC
estimates would reward variance reduction (darker albedo = less noise)
over matching the mean; path-matched draws cancel that bias.

Runs on JAX's default backend (one GPU → a 1x1 mesh and the fused
Pallas differentiable tier):
    python examples/inverse_render.py
`--cpu-mesh` runs the same program on an 8-device virtual CPU mesh (the
sharded XLA path, as the CPU test suite does); `--quick` runs the
original small single-device demo (8,192 rays).
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

if __name__ == "__main__" and "--cpu-mesh" in sys.argv:
    # before JAX starts: the virtual device count is read at backend init
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import jax.numpy as jnp
import numpy as np
import optax

from raytracing_rust_tpu.backend import gpu_kernels
from raytracing_rust_tpu.models.scene import SceneBuilder, BG_BLACK
from raytracing_rust_tpu.ops.camera import make_camera
from raytracing_rust_tpu.ops.integrator import trace

TRUE_ALBEDO = (0.2, 0.5, 0.8)   # ground-truth blue-ish box
TRUE_EMIT = 5.0                  # ground-truth light emission


def build_scene(box_albedo=(0.73, 0.73, 0.73), emit=TRUE_EMIT):
    b = SceneBuilder(background=BG_BLACK)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    b.rect("zx", -3, -3, 3, 3, 0.0, white)                       # floor
    b.rect("yz", 0, -3, 6, 3, -3.0, b.lambertian(b.solid(0.65, 0.05, 0.05)))
    b.rect("yz", 0, -3, 6, 3, 3.0, b.lambertian(b.solid(0.12, 0.45, 0.15)),
           flip=True)
    b.rect("zx", -2, -2, 2, 2, 5.9, b.diffuse_light(b.solid(emit, emit, emit)),
           flip=True)
    box_mat = b.lambertian(b.solid(*box_albedo))
    b.cube((-1.0, 0.0, -1.0), (1.0, 2.5, 1.0), box_mat)
    return b.build()


def param_tex_rows(scene):
    """(light_tex, box_tex) texture-table rows of the two trained
    parameter groups, derived from build_scene's push order (material 3
    is the diffuse light, the box material is pushed last). The ONE
    derivation — benchlib and tools/profile_train_step.py import it, so
    reordering build_scene cannot silently point them at the wrong
    texture rows."""
    light_tex = int(np.asarray(scene.mat_texture)[3])
    box_tex = int(np.asarray(scene.mat_texture)[-1])
    return light_tex, box_tex


def make_step_body(target_scene, scene, cam, box_tex, light_tex,
                   nx, ny, spp, max_depth, mesh, block, opt):
    """The training-step body shared by make_fused_step (jitted directly)
    and make_scan_steps (as the lax.scan body): pixel choice, path-matched
    target render, value_and_grad, optax update, clip. ONE copy so the
    RNG contract and the clip bounds cannot drift between the two loops.

    RNG contract: the per-step trace key is fold_in(key(0), i) for BOTH
    target and candidate (path-matched estimator — see module docstring);
    the pixel block comes from an independent fold of key(1)."""
    from raytracing_rust_tpu.parallel.sharding import (
        render_block_sharded, train_step_sharded)
    n_pix = nx * ny

    def step(params, state, i):
        k = jax.random.fold_in(jax.random.key(0), i)
        kp = jax.random.fold_in(jax.random.key(1), i)
        pix = jax.random.choice(kp, n_pix, (block,),
                                replace=False).astype(jnp.int32)
        target = render_block_sharded(target_scene, cam, pix, k, nx, ny,
                                      spp, max_depth, mesh) / spp
        s2 = dataclasses.replace(
            scene, tex_color=scene.tex_color
            .at[box_tex].set(params["albedo"])
            .at[light_tex].set(jnp.broadcast_to(params["emit"], (3,))))
        loss, grads = train_step_sharded(s2, cam, pix, k, target, nx=nx,
                                         ny=ny, spp=spp, max_depth=max_depth,
                                         mesh=mesh)
        g = {"albedo": grads.tex_color[box_tex],
             "emit": grads.tex_color[light_tex].sum()}
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params = {"albedo": jnp.clip(params["albedo"], 0.0, 1.0),
                  "emit": jnp.clip(params["emit"], 0.0, 20.0)}
        return params, state, loss

    return step


def make_fast_step_body(target_scene, scene, cam, box_tex, light_tex,
                        nx, ny, spp, max_depth, block, opt, cfg):
    """The training-step body on the FUSED Pallas differentiable tier
    (ops/pallas_grad.py): same pixel choice, clip bounds, and
    path-matched-estimator contract as make_step_body, but the trace —
    forward for the target, forward+backward for the candidate — runs
    as whole-trace GPU kernels instead of the XLA bounce scan.

    Path matching here is exact by construction: target and candidate
    share the SAME camera rays (one camera_lane_rays call) and the SAME
    in-trace draw tensor (trace_fast draws from the same per-step key),
    so the L2 compares two estimates of the same paths, differing only
    through the scene parameters."""
    from raytracing_rust_tpu.ops.pallas_grad import trace_fast
    from raytracing_rust_tpu.render import camera_lane_rays
    n_pix = nx * ny

    def step(params, state, i):
        k = jax.random.fold_in(jax.random.key(0), i)
        kp = jax.random.fold_in(jax.random.key(1), i)
        pix = jax.random.choice(kp, n_pix, (block,),
                                replace=False).astype(jnp.int32)
        pid = jnp.repeat(pix, spp)
        o, d, _ = camera_lane_rays(cam, pid, k, nx, ny)

        def img(s):
            rad = trace_fast(s, o, d, k, max_depth=max_depth, cfg=cfg)
            return rad.reshape(block, spp, 3).sum(axis=1) / spp

        target = jax.lax.stop_gradient(img(target_scene))

        def loss_fn(p):
            s2 = dataclasses.replace(
                scene, tex_color=scene.tex_color
                .at[box_tex].set(p["albedo"])
                .at[light_tex].set(jnp.broadcast_to(p["emit"], (3,))))
            return jnp.mean((img(s2) - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params = {"albedo": jnp.clip(params["albedo"], 0.0, 1.0),
                  "emit": jnp.clip(params["emit"], 0.0, 20.0)}
        return params, state, loss

    return step


def make_fused_step(target_scene, scene, cam, box_tex, light_tex,
                    nx, ny, spp, max_depth, mesh, block, opt):
    """ONE jitted dispatch per training step.

    Pixel choice, target render, grad, optimizer and clipping fuse into
    one compiled step, with no intermediate host touch; the loop pulls
    one scalar loss when it wants to print.

    RNG contract matches the unfused loop: the per-step trace key is
    fold_in(key(0), step) for BOTH target and candidate (path-matched
    estimator — see module docstring); the pixel block comes from an
    independent fold of key(1) (the unfused loop drew it with numpy,
    statistically equivalent). The production loop scans whole step
    chunks on device instead (make_scan_steps).
    """
    return jax.jit(make_step_body(target_scene, scene, cam, box_tex,
                                  light_tex, nx, ny, spp, max_depth, mesh,
                                  block, opt))


def make_scan_steps(target_scene, scene, cam, box_tex, light_tex,
                    nx, ny, spp, max_depth, mesh, block, opt, chunk,
                    step_fn=None):
    """`chunk` training steps as ONE dispatch: lax.scan over step indices.

    Scanning keeps the per-step feedback edge (params/state out → in) on
    device, so a chunk pays ONE dispatch + ONE host pull for `chunk`
    steps. The body is make_step_body (or the fused-tier step_fn) — the
    SAME code the fused step jits, so the RNG contract cannot drift;
    per-step losses come back as the scan ys for host-side printing.
    """
    step = step_fn or make_step_body(target_scene, scene, cam, box_tex,
                                     light_tex, nx, ny, spp, max_depth,
                                     mesh, block, opt)

    @jax.jit
    def run_chunk(params, state, i0):
        def body(carry, i):
            params, state = carry
            params, state, loss = step(params, state, i)
            return (params, state), loss

        (params, state), losses = jax.lax.scan(
            body, (params, state), i0 + jnp.arange(chunk, dtype=jnp.uint32))
        return params, state, losses

    return run_chunk


def main_sharded(steps: int, nx: int = 200, ny: int = 200, spp: int = 64,
                 block: int = 4096, max_depth: int = 6,
                 fused: bool = True, chunk: int = 10,
                 fast: bool = True) -> int:
    from raytracing_rust_tpu.parallel.sharding import (
        make_mesh, render_block_sharded, train_step_sharded)

    devs = jax.devices()
    sp = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
    mesh = make_mesh(devs, dp=len(devs) // sp, sp=sp)
    print(f"mesh: dp={mesh.shape['dp']} sp={mesh.shape['sp']} "
          f"({devs[0].platform}), image {nx}x{ny}, spp {spp}/step, "
          f"block {block} pixels, depth {max_depth}")

    target_scene = build_scene(TRUE_ALBEDO, TRUE_EMIT)
    scene = build_scene((0.5, 0.5, 0.5), 3.0)  # start grey, dim light
    light_tex, box_tex = param_tex_rows(scene)

    step_fn = jax.jit(train_step_sharded,
                      static_argnames=("nx", "ny", "spp", "max_depth",
                                       "mesh"))

    # explicit dtype: jnp.asarray(3.0) is WEAK-typed, and the scan returns
    # strong f32 — feeding that back would recompile the chunk on call 2.
    params = {"albedo": jnp.asarray([0.5, 0.5, 0.5], jnp.float32),
              "emit": jnp.asarray(3.0, jnp.float32)}
    # per-group lr: Adam steps ≈ lr, and emission must travel ~2.0 in
    # `steps` updates while albedo travels ≤0.3 — one lr cannot serve both.
    # Cosine decay damps the momentum overshoot once each group arrives.
    # The fused loop rounds steps UP to whole chunks (a shorter final
    # chunk would recompile the scan program), so the decay horizon must
    # cover the rounded count or the overflow steps train at alpha-floor
    # lr outside the schedule.
    total = (-(-steps // min(chunk, steps)) * min(chunk, steps)
             if fused else steps)
    sched = lambda lr: optax.cosine_decay_schedule(lr, total, alpha=0.1)
    opt = optax.multi_transform(
        {"albedo": optax.adam(sched(0.05)), "emit": optax.adam(sched(0.25))},
        {"albedo": "albedo", "emit": "emit"})
    state = opt.init(params)
    rng = np.random.default_rng(0)
    base = jax.random.key(0)
    n_pix = nx * ny

    print(f"target: albedo [{TRUE_ALBEDO[0]:.2f} {TRUE_ALBEDO[1]:.2f} "
          f"{TRUE_ALBEDO[2]:.2f}], emission {TRUE_EMIT:.2f}; "
          f"start: albedo [0.50 0.50 0.50], emission 3.00")

    if fused:
        # Chunked on-device loop: lax.scan keeps the params/state feedback
        # edge on the device (make_scan_steps). steps rounds UP to a whole number of chunks (a shorter final
        # chunk would be a second compile of the scan program); `total`
        # above already covers the rounded count for the lr schedule
        chunk = min(chunk, steps)
        n_chunks = -(-steps // chunk)
        if n_chunks * chunk != steps:
            print(f"note: --steps {steps} rounds UP to {n_chunks * chunk} "
                  f"(whole {chunk}-step scan chunks; a shorter final chunk "
                  f"would be a second compile)")
        # fused Pallas differentiable tier on a single GPU; several
        # devices (the CPU mesh included) run the sharded XLA path, which
        # is also the path for unsupported scenes
        from raytracing_rust_tpu.ops.pallas_grad import (
            fast_grad_config, supports_fast_grad)
        use_fast = (fast and len(devs) == 1 and gpu_kernels()
                    and supports_fast_grad(scene, max_depth))
        step_fn = None
        if use_fast:
            step_fn = make_fast_step_body(
                target_scene, scene, cam, box_tex, light_tex, nx, ny,
                spp, max_depth, block, opt, fast_grad_config(scene))
        print(f"differentiable tier: "
              f"{'fused pallas' if use_fast else 'xla scan'}")
        run_chunk = make_scan_steps(target_scene, scene, cam, box_tex,
                                    light_tex, nx, ny, spp, max_depth,
                                    mesh, block, opt, chunk,
                                    step_fn=step_fn)
        # pre-place params/state with the sharding the scan RETURNS
        # (replicated NamedSharding over the mesh): otherwise chunk 0
        # compiles for unspecified-sharding inputs and chunk 1 — fed
        # chunk 0's outputs — recompiles the whole program.
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        params, state = jax.device_put((params, state), repl)
        t0 = time.perf_counter()
        walls = []
        for c in range(n_chunks):
            params, state, losses = run_chunk(
                params, state, jnp.asarray(c * chunk, jnp.uint32))
            losses = np.asarray(losses)      # host pull = chunk completion
            a = np.asarray(params["albedo"])
            walls.append(time.perf_counter() - t0)
            done = (c + 1) * chunk
            print(f"step {done - 1:3d}  loss {losses[-1]:.5f}  "
                  f"albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}]  "
                  f"emit {float(params['emit']):.3f}  "
                  f"({walls[-1]:.2f}s chunk of {chunk})")
            t0 = time.perf_counter()
        a = np.asarray(params["albedo"])
        e = float(params["emit"])
        if n_chunks > 1:
            # median of post-compile chunks: robust to one-off stalls
            steady = float(np.median(walls[1:])) / chunk
            tag = "median steady chunk"
        else:
            steady = walls[0] / total
            tag = "avg incl. compile (single chunk)"
        err_a = np.abs(a - np.asarray(TRUE_ALBEDO)).max()
        err_e = abs(e - TRUE_EMIT)
        rays = block * spp
        print(f"recovered albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}] "
              f"(max abs err {err_a:.3f}), emission {e:.3f} "
              f"(err {err_e:.3f})")
        print(f"step time: {steady:.3f}s {tag} (on-device scan, "
              f"{chunk} steps/dispatch; {rays / 1e6:.2f}M target + "
              f"{rays / 1e6:.2f}M candidate sample-paths/step fwd+bwd, "
              f"depth {max_depth})")
        return 0 if (err_a < 0.1 and err_e < 0.5) else 1

    wall = []
    t_loop = time.perf_counter()
    for step in range(steps):
        pix = jnp.asarray(rng.choice(n_pix, size=block, replace=False)
                          .astype(np.int32))
        k = jax.random.fold_in(base, step)
        t0 = time.perf_counter()
        # path-matched target radiance for this block (same key/layout)
        target = render_block_sharded(target_scene, cam, pix, k, nx, ny,
                                      spp, max_depth, mesh) / spp
        s2 = dataclasses.replace(
            scene, tex_color=scene.tex_color
            .at[box_tex].set(params["albedo"])
            .at[light_tex].set(jnp.broadcast_to(params["emit"], (3,))))
        loss, grads = step_fn(s2, cam, pix, k, target, nx=nx, ny=ny,
                              spp=spp, max_depth=max_depth, mesh=mesh)
        g = {"albedo": grads.tex_color[box_tex],
             "emit": grads.tex_color[light_tex].sum()}
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params["albedo"] = jnp.clip(params["albedo"], 0.0, 1.0)
        params["emit"] = jnp.clip(params["emit"], 0.0, 20.0)
        jax.block_until_ready(params)
        wall.append(time.perf_counter() - t0)
        if step == 0:
            t_loop = time.perf_counter()  # steady-state clock (post-compile)
        if step % 5 == 0 or step == steps - 1:
            a = np.asarray(params["albedo"])
            print(f"step {step:3d}  loss {float(loss):.5f}  "
                  f"albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}]  "
                  f"emit {float(params['emit']):.3f}  "
                  f"({wall[-1]:.2f}s)")

    # materialize on host BEFORE stopping the clock, so the aggregate
    # below covers real completion
    a = np.asarray(params["albedo"])
    e = float(params["emit"])
    steady = (time.perf_counter() - t_loop) / max(steps - 1, 1)
    err_a = np.abs(a - np.asarray(TRUE_ALBEDO)).max()
    err_e = abs(e - TRUE_EMIT)
    rays = block * spp
    print(f"recovered albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}] "
          f"(max abs err {err_a:.3f}), emission {e:.3f} (err {err_e:.3f})")
    print(f"step time: {steady:.2f}s steady-state avg "
          f"({rays / 1e6:.2f}M target + {rays / 1e6:.2f}M candidate "
          f"sample-paths/step fwd+bwd, depth {max_depth})")
    return 0 if (err_a < 0.1 and err_e < 0.5) else 1


# --- geometry recovery mode (--geometry) ---------------------------------
#
# The third parameter FAMILY (geometry) at production scale. Parameter
# choice is measurement-driven, not arbitrary: this framework (like the
# reference's math) differentiates the path-tracing INTEGRAND only — no
# silhouette/edge term — so any geometry whose visual effect is
# coverage-dominated has a zero-a.e. or actively wrong photometric
# gradient. Measured (DESIGN.md "Geometry recovery"): the cornell
# light's HEIGHT sits at exactly its init forever (light-distance falloff
# lives in discrete hit events; emitted radiance is t-independent), and a
# sphere's RADIUS collapses to the clip floor (shrinking always reduces
# the covered-pixel integrand mismatch; the counterbalancing coverage
# term is invisible). A cube's TILT about its own center is
# shading-dominated — rotating normals continuously modulates the sky
# field — and converges cleanly: 25° recovered to ±0.5° in 200 steps.

TRUE_GEO_ALBEDO = (0.2, 0.5, 0.8)
TRUE_GEO_EMIT = 4.0
TRUE_TILT_DEG = 25.0
GEO_XF = 1  # the cube's transform row (row 0 is the identity slot)

cam_geo = make_camera((0, 2.2, 8), (0, 1.2, 0), (0, 1, 0), 40.0,
                      1.0, 0.0, 8.0)


def build_geo_scene(albedo=(0.5, 0.5, 0.5), emit=TRUE_GEO_EMIT,
                    tilt_deg=0.0):
    from raytracing_rust_tpu.models.scene import BG_SKY
    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.rect("zx", -1.5, -1.5, 1.5, 1.5, 6.0,
           b.diffuse_light(b.solid(emit, emit, emit)), flip=True)
    # cube CENTERED on the rotation origin, lifted by the translate —
    # rotation about the world origin would also translate it, turning
    # the in-place tilt into coverage change (measured: gradient runs
    # the wrong way)
    xf = b.transform(offset=(0.0, 1.3, 0.0), rotate_axis="x",
                     angle_deg=tilt_deg)
    b.cube((-0.9, -0.9, -0.9), (0.9, 0.9, 0.9),
           b.lambertian(b.solid(*albedo)), xform=xf)
    return b.build()


def main_geometry(steps: int = 200, nx: int = 200, ny: int = 200,
                  spp: int = 64, block: int = 4096, max_depth: int = 6,
                  chunk: int = 10, fast: bool = True) -> int:
    import math

    from raytracing_rust_tpu.ops.pallas_grad import (
        fast_grad_config, supports_fast_grad, trace_fast)
    from raytracing_rust_tpu.render import camera_lane_rays

    devs = jax.devices()
    target_scene = build_geo_scene(TRUE_GEO_ALBEDO, TRUE_GEO_EMIT,
                                   TRUE_TILT_DEG)
    scene = build_geo_scene()
    use_fast = (fast and len(devs) == 1 and gpu_kernels()
                and supports_fast_grad(scene, max_depth))
    cfg = fast_grad_config(scene) if use_fast else None
    c_tex = int(np.asarray(scene.mat_texture)
                [np.asarray(scene.prim_material)[-1]])
    l_tex = int(np.asarray(scene.mat_texture)
                [np.asarray(scene.prim_material)[1]])
    print(f"geometry mode ({devs[0].platform}, "
          f"{'fused pallas' if use_fast else 'xla scan'}): recover cube "
          f"tilt {TRUE_TILT_DEG}° + albedo + emission, {nx}x{ny}, "
          f"block {block}, spp {spp}, depth {max_depth}")

    total = -(-steps // chunk) * chunk
    sched = lambda lr: optax.cosine_decay_schedule(lr, total, alpha=0.1)
    opt = optax.multi_transform(
        {"albedo": optax.adam(sched(0.05)), "emit": optax.adam(sched(0.2)),
         "theta": optax.adam(sched(0.06))},
        {"albedo": "albedo", "emit": "emit", "theta": "theta"})
    params = {"albedo": jnp.asarray([0.5, 0.5, 0.5], jnp.float32),
              "emit": jnp.asarray(2.0, jnp.float32),
              "theta": jnp.asarray(0.0, jnp.float32)}
    state = opt.init(params)

    def step(params, state, i):
        k = jax.random.fold_in(jax.random.key(0), i)
        kp = jax.random.fold_in(jax.random.key(1), i)
        pix = jax.random.choice(kp, nx * ny, (block,),
                                replace=False).astype(jnp.int32)
        o, d, tm = camera_lane_rays(cam_geo, jnp.repeat(pix, spp), k,
                                    nx, ny)

        def img(s):
            if use_fast:
                rad = trace_fast(s, o, d, k, max_depth=max_depth, cfg=cfg)
            else:
                rad = trace(s, o, d, tm, k, max_depth=max_depth,
                            differentiable=True)
            return rad.reshape(block, spp, 3).sum(axis=1) / spp

        target = jax.lax.stop_gradient(img(target_scene))

        def loss_fn(p):
            s2 = dataclasses.replace(
                scene,
                tex_color=scene.tex_color
                .at[c_tex].set(p["albedo"])
                .at[l_tex].set(jnp.broadcast_to(p["emit"], (3,))),
                xf_sin=scene.xf_sin.at[GEO_XF].set(jnp.sin(p["theta"])),
                xf_cos=scene.xf_cos.at[GEO_XF].set(jnp.cos(p["theta"])))
            return jnp.mean((img(s2) - target) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params = {"albedo": jnp.clip(params["albedo"], 0.0, 1.0),
                  "emit": jnp.clip(params["emit"], 0.0, 20.0),
                  "theta": jnp.clip(params["theta"], -1.2, 1.2)}
        return params, state, loss

    @jax.jit
    def run_chunk(params, state, i0):
        def body(carry, i):
            p, s = carry
            p, s, loss = step(p, s, i)
            return (p, s), loss

        (params, state), losses = jax.lax.scan(
            body, (params, state), i0 + jnp.arange(chunk, dtype=jnp.uint32))
        return params, state, losses

    repl = jax.sharding.NamedSharding(
        jax.sharding.Mesh(np.array(devs[:1]).reshape(1, 1), ("a", "b")),
        jax.sharding.PartitionSpec())
    params, state = jax.device_put((params, state), repl)
    walls = []
    t0 = time.perf_counter()
    n_chunks = total // chunk
    for c in range(n_chunks):
        params, state, losses = run_chunk(
            params, state, jnp.asarray(c * chunk, jnp.uint32))
        losses = np.asarray(losses)
        walls.append(time.perf_counter() - t0)
        if c % 4 == 3 or c == n_chunks - 1:
            a = np.asarray(params["albedo"])
            print(f"step {(c + 1) * chunk - 1:3d}  loss {losses[-1]:.5f}  "
                  f"albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}]  "
                  f"emit {float(params['emit']):.3f}  tilt "
                  f"{math.degrees(float(params['theta'])):.2f}°  "
                  f"({walls[-1]:.2f}s chunk)")
        t0 = time.perf_counter()
    a = np.asarray(params["albedo"])
    e = float(params["emit"])
    tdeg = math.degrees(float(params["theta"]))
    err_a = np.abs(a - np.asarray(TRUE_GEO_ALBEDO)).max()
    err_e = abs(e - TRUE_GEO_EMIT)
    err_t = abs(tdeg - TRUE_TILT_DEG)
    steady = float(np.median(walls[1:])) / chunk if len(walls) > 1 else 0.0
    print(f"recovered albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}] "
          f"(max abs err {err_a:.3f}), emission {e:.3f} (err {err_e:.3f}), "
          f"tilt {tdeg:.2f}° (err {err_t:.2f}°)")
    print(f"step time: {steady:.3f}s median steady chunk "
          f"(3 groups incl. geometry, depth {max_depth})")
    return 0 if (err_a < 0.05 and err_e < 0.3 and err_t < 3.0) else 1


def rays(n, key):
    u = jax.random.uniform(key, (n, 2))
    s, t = u[:, 0], u[:, 1]
    from raytracing_rust_tpu.ops.camera import get_rays
    return get_rays(cam, s, t, jnp.zeros((n, 3)))


def main_quick() -> int:
    """The original small single-device demo (albedo only, 8,192 rays)."""
    n = 8192
    key = jax.random.key(0)
    o, d, time_ = rays(n, jax.random.fold_in(key, 1))

    target_scene = build_scene(TRUE_ALBEDO)
    scene = build_scene((0.5, 0.5, 0.5))
    _, box_tex = param_tex_rows(scene)

    def loss_fn(albedo, k):
        target = trace(target_scene, o, d, time_, k, max_depth=6,
                       differentiable=True)
        s2 = dataclasses.replace(
            scene, tex_color=scene.tex_color.at[box_tex].set(albedo))
        rad = trace(s2, o, d, time_, k, max_depth=6, differentiable=True)
        return jnp.mean((rad - jax.lax.stop_gradient(target)) ** 2)

    albedo = jnp.asarray([0.5, 0.5, 0.5])
    opt = optax.adam(0.05)
    state = opt.init(albedo)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))

    print(f"target albedo: [0.20 0.50 0.80], start: {np.asarray(albedo)}")
    for step in range(60):
        k = jax.random.fold_in(key, 100 + step)
        loss, g = grad_fn(albedo, k)
        updates, state = opt.update(g, state)
        albedo = jnp.clip(optax.apply_updates(albedo, updates), 0.0, 1.0)
        if step % 10 == 0 or step == 59:
            a = np.asarray(albedo)
            print(f"step {step:3d}  loss {float(loss):.5f}  "
                  f"albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}]")

    a = np.asarray(albedo)
    err = np.abs(a - np.array(TRUE_ALBEDO)).max()
    print(f"recovered albedo [{a[0]:.3f} {a[1]:.3f} {a[2]:.3f}] "
          f"(max abs err {err:.3f})")
    return 0 if err < 0.08 else 1


cam = make_camera((0, 3, 9), (0, 1.5, 0), (0, 1, 0), 45.0, 1.0, 0.0, 9.0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="original small single-device demo")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--unfused", action="store_true",
                    help="round-3 loop (2 dispatches + eager tail) for A/B")
    ap.add_argument("--no-fast", action="store_true",
                    help="force the XLA-scan differentiable tier even "
                         "where the fused Pallas tier applies (A/B)")
    ap.add_argument("--geometry", action="store_true",
                    help="production-scale GEOMETRY recovery (cube tilt "
                         "+ albedo + emission, 200 steps default)")
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="run on an 8-device virtual CPU mesh instead of "
                         "the default backend")
    args = ap.parse_args()
    from raytracing_rust_tpu.backend import init_compile_cache
    init_compile_cache()
    if args.quick:
        sys.exit(main_quick())
    if args.geometry:
        sys.exit(main_geometry(
            args.steps if args.steps != 40 else 200, spp=args.spp,
            block=args.block, fast=not args.no_fast))
    sys.exit(main_sharded(args.steps, spp=args.spp, block=args.block,
                          fused=not args.unfused, fast=not args.no_fast))
