#!/usr/bin/env python
"""Where does one inverse-render training step spend its time?

Times the step's components SEPARATELY on the device so the
optimization target is a measurement, not a guess:

  target      — forward render of the path-matched target block
                (render_block_sharded; jit dispatch #1 of the old loop);
  grad        — value_and_grad through the rematerialized bounce scan
                (train_step_sharded; jit dispatch #2);
  fwd_diff    — the SAME differentiable trace, value only (splits the
                grad entry into forward vs backward cost);
  host_tail   — everything the old loop ran eagerly between dispatches
                (scene tex_color updates, grad extraction, optax update,
                clipping) measured as full-loop minus the dispatches;
  full_loop   — the unfused per-step wall;
  fused_loop  — ONE jitted step doing all of the above in a single
                dispatch (examples/inverse_render.py --fused path).

Each phase is timed as an aggregate wall over N steps ending in a host
pull, never per-op.

    python tools/profile_train_step.py [--steps N]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from examples.inverse_render import (TRUE_ALBEDO, TRUE_EMIT,  # noqa: E402
                                     build_scene, cam, param_tex_rows)
from raytracing_rust_tpu.parallel.sharding import (  # noqa: E402
    make_mesh, render_block_sharded, train_step_sharded)


def timed(label, n, fn, *args):
    """Aggregate wall over n calls, host-pulling the last result."""
    out = fn(*args)                      # compile + warm
    np.asarray(jax.tree.leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    np.asarray(jax.tree.leaves(out)[0])
    dt = (time.perf_counter() - t0) / n
    print(f"  {label:<28s} {dt * 1e3:8.1f} ms/step")
    return dt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=6)
    args = ap.parse_args()
    n = args.steps

    devs = jax.devices()
    mesh = make_mesh(devs, dp=len(devs), sp=1)
    print(f"device: {devs[0]}  block={args.block} spp={args.spp} "
          f"depth={args.depth}  ({n} timed steps/phase)")

    target_scene = build_scene(TRUE_ALBEDO, TRUE_EMIT)
    scene = build_scene((0.5, 0.5, 0.5), 3.0)
    nx = ny = 200
    rng = np.random.default_rng(0)
    pix = jnp.asarray(rng.choice(nx * ny, size=args.block, replace=False)
                      .astype(np.int32))
    key = jax.random.key(7)

    kw = dict(nx=nx, ny=ny, spp=args.spp, max_depth=args.depth, mesh=mesh)

    t_target = timed("target render (fwd)", n,
                     lambda: render_block_sharded(target_scene, cam, pix,
                                                  key, **kw))
    target = render_block_sharded(target_scene, cam, pix, key, **kw) / args.spp

    step_fn = jax.jit(train_step_sharded,
                      static_argnames=("nx", "ny", "spp", "max_depth",
                                       "mesh"))
    t_grad = timed("value_and_grad (fwd+bwd)", n,
                   lambda: step_fn(scene, cam, pix, key, target, **kw))

    # value only, same differentiable scan — isolates the backward pass
    @jax.jit
    def fwd_diff(scene):
        from raytracing_rust_tpu.parallel.sharding import _lane_radiance
        sums = _lane_radiance(scene, cam, pix, key, nx, ny, args.spp,
                              args.depth, True)
        return jnp.mean((sums / args.spp - target) ** 2)

    t_fwd = timed("fwd only (diff scan)", n, lambda: fwd_diff(scene))

    # non-differentiable while-loop forward for reference
    t_while = timed("fwd only (while_loop)", n,
                    lambda: render_block_sharded(scene, cam, pix, key, **kw))

    # ---- the old unfused loop, verbatim shape -------------------------
    light_tex, box_tex = param_tex_rows(scene)
    params = {"albedo": jnp.asarray([0.5, 0.5, 0.5]),
              "emit": jnp.asarray(3.0)}
    opt = optax.multi_transform(
        {"albedo": optax.adam(0.05), "emit": optax.adam(0.25)},
        {"albedo": "albedo", "emit": "emit"})
    state = opt.init(params)
    base = jax.random.key(0)

    def unfused_step(step, params, state):
        p = jnp.asarray(rng.choice(nx * ny, size=args.block, replace=False)
                        .astype(np.int32))
        k = jax.random.fold_in(base, step)
        tgt = render_block_sharded(target_scene, cam, p, k, **kw) / args.spp
        s2 = dataclasses.replace(
            scene, tex_color=scene.tex_color
            .at[box_tex].set(params["albedo"])
            .at[light_tex].set(jnp.broadcast_to(params["emit"], (3,))))
        loss, grads = step_fn(s2, cam, p, k, tgt, **kw)
        g = {"albedo": grads.tex_color[box_tex],
             "emit": grads.tex_color[light_tex].sum()}
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        params["albedo"] = jnp.clip(params["albedo"], 0.0, 1.0)
        params["emit"] = jnp.clip(params["emit"], 0.0, 20.0)
        return params, state

    unfused_step(0, params, state)           # warm both dispatch shapes
    np.asarray(params["albedo"])
    t0 = time.perf_counter()
    for s in range(n):
        params, state = unfused_step(s + 1, params, state)
    np.asarray(params["albedo"])
    t_full = (time.perf_counter() - t0) / n
    print(f"  {'full loop (unfused)':<28s} {t_full * 1e3:8.1f} ms/step")
    tail = t_full - t_target - t_grad
    print(f"  {'-> host/eager tail':<28s} {tail * 1e3:8.1f} ms/step "
          f"(full - target - grad)")

    # ---- the fused single-dispatch step -------------------------------
    from examples.inverse_render import make_fused_step
    fused = make_fused_step(target_scene, scene, cam, box_tex, light_tex,
                            nx, ny, args.spp, args.depth, mesh,
                            args.block, opt)
    # explicit f32 (NOT weak-typed): if the optax chain strongifies a
    # scalar anywhere, a weak-init warm call compiles one signature and
    # the first TIMED iteration silently recompiles (1-5 min through the
    # remote helper) — the same trap the scan section below pins
    params = {"albedo": jnp.asarray([0.5, 0.5, 0.5], jnp.float32),
              "emit": jnp.asarray(3.0, jnp.float32)}
    state = opt.init(params)
    params, state, loss = fused(params, state, jnp.asarray(0, jnp.uint32))
    np.asarray(params["albedo"])
    t0 = time.perf_counter()
    for s in range(n):
        params, state, loss = fused(params, state,
                                    jnp.asarray(s + 1, jnp.uint32))
    np.asarray(params["albedo"])
    t_fused = (time.perf_counter() - t0) / n
    print(f"  {'fused single dispatch':<28s} {t_fused * 1e3:8.1f} ms/step")

    # ---- the on-device scan (production driver) ------------------------
    from examples.inverse_render import make_scan_steps
    chunk = 10
    run_chunk = make_scan_steps(target_scene, scene, cam, box_tex,
                                light_tex, nx, ny, args.spp, args.depth,
                                mesh, args.block, opt, chunk)
    params = {"albedo": jnp.asarray([0.5, 0.5, 0.5], jnp.float32),
              "emit": jnp.asarray(3.0, jnp.float32)}
    state = opt.init(params)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    params, state = jax.device_put((params, state), repl)
    walls = []
    t0 = time.perf_counter()
    for c in range(4):
        params, state, losses = run_chunk(params, state,
                                          jnp.asarray(c * chunk, jnp.uint32))
        np.asarray(losses)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    t_scan = float(np.median(walls[1:])) / chunk
    print(f"  {'on-device scan (10/chunk)':<28s} {t_scan * 1e3:8.1f} ms/step"
          f"  (chunk walls: {' '.join(f'{w:.2f}' for w in walls)}s)")

    print(f"\nbackward/forward ratio: {(t_grad - t_fwd) / t_fwd:.2f}x; "
          f"intersect+shade fwd is {t_while * 1e3:.0f} ms of the "
          f"{t_grad * 1e3:.0f} ms grad step")
    print(f"fused vs unfused: {t_full / t_fused:.2f}x  "
          f"({t_full * 1e3:.0f} -> {t_fused * 1e3:.0f} ms/step); "
          f"scan vs unfused: {t_full / t_scan:.2f}x "
          f"({t_full * 1e3:.0f} -> {t_scan * 1e3:.0f} ms/step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
