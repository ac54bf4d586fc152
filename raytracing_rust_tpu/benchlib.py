"""Throughput benchmark: rays/sec/chip on the BASELINE.json headline config
(cornell_box 800×800 @ 500 spp).

The reference publishes no performance numbers at all (BASELINE.md: README is
3 lines, no benchmarks dir) and Rust cannot run here, so `vs_baseline` is
computed against a MEASUREMENT of `native/ref_tracer.cpp` — a faithful
single-thread scalar f64 C++ mirror of the reference's hot loop (same
recursion, same rejection-sampled RNG draws, same virtual-dispatch object
model, same linear HittableList scan; reference tests/test.rs:55-85 +
src/color.rs:6-23) — on the same cornell_box camera/geometry at depth 50.
The mirror is re-timed live at bench time when the native toolchain is
available (`reference_measure`); otherwise the recorded measurement in
`native/ref_baseline.json` (written by tools/bench_reference.py, host CPU
documented there) is used. The old 2e5 rays/s estimate survives only as the
last-resort fallback and is labeled as such in `baseline_source`.

Metric definition: primary rays per wall-clock second on one chip =
nx·ny·spp / t. Each primary ray carries its full bounce tree (up to 51
segments, reference src/color.rs:9), so this undercounts total traced
segments by the mean path length — it is the honest end-to-end number a user
of `create_image` would measure.
"""

from __future__ import annotations

import json
import os
import time

REFERENCE_EST_RAYS_PER_SEC = 2.0e5  # last-resort fallback only
REF_BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "native", "ref_baseline.json")


def reference_measure(spp: int = 2):
    """Time the C++ reference mirror once on the headline cornell_box config
    (800×800, depth 50) at a reduced spp — per-primary-ray cost is
    spp-independent, so the throughput transfers to any spp. Returns
    {rays_per_sec, wall_seconds, config} or None if the native toolchain is
    unavailable."""
    from . import native
    from .models.builders import PRESETS

    p = PRESETS["cornell_box"]
    nx, ny = p.nx, p.ny
    r = native.ref_trace(0, nx, ny, spp, p.look_from, p.look_at, p.vfov,
                         vup=p.view_up, aperture=p.aperture,
                         focus_dist=p.focus_dist, time0=p.time0,
                         time1=p.time1, max_depth=50, seed=1234,
                         background=0)
    if r is None:
        return None
    _, secs = r
    return {
        "rays_per_sec": nx * ny * spp / secs,
        "wall_seconds": secs,
        "config": f"cornell_box {nx}x{ny} {spp}spp depth50 f64 1-thread",
    }


def reference_baseline():
    """(rays_per_sec, source) for the vs_baseline denominator: live
    measurement of the C++ mirror (best of 2), else the recorded
    measurement from tools/bench_reference.py, else the documented
    estimate."""
    try:
        runs = [reference_measure() for _ in range(2)]
        runs = [r for r in runs if r is not None]
        if runs:
            return (max(r["rays_per_sec"] for r in runs),
                    "measured (native/ref_tracer.cpp, live)")
    except Exception:
        pass
    try:
        with open(REF_BASELINE_PATH) as f:
            rec = json.load(f)
        return (float(rec["rays_per_sec"]),
                f"measured (recorded {rec.get('date')}, {rec.get('cpu')})")
    except Exception:
        return (REFERENCE_EST_RAYS_PER_SEC, "estimate (fallback)")


def require_gpu() -> None:
    """Device benchmarks measure the card: refuse any other backend
    rather than time the CPU under a device metric's name."""
    import jax
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"benchmark needs a CUDA GPU; JAX backend is "
            f"{jax.default_backend()!r}")


def run(scene: str = "cornell_box_baseline", spp: int | None = None,
        nx: int | None = None, ny: int | None = None, seed: int = 0,
        engine: str = "auto", reps: int = 5):
    """Forward headline: best and median wall of `reps` full renders
    after a warm-up render that carries the compile, plus the gradient
    figures (grad_throughput, grad_fd_err)."""
    import statistics

    import jax
    from .backend import gpu_kernels
    from .models.builders import PRESETS
    from .ops.pallas_tracer import UnsupportedScene, render_pallas
    from .render import render

    require_gpu()
    preset = PRESETS[scene]
    nx = nx or preset.nx
    ny = ny or preset.ny
    spp = spp or preset.spp
    tables = preset.build()
    cam = preset.camera()

    use_pallas = engine == "pallas" or (engine == "auto" and gpu_kernels())
    if use_pallas:
        try:  # warm-up doubles as the support check
            render_pallas(tables, cam, nx, ny, 2, seed=seed)
        except UnsupportedScene:
            if engine == "pallas":
                raise
            use_pallas = False

    if use_pallas:
        one = lambda r: render_pallas(tables, cam, nx, ny, spp, seed=seed + r)
    else:
        # warm with the tier's OWN default chunking (same shapes as the
        # timed run, so every compile is reused). TWO warm chunks compile
        # everything the timed compact run dispatches: chunk 0 the staged
        # head/tail pair, chunk 1 the fused single-dispatch program.
        bp = min(1 << 16, nx * ny)
        budget = max(1, (1 << 22) // bp)
        chunk = max(c for c in range(1, min(spp, budget) + 1)
                    if spp % c == 0)
        warm_spp = 2 * chunk if spp >= 2 * chunk else chunk
        render(tables, cam, nx, ny, warm_spp, seed=seed, spp_chunk=chunk)
        one = lambda r: render(tables, cam, nx, ny, spp, seed=seed + r,
                               spp_chunk=chunk)
    walls = []
    for r in range(reps):
        t0 = time.perf_counter()
        one(r)   # returns a host image: the wall ends at a device sync
        walls.append(time.perf_counter() - t0)
    dt = min(walls)
    dt_med = statistics.median(walls)
    rays_per_sec = nx * ny * spp / dt
    base_rays, base_source = reference_baseline()
    grad_worst, grad_per_leaf = grad_fd_err(tables, breakdown=True)
    grad_tp = grad_throughput()
    for k in ("grad_losses", "grad_memory_analysis"):
        grad_tp.pop(k)
    if grad_tp.get("grad_engine") == "pallas_fused":
        # keep the general tier's number visible too
        xla_tp = grad_throughput(reps=3, engine="xla")
        grad_tp["grad_samples_per_sec_xla_scan"] = \
            xla_tp["grad_samples_per_sec"]
        grad_tp["grad_step_seconds_xla_scan"] = \
            xla_tp["grad_step_seconds"]
    dev = jax.devices()[0]
    return {
        "metric": f"primary rays/sec/chip ({scene} {nx}x{ny} {spp}spp)",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / base_rays, 2),
        "baseline_rays_per_sec": round(base_rays, 1),
        "baseline_source": base_source,
        "median_rays_per_sec": round(nx * ny * spp / dt_med, 1),
        "wall_seconds": round(dt, 2),
        "wall_seconds_all_reps": [round(w, 2) for w in walls],
        "engine": "pallas" if use_pallas else "xla",
        "grad_fd_max_abs_err": grad_worst,
        "grad_fd_per_leaf": grad_per_leaf,
        **grad_tp,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }


def grad_throughput(reps: int = 5, chunk: int = 10, block: int = 4096,
                    spp: int = 64, max_depth: int = 6,
                    engine: str = "auto"):
    """BACKWARD-tier throughput of record: fwd+bwd sample-paths/s of the
    production inverse-render training step (examples/inverse_render.py:
    200x200 target, `block`-pixel minibatch, `spp` spp, depth 6,
    path-matched target render + value_and_grad + optax update, whole
    chunks scanned on device). Counts BOTH the target render and the
    candidate fwd+bwd — 2·block·spp sample-paths per step.

    engine: "auto" = the production tier selection (the fused Pallas
    differentiable kernels on a single GPU when the scene is supported);
    "xla" forces the general scan tier so its regressions stay visible
    too. The chunk program compiles once (`grad_compile_seconds`,
    `grad_memory_analysis`); best AND median of `reps` chunk walls are
    reported, each ending at a host pull of the chunk's losses. Also
    returns every step's loss (`grad_losses`) so callers can check they
    are finite and falling."""
    import statistics
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    require_gpu()
    # examples/ lives at the repo root (one level above the package)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import examples.inverse_render as ir
    from .backend import gpu_kernels
    from .parallel.sharding import make_mesh

    devs = jax.devices()
    sp = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
    mesh = make_mesh(devs, dp=len(devs) // sp, sp=sp)
    target_scene = ir.build_scene(ir.TRUE_ALBEDO, ir.TRUE_EMIT)
    scene = ir.build_scene((0.5, 0.5, 0.5), 3.0)
    light_tex, box_tex = ir.param_tex_rows(scene)
    nx = ny = 200
    opt = optax.multi_transform(
        {"albedo": optax.adam(0.05), "emit": optax.adam(0.25)},
        {"albedo": "albedo", "emit": "emit"})
    params = {"albedo": jnp.asarray([0.5, 0.5, 0.5], jnp.float32),
              "emit": jnp.asarray(3.0, jnp.float32)}
    state = opt.init(params)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    params, state = jax.device_put((params, state), repl)
    from .ops.pallas_grad import fast_grad_config, supports_fast_grad
    use_fast = (engine != "xla" and len(devs) == 1 and gpu_kernels()
                and supports_fast_grad(scene, max_depth))
    step_fn = None
    if use_fast:
        step_fn = ir.make_fast_step_body(
            target_scene, scene, ir.cam, box_tex, light_tex, nx, ny, spp,
            max_depth, block, opt, fast_grad_config(scene))
    run_chunk = ir.make_scan_steps(target_scene, scene, ir.cam, box_tex,
                                   light_tex, nx, ny, spp, max_depth, mesh,
                                   block, opt, chunk, step_fn=step_fn)
    losses = []
    # compile once, explicitly: set-up time and the step's memory use are
    # reported, and every chunk runs this one executable
    t0 = time.perf_counter()
    compiled = run_chunk.lower(params, state,
                               jnp.asarray(0, jnp.uint32)).compile()
    compile_s = time.perf_counter() - t0

    def one_chunk(c, params, state):
        params, state, ls = compiled(
            params, state, jnp.asarray(c * chunk, jnp.uint32))
        losses.extend(np.asarray(ls).tolist())  # host pull = completion
        return params, state

    # warm chunk: steady-state-sharded params/state, first-run costs
    params, state = one_chunk(0, params, state)
    walls = []
    for r in range(reps):
        t0 = time.perf_counter()
        params, state = one_chunk(1 + r, params, state)
        walls.append((time.perf_counter() - t0) / chunk)
    paths_per_step = 2 * block * spp
    best = min(walls)
    med = statistics.median(walls)
    return {
        "grad_samples_per_sec": round(paths_per_step / best, 1),
        "grad_samples_per_sec_median": round(paths_per_step / med, 1),
        "grad_step_seconds": round(best, 4),
        "grad_step_seconds_all_reps": [round(w, 4) for w in walls],
        "grad_engine": "pallas_fused" if use_fast else "xla_scan",
        "grad_compile_seconds": round(compile_s, 2),
        "grad_memory_analysis": str(compiled.memory_analysis()),
        "grad_losses": [float(x) for x in losses],
        "grad_config": (f"inverse_render {nx}x{ny} block {block} spp {spp} "
                        f"depth {max_depth} mesh {mesh.shape['dp']}x"
                        f"{mesh.shape['sp']}, {chunk}-step on-device scan, "
                        f"target+candidate fwd+bwd"),
    }


def grad_fd_err(scene=None, n_rays: int = 64, max_depth: int = 8,
                breakdown: bool = False):
    """BASELINE.json metric 2: worst |autodiff − FD| pixel gradient over a
    sweep of ≥10 parameters spanning the whole differentiable surface —
    albedo + emission channels (tex_color), geometry (prim_data: sphere
    radius and center), metal fuzz and dielectric ref_idx (mat_param), and
    an image texel (images) — at depth-8 fixed-RNG paths. The probe scene
    carries every differentiable feature (the bench scene is ignored; kept
    as an argument for CLI compatibility).

    With breakdown=True returns (worst, {sweep_label: worst_in_sweep}) so
    movements of the headline number are attributable to a parameter
    family. Metric history: the round-4 wavefront-compaction RNG
    relayout (lane-keyed draws, ops/rng.py lane_uniforms) changed the
    fixed-RNG paths, moving the worst from 4.68e-05 to ~5.6e-05 — same
    f32-cancellation scale, worst family still the small-step geometry
    probes. Before that, the r02→r03 drift (2.56e-06 → 4.68e-05) was
    the round-3 broadening of this sweep — the two-scale FD consistency
    gate replaced hard skips, so the small-step (eps=1e-3) geometry and
    material-parameter probes now contribute their (larger, still-valid)
    f32-cancellation error instead of being dropped; the autodiff side
    did not move. Both values are far below the 1e-3 health bar
    (tests/test_bench_grad_metric.py pins the scale)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from .models.scene import SceneBuilder, BG_SKY
    from .ops.integrator import trace

    rng = np.random.default_rng(5)
    # sky background so every escaping path carries the attenuation
    # product (with a black bg, fixed-RNG paths that never reach the
    # light have a genuinely zero gradient — vacuous probes)
    b = SceneBuilder(background=BG_SKY)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    red = b.lambertian(b.solid(0.65, 0.05, 0.05))
    b.rect("zx", -2, -2, 2, 2, 0.0, white)                 # floor
    b.rect("yz", 0, -2, 4, 2, -2.0, red)                   # left wall
    b.rect("zx", -1, -1, 1, 1, 4.0,
           b.diffuse_light(b.solid(5.0, 5.0, 5.0)), flip=True)
    centers = [(0.5, 1.0, 0.5), (-0.7, 0.7, -0.3), (1.2, 0.6, -1.0)]
    b.sphere(centers[0], 0.6, b.metal(b.solid(0.8, 0.8, 0.8), 0.3))
    b.sphere(centers[1], 0.5, b.dielectric(1.5))
    texels = rng.uniform(0.1, 0.9, (8, 16, 3)).astype(np.float32)
    b.sphere(centers[2], 0.6, b.lambertian(b.image(texels)))
    probe = b.build()

    # key chosen (scanned 0..15) so no probe straddles a discrete hit
    # flip at the sweep eps in either test or bench config; the
    # two-scale consistency check below makes the metric robust if a
    # future RNG-stream change moves the flips anyway
    key = jax.random.key(10)
    origin = np.array([0.0, 1.5, 6.0], np.float32)
    o = jnp.asarray(np.tile(origin, (n_rays, 1)), jnp.float32)
    # aim rays well inside each sphere's silhouette (jitter ≤ 0.4·r) so
    # an FD step never flips the hit set, plus a wide spread for the
    # walls/light; this keeps every probe non-vacuous and FD smooth
    per = n_rays // 4
    dirs = []
    for c in centers:
        to_c = np.asarray(c, np.float32) - origin
        jit = rng.uniform(-0.4 * 0.5, 0.4 * 0.5, (per, 3)).astype(np.float32)
        dirs.append(to_c / np.abs(to_c[2]) + jit / np.abs(to_c[2]))
    nw = n_rays - 3 * per
    dirs.append(np.stack([rng.uniform(-0.6, 0.6, nw),
                          rng.uniform(-0.4, 0.2, nw),
                          -np.ones(nw)], -1).astype(np.float32))
    d = jnp.asarray(np.concatenate(dirs))

    # one jitted loss over the whole scene pytree: every FD probe reuses
    # the same executable (same shapes/structure), so the sweep costs two
    # compiles total instead of one per leaf
    @jax.jit
    def loss(s):
        rad = trace(s, o, d, jnp.zeros(n_rays), key, max_depth=max_depth,
                    differentiable=True)
        return jnp.mean(rad)

    grads = jax.jit(jax.grad(loss, allow_int=True))(probe)

    worst = 0.0
    per_sweep = {}
    # (label, leaf, indices, eps): indices=None → top-|grad| entries
    sweeps = [
        ("albedo", "tex_color", None, 2, 1e-2),       # top-2 albedo channels
        ("emission", "tex_color", [(2, 0)], None, 1e-2),  # light solid R
        ("geometry", "prim_data",
         [(3, 3), (3, 1), (4, 3)], None, 1e-3),       # r, cy, r
        ("mat_param", "mat_param", [(3,), (4,)], None, 1e-3),  # fuzz, ior
        ("texels", "images", None, 2, 1e-2),          # top-2 image texels
    ]
    for label, leaf, idxs, top_k, eps in sweeps:
        base = np.asarray(getattr(probe, leaf), np.float32)
        g_np = np.asarray(getattr(grads, leaf))
        if idxs is None:
            flat = np.argsort(np.abs(g_np).ravel())[::-1][:top_k]
            idxs = [np.unravel_index(int(i), g_np.shape) for i in flat]
        for idx in idxs:
            idx = tuple(idx)

            def fd_at(e):
                hi = base.copy(); hi[idx] += e
                lo = base.copy(); lo[idx] -= e
                s_hi = type(probe)(
                    **{**probe.__dict__, leaf: jnp.asarray(hi)})
                s_lo = type(probe)(
                    **{**probe.__dict__, leaf: jnp.asarray(lo)})
                return (float(loss(s_hi)) - float(loss(s_lo))) / (2 * e)

            # two-scale consistency: the fixed-RNG estimator is only
            # PIECEWISE smooth — if the ±eps window straddles a discrete
            # hit flip, central differences are garbage (observed: a
            # sphere-center probe reading -8.9 vs autodiff 0.104). That is
            # FD's failure, not autodiff's: retry at eps/4, and skip the
            # probe if still inconsistent. A true autodiff bug shows as
            # consistent-FD ≠ autodiff and is never skipped.
            fd1, fd2 = fd_at(eps), fd_at(eps / 2)
            if abs(fd1 - fd2) > 0.2 * max(abs(fd1), abs(fd2)) + 1e-6:
                fd1, fd2 = fd_at(eps / 4), fd_at(eps / 8)
                if abs(fd1 - fd2) > 0.2 * max(abs(fd1), abs(fd2)) + 1e-6:
                    continue
            # fd1 (the larger consistent step) has the lower f32
            # cancellation noise — the half-step exists only as a witness
            err = abs(float(g_np[idx]) - fd1)
            worst = max(worst, err)
            per_sweep[label] = max(per_sweep.get(label, 0.0), err)
    worst = float(f"{worst:.3g}")
    if breakdown:
        return worst, {k: float(f"{v:.3g}") for k, v in per_sweep.items()}
    return worst


def to_json(result: dict) -> str:
    return json.dumps(result)
