"""Fused differentiable Pallas tier (ops/pallas_grad.py) vs the XLA scan.

Interpret mode runs the kernels in the CPU suite (passed explicitly —
the kernels never infer it from the backend) — primal radiance AND
reverse-mode gradients are compared
against `trace(differentiable=True)` on bit-identical draw streams
(lane_keyed_draws=True): the two tiers share the estimator, so they
must agree to f32 tolerance, not just statistically.

Cost split (measured): interpret-mode pallas multiplies the in-kernel
vjp's CPU compile ~30x, so the kernel-plumbing gradient test runs on a
small all-features scene while the full-feature 14-prim gradient
agreement runs through trace_tiles_reference — the SAME tile math,
no pallas_call. Hardware covers the full config (tools/grad_tier_bench).
"""

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_rust_tpu.models.scene import SceneBuilder, BG_SKY, BG_BLACK
from raytracing_rust_tpu.ops.integrator import trace
from raytracing_rust_tpu.ops.pallas_grad import (
    BLOCK, supports_fast_grad, trace_fast, trace_tiles_reference)

N = 8 * BLOCK   # lanes per test batch (8 kernel programs)

GRAD_LEAVES = ("prim_data", "mat_param", "tex_color", "xf_offset",
               "xf_sin", "xf_cos")


def probe_scene(background=BG_SKY):
    """Every supported feature: lambertian/metal/dielectric/light,
    sphere + rect + flipped rect + rotated-translated cube, solid
    textures only."""
    b = SceneBuilder(background=background)
    white = b.lambertian(b.solid(0.73, 0.73, 0.73))
    b.rect("zx", -3, -3, 3, 3, 0.0, white)                     # floor
    b.rect("yz", 0, -3, 6, 3, -3.0, b.lambertian(b.solid(0.65, 0.05, 0.05)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    b.sphere((-1.0, 0.8, 0.6), 0.7, b.dielectric(1.5))
    b.sphere((0.0, 0.6, -1.2), 0.6, b.lambertian(b.solid(0.2, 0.5, 0.8)))
    xf = b.transform(offset=(0.4, 0.0, 0.2), rotate_axis="y",
                     angle_deg=20.0)
    b.cube((-2.4, 0.0, -1.4), (-1.4, 1.6, -0.4),
           b.lambertian(b.solid(0.4, 0.6, 0.3)), xform=xf)
    return b.build()


def small_scene():
    """4 prims, all material families — small enough that the kernel's
    in-kernel-vjp compile stays fast in interpret mode."""
    b = SceneBuilder(background=BG_SKY)
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    b.sphere((-1.0, 0.8, 0.6), 0.7, b.dielectric(1.5))
    return b.build()


def probe_rays(n, seed=3):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([0.0, 2.0, 8.0], np.float32), (n, 1))
    d = np.stack([rng.uniform(-0.7, 0.7, n),
                  rng.uniform(-0.45, 0.25, n),
                  -np.ones(n)], -1).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def _grads_close(loss_a, loss_b, scene, atol_scale=5e-4):
    g_a = jax.grad(loss_a, allow_int=True)(scene)
    g_b = jax.grad(loss_b, allow_int=True)(scene)
    for leaf in GRAD_LEAVES:
        a = np.asarray(getattr(g_a, leaf))
        b = np.asarray(getattr(g_b, leaf))
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(
            b, a, rtol=0, atol=atol_scale * scale,
            err_msg=f"gradient leaf {leaf} disagrees between tiers")


def test_primal_matches_xla_tier_full_features():
    scene = probe_scene()
    assert supports_fast_grad(scene, 8)
    n = N
    o, d = probe_rays(n)
    key = jax.random.key(7)
    want = trace(scene, o, d, jnp.zeros(n), key, max_depth=5,
                 differentiable=True)
    got = trace_fast(scene, o, d, key, max_depth=5, lane_keyed_draws=True,
                     interpret=True)
    assert got.shape == (n, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_primal_pad_path_and_black_bg():
    scene = small_scene()
    n = N + 500  # exercises the lane-padding path
    b = SceneBuilder(background=BG_BLACK)
    # rebuild the small scene on a black background
    b.rect("zx", -3, -3, 3, 3, 0.0, b.lambertian(b.solid(0.7, 0.7, 0.7)))
    b.rect("zx", -1, -1, 1, 1, 5.0,
           b.diffuse_light(b.solid(4.0, 4.0, 4.0)), flip=True)
    b.sphere((0.9, 1.0, 0.5), 0.8, b.metal(b.solid(0.8, 0.7, 0.6), 0.2))
    b.sphere((-1.0, 0.8, 0.6), 0.7, b.dielectric(1.5))
    scene = b.build()
    o, d = probe_rays(n)
    key = jax.random.key(9)
    want = trace(scene, o, d, jnp.zeros(n), key, max_depth=4,
                 differentiable=True)
    got = trace_fast(scene, o, d, key, max_depth=4, lane_keyed_draws=True,
                     interpret=True)
    assert got.shape == (n, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_kernel_grads_match_xla_tier_small_scene():
    """The pallas custom_vjp plumbing end-to-end (small scene keeps the
    interpret-mode in-kernel-vjp compile fast; two programs exercise the
    per-block table-gradient sum)."""
    scene = small_scene()
    n = 2 * BLOCK
    o, d = probe_rays(n, seed=5)
    key = jax.random.key(11)
    w = jnp.asarray(np.random.default_rng(0)
                    .uniform(0.5, 1.5, (n, 3)).astype(np.float32))
    _grads_close(
        lambda s: jnp.mean(w * trace(s, o, d, jnp.zeros(n), key,
                                     max_depth=3, differentiable=True)),
        lambda s: jnp.mean(w * trace_fast(s, o, d, key, max_depth=3,
                                          lane_keyed_draws=True,
                                          interpret=True)),
        scene)


def test_reference_grads_match_xla_tier_full_features():
    """Full-feature gradient agreement through the identical tile math
    (trace_tiles_reference — see module docstring for why not the
    kernel)."""
    scene = probe_scene()
    n = N
    o, d = probe_rays(n, seed=5)
    key = jax.random.key(11)
    w = jnp.asarray(np.random.default_rng(1)
                    .uniform(0.5, 1.5, (n, 3)).astype(np.float32))
    _grads_close(
        lambda s: jnp.mean(w * trace(s, o, d, jnp.zeros(n), key,
                                     max_depth=4, differentiable=True)),
        lambda s: jnp.mean(w * trace_tiles_reference(
            s, o, d, key, max_depth=4, lane_keyed_draws=True)),
        scene)


def test_kernel_matches_reference_path():
    """Kernel plumbing == reference path on the same scene/draws (the
    two must be the same computation, not merely close)."""
    scene = small_scene()
    n = N
    o, d = probe_rays(n, seed=8)
    key = jax.random.key(2)
    a = np.asarray(trace_fast(scene, o, d, key, max_depth=3,
                               interpret=True))
    b = np.asarray(trace_tiles_reference(scene, o, d, key, max_depth=3))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_checker_matches_xla_tier():
    """3D-checker textures (round-5 scope extension): albedo AND
    emissive checker vs the XLA tier, primal + gradients (gradients
    flow into BOTH checker children's tex_color rows and through the
    hit point's sin(10p) factors)."""
    b = SceneBuilder(background=BG_SKY)
    # floor at y=0.37, NOT 0.0: a checker surface lying exactly on a
    # sin(10·y)=0 plane makes every hit's odd/even choice a coin flip
    # on f32 rounding residue — any op reordering between tiers flips
    # ~13% of lanes (measured; the f64 reference sits on the same
    # knife-edge). Off-boundary surfaces agree per-lane.
    b.rect("zx", -4, -4, 4, 4, 0.37, b.lambertian(b.checker(
        b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))))
    b.sphere((0.0, 1.37, 0.0), 1.0, b.diffuse_light(b.checker(
        b.solid(3.0, 0.5, 0.5), b.solid(0.5, 3.0, 0.5))))
    b.sphere((2.2, 1.1, 0.3), 0.8, b.lambertian(b.solid(0.3, 0.4, 0.8)))
    scene = b.build()
    assert supports_fast_grad(scene, 8)
    n = N
    o, d = probe_rays(n, seed=9)
    key = jax.random.key(6)
    want = trace(scene, o, d, jnp.zeros(n), key, max_depth=4,
                 differentiable=True)
    got = trace_tiles_reference(scene, o, d, key, max_depth=4,
                                lane_keyed_draws=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # kernel plumbing of the checker columns at small depth
    got_k = trace_fast(scene, o, d, key, max_depth=2,
                       lane_keyed_draws=True, interpret=True)
    want_k = trace(scene, o, d, jnp.zeros(n), key, max_depth=2,
                   differentiable=True)
    np.testing.assert_allclose(np.asarray(got_k), np.asarray(want_k),
                               rtol=2e-4, atol=2e-4)
    _grads_close(
        lambda s: jnp.mean(trace(s, o, d, jnp.zeros(n), key, max_depth=3,
                                 differentiable=True)),
        lambda s: jnp.mean(trace_tiles_reference(
            s, o, d, key, max_depth=3, lane_keyed_draws=True)),
        scene)


def test_dielectric_interior_rays_match_xla_tier():
    """Directed coverage of the exiting-ray dielectric branches (exit
    cosine, TIR, Schlick-at-exit): rays START INSIDE the glass sphere,
    at a spread of angles that includes beyond-critical incidence.
    Camera-ray suites hit these branches only probabilistically."""
    b = SceneBuilder(background=BG_SKY)
    b.rect("zx", -4, -4, 4, 4, -2.0, b.lambertian(b.solid(0.6, 0.3, 0.2)))
    b.sphere((0.0, 0.0, 0.0), 1.0, b.dielectric(1.5))
    scene = b.build()
    n = N
    rng = np.random.default_rng(12)
    o = jnp.asarray(rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    key = jax.random.key(4)
    want = trace(scene, o, d, jnp.zeros(n), key, max_depth=4,
                 differentiable=True)
    got = trace_tiles_reference(scene, o, d, key, max_depth=4,
                                lane_keyed_draws=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # and the gradients through the exit/TIR branches
    _grads_close(
        lambda s: jnp.mean(trace(s, o, d, jnp.zeros(n), key, max_depth=3,
                                 differentiable=True)),
        lambda s: jnp.mean(trace_tiles_reference(
            s, o, d, key, max_depth=3, lane_keyed_draws=True)),
        scene)


def test_supports_gate():
    scene = probe_scene()
    assert supports_fast_grad(scene, 8)
    assert not supports_fast_grad(scene, 8, rr_depth=3)   # RR unsupported
    assert not supports_fast_grad(scene, 40)              # depth cap

    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.checker(
        b.solid(1, 1, 1), b.solid(0, 0, 0))))
    assert supports_fast_grad(b.build(), 8)   # checker-of-solids: in scope

    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.noise(2.0)))
    assert not supports_fast_grad(b.build(), 8)           # noise tex

    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.medium_sphere((0, 1, 0), 1.0, 0.5, b.solid(1, 1, 1))
    assert not supports_fast_grad(b.build(), 8)           # media


def test_inverse_render_scene_supported():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    from examples.inverse_render import build_scene
    assert supports_fast_grad(build_scene(), 6)


def test_grad_kernels_lower_for_cuda():
    """Both fused kernels (the forward, and the backward with its
    in-kernel vjp) lower through the Triton route for CUDA on a host with
    no card, at the production inverse-render scene and depth."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    from examples.inverse_render import build_scene
    from raytracing_rust_tpu.ops.pallas_grad import fast_grad_config
    scene = build_scene()
    cfg = fast_grad_config(scene)
    o, d = probe_rays(2 * BLOCK)
    key = jax.random.key(0)

    def value_and_grad(s):
        return jax.value_and_grad(lambda s_: jnp.mean(trace_fast(
            s_, o, d, key, max_depth=6, cfg=cfg)), allow_int=True)(s)

    text = jax.jit(value_and_grad).trace(scene).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "rt_grad_fwd" in text and "rt_grad_bwd" in text
