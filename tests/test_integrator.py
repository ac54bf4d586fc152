"""End-to-end integrator / render driver behavior (reference src/color.rs:6-23,
tests/test.rs:55-85)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracing_rust_tpu.models.scene import SceneBuilder, BG_SKY, BG_BLACK
from raytracing_rust_tpu.models import builders
from raytracing_rust_tpu.ops.integrator import trace
from raytracing_rust_tpu.render import render
from raytracing_rust_tpu.utils import image_io

KEY = jax.random.key(0)


def _trace(scene, o, d, max_depth=4, differentiable=False):
    n = o.shape[0]
    return np.asarray(trace(scene, jnp.asarray(o, jnp.float32),
                            jnp.asarray(d, jnp.float32), jnp.zeros(n), KEY,
                            max_depth=max_depth,
                            differentiable=differentiable))


def test_direct_light_hit():
    """Ray into a diffuse light returns exactly its emission
    (src/color.rs:8-15: emitted + nothing, scatter=None kills the path)."""
    b = SceneBuilder(background=BG_BLACK)
    b.rect("zx", -1, -1, 1, 1, 2.0, b.diffuse_light(b.solid(15, 15, 15)))
    scene = b.build()
    o = np.zeros((4, 3))
    d = np.tile([0.0, 1.0, 0.0], (4, 1))
    np.testing.assert_allclose(_trace(scene, o, d), 15.0, rtol=1e-6)


def test_miss_returns_background():
    """Miss → sky gradient lerp((1,1,1),(.5,.7,1), .5(ŷ+1))
    (commented reference src/color.rs:18-20) or black (live :21)."""
    for bg, d_vec in [(BG_SKY, [1.0, 1.0, 0.0]), (BG_BLACK, [1.0, 1.0, 0.0])]:
        b = SceneBuilder(background=bg)
        b.sphere((0, 0, 100.0), 1.0, b.lambertian(b.solid(1, 0, 0)))
        scene = b.build()
        d = np.array([d_vec])
        got = _trace(scene, np.zeros((1, 3)), d)[0]
        if bg == BG_SKY:
            t = 0.5 * (d_vec[1] / np.linalg.norm(d_vec) + 1.0)
            want = (1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
            np.testing.assert_allclose(got, want, rtol=1e-5)
        else:
            np.testing.assert_allclose(got, 0.0)


def test_attenuation_one_bounce():
    """Lambertian floor below a uniform emitter: per-path radiance is either
    0 (escaped) or exactly albedo ⊙ emission — the multiplicative
    accumulation of src/color.rs:11-12 — so channel ratios of the mean equal
    the albedo ratios exactly."""
    b = SceneBuilder(background=BG_BLACK)
    b.rect("zx", -50, -50, 50, 50, 0.0, b.lambertian(b.solid(0.5, 0.25, 1.0)))
    b.rect("zx", -200, -200, 200, 200, 60.0, b.diffuse_light(b.solid(2, 2, 2)))
    scene = b.build()
    o = np.tile([0.0, 1.0, 0.0], (512, 1))
    d = np.tile([0.0, -1.0, 0.0], (512, 1))
    rad = _trace(scene, o, d, max_depth=50)
    lit = rad[:, 2] > 1.5  # paths that reached the light after one bounce
    assert lit.mean() > 0.5
    want = np.broadcast_to([1.0, 0.5, 2.0], rad[lit].shape)
    np.testing.assert_allclose(rad[lit], want, rtol=1e-5)


def test_depth_cap_terminates():
    """Mirror tunnel: two parallel perfect metal rects trap rays; the depth
    cap (src/color.rs:9) must terminate with finite black radiance."""
    b = SceneBuilder(background=BG_SKY)
    mirror = b.metal(b.solid(1, 1, 1), 0.0)
    b.rect("xy", -10, -10, 10, 10, 0.0, mirror)
    b.rect("xy", -10, -10, 10, 10, 1.0, mirror)
    scene = b.build()
    o = np.array([[0.0, 0.0, 0.5]])
    d = np.array([[0.0, 0.0, 1.0]])
    rad = _trace(scene, o, d, max_depth=8)
    assert np.all(np.isfinite(rad))
    np.testing.assert_allclose(rad, 0.0, atol=1e-6)  # never escapes


def test_cornell_box_statistics():
    """Small cornell render: interior means in the physically right range
    (light ≈15 emission, walls 0.05-0.73 albedo ⇒ mean luminance ~0.1)."""
    preset = builders.PRESETS["cornell_box"]
    scene = preset.build()
    cam = preset.camera()
    img = render(scene, cam, 64, 64, 32, seed=1, max_depth=16)
    assert img.shape == (64, 64, 3)
    assert np.all(np.isfinite(img))
    lum = img.mean()
    assert 0.05 < lum < 0.3, f"cornell mean luminance {lum}"
    # camera u-basis = −x (from (278,278,-800) toward +z), so the green wall
    # at x=555 (tests/test.rs:249) lands on the LEFT of the image
    left = img[:, :8].mean(axis=(0, 1))
    right = img[:, -8:].mean(axis=(0, 1))
    assert left[1] > left[0], "left wall should be green-dominant"
    assert right[0] > right[1], "right wall should be red-dominant"


def test_render_deterministic_per_seed():
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    a = render(scene, cam, 32, 18, 4, seed=3)
    b = render(scene, cam, 32, 18, 4, seed=3)
    c = render(scene, cam, 32, 18, 4, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_render_dispatch_grouping_invariant(monkeypatch):
    """The per-dispatch ray budget groups sample chunks into dispatches
    (render.py _DISPATCH_RAY_BUDGET); absolute chunk-id key folding must
    make the image bit-identical however the host groups them — one
    dispatch for all chunks, one per chunk, or a ragged 3+1 split."""
    import importlib
    # the package re-exports render() the FUNCTION under the same name,
    # so attribute import would grab it instead of the module
    render_mod = importlib.import_module("raytracing_rust_tpu.render")
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    # compact=False: the budget grouping only drives the plain path
    kw = dict(nx=16, ny=16, spp=8, seed=3, max_depth=6, spp_chunk=2,
              compact=False)
    full = render(scene, cam, **kw)  # default budget: all 4 chunks, 1 dispatch
    # 256 px × spp_chunk 2 = 512 rays/chunk → budget 512 = 1 chunk/dispatch
    monkeypatch.setattr(render_mod, "_DISPATCH_RAY_BUDGET", 512)
    per_chunk = render(scene, cam, **kw)
    np.testing.assert_array_equal(full, per_chunk)
    monkeypatch.setattr(render_mod, "_DISPATCH_RAY_BUDGET", 3 * 512)
    ragged = render(scene, cam, **kw)  # groups of 3 then 1
    np.testing.assert_array_equal(full, ragged)


def test_render_compaction_bit_identical():
    """Wavefront compaction (render.py) must be BIT-identical to the
    plain full-width path: lane RNG is addressed by original lane id, so
    gathering survivors into a narrower batch changes which rows compute,
    never what they compute. Covers: multi-segment schedules at depth 50,
    width reuse across chunks (spp_chunk < spp), media draws
    (cornell_smoke exercises the u_med gather), and Russian roulette."""
    for name, kw in [
        ("two_spheres", dict(nx=16, ny=16, spp=8, seed=3, max_depth=50,
                             spp_chunk=4)),
        ("cornell_smoke", dict(nx=12, ny=12, spp=4, seed=5, max_depth=50)),
        ("two_spheres", dict(nx=12, ny=12, spp=4, seed=2, max_depth=50,
                             rr_depth=3)),
    ]:
        preset = builders.PRESETS[name]
        scene = preset.build()
        cam = preset.camera()
        plain = render(scene, cam, compact=False, **kw)
        compacted = render(scene, cam, compact=True, **kw)
        np.testing.assert_array_equal(plain, compacted, err_msg=name)


def test_render_compaction_overflow_redo(monkeypatch):
    """A reused tail width that's too small for a chunk's survivor count
    must be DETECTED (ok=False) and the block redone with exact widths —
    never silently truncated (truncated lanes keep head-only radiance)."""
    import importlib
    rm = importlib.import_module("raytracing_rust_tpu.render")
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    nx = ny = 16
    spp = 4
    pix = jnp.arange(nx * ny, dtype=jnp.int32)
    key = jax.random.fold_in(jax.random.key(9), 0)
    good, used, oks = rm.render_block_compact(scene, cam, pix, key, spp,
                                              nx, ny, 50)
    assert all(bool(x) for x in jax.device_get(oks))
    # deliberately undersized widths: flags report the overflow, and the
    # result is visibly truncated (survivors beyond w lost their tail)
    bad, _, oks2 = rm.render_block_compact(scene, cam, pix, key, spp,
                                           nx, ny, 50,
                                           widths=[1] * len(used))
    assert not all(bool(x) for x in jax.device_get(oks2))
    assert not np.array_equal(np.asarray(bad), np.asarray(good))
    # end-to-end: poison the FIRST width choice; render() must notice the
    # ok=False flags and redo the block exactly
    orig = rm._pow2_width
    calls = []

    def flaky(count, n_total):
        calls.append(1)
        return 1 if len(calls) == 1 else orig(count, n_total)

    monkeypatch.setattr(rm, "_pow2_width", flaky)
    img = render(scene, cam, nx, ny, spp, seed=9, max_depth=50)
    monkeypatch.setattr(rm, "_pow2_width", orig)
    ref = render(scene, cam, nx, ny, spp, seed=9, max_depth=50)
    assert len(calls) > 1  # the redo actually re-chose widths
    np.testing.assert_array_equal(img, ref)


def test_render_compaction_bvh_bit_identical():
    """Compaction composes with the BVH tier (stacked traversal is
    per-lane math like the dense scan)."""
    preset = builders.PRESETS["two_spheres"]
    scene = preset.build()
    cam = preset.camera()
    kw = dict(nx=12, ny=12, spp=4, seed=4, max_depth=50, use_bvh=True)
    plain = render(scene, cam, compact=False, **kw)
    compacted = render(scene, cam, compact=True, **kw)
    np.testing.assert_array_equal(plain, compacted)


def test_ppm_roundtrip_and_format():
    img = np.asarray(np.random.default_rng(0).random((4, 6, 3)), np.float32)
    txt = image_io.to_ppm(img)
    lines = txt.splitlines()
    assert lines[0] == "P3" and lines[1] == "6 4" and lines[2] == "255"
    assert len(lines) == 3 + 4 * 6
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "x.ppm")
        image_io.write_ppm(p, img)
        back = image_io.read_ppm(p)
    np.testing.assert_allclose(back, img, atol=1.0 / 255.0)
