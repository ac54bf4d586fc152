"""End-to-end absolute correctness vs an INDEPENDENT scalar implementation.

`native/ref_tracer.cpp` is a faithful f64 single-thread C++ mirror of the
reference renderer (tests/test.rs:55-85 + src/color.rs:6-23) — a separate
implementation sharing no code with the JAX tiers. Rendering the same scene
with both and comparing converged Monte-Carlo means closes the loop that
self-recorded regression bands (test_scene_stats.py) cannot: it pins the
framework to the reference's absolute radiometry, not to its own history.

This is how the duplicated-cornell-floor tie-break bug was found (the JAX
argmin picked the flipped floor copy; the mirror, like the reference,
renders the unflipped one — bottom-half luminance 0.093 vs 0.176).
"""

import os

import numpy as np
import pytest

from raytracing_rust_tpu import native
from raytracing_rust_tpu.models.builders import PRESETS
from raytracing_rust_tpu.models.scene import BG_BLACK, BG_SKY, SceneBuilder
from raytracing_rust_tpu.ops.camera import make_camera
from raytracing_rust_tpu.render import render

if native._load_ref() is None:  # pragma: no cover
    pytest.skip("native toolchain unavailable", allow_module_level=True)

# Nightly knob: RT_ORACLE_SPP_MULT=16 multiplies every spp and shrinks the
# absolute floors by sqrt(mult). The default floors (0.01/0.012 luminance)
# mean a systematic bias below the floor passes forever at CI spp; the
# multiplied config converges the MC means enough to catch it (takes
# minutes, not CI material — run manually; last result recorded in
# docs/DESIGN.md "Oracle floors").
_MULT = max(1, int(os.environ.get("RT_ORACLE_SPP_MULT", "1")))


def _floor(base: float) -> float:
    return base / np.sqrt(_MULT)


def _stderr_of_mean(img):
    # the image mean of nx*ny pixel means has stderr ≈
    # std(pixel means)/sqrt(nx*ny) — a conservative sigma (pixel stds
    # already reflect the spp averaging).
    return float(np.std(img)) / np.sqrt(img.shape[0] * img.shape[1])


def test_oracle_spheres_mean_matches_mirror():
    """Mixed lambertian/metal/dielectric spheres under the sky background
    (mirror scene_id 1 — build_oracle_spheres in ref_tracer.cpp)."""
    nx, ny, spp = 64, 36, 64 * _MULT
    look_from, look_at, vfov = (0.0, 2.0, 8.0), (0.0, 1.0, 0.0), 35.0

    b = SceneBuilder(background=BG_SKY)
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.solid(0.5, 0.5, 0.5)))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.2))
    b.sphere((-2.2, 1, 0), 1.0, b.dielectric(1.5))
    scene = b.build()
    cam = make_camera(look_from, look_at, (0, 1, 0), vfov, nx / ny,
                      0.0, 10.0, 0.0, 1.0)
    # render() gamma-corrects (sqrt); the mirror reports pre-gamma mean
    # radiance — compare in linear space
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=3,
                             max_depth=50)) ** 2

    ref_img, _ = native.ref_trace(1, nx, ny, spp, look_from, look_at, vfov,
                                  aperture=0.0, background=1)

    sigma = np.hypot(_stderr_of_mean(ours), _stderr_of_mean(ref_img))
    diff = abs(float(ours.mean()) - float(ref_img.mean()))
    assert diff < max(6 * sigma, _floor(0.01)), (
        f"ours {ours.mean():.4f} vs mirror {ref_img.mean():.4f} "
        f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_cornell_box_matches_mirror_per_half():
    """cornell_box at the reference camera — per-half means catch exactly
    the class of bug the image mean can hide (the dark-floor tie-break bug
    lived only in the bottom half)."""
    nx, ny, spp = 48, 27, 96 * _MULT
    p = PRESETS["cornell_box"]

    scene = p.build()
    cam = make_camera(p.look_from, p.look_at, p.view_up, p.vfov, nx / ny,
                      p.aperture, p.focus_dist, p.time0, p.time1)
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=5,
                             max_depth=50)) ** 2  # linear space (see above)

    ref_img, _ = native.ref_trace(0, nx, ny, spp, p.look_from, p.look_at,
                                  p.vfov, vup=p.view_up, aperture=p.aperture,
                                  focus_dist=p.focus_dist, background=0)
    # apply render()'s OWN gamma+clamp pipeline to the mirror's pre-gamma
    # radiance before comparing: the light's direct pixels exceed 1.0 and
    # render() clamps them (tests/test.rs:72-75), so comparing clamped
    # ours**2 against UNclamped radiance put a 0.0755 systematic bias on
    # the top half — 6x the floor this test claims, "passing" only
    # because the same unclamped pixels inflated sigma (measured; with
    # this clamp the top-half diff is 0.0046)
    ref_img = np.clip(np.sqrt(np.clip(ref_img, 0.0, None)), 0.0, 1.0) ** 2

    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref_img[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, _floor(0.012)), (
            f"{name} half: ours {a.mean():.4f} vs mirror {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_cornell_smoke_matches_mirror_per_half():
    """ConstantMedium free-flight radiometry vs the mirror's exact
    transcription of medium.rs:28-56 (scene_id 2 — cornell_smoke with the
    framework's fixed back wall). The JAX tiers sample the medium with a
    closed-form reparameterization that shares no design with the
    reference's hit1/hit2 + log(U) loop, so tier-vs-tier parity cannot
    catch a shared semantic bias here — only this absolute check can."""
    nx, ny, spp = 48, 27, 96 * _MULT
    p = PRESETS["cornell_smoke"]

    scene = p.build()
    cam = make_camera(p.look_from, p.look_at, p.view_up, p.vfov, nx / ny,
                      p.aperture, p.focus_dist, p.time0, p.time1)
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=7,
                             max_depth=50)) ** 2

    ref_img, _ = native.ref_trace(2, nx, ny, spp, p.look_from, p.look_at,
                                  p.vfov, vup=p.view_up, aperture=p.aperture,
                                  focus_dist=p.focus_dist, background=0)
    # same clamped-linear comparison space as the cornell test above (the
    # light's direct pixels exceed 1.0 and render() clamps them)
    ref_img = np.clip(np.sqrt(np.clip(ref_img, 0.0, None)), 0.0, 1.0) ** 2

    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref_img[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, _floor(0.012)), (
            f"{name} half: ours {a.mean():.4f} vs mirror {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_fog_slab_density_matches_mirror_per_half():
    """Free-flight DENSITY law vs the mirror (scene_id 6). cornell_smoke
    (scene_id 2) pins the medium integration but has almost no density
    sensitivity — its white box scatters losslessly (albedo 1 conserves
    flux) and its black box is already opaque at 0.01·165, so even a
    DOUBLED density moves every luminance statistic by <0.003 (measured).
    This scene maximizes d(lum)/d(density): a 100-unit slab of gray
    (albedo 0.3) medium between camera and a large unit emitter, so
    direct transmission exp(−ρ·L) dominates. Measured power: the correct
    density agrees to 0.0005; density 0.013 (a 30% error) fails BOTH
    halves at 5.7× the floor (diff 0.057)."""
    nx, ny, spp = 48, 27, 64 * _MULT
    look_from, look_at, vfov = (0.0, 0.0, 300.0), (0.0, 0.0, 0.0), 30.0

    b = SceneBuilder(background=BG_BLACK)
    b.rect("xy", -100.0, -100.0, 100.0, 100.0, -50.0,
           b.diffuse_light(b.solid(1, 1, 1)))
    b.medium_box((-100, -100, 0), (100, 100, 100), 0.01,
                 b.solid(0.3, 0.3, 0.3))
    scene = b.build()
    cam = make_camera(look_from, look_at, (0, 1, 0), vfov, nx / ny,
                      0.0, 10.0, 0.0, 1.0)
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=17,
                             max_depth=50)) ** 2

    ref_img, _ = native.ref_trace(6, nx, ny, spp, look_from, look_at, vfov,
                                  aperture=0.0, background=0)
    ref_img = np.clip(np.sqrt(np.clip(ref_img, 0.0, None)), 0.0, 1.0) ** 2

    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref_img[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, _floor(0.01)), (
            f"{name} half: ours {a.mean():.4f} vs mirror {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_simple_light_noise_matches_mirror_per_half():
    """Noise path vs the mirror (scene_id 5): simple_light exactly
    (tests/test.rs:211-240, 685-723 — marble-noise ground + sphere, two
    4·(1,1,1) emitters, black background). The reference's own Perlin
    tables come from an UNSEEDED thread RNG (src/perlin.rs:5,13) so its
    field is unmatchable by design (README documents the hash-gradient
    deviation); the mirror instead carries an independent scalar f64
    transcription of the framework's hash-Perlin SPEC (no shared code or
    vectorization with ops/perlin.py / the GPU kernel / tests/oracle.py),
    pinning the marble formula, octave sum, lattice hash, and the whole
    noise-scene radiometry absolutely. Per-half means localize a bias to
    the emitters (top) vs the noise ground (bottom)."""
    nx, ny, spp = 64, 36, 64 * _MULT
    look_from, look_at, vfov = (13.0, 3.0, 3.0), (0.0, 0.0, 0.0), 50.0

    scene = PRESETS["simple_light"].build()
    cam = make_camera(look_from, look_at, (0, 1, 0), vfov, nx / ny,
                      0.1, 10.0, 0.0, 1.0)
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=13,
                             max_depth=50)) ** 2

    ref_img, _ = native.ref_trace(5, nx, ny, spp, look_from, look_at, vfov,
                                  aperture=0.1, background=0)
    # the 4·(1,1,1) emitters exceed 1.0: push the mirror's pre-gamma
    # radiance through render()'s own gamma+clamp pipeline before
    # comparing (same trap as cornell — see that test's comment; without
    # this the top half hides a 0.13 systematic under emitter-inflated σ)
    ref_img = np.clip(np.sqrt(np.clip(ref_img, 0.0, None)), 0.0, 1.0) ** 2

    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref_img[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, _floor(0.01)), (
            f"{name} half: ours {a.mean():.4f} vs mirror {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_earth_image_matches_mirror_per_half():
    """Image-texture path vs the mirror (scene_id 4): the reference earth
    config (tests/test.rs:200-209, 645-683 — one image-textured r=2
    sphere at the origin, sky background, aperture 0.1) with earthmap.jpg
    replaced by a synthetic 32x16 RGB byte pattern built from the same
    integer formula on both sides. Pins ImageTexture's nearest fetch /
    v-flip / clamp (texture.rs:86-108) AND the sphere-UV mapping
    including the FRAC_2_PI quirk (sphere.rs:9-15, compat_uv_bug=True
    here) absolutely. Per-half means localize a bias to the texture's
    row direction (the v flip would show up as a top/bottom swap)."""
    nx, ny, spp = 64, 36, 64 * _MULT
    look_from, look_at, vfov = (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 20.0

    w, h = 32, 16
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([(8 * ii + 3 * jj) % 256,
                    (5 * ii + 11 * jj) % 256,
                    (ii * jj) % 256], axis=-1).astype(np.uint8)

    b = SceneBuilder(background=BG_SKY, compat_uv_bug=True)
    b.sphere((0, 0, 0), 2.0, b.lambertian(b.image(pix)))
    scene = b.build()
    cam = make_camera(look_from, look_at, (0, 1, 0), vfov, nx / ny,
                      0.1, 10.0, 0.0, 1.0)
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=11,
                             max_depth=50)) ** 2

    ref_img, _ = native.ref_trace(4, nx, ny, spp, look_from, look_at, vfov,
                                  aperture=0.1, background=1)

    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref_img[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, _floor(0.01)), (
            f"{name} half: ours {a.mean():.4f} vs mirror {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")


def test_moving_checker_matches_mirror_per_half():
    """Motion-blur lerp (sphere.rs:115-118) and the 3-D checker
    (texture.rs:40-47) vs the mirror (scene_id 3): checker ground, a
    MovingSphere rising 0.5 over the shutter, a sharp metal hero, sky
    background. Per-half means localize a bias to the sky/sphere (top)
    vs ground (bottom). Power caveat (measured): at CI spp the blur
    envelope is a small image region — a 40% motion-amplitude error
    moves the sphere-window mean by 0.0068 (~1.7σ at spp 64), so
    motion-LERP detail has robust e2e power only at the nightly
    RT_ORACLE_SPP_MULT≥16 config (~7σ); CI-level motion coverage lives
    in the intersect unit tests."""
    nx, ny, spp = 64, 36, 64 * _MULT
    look_from, look_at, vfov = (0.0, 2.0, 8.0), (0.0, 1.0, 0.0), 35.0

    b = SceneBuilder(background=BG_SKY)
    checker = b.checker(b.solid(0.2, 0.3, 0.1), b.solid(0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.moving_sphere((0, 1, 0), (0, 1.5, 0), 0.0, 1.0, 1.0,
                    b.lambertian(b.solid(0.4, 0.2, 0.1)))
    b.sphere((2.2, 1, 0), 1.0, b.metal(b.solid(0.7, 0.6, 0.5), 0.0))
    scene = b.build()
    cam = make_camera(look_from, look_at, (0, 1, 0), vfov, nx / ny,
                      0.0, 10.0, 0.0, 1.0)
    ours = np.asarray(render(scene, cam, nx, ny, spp, seed=9,
                             max_depth=50)) ** 2

    ref_img, _ = native.ref_trace(3, nx, ny, spp, look_from, look_at, vfov,
                                  aperture=0.0, background=1)

    for name, sl in [("top", slice(0, ny // 2)), ("bottom", slice(ny // 2, ny))]:
        a, r = ours[sl], ref_img[sl]
        sigma = np.hypot(_stderr_of_mean(a), _stderr_of_mean(r))
        diff = abs(float(a.mean()) - float(r.mean()))
        assert diff < max(6 * sigma, _floor(0.01)), (
            f"{name} half: ours {a.mean():.4f} vs mirror {r.mean():.4f} "
            f"(diff {diff:.4f}, 6σ {6 * sigma:.4f})")
