"""Host-side scene table of the GPU kernel (ops/pallas_tracer.py).

The table flattening, feature set, row order and refusal triggers are
pure host logic and tested here; the kernel itself is covered by the
lowering tripwire, the interpret-mode tests, and chip_smoke.py on a card.
"""

import numpy as np
import pytest

from raytracing_rust_tpu.models import builders
from raytracing_rust_tpu.models.scene import SceneBuilder, BG_BLACK
from raytracing_rust_tpu.ops import pallas_tracer as pt


def test_cornell_record():
    scene = builders.cornell_box()
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(scene)
    # 17, not 18: the reference pushes the floor twice (flipped then
    # unflipped, tests/test.rs:268-295) and its rect tie-break makes the
    # flipped copy unreachable — SceneBuilder drops it (models/scene.py
    # _dedup_coincident), so the table sees one floor.
    assert tab.shape == (17, pt.NF) and n_sph == 0
    assert feats == frozenset({"lamb", "light"})
    # rows keep the original order when there are no spheres
    np.testing.assert_array_equal(tab[:, pt.F_ORIG], np.arange(17))
    # light rect (index 2) emits 15 through its texture value
    assert tab[2, pt.F_MAT] == 3.0
    np.testing.assert_allclose(tab[2, pt.F_EVEN:pt.F_EVEN + 3], 15.0)
    # green wall flip carried
    assert tab[0, pt.F_FLIP] == -1.0
    np.testing.assert_allclose(tab[1, pt.F_EVEN:pt.F_EVEN + 3],
                               [0.65, 0.05, 0.05], rtol=1e-6)
    assert atlas.shape == (1,)   # no image textures → dummy atlas


def test_random_spheres_partition():
    scene = builders.random_spheres()
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(scene)
    assert n_sph == scene.num_prims == len(tab)
    assert {"checker", "metal", "diel", "moving", "sky"} <= feats
    assert "noise" not in feats and "image" not in feats
    # moving spheres carry a nonzero center span and 1/(t1 - t0)
    moving = np.abs(tab[:, pt.F_DC:pt.F_DC + 3]).sum(axis=1) > 0
    assert moving.any() and not moving.all()
    assert (tab[moving, pt.F_INVDT] != 0).all()
    # radii round-trip through r² and 1/r
    np.testing.assert_allclose(tab[:, pt.F_R2] * tab[:, pt.F_INVR] ** 2,
                               1.0, rtol=1e-5)


def test_smoke_media_records():
    """Participating media are outside the kernel: cornell_smoke is
    refused with the reason, so auto mode renders it on the XLA tier."""
    with pytest.raises(pt.UnsupportedScene, match="media"):
        pt.build_scene_table(builders.cornell_smoke())


def test_unsupported_scenes_fall_back():
    # rect-heavy tables are fine now (one dynamic loop, no unroll budget)
    b = SceneBuilder(background=BG_BLACK)
    m = b.lambertian(b.solid(0.5, 0.5, 0.5))
    for i in range(120):
        b.rect("xy", 0, 0, 1, 1, float(i), m)
    tab, n_sph, *_ = pt.build_scene_table(b.build())
    assert len(tab) == 120 and n_sph == 0
    # an isotropic surface is refused
    b.sphere((0, 0, 0), 1.0, b.isotropic(b.solid(1, 1, 1)))
    with pytest.raises(pt.UnsupportedScene):
        pt.build_scene_table(b.build())


def test_final_scene_partition():
    """final_scene (reference tests/test.rs:419-523) carries two media, so
    the whole scene goes to the XLA tier; its surfaces alone would fit
    one table with spheres first and rects after."""
    scene = builders.final_scene()
    with pytest.raises(pt.UnsupportedScene, match="media"):
        pt.build_scene_table(scene)
    ptype = np.asarray(scene.prim_type)
    assert (ptype == 2).sum() > 2000    # 400 ground cubes as rects


def test_earth_record_and_atlas():
    """earth (image texture) runs in-kernel: table fields and the flat
    atlas hold the XLA tier's f32 texels exactly."""
    scene = builders.earth()
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(scene)
    assert "image" in feats
    assert tab[0, pt.F_IMG] == 1.0 and tab[0, pt.F_IMG_ID] == 0.0
    h, w = np.asarray(scene.image_hw)[0]
    assert tab[0, pt.F_IMG_H] == float(h)
    assert tab[0, pt.F_IMG_W] == float(w)
    images = np.asarray(scene.images)
    assert hw == images.shape[1:3]
    np.testing.assert_array_equal(atlas.reshape(images.shape), images)


def test_noise_scene_record():
    scene = builders.two_perlin_spheres()
    tab, n_sph, feats, atlas, hw = pt.build_scene_table(scene)
    assert feats == frozenset({"lamb", "noise", "sky"})
    np.testing.assert_allclose(tab[:, pt.F_NOISE], 1.0)
    np.testing.assert_allclose(tab[:, pt.F_NSCALE], 4.0)  # test.rs:186


def test_transformed_prims_hoisted():
    """Cornell's rotated boxes arrive as world-space plane frames."""
    tab, *_ = pt.build_scene_table(builders.cornell_box())
    kn = tab[5:, pt.F_KN:pt.F_KN + 3]
    np.testing.assert_allclose(np.linalg.norm(kn, axis=1), 1.0, rtol=1e-5)
    off_axis = np.sum((np.abs(kn) > 1e-6).sum(axis=1) > 1)
    assert off_axis > 0


def test_camera_record():
    p = builders.PRESETS["cornell_box"]
    cam = p.camera()
    rec = pt.build_camera_record(cam)
    assert rec.shape == (pt.CAMREC,)
    np.testing.assert_allclose(rec[pt.C_ORIGIN:pt.C_ORIGIN + 3],
                               [278, 278, -800])
    assert rec[pt.C_LENS_R] == np.float32(0.05)
    assert rec[pt.C_DTIME] == 1.0


def test_tile_bounds_partition():
    """Every tile is rendered exactly once for any (grid, device) split —
    the host-side contract of render_pallas's multi-device dispatch."""
    for grid in (1, 2, 7, 8, 100, 101):
        for n_dev in (1, 2, 3, 8):
            b = pt.tile_bounds(grid, min(n_dev, grid))
            assert b[0] == 0 and b[-1] == grid
            assert all(x <= y for x, y in zip(b, b[1:]))
            spans = [y - x for x, y in zip(b, b[1:])]
            assert sum(spans) == grid
            assert max(spans) <= -(-grid // min(n_dev, grid))


def test_scene_record_cache_invalidation():
    """The identity cache must miss on field reassignment (dataclass
    fields are mutable even though JAX arrays are not) and on a new
    object, and hit on the unchanged object."""
    scene = builders.two_spheres()
    rec1, aux1 = pt._cached_scene_record(scene)
    rec2, aux2 = pt._cached_scene_record(scene)
    assert rec1 is rec2 and aux1 is aux2          # hit
    scene.tex_color = scene.tex_color + 0.0       # reassign a leaf
    rec3, _ = pt._cached_scene_record(scene)
    assert rec3 is not rec1                       # leaf-id guard missed
    other = builders.two_spheres()
    rec4, _ = pt._cached_scene_record(other)
    assert rec4 is not rec3                       # distinct object


def test_sphere_rows_precede_rects_with_original_ids():
    """Mixed scenes: spheres occupy rows [0, n_sph), rects the rest, and
    F_ORIG maps every row back to its original primitive exactly once
    (the kernel's argmin tie-break compares F_ORIG)."""
    scene = builders.simple_light()
    tab, n_sph, *_ = pt.build_scene_table(scene)
    ptype = np.asarray(scene.prim_type)
    orig = tab[:, pt.F_ORIG].astype(int)
    assert sorted(orig) == list(range(scene.num_prims))
    assert (ptype[orig[:n_sph]] != 2).all()
    assert (ptype[orig[n_sph:]] == 2).all()
