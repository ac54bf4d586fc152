"""Flat SoA scene representation (data-parallel inversion of the reference's trait objects).

The reference scene graph is a tree of `Box<dyn Hittable>` / `&dyn Material` /
`dyn Texture` trait objects with dynamic dispatch per ray
(reference: src/hittable.rs:9-21, src/material.rs:30-33, src/texture.rs:4-6).
Here we instead flatten the whole scene at build time into integer-tagged
structure-of-arrays tables (a pytree of jnp arrays) so a batch of N rays can be
intersected/shaded against all primitives with pure vectorized math:

* primitives  — spheres, moving spheres, axis-aligned rects (cubes decompose
  into 6 rects at build time exactly like reference src/cube.rs:20-74;
  FlipNormals becomes a per-primitive sign, reference src/hittable.rs:67-88).
* transforms  — Traslate/Rotate wrappers (reference src/traslate.rs:6-33,
  src/rotate.rs:21-118) become one (rotation axis, sin, cos, offset) record per
  primitive, applied to the ray before and the hit after intersection.
* media       — ConstantMedium (reference src/medium.rs:11-61) entries with a
  convex analytic boundary (sphere or box), sampled in closed form.
* materials   — lambertian/metal/dielectric/diffuse_light/isotropic tags
  (reference src/material.rs:35-173).
* textures    — solid/checker/noise/image tags (reference src/texture.rs:8-108);
  Perlin noise is a lattice hash, seeded per scene (see ops/perlin.py).

All float arrays participate in autodiff: `jax.grad` of a rendered pixel flows
into `prim_data` (geometry), `mat_param`, `tex_color`, and image texels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import jax
import numpy as np
import jax.numpy as jnp

# Primitive type tags.
PRIM_SPHERE = 0
PRIM_MOVING_SPHERE = 1
PRIM_RECT = 2

# Medium boundary tags.
MED_SPHERE = 0
MED_BOX = 1

# Material type tags (reference src/material.rs:35-173).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture type tags (reference src/texture.rs:8-108).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3

# Background modes (reference src/color.rs:14-22 — black is live code, the sky
# gradient is the commented-out book-1 background; we support both per scene).
BG_BLACK = 0
BG_SKY = 1

# prim_data layout (f32[P, 9]):
#   sphere:        [cx, cy, cz, r, 0...]
#   moving sphere: [c0x, c0y, c0z, r, c1x, c1y, c1z, t0, t1]
#   rect:          [a0, b0, a1, b1, k, 0...]   axes from prim_axis
PRIM_DATA_W = 9
MED_DATA_W = 6


@jax.tree_util.register_dataclass
@dataclass
class SceneTables:
    """Device-side scene: everything the integrator needs, as flat arrays."""

    # primitives
    prim_type: jax.Array      # int32[P]
    prim_data: jax.Array      # f32[P, PRIM_DATA_W]
    prim_axis: jax.Array      # int32[P]  rect k-axis (0 for non-rects)
    prim_flip: jax.Array      # f32[P]    +1 / -1 normal sign (FlipNormals)
    prim_material: jax.Array  # int32[P]
    prim_xform: jax.Array     # int32[P]  index into transform tables

    # instance transforms (slot 0 = identity)
    xf_offset: jax.Array      # f32[T, 3]
    xf_axis: jax.Array        # int32[T]  rotation axis
    xf_sin: jax.Array         # f32[T]
    xf_cos: jax.Array         # f32[T]

    # constant-density media
    med_type: jax.Array       # int32[M]
    med_data: jax.Array       # f32[M, MED_DATA_W]
    med_density: jax.Array    # f32[M]
    med_material: jax.Array   # int32[M]
    med_xform: jax.Array      # int32[M]

    # materials
    mat_type: jax.Array       # int32[Mt]
    mat_texture: jax.Array    # int32[Mt]
    mat_param: jax.Array      # f32[Mt]  metal fuzz / dielectric ref_idx

    # textures
    tex_type: jax.Array       # int32[Tx]
    tex_color: jax.Array      # f32[Tx, 3]
    tex_child: jax.Array      # int32[Tx, 2]  checker (odd, even)
    tex_scale: jax.Array      # f32[Tx]       noise scale
    tex_image: jax.Array      # int32[Tx]     image id

    # image atlas: all images zero-padded into one array (only earthmap in
    # the reference, so I=1, H=512, W=1024 typically; (1,1,1,3) when unused)
    images: jax.Array         # f32[I, H, W, 3]
    image_hw: jax.Array       # int32[I, 2] true (h, w) of each image

    # scalar scene config (static python values so jit specializes per scene
    # and scenes don't pay for features they don't use)
    background: int = field(metadata=dict(static=True), default=BG_BLACK)
    # Perlin hash seed (reference src/perlin.rs builds random tables; we hash
    # the lattice — see ops/perlin.py module docstring)
    perlin_seed: int = field(metadata=dict(static=True), default=0)
    has_media: bool = field(metadata=dict(static=True), default=False)
    has_noise_tex: bool = field(metadata=dict(static=True), default=False)
    has_image_tex: bool = field(metadata=dict(static=True), default=False)
    has_moving: bool = field(metadata=dict(static=True), default=False)
    has_xforms: bool = field(metadata=dict(static=True), default=False)
    # faithful-quirk flag: reproduce the reference's sphere-UV constant bug
    # (FRAC_2_PI = 2/π where the formula wants π/2, src/sphere.rs:13) —
    # completes the compat trio with final_scene's dead light and
    # cornell_smoke's front wall (models/builders.py)
    compat_uv_bug: bool = field(metadata=dict(static=True), default=False)

    @property
    def num_prims(self) -> int:
        return self.prim_type.shape[0]

    @property
    def num_media(self) -> int:
        return self.med_type.shape[0]


_AXIS_OF_PLANE = {"yz": 0, "zx": 1, "xy": 2}
_AXIS_OF_ROT = {"x": 0, "y": 1, "z": 2}


@dataclass
class _Xform:
    offset: np.ndarray
    axis: int
    sin: float
    cos: float


class SceneBuilder:
    """Host-side builder: the data-parallel answer to the reference's scene-builder fns
    (reference tests/test.rs:89-523). Python objects in, flat tables out.
    """

    def __init__(self, background: int = BG_BLACK, perlin_seed: int = 0,
                 compat_uv_bug: bool = False):
        self.background = background
        self.perlin_seed = perlin_seed
        self.compat_uv_bug = compat_uv_bug
        self._ptype: List[int] = []
        self._pdata: List[np.ndarray] = []
        self._paxis: List[int] = []
        self._pflip: List[float] = []
        self._pmat: List[int] = []
        self._pxf: List[int] = []
        self._xf: List[_Xform] = [_Xform(np.zeros(3), 0, 0.0, 1.0)]
        self._mtype: List[int] = []
        self._mdata: List[np.ndarray] = []
        self._mdensity: List[float] = []
        self._mmat: List[int] = []
        self._mxf: List[int] = []
        self._mat_type: List[int] = []
        self._mat_tex: List[int] = []
        self._mat_param: List[float] = []
        self._tex_type: List[int] = []
        self._tex_color: List[np.ndarray] = []
        self._tex_child: List[np.ndarray] = []
        self._tex_scale: List[float] = []
        self._tex_image: List[int] = []
        self._images: List[np.ndarray] = []

    # -- textures ----------------------------------------------------------
    def _add_texture(self, ttype, color=(0, 0, 0), child=(0, 0), scale=0.0, image=0) -> int:
        self._tex_type.append(ttype)
        self._tex_color.append(np.asarray(color, np.float32))
        self._tex_child.append(np.asarray(child, np.int32))
        self._tex_scale.append(float(scale))
        self._tex_image.append(int(image))
        return len(self._tex_type) - 1

    def solid(self, r: float, g: float, b: float) -> int:
        """reference src/texture.rs:8-25"""
        return self._add_texture(TEX_SOLID, color=(r, g, b))

    def checker(self, odd: int, even: int) -> int:
        """reference src/texture.rs:27-48 (children are texture ids)"""
        return self._add_texture(TEX_CHECKER, child=(odd, even))

    def noise(self, scale: float) -> int:
        """reference src/texture.rs:50-71"""
        return self._add_texture(TEX_NOISE, scale=scale)

    def image(self, pixels: np.ndarray) -> int:
        """reference src/texture.rs:73-108 — pixels: float/uint8 [H, W, 3]"""
        pixels = np.asarray(pixels)
        if pixels.dtype == np.uint8:
            pixels = pixels.astype(np.float32) / 255.0
        self._images.append(pixels.astype(np.float32))
        return self._add_texture(TEX_IMAGE, image=len(self._images) - 1)

    # -- materials ----------------------------------------------------------
    def _add_material(self, mtype, tex, param=0.0) -> int:
        self._mat_type.append(mtype)
        self._mat_tex.append(int(tex))
        self._mat_param.append(float(param))
        return len(self._mat_type) - 1

    def lambertian(self, tex: int) -> int:
        """reference src/material.rs:35-58"""
        return self._add_material(MAT_LAMBERTIAN, tex)

    def metal(self, tex: int, fuzz: float) -> int:
        """reference src/material.rs:60-92 (fuzz clamped to <=1 like :67-72)"""
        return self._add_material(MAT_METAL, tex, min(fuzz, 1.0))

    def dielectric(self, ref_idx: float) -> int:
        """reference src/material.rs:94-131 (attenuation fixed (1,1,1))"""
        return self._add_material(MAT_DIELECTRIC, self.solid(1, 1, 1), ref_idx)

    def diffuse_light(self, tex: int) -> int:
        """reference src/material.rs:133-151"""
        return self._add_material(MAT_DIFFUSE_LIGHT, tex)

    def isotropic(self, tex: int) -> int:
        """reference src/material.rs:153-173"""
        return self._add_material(MAT_ISOTROPIC, tex)

    # -- transforms ----------------------------------------------------------
    def transform(self, offset=(0.0, 0.0, 0.0), rotate_axis: str = "y",
                  angle_deg: float = 0.0) -> int:
        """Traslate∘Rotate instance transform (reference tests/test.rs:297-321
        composition order: Traslate::new(Rotate::new(...)))."""
        rad = math.radians(angle_deg)
        self._xf.append(_Xform(np.asarray(offset, np.float64),
                               _AXIS_OF_ROT[rotate_axis],
                               math.sin(rad), math.cos(rad)))
        return len(self._xf) - 1

    # -- primitives ----------------------------------------------------------
    def _add_prim(self, ptype, data, axis=0, flip=1.0, material=0, xform=0):
        d = np.zeros(PRIM_DATA_W, np.float64)
        d[: len(data)] = data
        self._ptype.append(ptype)
        self._pdata.append(d)
        self._paxis.append(int(axis))
        self._pflip.append(float(flip))
        self._pmat.append(int(material))
        self._pxf.append(int(xform))

    def sphere(self, center, radius: float, material: int, xform: int = 0):
        """reference src/sphere.rs:20-85"""
        c = np.asarray(center, np.float64)
        self._add_prim(PRIM_SPHERE, [c[0], c[1], c[2], radius],
                       material=material, xform=xform)

    def moving_sphere(self, c0, c1, t0: float, t1: float, radius: float,
                      material: int, xform: int = 0):
        """reference src/sphere.rs:87-175"""
        c0 = np.asarray(c0, np.float64)
        c1 = np.asarray(c1, np.float64)
        self._add_prim(PRIM_MOVING_SPHERE,
                       [c0[0], c0[1], c0[2], radius, c1[0], c1[1], c1[2], t0, t1],
                       material=material, xform=xform)

    def rect(self, plane: str, a0, b0, a1, b1, k, material: int,
             flip: bool = False, xform: int = 0):
        """reference src/rect.rs:14-69; plane in {yz, zx, xy}.
        flip=True is the FlipNormals wrapper (reference src/hittable.rs:67-88)."""
        self._add_prim(PRIM_RECT, [a0, b0, a1, b1, k],
                       axis=_AXIS_OF_PLANE[plane],
                       flip=-1.0 if flip else 1.0, material=material, xform=xform)

    def cube(self, pmin, pmax, material: int, xform: int = 0):
        """6-rect decomposition, exactly reference src/cube.rs:20-74.

        Face order & params mirror the reference: XY at z=max/min, ZX at
        y=max/min, YZ at x=max/min. The reference does NOT flip inside faces
        (src/cube.rs has no FlipNormals) — all six normals point +axis."""
        p0 = np.asarray(pmin, np.float64)
        p1 = np.asarray(pmax, np.float64)
        self.rect("xy", p0[0], p0[1], p1[0], p1[1], p1[2], material, xform=xform)
        self.rect("xy", p0[0], p0[1], p1[0], p1[1], p0[2], material, xform=xform)
        self.rect("zx", p0[2], p0[0], p1[2], p1[0], p1[1], material, xform=xform)
        self.rect("zx", p0[2], p0[0], p1[2], p1[0], p0[1], material, xform=xform)
        self.rect("yz", p0[1], p0[2], p1[1], p1[2], p1[0], material, xform=xform)
        self.rect("yz", p0[1], p0[2], p1[1], p1[2], p0[0], material, xform=xform)

    # -- media ----------------------------------------------------------------
    def medium_sphere(self, center, radius: float, density: float, tex: int,
                      xform: int = 0):
        """ConstantMedium with sphere boundary (reference src/medium.rs:11-25,
        used at tests/test.rs:476-492)."""
        c = np.asarray(center, np.float64)
        self._add_medium(MED_SPHERE, [c[0], c[1], c[2], radius], density, tex, xform)

    def medium_box(self, pmin, pmax, density: float, tex: int, xform: int = 0):
        """ConstantMedium with (possibly transformed) cube boundary
        (reference tests/test.rs:379-415)."""
        p0 = np.asarray(pmin, np.float64)
        p1 = np.asarray(pmax, np.float64)
        self._add_medium(MED_BOX, [p0[0], p0[1], p0[2], p1[0], p1[1], p1[2]],
                         density, tex, xform)

    def _add_medium(self, mtype, data, density, tex, xform):
        d = np.zeros(MED_DATA_W, np.float64)
        d[: len(data)] = data
        self._mtype.append(mtype)
        self._mdata.append(d)
        self._mdensity.append(float(density))
        self._mmat.append(self.isotropic(tex))
        self._mxf.append(int(xform))

    def _dedup_coincident(self):
        """Drop coincident-geometry duplicates the reference tie-break makes
        unreachable.

        The reference resolves equal-t ties by scan order, and the order
        depends on the primitive: Rect::hit accepts t == t_max
        (src/rect.rs:45-47 uses `t > t_max`), so in the HittableList scan
        (src/hittable.rs:37-47) the LAST coincident rect replaces every
        earlier one; Sphere::hit is strict (`t < t_max`, src/sphere.rs:47),
        so the FIRST coincident sphere wins. cornell_box pushes its floor
        twice — flipped then unflipped (tests/test.rs:268-295) — and renders
        the UNFLIPPED (+y) one. Our closest-hit is an order-free
        min-reduction whose argmin would pick the flipped copy; since a
        shadowed duplicate can never win in the reference, delete it at
        build time instead of paying for tie-aware reductions in the
        kernels. Keyed on hit-t geometry only (type, axes, data, resolved
        transform) — flip sign and material belong to the surviving copy.

        Scope: BIT-IDENTICAL duplicate geometry only. Equal-t ties between
        non-identical prims (partially overlapping coplanar rects,
        rect/sphere tangencies) still resolve by argmin, not scan order —
        no shipped reference scene has one, and the general case would
        need tie-aware reductions in every tier.
        """
        n = len(self._ptype)
        keep = [True] * n

        def key(i):
            xf = self._xf[self._pxf[i]]
            return (self._ptype[i], self._paxis[i], self._pdata[i].tobytes(),
                    xf.offset.tobytes(), xf.axis, xf.sin, xf.cos)

        seen = {}
        for i in range(n - 1, -1, -1):  # backward: keep the LAST rect
            if self._ptype[i] != PRIM_RECT:
                continue
            k = key(i)
            if k in seen:
                keep[i] = False
            seen[k] = i
        seen = {}
        for i in range(n):  # forward: keep the FIRST sphere
            if self._ptype[i] == PRIM_RECT:
                continue
            k = key(i)
            if k in seen:
                keep[i] = False
            seen[k] = i
        if all(keep):
            return
        for name in ("_ptype", "_pdata", "_paxis", "_pflip", "_pmat", "_pxf"):
            setattr(self, name,
                    [v for v, k in zip(getattr(self, name), keep) if k])

    # -- finalize -------------------------------------------------------------
    def build(self, dtype=jnp.float32) -> SceneTables:
        self._dedup_coincident()
        if not self._ptype:  # keep shapes non-empty for jit friendliness
            # radius 0 ⇒ disc = b²−a·|oc|² ≤ 0 (Cauchy–Schwarz): never hits
            self._add_prim(PRIM_SPHERE, [0.0, 0.0, 0.0, 0.0], material=0)
        if not self._mat_type:
            self.lambertian(self.solid(0, 0, 0))
        M = len(self._mtype)
        if not self._images:
            images = np.zeros((1, 1, 1, 3), np.float32)
            image_hw = np.ones((1, 2), np.int32)
        else:
            # pad all to common H, W; true dims kept per image so sampling
            # never reads a smaller image's zero padding
            h = max(im.shape[0] for im in self._images)
            w = max(im.shape[1] for im in self._images)
            images = np.zeros((len(self._images), h, w, 3), np.float32)
            image_hw = np.zeros((len(self._images), 2), np.int32)
            for i, im in enumerate(self._images):
                images[i, : im.shape[0], : im.shape[1]] = im
                image_hw[i] = im.shape[:2]

        # build every table host-side and ship the whole pytree in ONE
        # batched device_put at the end instead of ~25 separate transfers
        def f(x):
            return np.asarray(x, _np_dtype(dtype))

        def i32(x):
            return np.asarray(x, np.int32)

        tables = SceneTables(
            prim_type=i32(self._ptype),
            prim_data=f(np.stack(self._pdata)),
            prim_axis=i32(self._paxis),
            prim_flip=f(self._pflip),
            prim_material=i32(self._pmat),
            prim_xform=i32(self._pxf),
            xf_offset=f(np.stack([x.offset for x in self._xf])),
            xf_axis=i32([x.axis for x in self._xf]),
            xf_sin=f([x.sin for x in self._xf]),
            xf_cos=f([x.cos for x in self._xf]),
            med_type=i32(self._mtype if M else [0]),
            med_data=f(np.stack(self._mdata) if M else np.full((1, MED_DATA_W), 0.0)),
            med_density=f(self._mdensity if M else [0.0]),
            med_material=i32(self._mmat if M else [0]),
            med_xform=i32(self._mxf if M else [0]),
            mat_type=i32(self._mat_type),
            mat_texture=i32(self._mat_tex),
            mat_param=f(self._mat_param),
            tex_type=i32(self._tex_type),
            tex_color=f(np.stack(self._tex_color)),
            tex_child=i32(np.stack(self._tex_child)),
            tex_scale=f(self._tex_scale),
            tex_image=i32(self._tex_image),
            images=f(images),
            image_hw=i32(image_hw),
            background=self.background,
            perlin_seed=self.perlin_seed,
            compat_uv_bug=self.compat_uv_bug,
            has_media=M > 0,
            has_noise_tex=TEX_NOISE in self._tex_type,
            has_image_tex=TEX_IMAGE in self._tex_type,
            has_moving=PRIM_MOVING_SPHERE in self._ptype,
            has_xforms=len(self._xf) > 1,
        )
        return jax.device_put(tables)


def _np_dtype(dtype):
    # canonicalize handles jnp scalar types, np scalar types, np.dtype,
    # and strings alike (and applies the x64-disabled downcast exactly
    # like the jnp.asarray this replaced)
    return np.dtype(jax.dtypes.canonicalize_dtype(dtype))
