"""Thin-lens motion-blur camera (reference src/camera.rs).

The reference camera is an AoS struct with a scalar `get_ray(s, t)` making 3+
RNG draws (src/camera.rs:53-67). Here the camera is a small pytree and ray
generation is a batched pure function of pixel coordinates + uniforms, so XLA
fuses it into the render. Ray directions are deliberately left UNNORMALIZED —
the reference convention (SURVEY.md §3.3); all intersection/shading math is
written for unnormalized directions, exactly like the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from . import rng


@jax.tree_util.register_dataclass
@dataclass
class Camera:
    origin: jax.Array       # f32[3]
    lower_left: jax.Array   # f32[3]
    horizontal: jax.Array   # f32[3]
    vertical: jax.Array     # f32[3]
    u: jax.Array            # f32[3]  lens basis
    v: jax.Array            # f32[3]
    time0: jax.Array        # f32[]
    time1: jax.Array        # f32[]
    lens_radius: jax.Array  # f32[]


def make_camera(look_from, look_at, view_up, vertical_fov: float, aspect: float,
                aperture: float, focus_dist: float, time0: float = 0.0,
                time1: float = 0.0, dtype=jnp.float32) -> Camera:
    """Exactly the construction math at reference src/camera.rs:21-51.

    Computed host-side in numpy and shipped in ONE batched device_put —
    each eager jnp op here would otherwise be its own device dispatch.
    """
    import numpy as np

    npdt = np.dtype(jax.dtypes.canonicalize_dtype(dtype))
    look_from = np.asarray(look_from, npdt)
    look_at = np.asarray(look_at, npdt)
    view_up = np.asarray(view_up, npdt)

    theta = vertical_fov * math.pi / 180.0
    half_height = focus_dist * math.tan(theta / 2.0)
    half_width = aspect * half_height

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(view_up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    cam = Camera(
        origin=look_from,
        lower_left=np.asarray(
            look_from - half_width * u - half_height * v - focus_dist * w,
            npdt),
        horizontal=np.asarray(2.0 * half_width * u, npdt),
        vertical=np.asarray(2.0 * half_height * v, npdt),
        u=np.asarray(u, npdt),
        v=np.asarray(v, npdt),
        time0=np.asarray(time0, npdt),
        time1=np.asarray(time1, npdt),
        lens_radius=np.asarray(aperture / 2.0, npdt),
    )
    return jax.device_put(cam)


def get_rays(cam: Camera, s: jnp.ndarray, t: jnp.ndarray, u: jnp.ndarray):
    """Batched `get_ray` (reference src/camera.rs:53-67).

    s, t: f32[N] viewport coordinates in [0,1); u: f32[N, 3] uniforms
    (2 for the lens disk, 1 for shutter time). Returns (origin[N,3],
    direction[N,3], time[N]); directions unnormalized like the reference.
    """
    rd = cam.lens_radius * rng.in_unit_disk(u[..., 0:2])
    offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
    origin = cam.origin + offset
    time = cam.time0 + u[..., 2] * (cam.time1 - cam.time0)
    direction = (cam.lower_left + s[..., None] * cam.horizontal
                 + t[..., None] * cam.vertical - origin)
    return origin, direction, time
