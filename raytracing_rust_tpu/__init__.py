"""raytracing_rust_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the feature set of
DrStiev/raytracing_rust (a CPU Rust "Ray Tracing in One Weekend / The Next
Week" renderer): batched wavefront integration instead of scalar recursion,
flat SoA scene tables instead of trait objects, counter-based stateless RNG
instead of thread_rng, `jax.grad`-able shading throughout, and
`jax.sharding`-based multi-device/multi-host scaling, and Pallas
(Triton-route) kernels for CUDA GPUs.
"""

from .models.scene import SceneBuilder, SceneTables, BG_BLACK, BG_SKY
from .models import builders
from .models.builders import PRESETS
from .ops.camera import Camera, make_camera
from .ops.integrator import trace
from .render import render, render_block
from .utils.image_io import to_ppm, write_ppm, write_png

__version__ = "0.1.0"
