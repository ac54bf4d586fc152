"""Worker process for the 2-process multi-host CPU test.

Usage: python tools/multihost_worker.py <coordinator> <num_procs> <pid> <out>

Each process contributes 4 virtual CPU devices; after
`jax.distributed.initialize()` the global mesh spans 8 devices across the
two processes, exactly like a 2-host cluster over the network (SURVEY.md §5
"Distributed communication backend"). Runs one sharded differentiable
train step (parallel/sharding.py train_step_sharded) and writes the
fully-replicated loss + gradient norms as JSON (process 0 only).
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")


def main():
    coord, n_procs, pid, out_path = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=n_procs, process_id=pid)
    assert jax.process_count() == n_procs
    assert len(jax.devices()) == 4 * n_procs

    import jax.numpy as jnp
    import numpy as np

    from raytracing_rust_tpu.models import builders
    from raytracing_rust_tpu.parallel.sharding import (make_mesh,
                                                       train_step_sharded)

    scene = builders.two_spheres()
    preset = builders.PRESETS["two_spheres"]
    cam = preset.camera()
    nx, ny, spp = 32, 18, 4
    pix = jnp.arange(64, dtype=jnp.int32)
    key = jax.random.key(3)
    target = jnp.zeros((64, 3), jnp.float32)
    mesh = make_mesh(dp=4, sp=2)
    loss, grads = train_step_sharded(scene, cam, pix, key, target,
                                     nx, ny, spp, 4, mesh)

    # cross-process shard_map COMPACTION (round 5): the head + one
    # re-compaction stage run over the process-spanning mesh — the
    # pmax/pmin count collectives and the survivor gather/scatter all
    # cross the process boundary. Compared against the plain GSPMD
    # path via fully-REPLICATED means (per-shard arrays are not
    # addressable across processes; replicated scalars are).
    from raytracing_rust_tpu.parallel.sharding import (
        _head_sharded, _stage_sharded, render_block_sharded)
    from raytracing_rust_tpu.render import _pow2_width
    depth = 8
    plain = render_block_sharded(scene, cam, pix, key, nx, ny, spp,
                                 depth, mesh)
    plain_mean = float(jax.jit(jnp.mean)(plain)) / spp
    *state, cnt = _head_sharded(scene, cam, pix, key, nx, ny, spp,
                                depth, mesh, s1=6)
    nl = 64 * spp // (4 * 2)
    w = _pow2_width(int(jax.device_get(cnt)), nl)
    state, cnt2, ok = _stage_sharded(scene, tuple(state), key, w,
                                     jnp.asarray(6, jnp.int32),
                                     jnp.asarray(depth + 1, jnp.int32),
                                     depth, mesh)
    compact_mean = float(jax.jit(jnp.mean)(state[4]))
    ok = bool(jax.device_get(ok))

    # loss and replicated-parameter grads are fully replicated → every
    # process holds complete copies and can read them back
    result = {
        "process_count": jax.process_count(),
        "n_devices": len(jax.devices()),
        "loss": float(loss),
        "g_tex": float(jnp.linalg.norm(grads.tex_color)),
        "g_geom": float(jnp.linalg.norm(grads.prim_data)),
        "compact_mean": compact_mean,
        "plain_mean": plain_mean,
        "compact_ok": ok,
    }
    if pid == 0:
        with open(out_path, "w") as fh:
            json.dump(result, fh)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
