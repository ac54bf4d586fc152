"""CLI surface (reference 'CLI' = cargo test; ours is a real one)."""

import os


from raytracing_rust_tpu.cli import main
from raytracing_rust_tpu.utils.image_io import read_ppm


def test_scenes_lists_presets(capsys):
    assert main(["scenes"]) == 0
    out = capsys.readouterr().out
    for name in ("cornell_box", "final_scene", "two_spheres"):
        assert name in out


def test_render_auto_engine_on_cpu(tmp_path, capsys):
    """auto engine renders on the XLA tier on a host without a GPU (the
    Triton-route kernel compiles only for CUDA) and says so."""
    out = str(tmp_path / "t.ppm")
    log = str(tmp_path / "log.log")
    rc = main(["render", "--scene", "two_spheres", "--nx", "32", "--ny",
               "18", "--spp", "2", "--out", out, "--no-progress",
               "--log", log])
    assert rc == 0
    img = read_ppm(out)
    assert img.shape == (18, 32, 3)
    assert img.mean() > 0.2  # sky scene, not black
    assert os.path.exists(log)
    assert "engine=xla" in capsys.readouterr().out
    assert "engine=xla" in open(log).read()


def test_render_png_and_unknown_scene(tmp_path):
    out = str(tmp_path / "t.png")
    rc = main(["render", "--scene", "two_spheres", "--nx", "16", "--ny",
               "9", "--spp", "2", "--out", out, "--no-progress",
               "--log", str(tmp_path / "l.log")])
    assert rc == 0 and os.path.getsize(out) > 100
    assert main(["render", "--scene", "nope", "--no-progress"]) == 2


def test_render_timers_report(tmp_path, capsys):
    """--timers prints per-phase wall times covering build, the
    compile-carrying first dispatch, and encode (SURVEY.md §5 profiling:
    the reference has none)."""
    out = str(tmp_path / "t.ppm")
    rc = main(["render", "--scene", "two_spheres", "--nx", "16", "--ny",
               "9", "--spp", "2", "--out", out, "--no-progress",
               "--timers", "--log", str(tmp_path / "l.log")])
    assert rc == 0
    text = capsys.readouterr().out
    for phase in ("scene_build", "compile+block0", "encode"):
        assert phase in text


def test_bench_validates_args(capsys):
    """bench must reject a typo'd scene / non-positive spp with exit 2 and
    a scene list, not a raw KeyError from inside benchlib."""
    assert main(["bench", "--scene", "nope"]) == 2
    assert "cornell_box" in capsys.readouterr().err
    assert main(["bench", "--scene", "cornell_box", "--spp", "0"]) == 2
    assert "positive" in capsys.readouterr().err


def test_checkpoint_requires_xla_engine(tmp_path, capsys):
    """--engine pallas on a host without a GPU stops with one clear line
    (exit 2) — with or without --checkpoint — and never drops to
    interpret mode or to the XLA tier."""
    out = tmp_path / "t.ppm"
    for extra in ([], ["--checkpoint", str(tmp_path / "c.npz")]):
        rc = main(["render", "--scene", "two_spheres", "--nx", "16",
                   "--ny", "9", "--spp", "2", "--engine", "pallas",
                   "--out", str(out), "--no-progress",
                   "--log", str(tmp_path / "l.log")] + extra)
        assert rc == 2
        err = capsys.readouterr().err.strip().splitlines()
        assert err == ["--engine pallas requires a CUDA GPU "
                       "(the kernel is compiled by Triton)"]
    assert not out.exists()
