#!/usr/bin/env python
"""Benchmark entry: prints ONE JSON line with the headline metric
(rays/sec/chip at cornell_box 800x800 500spp — BASELINE.json) on a CUDA
GPU; any other backend is an error.

Full 500 spp is rendered unless BENCH_SPP overrides (the metric is
per-sample-constant, so rays/s is invariant to spp beyond warmup)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from raytracing_rust_tpu import benchlib  # noqa: E402
from raytracing_rust_tpu.backend import init_compile_cache  # noqa: E402


def main():
    init_compile_cache()
    spp = int(os.environ.get("BENCH_SPP", "0")) or None
    result = benchlib.run(scene="cornell_box_baseline", spp=spp)
    print(benchlib.to_json(result))


if __name__ == "__main__":
    main()
