"""Measure the reference's performance class on this host.

The reference (DrStiev/raytracing_rust) publishes no numbers and Rust cannot
run in this environment, so `native/ref_tracer.cpp` — a faithful scalar f64
C++ mirror of its hot loop (same recursion, same rejection-sampled RNG draws,
same virtual-dispatch object model, same linear HittableList scan, single
thread; reference tests/test.rs:55-85 + src/color.rs:6-23) — is timed on the
headline config (cornell_box 800×800, depth 50) instead. The result is
recorded to `raytracing_rust_tpu/native/ref_baseline.json`, which `bench.py`
uses as the `vs_baseline` denominator (it also re-measures live when the
native toolchain is available; see benchlib.reference_baseline).

Usage: python tools/bench_reference.py [--spp 8] [--reps 3]
"""

import argparse
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytracing_rust_tpu.benchlib import REF_BASELINE_PATH, reference_measure


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-record", action="store_true",
                    help="print only; do not rewrite ref_baseline.json")
    args = ap.parse_args()

    best = None
    for _ in range(args.reps):
        r = reference_measure(spp=args.spp)
        if r is None:
            print(json.dumps({"error": "native toolchain unavailable"}))
            return 1
        if best is None or r["rays_per_sec"] > best["rays_per_sec"]:
            best = r

    record = {
        "rays_per_sec": round(best["rays_per_sec"], 1),
        "wall_seconds": round(best["wall_seconds"], 3),
        "config": best["config"],
        "reps": args.reps,
        "cpu": cpu_model(),
        "date": time.strftime("%Y-%m-%d"),
        "mirror": "native/ref_tracer.cpp (single-thread scalar f64, "
                  "faithful to reference tests/test.rs:55-85)",
    }
    print(json.dumps(record))
    if not args.no_record:
        with open(REF_BASELINE_PATH, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"recorded -> {REF_BASELINE_PATH}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
