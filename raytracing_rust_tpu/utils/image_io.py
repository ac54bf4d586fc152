"""Image output matching the reference byte-for-byte where possible.

The reference writes ASCII PPM P3: header `P3\n{nx} {ny}\n255\n`, one
`r g b\n` line per pixel, rows top-first, channels quantized with
`(255.99 * c) as i32` truncation (reference tests/test.rs:58-80).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def quantize(img: np.ndarray) -> np.ndarray:
    """[0,1] float image → int channel values, reference truncation
    (tests/test.rs:76-78)."""
    return (255.99 * np.asarray(img)).astype(np.int32)


def to_ppm(img: np.ndarray) -> str:
    """float [ny, nx, 3] (row 0 = top) → P3 PPM text (tests/test.rs:59,79).

    Uses the native encoder (byte-identical) when available — the Python
    string join is ~100x slower for full-size renders.
    """
    from .. import native
    # clip ONCE for both paths: the Python fallback quantizing an
    # unclipped image would emit invalid P3 for out-of-range values
    # (e.g. "-127"), diverging from the native encoder's output
    img = np.clip(np.asarray(img), 0.0, 1.0)
    out = native.encode_ppm(img)
    if out is not None:
        return out
    ny, nx, _ = img.shape
    q = quantize(img).reshape(-1, 3)
    body = "\n".join(f"{r} {g} {b}" for r, g, b in q)
    return f"P3\n{nx} {ny}\n255\n{body}\n"


def write_ppm(path: str, img: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(to_ppm(img))


def read_ppm(path: str) -> np.ndarray:
    """Parse P3 PPM → float [ny, nx, 3] in [0,1] (for golden comparisons
    against the reference's checked-in output/*.ppm)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3"
    nx, ny, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4:4 + nx * ny * 3], dtype=np.float32)
    return (vals / maxv).reshape(ny, nx, 3)


def encode_png(img: np.ndarray) -> bytes:
    """float [ny, nx, 3] (row 0 = top) → 8-bit RGB PNG bytes, with the
    reference's quantization. Standard library only (zlib + struct)."""
    arr = np.clip(quantize(img), 0, 255).astype(np.uint8)
    ny, nx, _ = arr.shape
    # filter type 0 (none) on every scanline
    raw = np.concatenate([np.zeros((ny, 1), np.uint8),
                          arr.reshape(ny, nx * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", nx, ny, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def load_rgb8(path: str) -> np.ndarray:
    """Load an 8-bit RGB image stored as `.npz` (key "rgb", uint8
    [H, W, 3]) → float [H, W, 3] in [0, 1] (scene-build time, like
    reference tests/test.rs:201-206 image::open().to_rgb8())."""
    with np.load(path) as z:
        return np.asarray(z["rgb"], dtype=np.float32) / 255.0
