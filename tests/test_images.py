"""HDR (RGBE) and PNG codec tests."""

import io
import os
import zlib

import numpy as np
import pytest

from refraction.io.hdr import (
    decode_hdr_bytes,
    float_to_rgbe,
    rgbe_to_float,
    write_hdr,
)
from refraction.io.png import (
    decode_png_bytes,
    load_png,
    png_to_float_rgb,
    write_png,
)

REF_ENVMAP = "/root/reference/envmap.png"


def test_rgbe_roundtrip():
    rng = np.random.default_rng(0)
    rgb = (rng.uniform(0, 1, (16, 16, 3)).astype(np.float32) *
           np.float32(2.0) ** rng.integers(-8, 8, (16, 16, 1)))
    back = rgbe_to_float(float_to_rgbe(rgb))
    # RGBE shares one exponent across channels: ~1/256 relative error bound
    # on the max channel.
    maxc = rgb.max(-1, keepdims=True)
    assert np.all(np.abs(back - rgb) <= maxc / 128.0 + 1e-7)


def test_rgbe_zero_and_tiny():
    rgb = np.array([[[0, 0, 0], [1e-40, 0, 0]]], np.float32)
    back = rgbe_to_float(float_to_rgbe(rgb))
    assert np.all(back == 0)


def test_hdr_file_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 4, (32, 48, 3)).astype(np.float32)
    p = str(tmp_path / "x.hdr")
    write_hdr(p, rgb)
    with open(p, "rb") as f:
        back = decode_hdr_bytes(f.read())
    assert back.shape == (32, 48, 3)
    maxc = rgb.max(-1, keepdims=True)
    assert np.all(np.abs(back - rgb) <= maxc / 128.0 + 1e-7)


def test_hdr_rle_decode():
    # Hand-build a new-style RLE file: 1 scanline, width 8.
    w, h = 8, 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[0, :, 0] = 128           # constant red mantissa -> run
    rgbe[0, :, 1] = np.arange(8)  # varying green -> literals
    rgbe[0, :, 2] = 64
    rgbe[0, :, 3] = 129
    payload = bytes([2, 2, 0, 8])
    payload += bytes([128 + 8, 128])                 # R: run of 8 x 128
    payload += bytes([8]) + bytes(range(8))          # G: 8 literals
    payload += bytes([128 + 8, 64])                  # B: run
    payload += bytes([128 + 8, 129])                 # E: run
    data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode() + payload
    out = decode_hdr_bytes(data)
    np.testing.assert_allclose(out, rgbe_to_float(rgbe), rtol=0, atol=0)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_roundtrip(tmp_path, channels):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (20, 30, channels), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    back = load_png(p)
    np.testing.assert_array_equal(back, img)


def test_png_filters_all_types():
    """Build PNGs using each filter type and check decode (filter 0 written
    by our encoder is covered above; 1-4 built by hand)."""
    import struct

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
    h, w, c = img.shape
    bpp = c

    def filt(ftype, line, prev):
        line = line.astype(np.int32)
        out = np.zeros_like(line)
        for i in range(len(line)):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            cc = prev[i - bpp] if i >= bpp else 0
            if ftype == 1:
                out[i] = (line[i] - a) & 0xFF
            elif ftype == 2:
                out[i] = (line[i] - b) & 0xFF
            elif ftype == 3:
                out[i] = (line[i] - ((a + b) >> 1)) & 0xFF
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                out[i] = (line[i] - pred) & 0xFF
        return out.astype(np.uint8)

    raw = b""
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        ftype = 1 + (y % 4)
        line = img[y].reshape(-1)
        raw += bytes([ftype]) + filt(ftype, line, prev).tobytes()
        prev = line.astype(np.int32)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))
    back = decode_png_bytes(data)
    np.testing.assert_array_equal(back, img)


def test_png_to_float_gamma():
    img = np.array([[[255, 128, 0]]], np.uint8)
    f = png_to_float_rgb(img)
    np.testing.assert_allclose(f[0, 0, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(f[0, 0, 1], (128 / 255) ** 2.2, rtol=1e-5)
    assert f[0, 0, 2] == 0.0
    # grayscale replication
    g = png_to_float_rgb(np.array([[[100]]], np.uint8))
    assert g.shape == (1, 1, 3)
    assert g[0, 0, 0] == g[0, 0, 1] == g[0, 0, 2]


@pytest.mark.skipif(not os.path.exists(REF_ENVMAP), reason="reference assets not mounted")
def test_decode_reference_envmap():
    img = load_png(REF_ENVMAP)
    assert img.ndim == 3 and img.shape[2] in (1, 2, 3, 4)
    f = png_to_float_rgb(img)
    assert f.shape == (img.shape[0], img.shape[1], 3)
    assert f.dtype == np.float32
    assert float(f.max()) <= 1.0 and float(f.min()) >= 0.0
