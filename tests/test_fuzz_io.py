"""Randomized fuzz-parity tests for the asset-ingest layer.

The reference trusts its inputs completely (Mesh.cpp:6-37 indexes vertex
arrays with unchecked sscanf ints; stb_image is the battle-tested part).
This framework ships TWO implementations of each decoder — the Python
behavioral definition and the C++ fast path (native/io_native.cpp) — so
beyond crash-safety the property that matters is *exact agreement* on
arbitrary input: a divergence means a scene silently parses differently
depending on whether the native library built.

Three layers, all seeded (deterministic):
- OBJ: random token-soup files (valid lines, malformed tokens, quads,
  out-of-range indices, Python-only literal forms like ``1_0``/``0x1p3``,
  embedded NULs, long lines, CRLF) → Python parse never raises, and
  native output is byte-identical.
- HDR: random images through every encoding (flat, new-style RLE with
  mixed runs/literals, old-style RLE with repeat codes) decode
  identically; random truncations/bit-flips either decode identically or
  fail cleanly on both sides (Python ValueError <=> native NULL).
- PNG: random truncations of a valid file raise clean errors.
"""

import os
import struct
import subprocess
import zlib

import numpy as np
import pytest

from refraction.io import native
from refraction.io.hdr import decode_hdr_bytes, float_to_rgbe, write_hdr
from refraction.io.objmesh import parse_obj
from refraction.io.png import decode_png_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_lib():
    try:
        subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"cannot build native lib: {e}")
    native._LIB = None
    native._TRIED = False
    if not native.available():
        pytest.skip("native lib failed to load")
    return native


# ---------------------------------------------------------------------------
# OBJ fuzz
# ---------------------------------------------------------------------------

# Token soup: the interesting boundary cases of the shared numeric-token
# contract (objmesh.py module docstring / io_native.cpp parse_float_token).
_TAGS = ["v", "vt", "vn", "f", "g", "o", "usemtl", "#", "vv", "F", ""]
_NUM_TOKENS = [
    "0", "1", "2", "3", "4", "-1", "+2", "007",
    "1.5", "-0.25", ".5", "1.", "+.5e-2", "1e3", "1E-2", "9e99", "1e999",
    "inf", "-inf", "INFINITY", "nan", "NAN", "-nan",
]
_BAD_TOKENS = [
    "1.5abc", "1e", "1.5e+", "abc", "--1", "++2", "1..2", "", ".",
    "1_0", "1_000.5", "0x1p3", "0X10", "-0x2", "infin", "nan(12)",
    "\x0c1", "\x0b2.5", "é", "１２３", "1\x00junk",
]
_FACE_TOKENS = [
    "1/1/1", "2/2/2", "3/1/2", "1/2/3", "4/1/1", "-1/2/3", "0/1/1",
    "9/9/9", "99/1/1", "1/2/3/4", "1//2", "//", "a/b/c", "1/2/",
    "/1/2", "1/2", "1", "+1/+1/+1", "001/001/001", "1_0/1/1",
    "99999999999999999999/1/1", "\x0c1/1/1", "1/1/1extra",
]


def _random_obj_text(rng: np.random.Generator, n_lines: int) -> str:
    lines = []
    for _ in range(n_lines):
        tag = _TAGS[rng.integers(len(_TAGS))]
        toks = [tag]
        pool = _FACE_TOKENS if tag == "f" else (_NUM_TOKENS + _BAD_TOKENS)
        for _ in range(int(rng.integers(0, 6))):
            if tag != "f" and rng.random() < 0.25:
                toks.append(_BAD_TOKENS[rng.integers(len(_BAD_TOKENS))])
            else:
                toks.append(pool[rng.integers(len(pool))])
        sep = [" ", "\t", "  ", " \t"][rng.integers(4)]
        line = sep.join(toks)
        if rng.random() < 0.1:
            line += "\r"
        if rng.random() < 0.05:  # the occasional very long line (>8 KiB)
            line = line + " " + " ".join(["1.0"] * 4000)
        lines.append(line)
    text = "\n".join(lines)
    if rng.random() < 0.5:
        text += "\n"
    return text


def test_obj_fuzz_python_vs_native(native_lib, tmp_path):
    rng = np.random.default_rng(20260817)
    p = str(tmp_path / "fuzz.obj")
    for it in range(120):
        text = _random_obj_text(rng, int(rng.integers(1, 40)))
        with open(p, "w", encoding="utf-8") as f:
            f.write(text)
        py = parse_obj(p, allow_native=False)   # must never raise
        nat = native_lib.parse_obj(p)
        assert nat is not None, f"iter {it}: native failed to open"
        pos, norm, uv = nat
        assert pos.shape == py.positions.shape, (
            f"iter {it}: tri count {pos.shape} vs {py.positions.shape}"
            f"\n--- obj ---\n{text!r}")
        np.testing.assert_array_equal(pos, py.positions, err_msg=f"iter {it}")
        np.testing.assert_array_equal(norm, py.normals, err_msg=f"iter {it}")
        np.testing.assert_array_equal(uv, py.uvs, err_msg=f"iter {it}")


def test_obj_fuzz_raw_bytes(native_lib, tmp_path):
    """Invalid UTF-8 and control bytes: both sides skip identically."""
    rng = np.random.default_rng(7)
    p = str(tmp_path / "raw.obj")
    alphabet = (b"v vt vn f 0123456789./-+e\t\r\n"
                + bytes([0xFF, 0xC3, 0xA9, 0x00, 0x7F]))
    for it in range(60):
        raw = bytes(alphabet[b % len(alphabet)]
                    for b in rng.integers(0, 256, int(rng.integers(10, 400))))
        with open(p, "wb") as f:
            f.write(raw)
        py = parse_obj(p, allow_native=False)
        nat = native_lib.parse_obj(p)
        assert nat is not None
        np.testing.assert_array_equal(nat[0], py.positions, err_msg=f"iter {it}")
        np.testing.assert_array_equal(nat[1], py.normals, err_msg=f"iter {it}")
        np.testing.assert_array_equal(nat[2], py.uvs, err_msg=f"iter {it}")


# ---------------------------------------------------------------------------
# HDR fuzz
# ---------------------------------------------------------------------------

def _encode_new_rle(rgbe: np.ndarray, rng: np.random.Generator) -> bytes:
    """New-style RLE with a random mix of runs and literal spans."""
    h, w, _ = rgbe.shape
    payload = b""
    for y in range(h):
        payload += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            col = rgbe[y, :, c]
            x = 0
            while x < w:
                n = int(rng.integers(1, min(127, w - x) + 1))
                span = col[x:x + n]
                if rng.random() < 0.5 and (span == span[0]).all():
                    payload += bytes([128 + n, int(span[0])])
                else:
                    payload += bytes([n]) + span.tobytes()
                x += n
    return payload


def _encode_old_style(rgbe: np.ndarray, rng: np.random.Generator) -> bytes:
    """Flat stream with occasional (1,1,1,n) repeat codes (requires the
    preceding pixel to actually repeat; we emit codes for real runs)."""
    h, w, _ = rgbe.shape
    out = bytearray()
    for y in range(h):
        x = 0
        while x < w:
            px = rgbe[y, x]
            out += px.tobytes()
            x += 1
            run = 0
            while (x + run < w and run < 255
                   and (rgbe[y, x + run] == px).all()):
                run += 1
            if run > 1 and rng.random() < 0.7:
                out += bytes([1, 1, 1, run])
                x += run
    return bytes(out)


def _header(h: int, w: int) -> bytes:
    return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode())


def _assert_hdr_parity(native_lib, tmp_path, data: bytes, tag: str):
    p = str(tmp_path / "f.hdr")
    with open(p, "wb") as f:
        f.write(data)
    try:
        py = decode_hdr_bytes(data)
        err = None
    except ValueError as e:
        py, err = None, e
    except Exception as e:  # pragma: no cover - the failure being hunted
        raise AssertionError(f"{tag}: python raised {type(e).__name__}: {e}")
    nat = native_lib.load_hdr(p)
    if err is not None:
        assert nat is None, f"{tag}: python rejected ({err}) but native decoded"
    else:
        assert nat is not None, f"{tag}: native rejected but python decoded"
        np.testing.assert_array_equal(nat, py, err_msg=tag)


def test_hdr_fuzz_valid_encodings(native_lib, tmp_path):
    rng = np.random.default_rng(42)
    for it in range(40):
        h = int(rng.integers(1, 8))
        w = int(rng.integers(1, 70))
        img = (rng.uniform(0, 4, (h, w, 3)) ** 3).astype(np.float32)
        if rng.random() < 0.3:  # blocks of repeated pixels exercise runs
            img[:, : w // 2] = img[:, :1]
        rgbe = float_to_rgbe(img)
        # Normal pixels starting with byte 1 could alias the old-style
        # repeat marker mid-stream only as (1,1,1,*); real encoders avoid
        # it the same way.
        if w >= 8:
            data = _header(h, w) + _encode_new_rle(rgbe, rng)
            _assert_hdr_parity(native_lib, tmp_path, data, f"new-rle it{it}")
        small_w = min(w, 7)
        rgbe_s = np.ascontiguousarray(rgbe[:, :small_w])
        alias = (rgbe_s[..., 0] == 1) & (rgbe_s[..., 1] == 1) & (rgbe_s[..., 2] == 1)
        rgbe_s[alias, 0] = 3
        data = _header(h, small_w) + _encode_old_style(rgbe_s, rng)
        _assert_hdr_parity(native_lib, tmp_path, data, f"old-style it{it}")
        data = _header(h, small_w) + rgbe_s.tobytes()
        _assert_hdr_parity(native_lib, tmp_path, data, f"flat it{it}")


def test_hdr_fuzz_corruption(native_lib, tmp_path):
    """Truncations and bit flips: clean, *matching* accept/reject."""
    rng = np.random.default_rng(3)
    h, w = 4, 32
    img = rng.uniform(0, 2, (h, w, 3)).astype(np.float32)
    rgbe = float_to_rgbe(img)
    base = _header(h, w) + _encode_new_rle(rgbe, rng)
    for it in range(80):
        data = bytearray(base)
        if it % 2 == 0:
            data = data[: int(rng.integers(0, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(len(data)))] = int(rng.integers(256))
        _assert_hdr_parity(native_lib, tmp_path, bytes(data), f"corrupt it{it}")


def test_hdr_hostile_dimensions(native_lib, tmp_path):
    """Multi-exabyte header dims must be rejected, not allocated."""
    for res in (b"-Y 999999999 +X 999999999", b"-Y 16385 +X 16385",
                b"-Y -3 +X 8", b"-Y 0 +X 8"):
        data = b"#?RADIANCE\n\n" + res + b"\n" + b"\x00" * 64
        _assert_hdr_parity(native_lib, tmp_path, data, res.decode())


def test_hdr_resolution_line_sscanf_semantics(native_lib, tmp_path):
    """The resolution line parses with sscanf elasticity on both sides."""
    rgbe = float_to_rgbe(np.full((2, 4, 3), 0.5, np.float32))
    body = rgbe.tobytes()
    for res, ok in ((b"-Y 2 +X 4 trailing junk", True),
                    (b"-Y2+X4", True),
                    (b"-Y \t2 \t+X 4", True),
                    (b" -Y 2 +X 4", False),
                    (b"+X 4 -Y 2", False),
                    (b"-Y 2 +X 4_0", True),   # sscanf stops at '_'
                    (b"-Y two +X 4", False)):
        data = b"#?RADIANCE\n\n" + res + b"\n" + body
        try:
            py = decode_hdr_bytes(data)
            got = py.shape == (2, 4, 3)
        except ValueError:
            got = False
        assert got == ok, f"python on {res!r}: {got} != {ok}"
        _assert_hdr_parity(native_lib, tmp_path, data, repr(res))


# ---------------------------------------------------------------------------
# PNG robustness (pure Python decoder; no native twin)
# ---------------------------------------------------------------------------

def _tiny_png() -> bytes:
    raw = b""
    for y in range(4):
        raw += b"\x00" + bytes(range(y * 12, y * 12 + 12))
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_truncation_fuzz():
    base = _tiny_png()
    assert decode_png_bytes(base).shape == (4, 4, 3)
    rng = np.random.default_rng(11)
    for _ in range(60):
        cut = bytes(base[: int(rng.integers(0, len(base)))])
        try:
            decode_png_bytes(cut)
        except (ValueError, zlib.error):
            pass  # clean, typed failure
        # success is fine too (truncation after IEND-adjacent bytes)


def test_png_bitflip_fuzz():
    base = _tiny_png()
    rng = np.random.default_rng(13)
    for _ in range(60):
        data = bytearray(base)
        data[int(rng.integers(8, len(data)))] ^= 1 << int(rng.integers(8))
        try:
            decode_png_bytes(bytes(data))
        except (ValueError, zlib.error):
            pass


def test_png_fuzz_python_vs_native(native_lib, tmp_path):
    """Parity property at the dispatch boundary: for ANY input bytes the
    native decoder either bows out (None -> Python fallback) or returns
    exactly what the Python decoder returns. Random valid files sweep
    sizes/color types/depths/filters; mutations sweep corruption."""
    import struct

    rng = np.random.default_rng(17)
    p = str(tmp_path / "f.png")

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    def rand_png():
        color, nch = [(0, 1), (2, 3), (4, 2), (6, 4)][int(rng.integers(4))]
        depth = 16 if rng.random() < 0.3 else 8
        w = int(rng.integers(1, 24))
        h = int(rng.integers(1, 12))
        stride = w * nch * (depth // 8)
        rows = b"".join(
            bytes([int(rng.integers(0, 5))])
            + rng.integers(0, 256, stride, dtype=np.uint8).tobytes()
            for _ in range(h))
        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR",
                        struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))

    def check(blob, tag):
        with open(p, "wb") as f:
            f.write(blob)
        nat = native_lib.load_png(p)
        try:
            py = decode_png_bytes(blob)
        except (ValueError, zlib.error):
            py = None
        if nat is None:
            return  # fallback: Python's answer (or error) stands either way
        assert py is not None, f"{tag}: native decoded what python rejects"
        assert nat.dtype == py.dtype and nat.shape == py.shape, tag
        np.testing.assert_array_equal(nat, py, err_msg=tag)

    for it in range(40):
        base = rand_png()
        check(base, f"valid {it}")
        # structural mutations: truncate / bit-flip
        cut = base[: int(rng.integers(8, len(base)))]
        check(cut, f"trunc {it}")
        flipped = bytearray(base)
        flipped[int(rng.integers(8, len(flipped)))] ^= 1 << int(rng.integers(8))
        check(bytes(flipped), f"flip {it}")
