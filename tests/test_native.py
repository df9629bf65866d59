"""C++ IO accelerator vs the pure-Python behavioral definition.

Builds native/libio_native.so on demand (skipped when no compiler)."""

import os
import subprocess

import numpy as np
import pytest

from refraction.io import native
from refraction.io.hdr import load_hdr, write_hdr
from refraction.io.objmesh import parse_obj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_lib():
    # Always run make: it is an incremental no-op when the .so is up to
    # date and rebuilds it when io_native.cpp changed (a stale library
    # would silently test old semantics).
    try:
        subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        pytest.skip(f"cannot build native lib: {e}")
    # reset the cached loader state so the fresh .so is picked up
    native._LIB = None
    native._TRIED = False
    if not native.available():
        pytest.skip("native lib failed to load")
    return native


OBJ_FIXTURE = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
vt 0 0
vt 0.25 0.75
vn 0 0 1
vn 0.5 0.5 0
f 1/1/1 2/2/1 3/1/2
f 1/1/2 2/2/2 3/1/1 4/2/2
f 1/1 2/2 3/1
f 9/1/1 2/2/2 3/1/1
garbage line
"""


def test_obj_matches_python(native_lib, tmp_path):
    p = str(tmp_path / "t.obj")
    with open(p, "w") as f:
        f.write(OBJ_FIXTURE)
    py = parse_obj(p, allow_native=False)
    nat = native_lib.parse_obj(p)
    assert nat is not None
    pos, norm, uv = nat
    assert pos.shape == py.positions.shape == (2, 3, 3)
    np.testing.assert_array_equal(pos, py.positions)
    np.testing.assert_array_equal(norm, py.normals)
    np.testing.assert_array_equal(uv, py.uvs)


@pytest.mark.parametrize("name", ["cube.obj", "sphere.obj", "monkey.obj",
                                  "shell.obj", "ott.obj"])
def test_obj_reference_assets(native_lib, asset_dir, name):
    p = os.path.join(asset_dir, name)
    py = parse_obj(p, allow_native=False)
    pos, norm, uv = native_lib.parse_obj(p)
    assert pos.shape[0] == py.num_tris
    np.testing.assert_array_equal(pos, py.positions)
    np.testing.assert_array_equal(norm, py.normals)
    np.testing.assert_array_equal(uv, py.uvs)


def test_hdr_matches_python(native_lib, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 8, (24, 40, 3)).astype(np.float32)
    p = str(tmp_path / "t.hdr")
    write_hdr(p, img)
    py = load_hdr(p, allow_native=False)
    nat = native_lib.load_hdr(p)
    assert nat is not None
    assert nat.shape == py.shape == (24, 40, 3)
    np.testing.assert_array_equal(nat, py)


def test_hdr_rle_matches_python(native_lib, tmp_path):
    # new-style RLE: constant rows (runs) + varying rows (literals)
    w, h = 64, 8
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., 0] = 100
    rgbe[..., 1] = np.arange(w, dtype=np.uint8)[None, :]
    rgbe[..., 2] = 7
    rgbe[..., 3] = 130
    payload = b""
    for y in range(h):
        payload += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            col = rgbe[y, :, c]
            if (col == col[0]).all():
                payload += bytes([128 + w, int(col[0])])
            else:
                payload += bytes([w]) + col.tobytes()
    data = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode() + payload)
    p = str(tmp_path / "rle.hdr")
    with open(p, "wb") as f:
        f.write(data)
    py = load_hdr(p, allow_native=False)
    nat = native_lib.load_hdr(p)
    np.testing.assert_array_equal(nat, py)


def test_native_missing_file(native_lib):
    assert native_lib.parse_obj("/nonexistent/x.obj") is None
    assert native_lib.load_hdr("/nonexistent/x.hdr") is None


# ---------------------------------------------------------------------------
# PNG decode (rrt_load_png vs io/png.py)
# ---------------------------------------------------------------------------

def _png_bytes(w, h, depth, color, scanlines, plte=None, trns=None):
    """Hand-assemble a PNG from raw (filter_byte + data) scanlines."""
    import struct
    import zlib

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", zlib.compress(b"".join(scanlines)))
    out += chunk(b"IEND", b"")
    return out


def _assert_native_matches_python(native_lib, tmp_path, blob, name):
    from refraction.io.png import decode_png_bytes

    p = tmp_path / name
    p.write_bytes(blob)
    n = native_lib.load_png(str(p))
    ref = decode_png_bytes(blob)
    assert n is not None, name
    assert n.dtype == ref.dtype and n.shape == ref.shape, name
    np.testing.assert_array_equal(n, ref, err_msg=name)


def test_png_reference_asset(native_lib, asset_dir):
    from refraction.io.png import load_png

    n = native_lib.load_png(os.path.join(asset_dir, "envmap.png"))
    ref = load_png(os.path.join(asset_dir, "envmap.png"), allow_native=False)
    assert n is not None and n.dtype == ref.dtype
    np.testing.assert_array_equal(n, ref)


@pytest.mark.parametrize("color,nch", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_all_filters_8bit(native_lib, tmp_path, color, nch):
    rng = np.random.default_rng(11)
    w, h = 13, 5
    rows = []
    for y in range(5):
        data = rng.integers(0, 256, w * nch, dtype=np.uint8).tobytes()
        rows.append(bytes([y]) + data)  # one row per filter type 0..4
    blob = _png_bytes(w, h, 8, color, rows)
    _assert_native_matches_python(native_lib, tmp_path,
                                  blob, f"f8_{color}.png")


@pytest.mark.parametrize("color,nch", [(0, 1), (2, 3), (6, 4)])
def test_png_16bit(native_lib, tmp_path, color, nch):
    rng = np.random.default_rng(12)
    w, h = 7, 6
    rows = []
    for y in range(h):
        data = rng.integers(0, 256, w * nch * 2, dtype=np.uint8).tobytes()
        rows.append(bytes([y % 5]) + data)
    blob = _png_bytes(w, h, 16, color, rows)
    _assert_native_matches_python(native_lib, tmp_path,
                                  blob, f"f16_{color}.png")


@pytest.mark.parametrize("with_trns", [False, True])
def test_png_palette(native_lib, tmp_path, with_trns):
    rng = np.random.default_rng(13)
    w, h, pal_n = 9, 4, 7
    plte = rng.integers(0, 256, pal_n * 3, dtype=np.uint8).tobytes()
    trns = bytes([200, 0, 255]) if with_trns else None  # partial alpha table
    rows = [bytes([0]) + rng.integers(0, pal_n, w, dtype=np.uint8).tobytes()
            for _ in range(h)]
    blob = _png_bytes(w, h, 8, 3, rows, plte=plte, trns=trns)
    _assert_native_matches_python(native_lib, tmp_path,
                                  blob, f"pal_{with_trns}.png")


def test_png_roundtrip_writer(native_lib, tmp_path):
    # The framework's own PNG writer output must decode natively.
    from refraction.io.png import write_png

    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = tmp_path / "rt.png"
    write_png(str(p), img)
    n = native_lib.load_png(str(p))
    assert n is not None
    np.testing.assert_array_equal(n, img)


def test_png_subbyte_falls_back(native_lib, tmp_path):
    # 4-bit grayscale is outside the native subset: native returns None,
    # the Python decoder handles it (io/png.py sub-byte unpack).
    from refraction.io.png import load_png

    w, h = 6, 3
    rng = np.random.default_rng(15)
    stride = (w * 4 + 7) // 8
    rows = [bytes([0]) + rng.integers(0, 256, stride, dtype=np.uint8).tobytes()
            for _ in range(h)]
    blob = _png_bytes(w, h, 4, 0, rows)
    p = tmp_path / "sub.png"
    p.write_bytes(blob)
    assert native_lib.load_png(str(p)) is None
    img = load_png(str(p))  # full loader: native miss -> Python
    assert img.shape == (h, w, 1)


def test_png_corrupt_rejected_everywhere(native_lib, tmp_path):
    from refraction.io.png import decode_png_bytes

    rng = np.random.default_rng(16)
    rows = [bytes([0]) + rng.integers(0, 256, 9, dtype=np.uint8).tobytes()]
    blob = _png_bytes(3, 1, 8, 2, rows)
    trunc = blob[:len(blob) - 20]  # cut into IDAT/IEND
    p = tmp_path / "bad.png"
    p.write_bytes(trunc)
    assert native_lib.load_png(str(p)) is None
    with pytest.raises(ValueError):
        decode_png_bytes(trunc)
