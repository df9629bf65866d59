"""CLI (refraction.run) smoke tests + MTL parsing."""

import os

import numpy as np
import pytest

from refraction.io.mtl import ior_for_scene, parse_mtl
from refraction.io.png import load_png
from refraction.run import main, tonemap

# Compile-heavy integration tier: excluded by `-m "not slow"` (fast tier).
pytestmark = pytest.mark.slow

REF = "/root/reference"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_single_frame(tmp_path, asset_dir):
    out = str(tmp_path / "f.png")
    rc = main(["--scene", os.path.join(asset_dir, "cube.obj"),
               "--envmap", os.path.join(asset_dir, "envmap.png"),
               "--width", "64",
               "--height", "32", "--backend", "xla", "--frames", "1",
               "--out", out])
    assert rc == 0
    img = load_png(out)
    assert img.shape == (32, 64, 3)
    assert img.max() > 0


def test_cli_accumulate_resume(tmp_path, asset_dir):
    out = str(tmp_path / "acc.png")
    rc = main(["--scene", os.path.join(asset_dir, "cube.obj"),
               "--envmap", os.path.join(asset_dir, "envmap.png"),
               "--width", "64",
               "--height", "32", "--backend", "xla", "--frames", "2",
               "--accumulate", "--out", out, "--raw"])
    assert rc == 0
    state = str(tmp_path / "acc_state.npz")
    assert os.path.exists(state)
    # resume adds more frames on top of the saved state
    rc = main(["--scene", os.path.join(asset_dir, "cube.obj"),
               "--envmap", os.path.join(asset_dir, "envmap.png"),
               "--width", "64",
               "--height", "32", "--backend", "xla", "--frames", "1",
               "--accumulate", "--resume", state, "--out", out])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "acc.npy"))


def test_tonemap():
    x = np.array([[-1.0, 0.0, 0.5, 2.0]])
    y = tonemap(x)
    assert y[0, 0] == 0 and y[0, 3] == 1.0
    np.testing.assert_allclose(y[0, 2], 0.5 ** (1 / 2.2), rtol=1e-6)
    # --linear: clamp ONLY — the reference's exact UNORM present
    # (RefractionDemo.cpp:430,596-604; no gamma anywhere in its pipeline).
    lin = tonemap(x, linear=True)
    np.testing.assert_array_equal(lin, [[0.0, 0.0, 0.5, 1.0]])


def test_cli_linear_display_parity(tmp_path, asset_dir):
    """--linear PNG == the default PNG with the gamma lift removed.

    The reference presents clamped linear radiance into an 8-bit UNORM
    target (RefractionDemo.cpp:430, copy at :596-604) — no gamma. Render
    the reference's own scene (shell.obj) once per mode with identical
    camera/config: the two PNGs must differ ONLY by the display
    transform, i.e. u8_linear == round(clamp(rad)*255) and
    u8_default == round(clamp(rad)**(1/2.2)*255) for the same radiance.
    """
    args = ["--scene", os.path.join(asset_dir, "shell.obj"),
            "--envmap", os.path.join(asset_dir, "envmap.png"),
            "--width", "64",
            "--height", "48", "--backend", "xla", "--frames", "1"]
    out_g = str(tmp_path / "gamma.png")
    out_l = str(tmp_path / "linear.png")
    assert main(args + ["--out", out_g, "--raw"]) == 0
    assert main(args + ["--out", out_l, "--linear"]) == 0
    rad = np.load(str(tmp_path / "gamma.npy"))  # linear radiance
    img_g = load_png(out_g).astype(np.float32) / 255.0
    img_l = load_png(out_l).astype(np.float32) / 255.0
    clamped = np.clip(rad, 0.0, 1.0)
    # write_png quantizes with round-half-up at 255 steps: 1/510 tolerance.
    np.testing.assert_allclose(img_l, clamped, atol=1.01 / 510)
    np.testing.assert_allclose(img_g, clamped ** (1 / 2.2), atol=1.01 / 510)
    # and the transform actually differs where radiance is mid-range
    assert (np.abs(img_l - img_g) > 0.05).any()


def test_parse_mtl(tmp_path):
    p = str(tmp_path / "m.mtl")
    with open(p, "w") as f:
        f.write("""# comment
newmtl glass
Ns 250
Ni 1.45
Kd 0.8 0.1 0.1
map_Kd C:\\textures\\foo.png
newmtl other
Ni 1.1
""")
    mats = parse_mtl(p)
    assert mats["glass"]["Ni"] == 1.45
    assert mats["glass"]["Kd"] == (0.8, 0.1, 0.1)
    assert mats["other"]["Ni"] == 1.1


@pytest.mark.skipif(not os.path.exists(os.path.join(REF, "ott.mtl")),
                    reason="reference assets not mounted")
def test_reference_ott_mtl_ni():
    # SURVEY.md 2.3: ott.mtl has Ni=1.45 (ignored by the reference loader).
    assert ior_for_scene(os.path.join(REF, "ott.obj"), 1.3) == 1.45
    assert ior_for_scene(os.path.join(REF, "monkey.obj"), 1.3) == 1.3


def test_viewer_server_roundtrip():
    """FrameServer publishes frames and serves /, /frame, /stats."""
    import json
    import urllib.request

    import numpy as np

    from refraction.viewer import FrameServer

    srv = FrameServer(port=0)  # ephemeral port
    try:
        img = (np.random.default_rng(0).random((16, 24, 3)) * 255
               ).astype(np.uint8)
        srv.publish(img, {"frame": 7})
        base = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"refraction" in page
        r = urllib.request.urlopen(base + "/frame", timeout=5)
        data = r.read()
        assert r.headers["X-Frame-Id"] == "0"
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        # decode back and compare
        from refraction.io.png import decode_png_bytes

        arr = decode_png_bytes(data)
        assert np.array_equal(arr, img)
        st = json.loads(
            urllib.request.urlopen(base + "/stats", timeout=5).read())
        assert st["frame"] == 7
    finally:
        srv.close()


def test_cli_hdr_envmap(tmp_path, asset_dir):
    """End-to-end .hdr envmap: write a Radiance file, load it losslessly
    and render through the CLI (the reference's own load path is
    ../envMap.hdr, RefractionDemo.cpp:527)."""
    from refraction.config import RenderConfig
    from refraction.io.hdr import float_to_rgbe, rgbe_to_float, write_hdr
    from refraction.scene import load_scene

    rng = np.random.default_rng(7)
    env = rng.uniform(0.05, 3.0, size=(32, 64, 3)).astype(np.float32)
    env = rgbe_to_float(float_to_rgbe(env))
    hdr = str(tmp_path / "env.hdr")
    write_hdr(hdr, env)

    scene, _ = load_scene(RenderConfig(
        scene_path=os.path.join(asset_dir, "cube.obj"), envmap_path=hdr))
    np.testing.assert_array_equal(scene.envmap, env)

    out = str(tmp_path / "hdr.png")
    rc = main(["--scene", os.path.join(asset_dir, "cube.obj"),
               "--envmap", hdr,
               "--width", "64", "--height", "32", "--backend", "xla",
               "--frames", "1", "--out", out])
    assert rc == 0
    img = load_png(out)
    assert img.shape == (32, 64, 3) and img.max() > 0


def test_cli_endless_serve(tmp_path, asset_dir):
    """--frames 0 --serve N: endless orbit streaming (regression: the
    documented live-viewer command crashed with drain(None))."""
    import json
    import signal
    import subprocess
    import sys
    import time
    import urllib.request

    port = 18431
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.Popen(
        [sys.executable, "-m", "refraction.run",
         "--scene", os.path.join(asset_dir, "cube.obj"),
         "--envmap", os.path.join(asset_dir, "envmap.png"), "--width", "64",
         "--height", "32", "--backend", "xla", "--frames", "0",
         "--serve", str(port), "--out", str(tmp_path / "x.png")],
        env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        stats = {}
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/stats", timeout=2) as r:
                    stats = json.loads(r.read() or b"{}")
                if stats.get("frame", 0) >= 3:
                    break
            except OSError:
                pass
            time.sleep(1.0)
        assert stats.get("frame", 0) >= 3, stats
    finally:
        p.send_signal(signal.SIGINT)
        rc = p.wait(timeout=30)
    assert rc == 0
