"""Image-tile aspect knob (RRT_TILE, utils/tileshape.py).

The tile shape is a pure speed knob: retiling is a permutation that
untile_order inverts, and no per-lane ray math depends on tile
membership — so the intersection kernel's wavefront must produce a
BIT-IDENTICAL image for every shape. The shape binds at import time
(module constants), so each setting renders in a fresh subprocess.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from refraction.config import RenderConfig
from refraction.camera import orbit_camera
from refraction.io.primitives import make_gradient_envmap, make_icosphere
from refraction.scene import build_scene, scene_to_device
from refraction.ops.backends import get_backend
from refraction.render import TILE_H, TILE_W, render_frame
assert (TILE_H, TILE_W) == tuple(
    int(v) for v in os.environ["RRT_TILE"].split("x")), (TILE_H, TILE_W)
cfg = RenderConfig(width=192, height=96, cluster_size=32)
scene, _ = build_scene(make_icosphere(subdiv=2, radius=1.2),
                       make_gradient_envmap(64, 128), cluster_size=32)
scene = scene_to_device(scene)
kernel = get_backend("pallas", interpret=True).intersect
img = np.asarray(
    render_frame(scene, cfg, frame=orbit_camera(0.3, cfg),
                 intersect_fn=kernel))
np.save(sys.argv[1], img)
"""


def _render_with_tile(shape: str, out_path: str):
    env = dict(os.environ, RRT_TILE=shape, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT % {"repo": _REPO}, out_path],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-800:])
    return np.load(out_path)


@pytest.mark.parametrize("shape", ["16x64", "8x128"])
def test_tile_shape_bit_parity(tmp_path, shape):
    ref = _render_with_tile("32x32", str(tmp_path / "ref.npy"))
    alt = _render_with_tile(shape, str(tmp_path / "alt.npy"))
    assert ref.shape == alt.shape == (96, 192, 3)
    assert ref.max() > 0
    np.testing.assert_array_equal(ref, alt)


def test_tile_shape_rejects_bad_spec(monkeypatch):
    from refraction.utils.tileshape import tile_shape

    # monkeypatch (not a finally-pop) so a user-set RRT_TILE is restored
    # for later tests in the same process.
    monkeypatch.setenv("RRT_TILE", "16x16")  # product != 1024
    with pytest.raises(ValueError):
        tile_shape()
    monkeypatch.setenv("RRT_TILE", "banana")
    with pytest.raises(ValueError):
        tile_shape()
