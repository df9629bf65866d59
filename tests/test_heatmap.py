"""Per-pixel ray-count heatmap (SURVEY §5 metrics row: bounce heatmaps).

``render_pixels(collect_stats=True)['pixel_rays']`` counts live lanes
entering each trace round per pixel (lane i of every N*2^k-wide pool
belongs to pixel i % N); render.render_heatmap wraps it per frame.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from refraction.camera import orbit_camera
from refraction.render import heatmap_to_rgb, render_heatmap

pytestmark = pytest.mark.slow


def test_heatmap_semantics(sphere_scene, small_cfg):
    scene, _ = sphere_scene
    cfg = small_cfg.replace(width=48, height=32, backend="xla")
    counts = render_heatmap(scene, cfg, frame=orbit_camera(0.3, cfg))
    assert counts.shape == (32, 48) and counts.dtype == np.int32
    # Background pixels trace exactly the primary ray; the sphere spawns
    # refraction chains + reflection splits.
    assert counts.min() == 1
    assert counts.max() > 2
    # Per-pixel counts must sum to the frame's honest live-ray total.
    from refraction.camera import generate_rays
    from refraction.integrator import render_pixels
    from refraction.ops.backends import get_backend
    import jax.numpy as jnp

    backend = get_backend("xla")
    o, d = generate_rays(orbit_camera(0.3, cfg), cfg.width, cfg.height,
                         xp=jnp)
    _, st = render_pixels(scene, o, d, cfg, backend.intersect,
                          collect_stats=True)
    assert counts.sum() == int(st["rays_traced"])


def test_heatmap_rgb_ramp():
    counts = np.array([[0, 1], [5, 10]], np.int32)
    rgb = heatmap_to_rgb(counts)
    assert rgb.shape == (2, 2, 3)
    assert np.allclose(rgb[0, 0], 0.0)          # zero stays black
    assert rgb[1, 1].min() > 0.9                # max saturates to white
    # Monotone cost reading: brighter with more rays.
    assert rgb[1, 0].sum() > rgb[0, 1].sum()


def test_heatmap_cli(tmp_path, asset_dir):
    out = tmp_path / "heat.png"
    r = subprocess.run(
        [sys.executable, "-m", "refraction.run",
         "--scene", os.path.join(asset_dir, "cube.obj"),
         "--envmap", os.path.join(asset_dir, "envmap.png"),
         "--width", "48", "--height", "32",
         "--backend", "xla", "--heatmap", str(out)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
