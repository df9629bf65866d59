"""Robustness: degenerate scenes."""

import numpy as np

from conftest import rmse
from refraction.config import RenderConfig
from refraction.io.objmesh import MeshData
from refraction.io.primitives import make_gradient_envmap
from refraction.render import render_frame
from refraction.camera import generate_rays, orbit_camera
from refraction.ops.shade import envmap_color
from refraction.scene import build_scene


def _empty_mesh() -> MeshData:
    return MeshData(
        np.zeros((0, 3, 3), np.float32),
        np.zeros((0, 3, 3), np.float32),
        np.zeros((0, 3, 2), np.float32),
    )


def test_empty_scene_renders_pure_envmap():
    scene, meta = build_scene(_empty_mesh(), make_gradient_envmap(), 8)
    assert meta.num_real_tris == 0
    cfg = RenderConfig(width=64, height=32, backend="xla")
    img = np.asarray(render_frame(scene, cfg, angle=0.3))
    frame = orbit_camera(0.3, cfg)
    _, dirs = generate_rays(frame, cfg.width, cfg.height, xp=np)
    env = envmap_color(dirs, scene.envmap, np).reshape(32, 64, 3)
    assert rmse(img, env) < 1e-6


def test_single_triangle_scene():
    mesh = MeshData(
        np.array([[[0, -1, -1], [0, 1, -1], [0, 0, 1]]], np.float32),
        np.broadcast_to(np.array([-1.0, 0, 0], np.float32), (1, 3, 3)).copy(),
        np.zeros((1, 3, 2), np.float32),
    )
    scene, meta = build_scene(mesh, make_gradient_envmap(), 8)
    cfg = RenderConfig(width=32, height=32, backend="xla")
    img = np.asarray(render_frame(scene, cfg, angle=0.0))
    assert np.isfinite(img).all()
