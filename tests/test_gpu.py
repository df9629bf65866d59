"""On the card only: the compiled intersection kernel against the XLA
brute force and the NumPy oracle (skips elsewhere; see the ``gpu``
fixture in conftest.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import rmse
from refraction.config import RenderConfig

pytestmark = pytest.mark.gpu


def test_kernel_matches_oracle_on_gpu(gpu, asset_dir):
    """128x96 demo stand-in through the compiled kernel vs the oracle,
    at the CPU tier's bound (test_render_pallas_backend_matches_oracle)."""
    from oracle.numpy_tracer import render_oracle
    from refraction.render import render_frame
    from refraction.scene import load_scene, scene_to_device

    cfg = RenderConfig(width=128, height=96, backend="pallas",
                       scene_path=os.path.join(asset_dir, "shell.obj"),
                       envmap_path=os.path.join(asset_dir, "envmap.png"))
    scene, _ = load_scene(cfg)
    img = np.asarray(render_frame(scene_to_device(scene), cfg, angle=0.85))
    ref = render_oracle(scene, cfg, angle=0.85)
    assert rmse(img, ref) <= 1e-4


def test_kernel_matches_xla_on_gpu(gpu, sphere_scene):
    """Hits and winners of the compiled kernel and xla_intersect agree on
    at least 99.99% of live random rays (FMA contraction and Triton's
    division may flip a grazing winner)."""
    from refraction.kernels.intersect_pallas import pallas_intersect
    from refraction.ops.backends import xla_intersect

    scene, _ = sphere_scene
    rng = np.random.default_rng(1)
    n = 1 << 16
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    wf = jnp.asarray(rng.random(n) < 0.5)
    al = rng.random(n) < 0.8
    lim = (jnp.float32(1e-4), jnp.float32(100.0))
    h1, t1, i1, _ = xla_intersect(scene, o, d, wf, jnp.asarray(al), *lim)
    h2, t2, i2, _ = pallas_intersect(scene, o, d, wf, jnp.asarray(al), *lim)
    h1, h2 = np.asarray(h1) & al, np.asarray(h2)
    i1, i2 = np.asarray(i1), np.asarray(i2)
    agree = (h1 == h2) & (~h1 | (i1 == i2))
    assert agree[al].mean() >= 0.9999
    same = h1 & h2 & (i1 == i2)
    t1, t2 = np.asarray(t1), np.asarray(t2)
    assert (np.abs(t1 - t2)[same] <= 1e-5 * np.maximum(1, t1[same])).all()
