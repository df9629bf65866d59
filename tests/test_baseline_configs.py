"""Golden-image tests for the staged BASELINE.json configs on the real
reference assets (SURVEY.md 4, 6): each config rendered small and diffed
against the oracle (acceptance: RMSE <= 1e-3; observed ~1e-8)."""

import os

import numpy as np
import pytest

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction.config import RenderConfig, baseline_config
from refraction.render import render_frame
from refraction.scene import load_scene

REF = "/root/reference"

needs_assets = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference assets not mounted")


def _small(cfg: RenderConfig, w=96, h=54) -> RenderConfig:
    return cfg.replace(width=w, height=h, backend="xla", spp=1)


@needs_assets
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_baseline_config_golden(n):
    cfg = _small(baseline_config(n))
    scene, meta = load_scene(cfg)
    img = np.asarray(render_frame(scene, cfg, angle=0.35))
    ref = render_oracle(scene, cfg, angle=0.35)
    assert rmse(img, ref) < 1e-3, (n, rmse(img, ref))


@needs_assets
@pytest.mark.slow
def test_baseline_config5_golden():
    """ott.obj with 4x supersampling (the heaviest config; oracle does
    4 full brute-force renders at 12,877 tris)."""
    from refraction.render import sample_offsets

    cfg = _small(baseline_config(5), w=64, h=36).replace(spp=4)
    scene, meta = load_scene(cfg)
    img = np.asarray(render_frame(scene, cfg, angle=0.35))
    offs = sample_offsets(4)
    nn = cfg.width * cfg.height
    acc = np.zeros((cfg.height, cfg.width, 3), np.float64)
    for s in range(4):
        acc += render_oracle(
            scene, cfg.replace(spp=1), angle=0.35,
            jitter=np.broadcast_to(offs[s], (nn, 2)))
    assert rmse(img, acc / 4) < 1e-3


@needs_assets
def test_demo_scene_golden():
    """The exact reference demo: shell.obj + envmap + all defaults."""
    cfg = _small(RenderConfig())
    scene, meta = load_scene(cfg)
    assert meta.num_real_tris == 1536
    img = np.asarray(render_frame(scene, cfg, angle=0.01))
    ref = render_oracle(scene, cfg, angle=0.01)
    assert rmse(img, ref) < 1e-3
