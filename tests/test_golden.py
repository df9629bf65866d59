"""Golden-image tests: JAX wavefront integrator vs the NumPy oracle.

The oracle implements the reference recursion literally (SURVEY.md 3.3);
the integrator restructures it into a static wavefront. Agreement here is
the core behavioral-parity guarantee (BASELINE.md: <= 1e-3 RMSE; we
observe ~1e-8 — bit-level modulo reduction order)."""

import numpy as np
import pytest

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction.render import render_frame, rays_per_frame, sample_offsets

# Compile-heavy integration tier: excluded by `-m "not slow"` (fast tier).
pytestmark = pytest.mark.slow


@pytest.mark.parametrize("scene_fixture,angle", [
    ("cube_scene", 0.3),
    ("sphere_scene", 0.85),
])
def test_wavefront_matches_oracle(scene_fixture, angle, small_cfg, request):
    scene, _ = request.getfixturevalue(scene_fixture)
    cfg = small_cfg.replace(width=48, height=36, backend="xla")
    img_j = np.asarray(render_frame(scene, cfg, angle=angle))
    img_o = render_oracle(scene, cfg, angle=angle)
    assert rmse(img_j, img_o) < 1e-4
    assert np.abs(img_j - img_o).max() < 1e-3


def test_bounce_cap_profiles(sphere_scene, small_cfg, request):
    """Vary refraction/reflection caps; integrator must track the oracle
    through every control-flow shape (1..5 refract, 0..2 reflect)."""
    scene, _ = sphere_scene
    for mrd, mld in [(1, 0), (2, 1), (3, 2), (5, 2)]:
        cfg = small_cfg.replace(
            width=32, height=24, backend="xla",
            max_refract_depth=mrd, max_reflect_depth=mld,
        )
        img_j = np.asarray(render_frame(scene, cfg, angle=0.5))
        img_o = render_oracle(scene, cfg, angle=0.5)
        assert rmse(img_j, img_o) < 1e-4, (mrd, mld)


def test_supersampling_accumulation(cube_scene, small_cfg):
    """spp=4 equals the average of 4 oracle renders with the same stratified
    offsets (BASELINE config 5 semantics)."""
    scene, _ = cube_scene
    cfg = small_cfg.replace(width=32, height=24, backend="xla", spp=4)
    img_j = np.asarray(render_frame(scene, cfg, angle=0.3))
    offs = sample_offsets(4)
    n = cfg.width * cfg.height
    acc = np.zeros((cfg.height, cfg.width, 3), np.float64)
    for s in range(4):
        jitter = np.broadcast_to(offs[s], (n, 2))
        acc += render_oracle(scene, cfg.replace(spp=1), angle=0.3, jitter=jitter)
    assert rmse(img_j, acc / 4) < 1e-4


def test_rays_per_frame_bound():
    from refraction.config import RenderConfig

    cfg = RenderConfig(width=10, height=10)
    # widths 1,2,4,4,4,4 -> 19 rays/pixel upper bound (SURVEY.md 3.3)
    assert rays_per_frame(cfg) == 100 * 19


def test_sample_offsets():
    assert sample_offsets(1).tolist() == [[0.5, 0.5]]
    o4 = sample_offsets(4)
    assert o4.shape == (4, 2)
    assert sorted(map(tuple, o4.tolist())) == [
        (0.25, 0.25), (0.25, 0.75), (0.75, 0.25), (0.75, 0.75)]
