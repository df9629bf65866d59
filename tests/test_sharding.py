"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY.md 4):
image-sharded rendering must match single-device bit-for-bit, and the
triangle-sharded intersect must match the replicated one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import rmse
from refraction.parallel.sharding import (
    make_mesh,
    make_mesh2d,
    make_sample_sharded_renderer,
    make_sharded_renderer,
    make_trisharded_intersect,
)
from refraction.camera import orbit_camera
from refraction.ops.backends import xla_intersect
from refraction.render import make_renderer

# Compile-heavy integration tier: excluded by `-m "not slow"` (fast tier).
pytestmark = pytest.mark.slow


def test_eight_fake_devices():
    assert len(jax.devices()) == 8, jax.devices()


@pytest.mark.parametrize("ndev", [2, 8])
def test_image_sharded_matches_single(sphere_scene, small_cfg, ndev):
    scene, _ = sphere_scene
    cfg = small_cfg.replace(width=40, height=24, backend="xla")
    frame = orbit_camera(0.6, cfg)

    single = np.asarray(make_renderer(cfg)(scene, frame))
    mesh = make_mesh(ndev)
    sharded = np.asarray(make_sharded_renderer(cfg, mesh)(scene, frame))
    # Pixel math is identical, but the single-device path renders in
    # tile-permuted order (render.tile_order) so XLA fuses differently ->
    # ulp-level noise; assert tight agreement, not bit equality.
    np.testing.assert_allclose(single, sharded, rtol=0, atol=2e-6)


def test_interleaved_sharding_matches_contiguous(sphere_scene, small_cfg):
    # Load-balance interleave is a pure unit permutation: per-pixel work
    # is device-independent, so the image matches the contiguous-band
    # assignment up to XLA fusion ulp noise (the reshape/transpose fuses
    # into ray generation differently — same caveat as
    # test_image_sharded_matches_single).
    scene, _ = sphere_scene
    cfg = small_cfg.replace(width=40, height=24, backend="xla")
    frame = orbit_camera(0.6, cfg)
    mesh = make_mesh(8)
    plain = np.asarray(
        make_sharded_renderer(cfg, mesh, interleave=False)(scene, frame))
    inter = np.asarray(
        make_sharded_renderer(cfg, mesh, interleave=True)(scene, frame))
    np.testing.assert_allclose(plain, inter, rtol=0, atol=2e-6)


def test_image_sharded_supersampling(cube_scene, small_cfg):
    scene, _ = cube_scene
    cfg = small_cfg.replace(width=32, height=16, backend="xla", spp=4)
    frame = orbit_camera(0.3, cfg)
    single = np.asarray(make_renderer(cfg)(scene, frame))
    sharded = np.asarray(
        make_sharded_renderer(cfg, make_mesh(8))(scene, frame)
    )
    assert rmse(single, sharded) < 1e-7


@pytest.mark.parametrize("sample_devs", [2, 4])
def test_sample_sharded_matches_single(cube_scene, small_cfg, sample_devs):
    """2-D (samples, pixels) mesh: spp sharded over one axis, the image
    over the other; psum over samples must equal the sequential spp
    accumulation (up to float-add reassociation)."""
    scene, _ = cube_scene
    cfg = small_cfg.replace(width=32, height=16, backend="xla", spp=4)
    frame = orbit_camera(0.3, cfg)
    single = np.asarray(make_renderer(cfg)(scene, frame))
    mesh = make_mesh2d(8, sample_devs=sample_devs)
    assert dict(mesh.shape) == {
        "samples": sample_devs, "pixels": 8 // sample_devs}
    out = np.asarray(make_sample_sharded_renderer(cfg, mesh)(scene, frame))
    assert rmse(single, out) < 1e-6


def test_sample_sharded_rejects_uneven_spp(cube_scene, small_cfg):
    cfg = small_cfg.replace(spp=3)
    with pytest.raises(ValueError, match="spp=3"):
        make_sample_sharded_renderer(cfg, make_mesh2d(8, sample_devs=2))


def test_trisharded_intersect_matches(sphere_scene):
    scene, meta = sphere_scene
    assert meta.num_padded_tris % 8 == 0
    mesh = make_mesh(8)

    rng = np.random.default_rng(7)
    n = 512
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wf = jnp.asarray(rng.random(n) < 0.5)
    al = jnp.ones(n, bool)
    tmin, tmax = jnp.float32(1e-4), jnp.float32(100.0)

    h1, t1, i1, _ = xla_intersect(scene, jnp.asarray(o), jnp.asarray(d), wf, al, tmin, tmax)
    tri = make_trisharded_intersect(mesh)
    h2, t2, i2, _ = jax.jit(
        lambda s, oo, dd, ww: tri(s, oo, dd, ww, al, tmin, tmax)
    )(scene, jnp.asarray(o), jnp.asarray(d), wf)

    h1, t1, i1 = map(np.asarray, (h1, t1, i1))
    h2, t2, i2 = map(np.asarray, (h2, t2, i2))
    assert (h1 == h2).all()
    m = h1
    assert (i1[m] == i2[m]).all()
    np.testing.assert_allclose(t1[m], t2[m], rtol=1e-6)


@pytest.mark.parametrize("w,h", [(128, 64), (96, 64)])
def test_kernel_sharded_matches_single(sphere_scene, small_cfg, w, h):
    """Pixel-DP with the intersection kernel (interpret mode) under
    shard_map matches the single-device kernel render."""
    import functools

    from refraction.kernels.intersect_pallas import pallas_intersect

    scene, _ = sphere_scene
    cfg = small_cfg.replace(width=w, height=h)
    frame = orbit_camera(0.6, cfg)
    kernel = functools.partial(pallas_intersect, interpret=True)
    single = np.asarray(make_renderer(cfg, kernel)(scene, frame))
    sharded = np.asarray(
        make_sharded_renderer(cfg, make_mesh(8), kernel)(scene, frame))
    # Same caveat as test_image_sharded_matches_single: tile-permuted vs
    # row-major ray order fuses differently -> ulp-level noise.
    np.testing.assert_allclose(single, sharded, rtol=0, atol=2e-6)
