"""Möller–Trumbore brute-force vs an independent scalar float64 oracle, plus
facing/culling semantics and primitive winding checks."""

import numpy as np

from refraction.io.primitives import make_cube, make_icosphere
from refraction.ops.intersect import intersect_brute


def _scalar_hit(o, d, a, b, c, tmin, tmax, want_front):
    """Textbook float64 MT, one ray x one tri."""
    e1 = b - a
    e2 = c - a
    pvec = np.cross(d, e2)
    det = np.dot(e1, pvec)
    if det == 0:
        return None
    if want_front and det <= 0:
        return None
    if not want_front and det >= 0:
        return None
    inv = 1.0 / det
    tvec = o - a
    u = np.dot(tvec, pvec) * inv
    if u < 0 or u > 1:
        return None
    qvec = np.cross(tvec, e1)
    v = np.dot(d, qvec) * inv
    if v < 0 or u + v > 1:
        return None
    t = np.dot(e2, qvec) * inv
    if t < tmin or t > tmax:
        return None
    return t, u, v


def test_brute_matches_scalar_random():
    rng = np.random.default_rng(0)
    T, N = 40, 200
    tris = rng.uniform(-1, 1, (T, 3, 3)).astype(np.float32)
    a, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    origins = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want_front = rng.random(N) < 0.5

    hit, t, idx, u, v = intersect_brute(
        origins, dirs, a, e1, e2, np.float32(1e-4), np.float32(100.0),
        want_front, np,
    )

    for i in range(N):
        best = None
        for k in range(T):
            r = _scalar_hit(
                origins[i].astype(np.float64), dirs[i].astype(np.float64),
                *tris[k].astype(np.float64), 1e-4, 100.0, want_front[i],
            )
            if r is not None and (best is None or r[0] < best[0]):
                best = r
                besti = k
        if best is None:
            assert not hit[i], i
        else:
            # float32 vs float64 can flip razor-edge hits; tolerate only
            # near-boundary disagreement.
            if not hit[i]:
                assert min(best[1], best[2], 1 - best[1] - best[2]) < 1e-5
                continue
            assert abs(t[i] - best[0]) < 1e-3 or idx[i] != besti
            if idx[i] == besti:
                np.testing.assert_allclose(t[i], best[0], atol=1e-3)
                np.testing.assert_allclose(u[i], best[1], atol=1e-3)
                np.testing.assert_allclose(v[i], best[2], atol=1e-3)


def test_culling_semantics_cube():
    """Rays from outside with want_front=True hit the near face; with
    want_front=False they hit the far (interior) face."""
    m = make_cube(2.0)
    a = m.positions[:, 0]
    e1 = m.positions[:, 1] - m.positions[:, 0]
    e2 = m.positions[:, 2] - m.positions[:, 0]
    o = np.array([[0.0, 0.0, -5.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)

    hit, t, idx, _, _ = intersect_brute(
        o, d, a, e1, e2, np.float32(1e-4), np.float32(100.0),
        np.array([True]), np,
    )
    assert hit[0] and np.isclose(t[0], 4.0, atol=1e-5)  # near face z=-1

    hit, t, idx, _, _ = intersect_brute(
        o, d, a, e1, e2, np.float32(1e-4), np.float32(100.0),
        np.array([False]), np,
    )
    assert hit[0] and np.isclose(t[0], 6.0, atol=1e-5)  # far face z=+1


def test_primitive_winding_outward():
    """cross(e1, e2) must point outward for every face (cube + icosphere);
    the culling contract depends on it (ops/intersect.py docstring)."""
    for mesh in (make_cube(2.0), make_icosphere(2)):
        p = mesh.positions.astype(np.float64)
        ng = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        centroid = p.mean(axis=1)
        assert (np.sum(ng * centroid, axis=-1) > 0).all()
        # shading normals agree with geometric side
        ns = mesh.normals.mean(axis=1)
        assert (np.sum(ng * ns, axis=-1) > 0).all()


def test_watertight_parity_sphere():
    """Closed mesh: alternating front/back hits along a ray through it."""
    m = make_icosphere(3)
    a = m.positions[:, 0]
    e1 = m.positions[:, 1] - m.positions[:, 0]
    e2 = m.positions[:, 2] - m.positions[:, 0]
    rng = np.random.default_rng(4)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-3.0 * d).astype(np.float32)
    d = d.astype(np.float32)

    hit_f, t_f, _, _, _ = intersect_brute(
        o, d, a, e1, e2, np.float32(1e-4), np.float32(100.0),
        np.ones(64, bool), np,
    )
    assert hit_f.all()
    # continue past the entry: should exit through a back face
    o2 = o + (t_f[:, None] + 1e-3) * d
    hit_b, t_b, _, _, _ = intersect_brute(
        o2, d, a, e1, e2, np.float32(1e-3), np.float32(100.0),
        np.zeros(64, bool), np,
    )
    assert hit_b.all()
    # entry ~ 3-1=2, exit ~ 2 more
    assert np.all(np.abs(t_f - 2.0) < 0.1)
    assert np.all(np.abs(t_b - 2.0) < 0.1)
