"""Hilbert-curve triangle ordering (bvh/morton.py::hilbert_order).

The vectorized Skilling transform is validated bit-for-bit against a
direct scalar transcription of the published algorithm, and the
locality property that motivates it (tighter equal-size clusters than
Morton) is asserted on random point sets.
"""

import numpy as np

from refraction.bvh.morton import _hilbert_keys, hilbert_order, morton_order


def _scalar_hilbert_key(x: int, y: int, z: int, b: int = 10) -> int:
    """Skilling AxesToTranspose (AIP Conf. Proc. 707, 2004) + the same
    bit interleave the vectorized version uses."""
    X = [x, y, z]
    n = 3
    Q = 1 << (b - 1)
    while Q > 1:
        P = Q - 1
        for i in range(n):
            if X[i] & Q:
                X[0] ^= P
            else:
                t = (X[0] ^ X[i]) & P
                X[0] ^= t
                X[i] ^= t
        Q >>= 1
    for i in range(1, n):
        X[i] ^= X[i - 1]
    t = 0
    Q = 1 << (b - 1)
    while Q > 1:
        if X[n - 1] & Q:
            t ^= Q - 1
        Q >>= 1
    X = [v ^ t for v in X]

    def expand(v):
        v &= 0x3FF
        v = (v * 0x00010001) & 0xFF0000FF
        v = (v * 0x00000101) & 0x0F00F00F
        v = (v * 0x00000011) & 0xC30C30C3
        v = (v * 0x00000005) & 0x49249249
        return v

    return (expand(X[0]) << 2) | (expand(X[1]) << 1) | expand(X[2])


def test_vectorized_matches_scalar_skilling():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1024, (2000, 3)).astype(np.uint32)
    keys = _hilbert_keys(q)
    for row, k in zip(q, keys):
        assert _scalar_hilbert_key(*map(int, row)) == int(k)


def test_keys_are_unique_per_cell():
    # The Hilbert index is a bijection on the 2^30 grid: distinct cells
    # must get distinct keys (exhaustive on a 16^3 sub-grid scaled up).
    g = np.arange(16, dtype=np.uint32) * 64
    q = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    keys = _hilbert_keys(q)
    assert len(np.unique(keys)) == len(keys)


def test_order_is_permutation_and_empty_ok():
    rng = np.random.default_rng(1)
    tri = rng.uniform(-2, 2, (257, 3, 3)).astype(np.float32)
    o = hilbert_order(tri)
    assert sorted(o.tolist()) == list(range(257))
    assert hilbert_order(np.zeros((0, 3, 3), np.float32)).shape == (0,)


def test_tighter_than_morton_on_random_points():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (8192, 3)).astype(np.float32)
    tri = np.repeat(pts[:, None, :], 3, axis=1)

    def mean_step(order):
        return float(np.linalg.norm(np.diff(pts[order], axis=0), axis=1).mean())

    # No diagonal jumps: consecutive curve steps are markedly shorter.
    assert mean_step(hilbert_order(tri)) < 0.9 * mean_step(morton_order(tri))


def _window_sa(pos, order, leaf):
    p = pos[order]
    tot = 0.0
    for s in range(0, p.shape[0], leaf):
        w = p[s:s + leaf].reshape(-1, 3)
        d = w.max(0) - w.min(0)
        tot += 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])
    return tot


def test_median_split_is_permutation_all_sizes():
    from refraction.bvh.morton import median_split_order
    rng = np.random.default_rng(3)
    for t in (0, 1, 7, 8, 255, 256, 257, 1000):
        tri = rng.uniform(-2, 2, (t, 3, 3)).astype(np.float32)
        o = median_split_order(tri, (8192, 256, 8))
        assert sorted(o.tolist()) == list(range(t)), t


def test_median_split_windows_are_disjoint_splits():
    # Every aligned window at every cascade level is one kd subtree: its
    # centroid AABB must be tighter (never looser) than the same-index
    # windows of a plain Hilbert order, at every level, on a shape with
    # real structure (two separated blobs).
    from refraction.bvh.morton import median_split_order
    rng = np.random.default_rng(4)
    a = rng.normal(0.0, 0.3, (600, 3))
    b = rng.normal(4.0, 0.3, (424, 3))
    pts = np.concatenate([a, b]).astype(np.float32)
    rng.shuffle(pts)
    tri = np.repeat(pts[:, None, :], 3, axis=1)
    o = median_split_order(tri, (512, 64, 8))
    h = hilbert_order(tri)
    for leaf in (512, 64, 8):
        assert _window_sa(tri, o, leaf) <= _window_sa(tri, h, leaf) * 1.05, leaf


def test_median_split_levels_nest():
    # A cascade stage only reorders WITHIN the parent windows: the set of
    # triangles in each super window must be identical with and without
    # the finer stages.
    from refraction.bvh.morton import median_split_order
    rng = np.random.default_rng(5)
    tri = rng.uniform(-1, 1, (2048, 3, 3)).astype(np.float32)
    coarse = median_split_order(tri, (512,))
    full = median_split_order(tri, (512, 64, 8))
    for s in range(0, 2048, 512):
        assert set(coarse[s:s + 512].tolist()) == set(full[s:s + 512].tolist())
