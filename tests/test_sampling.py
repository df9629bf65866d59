"""Sub-pixel supersampling offsets (render.sample_offsets).

The mean of every sample set must sit at the pixel center: a biased set
shifts the whole rendered image relative to spp=1 (the reference's pixel
centers, RayTracing.hlsl:29). Non-square spp takes the first cells of
the next square grid, which is top-left-biased before recentering (found
in review: spp=2 put both samples at y=0.25 — a 0.25px vertical shift).
"""

import numpy as np
import pytest

from refraction.render import sample_offsets


@pytest.mark.parametrize("spp", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16])
def test_sample_mean_is_pixel_center(spp):
    off = sample_offsets(spp)
    assert off.shape == (spp, 2)
    np.testing.assert_allclose(off.mean(axis=0), [0.5, 0.5], atol=1e-6)
    assert (off > 0.0).all() and (off < 1.0).all()


def test_square_grids_unchanged():
    # spp=1 and square grids are the reference-parity sets: exact values.
    np.testing.assert_array_equal(sample_offsets(1), [[0.5, 0.5]])
    np.testing.assert_allclose(
        sample_offsets(4),
        [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]])


def test_samples_distinct():
    for spp in (2, 3, 5, 8):
        off = sample_offsets(spp)
        assert len({tuple(p) for p in off.tolist()}) == spp
