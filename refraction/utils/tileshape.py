"""Image-tile shape shared by the tiling helpers (``RRT_TILE``).

``render.tile_order`` permutes pixels into TILE_H x TILE_W image tiles so
that consecutive rays (one intersection-kernel block) form a compact image
patch. The default is the 32x32 square, the tile with the smallest frustum
diameter. ``RRT_TILE`` is "HxW" (e.g. ``RRT_TILE=16x64``) with H*W = 1024.
Output is bit-identical across shapes: tiling is a pure permutation that
``untile_order`` inverts, and per-lane ray math never depends on tile
membership. Which shape culls best on the GPU is not measured.
"""

from __future__ import annotations

import os

BLOCK_RAYS = 1024


def tile_shape() -> tuple[int, int]:
    spec = os.environ.get("RRT_TILE", "32x32")
    try:
        h, w = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"RRT_TILE={spec!r}: expected 'HxW', e.g. 16x64")
    if h * w != BLOCK_RAYS or h < 1 or w < 1:
        raise ValueError(
            f"RRT_TILE={spec!r}: H*W must be {BLOCK_RAYS}")
    return h, w
