"""Frame rendering: camera -> wavefront integrator -> image.

The equivalent of `RefractionDemo::drawFrame` (RefractionDemo.cpp:557-612)
minus the D3D plumbing: per frame, only the 4x4 unprojection matrix and the
3-vector camera origin cross the host->device boundary; ray generation,
tracing, shading and (optional) supersample accumulation all run inside one
jitted program. No per-frame sync is required (the reference stalls the
pipeline every frame, RefractionDemo.cpp:611 — SURVEY.md 2.4 point 2).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from refraction.camera import CameraFrame, generate_rays, orbit_camera
from refraction.config import RenderConfig
from refraction.integrator import render_pixels
from refraction.ops.backends import get_backend
from refraction.scene import Scene
from refraction.utils.tileshape import tile_shape

TILE_H, TILE_W = tile_shape()


def tile_order(x: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Permute flat row-major pixel data (N, ...) into TILE_HxTILE_W-tile
    order (default 32x32; RRT_TILE sweeps the aspect, utils/tileshape.py).

    A block of consecutive rays then covers a compact image patch instead
    of part of a scanline: live lanes (object pixels) concentrate into
    fewer blocks and every block's rays span a tight angular window, which
    is what the intersection kernel's cluster culling keys on. Pure
    reshape/transpose — no gather. Requires height and width divisible by
    the tile dims (render pads first).
    """
    rest = x.shape[1:]
    x = x.reshape(height // TILE_H, TILE_H, width // TILE_W, TILE_W, *rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape((height * width,) + rest)


def untile_order(x: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Inverse of `tile_order`."""
    rest = x.shape[1:]
    x = x.reshape(height // TILE_H, width // TILE_W, TILE_H, TILE_W, *rest)
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape((height * width,) + rest)


def sample_offsets(spp: int) -> np.ndarray:
    """Deterministic stratified sub-pixel offsets, (spp, 2) in [0,1).

    spp=1 reproduces the reference's pixel centers (RayTracing.hlsl:29).
    Square spp uses a k x k grid (BASELINE config 5: 4x supersampling =
    2x2); otherwise the first spp cells of the next square grid,
    recentered so the mean sample sits at the pixel center (the raw
    prefix is biased toward the top-left — spp=2 would put both samples
    at y=0.25 and shift the whole image ~0.25px vertically vs spp=1/4).
    """
    if spp == 1:
        return np.array([[0.5, 0.5]], np.float32)
    k = math.ceil(math.sqrt(spp))
    cells = [((i + 0.5) / k, (j + 0.5) / k) for j in range(k) for i in range(k)]
    off = np.asarray(cells[:spp], np.float32)
    if k * k != spp:
        off = off + (np.float32(0.5) - off.mean(axis=0, dtype=np.float32))
    return off


def padded_size(cfg: RenderConfig) -> tuple[int, int]:
    """Image height and width padded up to whole tiles."""
    return (-(-cfg.height // TILE_H) * TILE_H,
            -(-cfg.width // TILE_W) * TILE_W)


def tiled_primary_rays(frame: CameraFrame, cfg: RenderConfig,
                       offset=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Primary rays of one sample (``offset``: its sub-pixel jitter, None
    for pixel centers) for the image padded to whole tiles (edge rays
    duplicated, cropped after), in ``tile_order`` so that consecutive
    rays form image patches."""
    h_pad, w_pad = padded_size(cfg)
    jitter = None
    if offset is not None:
        jitter = jnp.broadcast_to(jnp.asarray(offset, jnp.float32),
                                  (cfg.height * cfg.width, 2))
    o, d = generate_rays(frame, cfg.width, cfg.height, jitter=jitter, xp=jnp)

    def pad_tile(x):
        x = x.reshape(cfg.height, cfg.width, 3)
        x = jnp.pad(x, ((0, h_pad - cfg.height), (0, w_pad - cfg.width),
                        (0, 0)), mode="edge")
        return tile_order(x.reshape(-1, 3), h_pad, w_pad)

    return pad_tile(o), pad_tile(d)


def make_renderer(
    cfg: RenderConfig,
    intersect_fn: Callable | None = None,
) -> Callable[[Scene, CameraFrame], jnp.ndarray]:
    """Build a jitted (scene, frame) -> (H, W, 3) renderer for ``cfg``.

    ``intersect_fn`` defaults to ``cfg.backend``'s. The jitted program is
    ``render.jitted(scene, proj_inv, origin)`` (for AOT lowering and
    ``memory_analysis``)."""
    if intersect_fn is None:
        intersect_fn = get_backend(cfg.backend).intersect
    offsets = sample_offsets(cfg.spp)
    inv_spp = np.float32(1.0 / cfg.spp)
    h_pad, w_pad = padded_size(cfg)

    @jax.jit
    def _render(scene: Scene, proj_inv: jnp.ndarray, origin: jnp.ndarray):
        frame = CameraFrame(origin=origin, proj_inv=proj_inv)
        acc = jnp.zeros((h_pad * w_pad, 3), jnp.float32)
        for s in range(cfg.spp):
            o, d = tiled_primary_rays(
                frame, cfg, None if cfg.spp == 1 else offsets[s])
            acc = acc + render_pixels(scene, o, d, cfg, intersect_fn)
        img = untile_order(acc * inv_spp, h_pad, w_pad)
        img = img.reshape(h_pad, w_pad, 3)
        return img[:cfg.height, :cfg.width]

    def render(scene: Scene, frame: CameraFrame) -> jnp.ndarray:
        return _render(
            scene,
            jnp.asarray(frame.proj_inv, jnp.float32),
            jnp.asarray(frame.origin, jnp.float32),
        )

    render.jitted = _render
    return render


def render_frame(
    scene: Scene,
    cfg: RenderConfig,
    angle: float = 0.01,
    frame: CameraFrame | None = None,
    intersect_fn: Callable | None = None,
) -> jnp.ndarray:
    """One-shot render (compiles on first use per (cfg, backend))."""
    if frame is None:
        frame = orbit_camera(angle, cfg)
    return make_renderer(cfg, intersect_fn)(scene, frame)


def render_heatmap(
    scene: Scene,
    cfg: RenderConfig,
    frame: CameraFrame | None = None,
    angle: float = 0.01,
) -> np.ndarray:
    """Per-pixel live-ray-count heatmap, (H, W) int32 (SURVEY §5 metrics
    row: "optional heatmaps (bounce count per pixel)").

    Counts every live lane entering a trace round for the pixel's ray
    tree, summed over spp samples: 1 = primary missed straight to the
    envmap, larger = deeper refraction chains / reflection splits (the
    per-pixel cost map of the frame). Runs the XLA wavefront path (the
    diagnostic tool; speed is not the point here)."""
    from refraction.integrator import render_pixels
    from refraction.ops.backends import get_backend

    if frame is None:
        frame = orbit_camera(angle, cfg)
    backend = get_backend("xla")
    offsets = sample_offsets(cfg.spp)
    n = cfg.height * cfg.width

    @jax.jit
    def _heat(scene, proj_inv, origin):
        fr = CameraFrame(origin=origin, proj_inv=proj_inv)
        counts = jnp.zeros((n,), jnp.int32)
        for s in range(cfg.spp):
            jitter = jnp.broadcast_to(jnp.asarray(offsets[s]), (n, 2))
            o, d = generate_rays(
                fr, cfg.width, cfg.height,
                jitter=None if cfg.spp == 1 else jitter, xp=jnp,
            )
            _, st = render_pixels(
                scene, o, d, cfg, backend.intersect, collect_stats=True)
            counts = counts + st["pixel_rays"]
        return counts.reshape(cfg.height, cfg.width)

    return np.asarray(_heat(
        scene,
        jnp.asarray(frame.proj_inv, jnp.float32),
        jnp.asarray(frame.origin, jnp.float32),
    ))


def heatmap_to_rgb(counts: np.ndarray) -> np.ndarray:
    """Map (H, W) ray counts to a (H, W, 3) float image: black (0) ->
    deep blue (1 ray) -> orange -> white (max), a perceptual-ish cost
    ramp with no dependencies."""
    c = counts.astype(np.float64)
    t = np.where(c > 0, c / max(float(c.max()), 1.0), 0.0)
    stops = np.array([
        [0.00, 0.0, 0.0, 0.0],
        [0.01, 0.05, 0.05, 0.35],
        [0.40, 0.60, 0.20, 0.10],
        [0.75, 0.95, 0.60, 0.15],
        [1.00, 1.0, 1.0, 1.0],
    ])
    rgb = np.stack([
        np.interp(t, stops[:, 0], stops[:, k + 1]) for k in range(3)
    ], axis=-1)
    return rgb.astype(np.float32)


def rays_per_frame(cfg: RenderConfig) -> int:
    """Upper bound on traced rays per frame: sum of wavefront widths
    (the dense-slot count; the Mrays/s metric in bench.py divides actual
    *alive* lane-rounds instead — see utils/stats.py)."""
    n = cfg.width * cfg.height * cfg.spp
    total = 0
    w = 1
    for count in range(cfg.max_refract_depth + 1):
        total += w
        if count < cfg.max_reflect_depth:
            w *= 2
    return n * total


class Accumulator:
    """Progressive accumulation state (checkpoint/resume-able).

    The reference is stateless per frame except the orbit angle
    (RefractionDemo.cpp:555); for offline supersampled renders we keep an
    explicit (sum, count) state that can be saved/loaded mid-render
    (SURVEY.md 5, checkpoint/resume)."""

    def __init__(self, height: int, width: int):
        self.sum = np.zeros((height, width, 3), np.float64)
        self.count = 0

    def add(self, img: np.ndarray) -> None:
        self.sum += np.asarray(img, np.float64)
        self.count += 1

    @property
    def image(self) -> np.ndarray:
        return (self.sum / max(self.count, 1)).astype(np.float32)

    def save(self, path: str) -> None:
        np.savez(path, sum=self.sum, count=self.count)

    @classmethod
    def load(cls, path: str) -> "Accumulator":
        z = np.load(path)
        acc = cls(z["sum"].shape[0], z["sum"].shape[1])
        acc.sum = z["sum"]
        acc.count = int(z["count"])
        return acc
