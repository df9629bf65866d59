"""Multi-device rendering: shard_map over a JAX device mesh.

The reference is strictly single-GPU (SURVEY.md 2.4 — one adapter,
RefractionDemo.cpp:155); scaling over several cards is this framework's
own design:

- **Pixel data parallelism** (`make_sharded_renderer`): the image is
  sharded over the mesh's ``pixels`` axis; geometry + envmap are
  replicated (scenes are <= a few MB). Each device runs the full
  wavefront on its share of the pixels; the only cross-device
  communication is the output assembly, which XLA lowers to collectives
  over the cards' interconnect.
- **Triangle sharding** (`make_trisharded_intersect`): for scenes too big
  to replicate, each device intersects every ray against its triangle
  shard and the per-device (t, idx) candidates are combined with an
  all_gather + min/tie-break reduction — the renderer's analogue of
  tensor parallelism, and the pattern the multichip dry-run exercises.
- **Sample parallelism** (`make_sample_sharded_renderer`): supersampling
  samples sharded over a second mesh axis on a 2-D ``(samples, pixels)``
  mesh; each device traces its jitter subset of its pixel shard and the
  partial radiance sums ``psum``-reduce over the samples axis. The
  renderer's analogue of ML data parallelism over the batch (SURVEY.md
  §2.4: "data parallelism over pixels/samples").

The meshes are flat (1-D ``pixels`` or 2-D ``(samples, pixels)``) and
follow the algorithm only: the cards of one host reach each other all to
all. Every path runs unchanged on a virtual CPU mesh
(``--xla_force_host_platform_device_count``) and on GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from refraction.camera import CameraFrame, generate_rays
from refraction.config import RenderConfig
from refraction.integrator import render_pixels
from refraction.ops.backends import brute_force_closest, get_backend
from refraction.scene import Scene


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ("pixels",))


# Consecutive pixels per work unit of the round-robin interleave.
_UNIT = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _unit_interleave(n_pad: int, unit: int, ndev: int):
    """(scatter, gather) closures for round-robin load balancing.

    Static unit permutation: unit u lands at slot
    ``(u % ndev) * units_per_dev + u // ndev``, so device d's contiguous
    shard holds units d, d+ndev, d+2*ndev, ... — a uniform vertical
    slice of the frame instead of one contiguous band (center rows carry
    the object's bounce tree; sky rows miss straight to the envmap).
    ``scatter`` maps ray order -> device-interleaved order, ``gather``
    inverts it; both permute ``axis`` (default 0). ndev <= 1 returns
    identities."""
    if ndev <= 1:
        ident = lambda x, axis=0: x  # noqa: E731
        return ident, ident
    upd = n_pad // unit // ndev

    # Pure reshape/transpose (no gather — same rationale as
    # render.tile_order): a (upd, ndev) block transpose of unit rows,
    # which the SPMD partitioner lowers to a clean all-to-all instead of
    # an opaque 2M-element index gather.
    def _block_swap(x, a, b, axis):
        lead, trail = x.shape[:axis], x.shape[axis + 1:]
        x = x.reshape(*lead, a, b, unit, *trail)
        x = jnp.swapaxes(x, axis, axis + 1)
        return x.reshape(*lead, n_pad, *trail)

    def scatter(x, axis=0):   # ray order -> device-interleaved order
        return _block_swap(x, upd, ndev, axis)

    def gather(x, axis=0):    # device-interleaved order -> ray order
        return _block_swap(x, ndev, upd, axis)

    return scatter, gather


def make_sharded_renderer(
    cfg: RenderConfig,
    mesh: Mesh,
    intersect_fn: Callable | None = None,
    interleave: bool = True,
):
    """Build a jitted multi-device (scene, frame) -> (H, W, 3) renderer.

    Image rows x cols are flattened and sharded over the ``pixels`` mesh
    axis (padded up to a multiple of the device count); the scene is
    replicated. Per-sample jitter offsets follow render.make_renderer.

    ``interleave`` (default) assigns the shard's work units (runs of
    ``_UNIT`` consecutive pixels) to devices round-robin instead of as one
    contiguous band each: the frame's cost is concentrated in the center
    rows (the object's bounce tree; sky rows miss straight to the
    envmap), so contiguous bands leave the sky-band cards idle behind the
    center-band cards every frame. Round-robin gives every card a uniform
    vertical slice of the frame. Per-pixel work is device-independent —
    the image matches the contiguous assignment to XLA-fusion ulp
    (asserted in test_sharding.py)."""
    if intersect_fn is None:
        intersect_fn = get_backend(cfg.backend).intersect
    from refraction.render import sample_offsets

    offsets = sample_offsets(cfg.spp)
    n = cfg.height * cfg.width
    ndev = mesh.devices.size
    n_pad = _round_up(n, ndev * _UNIT)

    scatter_units, gather_units = _unit_interleave(
        n_pad, _UNIT, ndev if interleave else 1)

    ray_spec = P("pixels")
    rep = P()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(rep, ray_spec, ray_spec),
        out_specs=ray_spec,
        # pallas_call outputs carry no varying-mesh-axis metadata; the
        # shard body is per-shard pure, so the static check is safely off.
        check_vma=False,
    )
    def _trace_shard(scene, o, d):
        return render_pixels(scene, o, d, cfg, intersect_fn)

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def _render(scene: Scene, proj_inv, origin):
        frame = CameraFrame(origin=origin, proj_inv=proj_inv)
        acc = jnp.zeros((n_pad, 3), jnp.float32)
        for s in range(cfg.spp):
            jitter = jnp.broadcast_to(jnp.asarray(offsets[s]), (n, 2))
            o, d = generate_rays(
                frame, cfg.width, cfg.height,
                jitter=None if cfg.spp == 1 else jitter, xp=jnp,
            )
            pad = n_pad - n
            if pad:
                o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
                d = jnp.concatenate(
                    [d, jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], d.dtype), (pad, 3))]
                )
            o = scatter_units(o)
            d = scatter_units(d)
            o = jax.lax.with_sharding_constraint(o, NamedSharding(mesh, ray_spec))
            d = jax.lax.with_sharding_constraint(d, NamedSharding(mesh, ray_spec))
            acc = acc + _trace_shard(scene, o, d)
        acc = gather_units(acc)  # undo the unit interleave (ray order)
        return (acc[:n] / cfg.spp).reshape(cfg.height, cfg.width, 3)

    def render(scene: Scene, frame: CameraFrame):
        return _render(
            scene,
            jnp.asarray(frame.proj_inv, jnp.float32),
            jnp.asarray(frame.origin, jnp.float32),
        )

    return render


def make_mesh2d(n_devices: int | None = None, sample_devs: int = 2) -> Mesh:
    """2-D ``(samples, pixels)`` mesh: ``sample_devs`` must divide the
    device count; the pixel axis gets the rest."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if len(devs) % sample_devs:
        raise ValueError(
            f"{len(devs)} devices do not split into samples={sample_devs}")
    grid = np.asarray(devs).reshape(sample_devs, -1)
    return Mesh(grid, ("samples", "pixels"))


def make_sample_sharded_renderer(
    cfg: RenderConfig,
    mesh: Mesh,
    intersect_fn: Callable | None = None,
    interleave: bool = True,
):
    """Build a jitted (scene, frame) -> (H, W, 3) renderer over a 2-D
    ``(samples, pixels)`` mesh (``make_mesh2d``).

    The spp jittered sample set is sharded over the ``samples`` axis and
    the flattened image over ``pixels``; each device traces
    ``spp / samples_devs`` full wavefronts on its pixel shard and the
    per-device partial sums reduce with ONE ``psum`` over ``samples``
    (one all-reduce), after which the mean over spp is taken. Equals the
    single-device sequential spp accumulation up to float-add
    reassociation (the psum tree reorders the sum).
    """
    if intersect_fn is None:
        intersect_fn = get_backend(cfg.backend).intersect
    from refraction.render import sample_offsets

    sdev = mesh.shape["samples"]
    pdev = mesh.shape["pixels"]
    if cfg.spp % sdev:
        raise ValueError(
            f"spp={cfg.spp} must be a multiple of the samples axis ({sdev})")
    offsets = sample_offsets(cfg.spp)
    n = cfg.height * cfg.width
    n_pad = _round_up(n, pdev * _UNIT)
    scatter_units, gather_units = _unit_interleave(
        n_pad, _UNIT, pdev if interleave else 1)
    ray_spec = P("samples", "pixels", None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), ray_spec, ray_spec),
        out_specs=P("pixels", None),
        check_vma=False,  # same rationale as make_sharded_renderer
    )
    def _trace(scene, o, d):
        acc = jnp.zeros((o.shape[1], 3), jnp.float32)
        for k in range(o.shape[0]):  # spp_local, static
            acc = acc + render_pixels(scene, o[k], d[k], cfg, intersect_fn)
        return jax.lax.psum(acc, "samples")

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def _render(scene: Scene, proj_inv, origin):
        frame = CameraFrame(origin=origin, proj_inv=proj_inv)
        pad = n_pad - n
        o_all, d_all = [], []
        for s in range(cfg.spp):
            jitter = jnp.broadcast_to(jnp.asarray(offsets[s]), (n, 2))
            o, d = generate_rays(
                frame, cfg.width, cfg.height,
                jitter=None if cfg.spp == 1 else jitter, xp=jnp,
            )
            if pad:
                o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
                d = jnp.concatenate([d, jnp.broadcast_to(
                    jnp.asarray([0.0, 1.0, 0.0], d.dtype), (pad, 3))])
            o_all.append(o)
            d_all.append(d)
        sh = NamedSharding(mesh, ray_spec)
        o_all = jax.lax.with_sharding_constraint(
            scatter_units(jnp.stack(o_all), axis=1), sh)
        d_all = jax.lax.with_sharding_constraint(
            scatter_units(jnp.stack(d_all), axis=1), sh)
        img = gather_units(_trace(scene, o_all, d_all))
        return (img[:n] / cfg.spp).reshape(cfg.height, cfg.width, 3)

    def render(scene: Scene, frame: CameraFrame):
        return _render(
            scene,
            jnp.asarray(frame.proj_inv, jnp.float32),
            jnp.asarray(frame.origin, jnp.float32),
        )

    return render


def make_trisharded_intersect(mesh: Mesh, axis: str = "pixels"):
    """IntersectFn where *triangles* are sharded over ``axis``.

    For scenes too large to replicate: every device sees all rays,
    intersects its contiguous triangle shard, and per-device (t, idx)
    candidates reduce across the mesh — min over t, ties to the lowest
    global triangle index (argmin over the device axis picks the lowest
    shard, and shards are contiguous ascending, so tie-breaking matches
    the single-device argmin-first contract exactly).

    Shading-side arrays (tri_norm) stay replicated in this version; only
    the intersection inputs shard. Triangle counts must divide evenly by
    the device count (scene padding handles this — pick cluster_size as a
    multiple of the device count).
    """

    def intersect(scene: Scene, origins, dirs, want_front, alive, tmin, tmax):
        del alive

        def local(tri_a, tri_e1, tri_e2, o, d, wf):  # noqa: ANN001
            t_local = tri_a.shape[0]
            shard_id = jax.lax.axis_index(axis)
            hit, t, idx = brute_force_closest(
                tri_a, tri_e1, tri_e2, o, d, wf, tmin, tmax)
            gidx = idx + shard_id.astype(jnp.int32) * t_local
            ts = jax.lax.all_gather(
                jnp.where(hit, t, jnp.float32(3e38)), axis
            )  # (ndev, N)
            gs = jax.lax.all_gather(gidx, axis)
            best_dev = jnp.argmin(ts, axis=0)
            ar = jnp.arange(ts.shape[1])
            t_best = ts[best_dev, ar]
            i_best = gs[best_dev, ar]
            return t_best < jnp.float32(1e37), t_best, i_best

        hit, t_best, i_best = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P(), P()),
            out_specs=(P(), P(), P()),
            # Outputs are deterministically identical on every device (same
            # all_gather + argmin everywhere); the static checker can't see
            # that, so varying-mesh-axis checking is disabled.
            check_vma=False,
        )(scene.tri_a, scene.tri_e1, scene.tri_e2, origins, dirs, want_front)
        return hit, t_best, i_best, None

    return intersect
