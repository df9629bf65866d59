"""Intersection backends for the wavefront integrator.

Both implement the IntersectFn contract (integrator.py):
  (scene, origins, dirs, want_front, alive, tmin, tmax) -> (hit, t, tri_idx)

- ``xla_intersect``: pure-jnp brute force, tiled over rays with ``lax.map``
  so the fused Möller–Trumbore chain never materializes more than a
  (chunk, T) slab. Runs on every platform; the in-repo reference.
- ``pallas_intersect`` (kernels/intersect_pallas.py): the cluster-culling
  GPU kernel, selected by ``get_backend('pallas')``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from refraction.ops.intersect import intersect_closest
from refraction.scene import Scene


# Rays per lax.map step of the brute force: the fastest of 2^11..2^19 on
# an H100 at the demo size (PERF.md). XLA materializes the step's
# (chunk, T) Möller–Trumbore slab (about 24 bytes a pair), so the step
# also stays under PAIR_BUDGET ray-triangle pairs (~6 GiB): 131,072 rays
# at 1.6k triangles, 23k at 11.5k, 3.2k at 81,920.
CHUNK = 131072
PAIR_BUDGET = 1 << 28


def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    shape = (pad,) + x.shape[1:]
    return jnp.concatenate([x, jnp.full(shape, fill, x.dtype)])


def xla_intersect(
    scene: Scene,
    origins,
    dirs,
    want_front,
    alive,
    tmin,
    tmax,
    chunk: int = CHUNK,
    ray_mask=None,
):
    """Brute-force closest hit, ray-tiled. alive is accepted but unused
    (dense evaluation; masking happens in the integrator).

    ``ray_mask`` ((N,) int32): DXR's per-TraceRay InstanceInclusionMask
    (RayTracing.hlsl:60) — a triangle is testable by a ray iff
    ``scene.tri_mask & ray_mask != 0``. None (the reference's constant
    0xff against all-visible instances) skips the test entirely; a mask
    against a scene without ``tri_mask`` is an error."""
    del alive
    if ray_mask is not None and scene.tri_mask is None:
        raise ValueError(
            "ray_mask given but the scene has no tri_mask to test it against")
    hit, t, idx = brute_force_closest(
        scene.tri_a, scene.tri_e1, scene.tri_e2, origins, dirs, want_front,
        tmin, tmax, chunk,
        tri_mask=None if ray_mask is None else scene.tri_mask,
        ray_mask=ray_mask)
    return hit, t, idx, None


def brute_force_closest(tri_a, tri_e1, tri_e2, origins, dirs, want_front,
                        tmin, tmax, chunk: int = CHUNK, tri_mask=None,
                        ray_mask=None):
    """``intersect_closest`` over ray chunks with ``lax.map``, so no more
    than a (chunk, T) slab is live at once; the chunk shrinks below
    ``chunk`` to keep that slab within ``PAIR_BUDGET`` pairs."""
    n = origins.shape[0]
    c = max(1, min(chunk, n, PAIR_BUDGET // max(tri_a.shape[0], 1)))
    n_pad = ((n + c - 1) // c) * c

    o = _pad_to(origins, n_pad).reshape(-1, c, 3)
    d = _pad_to(dirs, n_pad, fill=1).reshape(-1, c, 3)
    wf = _pad_to(want_front, n_pad).reshape(-1, c)
    if ray_mask is not None:
        rm = _pad_to(jnp.asarray(ray_mask, jnp.int32), n_pad).reshape(-1, c)
        args = (o, d, wf, rm)
    else:
        args = (o, d, wf)

    def body(args):
        return intersect_closest(
            args[0], args[1], tri_a, tri_e1, tri_e2, tmin, tmax, args[2],
            jnp, tri_mask=tri_mask,
            ray_mask=args[3] if ray_mask is not None else None)

    hit, t, idx = jax.lax.map(body, args)
    return hit.reshape(-1)[:n], t.reshape(-1)[:n], idx.reshape(-1)[:n]


class Backend:
    """A named intersect implementation."""

    def __init__(self, name, intersect):
        self.name = name
        self.intersect = intersect


def get_backend(name: str, interpret: bool = False) -> Backend:
    """Resolve 'xla' | 'pallas' | 'auto' to a Backend.

    'auto' is 'pallas' on a GPU and 'xla' elsewhere. 'pallas' off a GPU
    needs ``interpret=True`` (the Pallas interpreter, for tests)."""
    if name == "auto":
        name = "pallas" if jax.default_backend() == "gpu" else "xla"
    if name == "xla":
        return Backend("xla", xla_intersect)
    if name == "pallas":
        if not interpret and jax.default_backend() != "gpu":
            raise ValueError(
                "backend 'pallas' compiles for a GPU only; the default "
                f"backend is {jax.default_backend()!r} (use 'xla', or "
                "interpret=True in tests)")
        from refraction.kernels.intersect_pallas import pallas_intersect

        return Backend("pallas", partial(pallas_intersect,
                                         interpret=interpret))
    raise ValueError(f"unknown intersect backend: {name}")
