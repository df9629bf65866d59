"""Device-built LBVH over Morton order, with closest-hit traversal.

The reference delegates BVH construction and traversal to DXR hardware
(`BuildRaytracingAccelerationStructure` RefractionDemo.cpp:321,356 and
`TraceRay` RayTracing.hlsl:60). This module is a from-scratch software
equivalent in plain XLA:

- **Implicit topology.** Instead of the pointer-based Karras radix tree
  (whose adaptive topology needs data-dependent construction), triangles
  are Morton-sorted and the tree is a *complete binary tree over the
  sorted order* (a segment tree): leaves are the sorted triangles padded
  to a power of two, node k's children are 2k+1 / 2k+2. Construction is
  log2(T) dense reshape-min/max passes — one jit, no scatter, no
  divergence — and the whole hierarchy is two (2L-1, 3) arrays.
- **Traversal** is a lax.while_loop over a per-ray explicit stack
  (vmap-batched). Every lane steps in lock-step and node fetches are
  XLA gathers. This module is a *traversal oracle*: a second,
  structurally independent implementation for property tests (BVH ==
  brute force == cluster kernel). The production path on a GPU is the
  cluster kernel (kernels/intersect_pallas.py); how this traversal
  compares with it on the card is not measured (ROADMAP S1).

Quality note: fixed topology over Morton order gives slightly looser
boxes than surface-area-heuristic builds, but identical *results* —
closest-hit selection still tie-breaks to the lowest sorted-triangle
index, matching ops/intersect.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from refraction.bvh.morton import morton3d_jnp


class LBVH(NamedTuple):
    node_lo: jnp.ndarray   # (2L-1, 3) node AABB minima
    node_hi: jnp.ndarray   # (2L-1, 3) node AABB maxima
    tri_a: jnp.ndarray     # (L, 3) sorted (+padded) triangle data
    tri_e1: jnp.ndarray    # (L, 3)
    tri_e2: jnp.ndarray    # (L, 3)
    order: jnp.ndarray     # (L,) sorted index -> original triangle index

    @property
    def num_leaves(self) -> int:
        return int(self.tri_a.shape[0])

    @property
    def depth(self) -> int:
        return int(self.num_leaves).bit_length() - 1


_INF = 3.0e38


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def build_lbvh(tri_a, tri_e1, tri_e2) -> LBVH:
    """Build on device (jit-able; all shapes static)."""
    t = tri_a.shape[0]
    v0 = tri_a
    v1 = tri_a + tri_e1
    v2 = tri_a + tri_e2
    lo = jnp.minimum(jnp.minimum(v0, v1), v2)
    hi = jnp.maximum(jnp.maximum(v0, v1), v2)
    # Degenerate padding triangles (zero edges) collapse to a point and are
    # never hit (det == 0 in the leaf test), so they can stay in the tree.
    centroid = (lo + hi) * 0.5
    scene_lo = jnp.min(lo, axis=0)
    scene_hi = jnp.max(hi, axis=0)
    codes = morton3d_jnp(centroid, scene_lo, scene_hi, jnp)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)

    leaves = _next_pow2(max(t, 1))
    pad = leaves - t
    lo_s = lo[order]
    hi_s = hi[order]
    a_s = tri_a[order]
    e1_s = tri_e1[order]
    e2_s = tri_e2[order]
    if pad:
        # Empty leaves: inverted boxes fail every slab test.
        lo_s = jnp.concatenate([lo_s, jnp.full((pad, 3), _INF, lo.dtype)])
        hi_s = jnp.concatenate([hi_s, jnp.full((pad, 3), -_INF, hi.dtype)])
        a_s = jnp.concatenate([a_s, jnp.zeros((pad, 3), a_s.dtype)])
        e1_s = jnp.concatenate([e1_s, jnp.zeros((pad, 3), e1_s.dtype)])
        e2_s = jnp.concatenate([e2_s, jnp.zeros((pad, 3), e2_s.dtype)])
        order = jnp.concatenate([order, jnp.zeros(pad, jnp.int32)])

    # Bottom-up union passes: levels[d] has 2^d nodes.
    levels_lo = [lo_s]
    levels_hi = [hi_s]
    while levels_lo[0].shape[0] > 1:
        cur_lo = levels_lo[0].reshape(-1, 2, 3)
        cur_hi = levels_hi[0].reshape(-1, 2, 3)
        levels_lo.insert(0, cur_lo.min(axis=1))
        levels_hi.insert(0, cur_hi.max(axis=1))
    node_lo = jnp.concatenate(levels_lo, axis=0)  # heap order: root at 0
    node_hi = jnp.concatenate(levels_hi, axis=0)
    return LBVH(node_lo, node_hi, a_s, e1_s, e2_s, order)


def lbvh_from_scene(scene) -> LBVH:
    return build_lbvh(
        jnp.asarray(scene.tri_a), jnp.asarray(scene.tri_e1),
        jnp.asarray(scene.tri_e2),
    )


def _ray_box(o, inv_d, lo, hi, tmin, tmax):
    ta = (lo - o) * inv_d
    tb = (hi - o) * inv_d
    enter = jnp.maximum(jnp.max(jnp.minimum(ta, tb)), tmin)
    leave = jnp.minimum(jnp.min(jnp.maximum(ta, tb)), tmax)
    return enter <= leave


def _tri_test(o, d, a, e1, e2, tmin, tmax, want_front):
    pvec = jnp.cross(d, e2)
    det = jnp.dot(e1, pvec)
    accept = jnp.where(want_front, det > 0, det < 0)
    inv_det = 1.0 / jnp.where(det == 0, 1.0, det)
    tvec = o - a
    u = jnp.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.dot(d, qvec) * inv_det
    t = jnp.dot(e2, qvec) * inv_det
    ok = (accept & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t >= tmin) & (t <= tmax))
    return ok, t


def lbvh_intersect_one(bvh: LBVH, o, d, tmin, tmax, want_front):
    """Closest hit for a single ray (vmap over rays at the call site)."""
    depth = bvh.depth
    leaves = bvh.num_leaves
    stack = jnp.zeros(depth + 2, jnp.int32)

    eps = jnp.float32(1e-30)
    mag = jnp.maximum(jnp.abs(d), eps)
    inv_d = jnp.where(d < 0, -1.0 / mag, 1.0 / mag)

    def cond(state):
        sp, *_ = state
        return sp > 0

    def body(state):
        sp, stack, best_t, best_i = state
        node = stack[sp - 1]
        sp = sp - 1
        hit_box = _ray_box(o, inv_d, bvh.node_lo[node], bvh.node_hi[node],
                           tmin, jnp.minimum(tmax, best_t))

        is_leaf = node >= leaves - 1

        def leaf_case(args):
            sp, stack, best_t, best_i = args
            li = node - (leaves - 1)
            ok, t = _tri_test(o, d, bvh.tri_a[li], bvh.tri_e1[li],
                              bvh.tri_e2[li], tmin, tmax, want_front)
            # Strict < with ascending-sorted-order pushes preserves the
            # lowest-ORIGINAL-index tie-break only when t differs; equal-t
            # ties break by sorted position here (documented deviation,
            # measure-zero for real geometry).
            upd = ok & (t < best_t)
            return (sp, stack,
                    jnp.where(upd, t, best_t),
                    jnp.where(upd, li, best_i))

        def inner_case(args):
            sp, stack, best_t, best_i = args
            left = 2 * node + 1
            # Push right then left (left processed first: ascending order).
            stack = stack.at[sp].set(2 * node + 2)
            stack = stack.at[sp + 1].set(left)
            return (sp + 2, stack, best_t, best_i)

        def skip_case(args):
            return args

        return jax.lax.cond(
            hit_box,
            lambda a: jax.lax.cond(is_leaf, leaf_case, inner_case, a),
            skip_case,
            (sp, stack, best_t, best_i),
        )

    state = (jnp.int32(1), stack, jnp.float32(_INF), jnp.int32(0))
    _, _, best_t, best_i = jax.lax.while_loop(cond, body, state)
    hit = best_t < jnp.float32(1e37)
    return hit, best_t, bvh.order[best_i]


def lbvh_intersect(bvh: LBVH, origins, dirs, want_front, tmin, tmax):
    """Batched closest hit: returns (hit, t, original_tri_idx)."""
    f = jax.vmap(
        lambda o, d, wf: lbvh_intersect_one(bvh, o, d, tmin, tmax, wf)
    )
    return f(origins, dirs, want_front)


def make_lbvh_backend(scene):
    """IntersectFn adapter (integrator contract) for a prebuilt LBVH."""
    bvh = lbvh_from_scene(scene)

    def intersect(scene_, origins, dirs, want_front, alive, tmin, tmax):
        del scene_
        hit, t, idx = lbvh_intersect(bvh, origins, dirs, want_front, tmin, tmax)
        return hit & alive, t, idx, None

    return intersect
