"""Scene representation: device-resident triangle soup + environment map.

The replacement for the reference's GPU resource zoo — vertex /
index upload buffers (Mesh.cpp:55-94), the BLAS/TLAS acceleration structures
(RefractionDemo.cpp:272-361) and SRV descriptor tables (RefractionDemo.cpp:466-511)
all collapse into one immutable pytree of dense arrays:

- triangles are Morton-sorted at build time (our BLAS-build equivalent) and
  padded with degenerate triangles to a multiple of the cluster size, so
  every downstream kernel sees static, tile-aligned shapes;
- per-cluster AABBs play the role of the acceleration structure;
- Möller–Trumbore inputs (A, e1, e2) are precomputed once.

The pytree passes straight through jit/shard_map; geometry is replicated
across devices (scenes are tiny — SURVEY.md 2.4) while rays/pixels shard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np

from refraction.bvh.clusters import build_clusters
from refraction.bvh.morton import (hilbert_order, median_split_order,
                                       morton_order)
from refraction.config import RenderConfig
from refraction.io.objmesh import MeshData, parse_obj
from refraction.io.texture import load_texture


class Scene(NamedTuple):
    """All-array scene pytree (leaves may be numpy or jax arrays)."""

    tri_a: np.ndarray        # (T, 3)  first vertex
    tri_e1: np.ndarray       # (T, 3)  B - A
    tri_e2: np.ndarray       # (T, 3)  C - A
    tri_norm: np.ndarray     # (T, 3, 3) per-corner shading normals
    cluster_lo: np.ndarray   # (C, 3) cluster AABB min
    cluster_hi: np.ndarray   # (C, 3) cluster AABB max
    sub_bounds: np.ndarray      # (T/8, 6) fine 8-tri subcluster AABBs
    envmap: np.ndarray       # (H, W, 3) float32 equirect environment
    tri_mask: np.ndarray = None  # (T,) int32 per-triangle instance mask
                             # (DXR InstanceMask baked per tri; pad tris
                             # 0), in table order like tri_a/e1/e2. Both
                             # intersect backends test it against per-ray
                             # masks (RayTracing.hlsl:60,106,121).

    @property
    def num_tris(self) -> int:
        return int(self.tri_a.shape[0])

    @property
    def num_clusters(self) -> int:
        return int(self.cluster_lo.shape[0])


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (non-traced) facts about a built scene."""

    num_real_tris: int
    num_padded_tris: int
    cluster_size: int
    scene_path: str = ""
    envmap_path: str = ""


# Triangles per cluster unless the config says otherwise: the fastest of
# 16..256 for the intersection kernel on an H100 at both stand-in sizes
# (PERF.md).
DEFAULT_CLUSTER_SIZE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Triangles per fine (subcluster) AABB — the kernel's finest gating
# granularity (a power of two: one (block, SUB_TRIS) tile per visit).
SUB_TRIS = int(os.environ.get("RRT_SUBTRIS", "8"))

# Clusters per top level of the median-split ordering (RRT_SUPER_SIZE):
# the sort mirrors a three-level hierarchy so that clusters and
# subclusters come out spatially tight.
SUPER_CLUSTERS = int(os.environ.get("RRT_SUPER_SIZE", "32"))
assert SUPER_CLUSTERS > 0, SUPER_CLUSTERS


def build_scene(
    mesh: MeshData,
    envmap: np.ndarray,
    cluster_size: int = 32,
    tri_mask: np.ndarray | None = None,
) -> tuple[Scene, SceneMeta]:
    """Spatially sort (RRT_CURVE), pad, and precompute intersection
    inputs.

    ``tri_mask`` (num_tris,) int: per-triangle DXR InstanceMask bytes
    (build_instanced_scene bakes per-instance masks here; default all
    1, the reference's instance mask). Carried in table order for the
    wavefront path's per-ray mask test; pad triangles get mask 0."""
    assert cluster_size % SUB_TRIS == 0 and cluster_size >= SUB_TRIS, (
        f"cluster_size={cluster_size} must be a multiple of "
        f"SUB_TRIS={SUB_TRIS} (the kernel's subclusters divide it)")
    t_real = mesh.num_tris
    # Triangle ordering sets cluster/subcluster AABB tightness, i.e.
    # culling power. RRT_CURVE: median (default — cascaded kd-style
    # median split over the cluster hierarchy), hilbert (no diagonal
    # jumps, ~20% tighter clusters than morton), morton. Their speed on
    # the GPU is not measured.
    curve = os.environ.get("RRT_CURVE", "median")
    if curve == "median":
        order = median_split_order(
            mesh.positions,
            (SUPER_CLUSTERS * cluster_size, cluster_size, SUB_TRIS))
    elif curve == "hilbert":
        order = hilbert_order(mesh.positions)
    elif curve == "morton":
        order = morton_order(mesh.positions)
    else:
        # A typo'd knob silently benchmarking the wrong ordering poisons
        # perf experiments — fail loudly.
        raise ValueError(f"RRT_CURVE={curve!r}: use median|hilbert|morton")
    pos = mesh.positions[order]
    norm = mesh.normals[order]
    if tri_mask is None:
        tri_mask = np.ones(t_real, np.int32)
    mask = np.asarray(tri_mask, np.int32)[order]

    t_pad = max(_round_up(max(t_real, 1), cluster_size), cluster_size)
    if t_pad > t_real:
        # Degenerate padding: repeat the last real triangle's first vertex as
        # all three corners -> zero-area, never intersected (det == 0), and
        # a point inside the final cluster so its AABB stays tight.
        if t_real > 0:
            pad_pt = pos[-1, 0]
        else:
            pad_pt = np.zeros(3, np.float32)
        pad_pos = np.broadcast_to(pad_pt, (t_pad - t_real, 3, 3)).copy()
        pad_norm = np.broadcast_to(
            np.array([0, 1, 0], np.float32), (t_pad - t_real, 3, 3)
        ).copy()
        pos = np.concatenate([pos, pad_pos])
        norm = np.concatenate([norm, pad_norm])
        mask = np.concatenate([mask, np.zeros(t_pad - t_real, np.int32)])

    # Optional front-to-back cluster ordering (RRT_ORDER_FROM="x,y,z"):
    # permute whole cluster blocks by AABB-center distance from a point
    # (the camera). The kernel visits clusters in ascending table order
    # and gates each on the rays' current best hit, so a near-to-far
    # order lets an early hit prune far clusters — the moral of DXR's
    # ordered BVH traversal (RayTracing.hlsl:60) — at no in-kernel cost.
    # Every downstream table and the oracle derive from this array
    # order, so parity is exact.
    order_from = os.environ.get("RRT_ORDER_FROM")
    if order_from:
        pt = np.asarray([float(v) for v in order_from.split(",")],
                        np.float32)
        c_lo, c_hi = build_clusters(pos, cluster_size)
        centers = 0.5 * (c_lo + c_hi)
        perm = np.argsort(((centers - pt) ** 2).sum(axis=1), kind="stable")
        blocks = perm[:, None] * cluster_size + np.arange(cluster_size)
        pos = pos[blocks.reshape(-1)]
        norm = norm[blocks.reshape(-1)]
        mask = mask[blocks.reshape(-1)]

    lo, hi = build_clusters(pos, cluster_size)
    sub_lo, sub_hi = build_clusters(pos, SUB_TRIS)
    tri_a = np.ascontiguousarray(pos[:, 0])
    tri_e1 = np.ascontiguousarray(pos[:, 1] - pos[:, 0])
    tri_e2 = np.ascontiguousarray(pos[:, 2] - pos[:, 0])
    envmap = np.ascontiguousarray(envmap, dtype=np.float32)
    sub_bounds = np.ascontiguousarray(np.concatenate([sub_lo, sub_hi], axis=1))

    scene = Scene(
        tri_a=tri_a,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_norm=np.ascontiguousarray(norm),
        cluster_lo=lo,
        cluster_hi=hi,
        sub_bounds=sub_bounds,
        envmap=envmap,
        tri_mask=np.ascontiguousarray(mask),
    )
    meta = SceneMeta(
        num_real_tris=t_real,
        num_padded_tris=t_pad,
        cluster_size=cluster_size,
    )
    return scene, meta


def load_scene(cfg: RenderConfig) -> tuple[Scene, SceneMeta]:
    """Load scene + envmap from cfg paths (the `initialize` asset ingest,
    RefractionDemo.cpp:527,537-538)."""
    mesh = parse_obj(cfg.scene_path)
    envmap = load_texture(cfg.envmap_path)
    cs = cfg.cluster_size or DEFAULT_CLUSTER_SIZE
    scene, meta = build_scene(mesh, envmap, cs)
    meta = dataclasses.replace(
        meta, scene_path=cfg.scene_path, envmap_path=cfg.envmap_path
    )
    return scene, meta


@dataclasses.dataclass(frozen=True)
class Instance:
    """One TLAS instance — the D3D12_RAYTRACING_INSTANCE_DESC equivalent
    (RefractionDemo.cpp:325-335: 3x4 row-major object->world ``Transform``,
    ``InstanceMask``). The reference builds exactly one instance with the
    identity transform and mask 1; this framework generalizes to N
    instances by *baking* transforms into world space at scene build —
    this framework's answer to a TLAS: geometry is a replicated dense
    array, so an instance edit is one rebuild + host->device transfer,
    just as the reference re-records its TLAS build.

    ``mask`` honors full DXR visibility semantics: an instance is
    visible to a ray iff ``mask & InstanceInclusionMask != 0``
    (RayTracing.hlsl:60,106,121 — the reference passes 0xff on every
    TraceRay). Masks are baked per triangle (scene.tri_mask); PER-RAY
    inclusion masks are served by the wavefront path
    (integrator.render_pixels(ray_mask=...)) on both intersect backends;
    mask-0 instances (invisible under EVERY inclusion mask) are dropped
    at build.
    """

    mesh: MeshData
    transform: np.ndarray | None = None  # (3, 4) row-major; None = identity
    mask: int = 1


def _transform_mesh(mesh: MeshData, transform: np.ndarray) -> MeshData:
    """Bake a 3x4 object->world transform: positions affinely, shading
    normals by the inverse-transpose of the linear part (correct under
    non-uniform scale; the shader re-normalizes after barycentric lerp,
    RayTracing.hlsl:83-86, so lengths don't matter)."""
    m = np.asarray(transform, np.float32)
    if m.shape != (3, 4):
        raise ValueError(f"instance transform must be (3, 4), got {m.shape}")
    lin, t = m[:, :3], m[:, 3]
    if abs(float(np.linalg.det(lin))) < 1e-12:
        raise ValueError("instance transform is singular")
    nrm_m = np.linalg.inv(lin).T.astype(np.float32)
    return MeshData(
        positions=(mesh.positions @ lin.T + t).astype(np.float32),
        normals=(mesh.normals @ nrm_m.T).astype(np.float32),
        uvs=mesh.uvs,
    )


def merge_meshes(meshes: list[MeshData]) -> MeshData:
    if not meshes:
        raise ValueError("no meshes to merge")
    return MeshData(
        positions=np.concatenate([m.positions for m in meshes]),
        normals=np.concatenate([m.normals for m in meshes]),
        uvs=np.concatenate([m.uvs for m in meshes]),
    )


def build_instanced_scene(
    instances: list[Instance],
    envmap: np.ndarray,
    cluster_size: int | None = None,
) -> tuple[Scene, SceneMeta]:
    """Build one scene from N instances (the TLAS-with-N-instances
    capability). Baked world-space triangles from all visible instances
    are merged and spatially clustered together (RRT_CURVE order), so
    traversal is exactly the single-mesh path — instancing costs nothing
    per ray."""
    visible = [i for i in instances if i.mask & 0xFF]
    if not visible:
        raise ValueError("all instances are masked out (mask & 0xff == 0)")
    baked = [
        i.mesh if i.transform is None else _transform_mesh(i.mesh, i.transform)
        for i in visible
    ]
    merged = merge_meshes(baked)
    tri_mask = np.concatenate([
        np.full(i.mesh.num_tris, np.int32(i.mask & 0xFF))
        for i in visible
    ]).astype(np.int32)
    cs = cluster_size or DEFAULT_CLUSTER_SIZE
    return build_scene(merged, envmap, cs, tri_mask=tri_mask)


def instance_transform(translate=(0.0, 0.0, 0.0), scale=1.0,
                       rotate_y_deg=0.0) -> np.ndarray:
    """Convenience 3x4 composer (scale, then rotate about +Y, then
    translate) for CLI/instance specs."""
    s = np.asarray(scale, np.float32) * np.ones(3, np.float32)
    c, sn = np.cos(np.radians(rotate_y_deg)), np.sin(np.radians(rotate_y_deg))
    rot = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]],
                   np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = rot * s[None, :]
    m[:, 3] = np.asarray(translate, np.float32)
    return m


def load_instanced(spec_path: str, cfg: RenderConfig) -> tuple[Scene, SceneMeta]:
    """Load an instanced scene from a JSON spec (the CLI ``--instances``
    format): a list (or {"instances": [...]}) of entries
    ``{"obj": path, "translate": [x,y,z], "scale": s | [sx,sy,sz],
    "rotate_y_deg": deg, "mask": m}`` — or an explicit
    ``"transform": 3x4`` row-major matrix instead of the convenience
    fields. OBJ paths resolve like ``--scene``: as given, else under the
    asset dir of ``cfg.scene_path``."""
    import json

    with open(spec_path) as f:
        spec = json.load(f)
    if isinstance(spec, dict):
        spec = spec["instances"]
    if not isinstance(spec, list) or not spec:
        raise ValueError(f"{spec_path}: expected a non-empty instance list")
    asset_dir = os.path.dirname(cfg.scene_path)
    meshes: dict[str, MeshData] = {}
    instances = []
    for ent in spec:
        path = ent["obj"]
        if not os.path.exists(path):
            path = os.path.join(asset_dir, ent["obj"])
        if path not in meshes:
            meshes[path] = parse_obj(path)
        if "transform" in ent:
            m = np.asarray(ent["transform"], np.float32)
        else:
            m = instance_transform(
                translate=ent.get("translate", (0.0, 0.0, 0.0)),
                scale=ent.get("scale", 1.0),
                rotate_y_deg=ent.get("rotate_y_deg", 0.0))
        instances.append(
            Instance(meshes[path], m, mask=int(ent.get("mask", 1))))
    envmap = load_texture(cfg.envmap_path)
    scene, meta = build_instanced_scene(instances, envmap, cfg.cluster_size)
    meta = dataclasses.replace(
        meta, scene_path=spec_path, envmap_path=cfg.envmap_path)
    return scene, meta


def scene_to_device(scene: Scene, sharding=None) -> Scene:
    """Move scene leaves to device (replicated unless a sharding is given)."""
    import jax

    if sharding is None:
        return jax.tree.map(jax.device_put, scene)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scene)
