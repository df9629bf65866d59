"""Multi-host (multi-process) offline rendering over jax.distributed.

The reference is single-GPU, single-process (SURVEY.md §2.4 —
``D3D12CreateDevice(nullptr, …)`` picks one adapter,
RefractionDemo.cpp:155). Scaling past one host is this framework's own
design (SURVEY.md §5 "Distributed communication backend"): offline
animation rendering shards *frames* across processes — geometry and the
envmap are tiny and replicated, each host renders its own frames with the
full single-host pipeline, and the only cross-host communication is a
scalar ``psum`` of the run statistics at the end. No ray or image data
ever crosses hosts.

Topology: ``jax.distributed.initialize`` brings up the coordinator/client
transport; a 1-D ``hosts`` mesh over all global devices carries the stats
reduction. On CPU (the test rig and the two-process smoke test) the
collectives run on gloo; on GPUs XLA hands them to NCCL.

Usage (one command per host / process):

    python -m refraction.parallel.distributed \
        --coordinator host0:9876 --num-processes 2 --process-id {0,1} \
        --frames 32 --out render_out [--scene path/to.obj ...]
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Bring up the jax.distributed runtime for this process.

    Must run before any other JAX API touches a backend. On the CPU
    platform, cross-process collectives need the gloo implementation."""
    import jax

    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        jax.config.update("jax_platforms", "cpu")
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # older jax: gloo is the default when available
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def frames_for_process(n_frames: int, process_id: int,
                       num_processes: int) -> list[int]:
    """Round-robin frame partition: adjacent frames land on different
    hosts so every host's work tracks the orbit's cost variation."""
    return list(range(process_id, n_frames, num_processes))


def _global_stats_psum(local: Sequence[float]) -> np.ndarray:
    """Sum a small per-process stats vector across ALL processes: the
    cross-host collective of the design (scalar psum; SURVEY.md §5)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("hosts",))
    k = len(local)
    # Each process owns len(local_devices) rows of the (n_devices, k)
    # global array; fill the first local row with this process's stats and
    # zeros elsewhere so the psum over rows is the cross-process total.
    rows = np.zeros((len(jax.local_devices()), k), np.float32)
    rows[0] = np.asarray(local, np.float32)
    x = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("hosts")), rows)
    f = jax.jit(jax.shard_map(
        lambda v: jax.lax.psum(v, "hosts"),
        mesh=mesh, in_specs=P("hosts"), out_specs=P()))
    # psum over the row axis: every device holds the same (1, k) total.
    return np.asarray(f(x))[0]


def render_frames_distributed(cfg, n_frames: int, out_dir: str | None,
                              process_id: int, num_processes: int,
                              angle0: float = 0.01,
                              dangle: float = 0.01,
                              scene=None) -> dict:
    """Render this process's share of an ``n_frames`` orbit animation.

    Every process calls this with the same arguments after
    ``init_distributed``; returns the GLOBAL run stats (identical on all
    processes — the value has crossed hosts, which is what the smoke test
    asserts)."""
    import jax.numpy as jnp

    from refraction.camera import orbit_camera
    from refraction.render import make_renderer
    from refraction.scene import load_scene, scene_to_device

    if scene is None:
        scene, _ = load_scene(cfg)
    scene = scene_to_device(scene)
    render = make_renderer(cfg)

    mine = frames_for_process(n_frames, process_id, num_processes)
    checksum = 0.0
    for k in mine:
        img = render(scene, orbit_camera(angle0 + dangle * k, cfg))
        img = np.asarray(img)
        if not np.isfinite(img).all():
            raise RuntimeError(f"non-finite radiance in frame {k}")
        checksum += float(img.mean())
        if out_dir:
            from refraction.io.png import write_png

            os.makedirs(out_dir, exist_ok=True)
            u8 = np.clip(img ** (1 / 2.2) * 255.0 + 0.5, 0, 255
                         ).astype(np.uint8)
            write_png(os.path.join(out_dir, f"frame_{k:04d}.png"), u8)

    total = _global_stats_psum([float(len(mine)), checksum])
    return {
        "frames_rendered_global": int(round(float(total[0]))),
        "frames_rendered_local": len(mine),
        "checksum_global": float(total[1]),
        "checksum_local": checksum,
    }


def _main() -> None:
    ap = argparse.ArgumentParser(
        description="multi-host offline orbit render (one invocation "
        "per process; see module docstring)")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0's coordinator service")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--scene", default=None,
                    help="OBJ path; default: procedural icosphere")
    ap.add_argument("--envmap", default=None)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--out", default=None, help="PNG output directory")
    args = ap.parse_args()

    init_distributed(args.coordinator, args.num_processes, args.process_id)

    from refraction.config import RenderConfig

    cfg = RenderConfig(width=args.width, height=args.height,
                       backend="auto", cluster_size=32)
    scene = None
    if args.scene:
        cfg = cfg.replace(scene_path=args.scene, cluster_size=128)
        if args.envmap:
            cfg = cfg.replace(envmap_path=args.envmap)
    else:
        from refraction.io.primitives import (
            make_gradient_envmap, make_icosphere)
        from refraction.scene import build_scene

        scene, _ = build_scene(make_icosphere(subdiv=2, radius=1.2),
                               make_gradient_envmap(64, 128),
                               cluster_size=32)

    stats = render_frames_distributed(
        cfg, args.frames, args.out, args.process_id, args.num_processes,
        scene=scene)
    import json

    print(json.dumps({"process_id": args.process_id, **stats}), flush=True)


if __name__ == "__main__":
    _main()
