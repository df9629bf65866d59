#!/usr/bin/env python
"""Headline benchmark: monkey.obj refraction at 1920x1080, 4 bounces, 1 card.

Prints ONE JSON line: {"metric", "value", "unit", ...}. ``value`` is
frames per second of the pipelined render loop; ``mrays_live`` counts
rays alive entering a trace round, ``mrays_dense`` counts wavefront slots
(the 15-slot-per-pixel static tree bound). ``device_ms`` is the device time
of the frame from a profiler trace. No H100 number has been taken with
this script yet (PERF.md); its metrics are redefined with the benchmark
(ROADMAP S0). Assets are read from ``RRT_ASSET_DIR``.
"""

import glob
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from refraction.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from refraction.camera import orbit_camera
from refraction.config import RenderConfig
from refraction.ops.backends import get_backend
from refraction.render import make_renderer, rays_per_frame
from refraction.scene import load_scene, scene_to_device

def count_live_rays(scene, cfg):
    """Live-ray count per frame via the wavefront integrator's stats path
    (one dispatch; not part of the timed loop)."""
    from refraction.camera import CameraFrame
    from refraction.integrator import render_pixels
    from refraction.render import tiled_primary_rays

    backend = get_backend(cfg.backend)

    @jax.jit
    def stats_step(scene, proj_inv, origin):
        o, d = tiled_primary_rays(CameraFrame(origin, proj_inv), cfg)
        _, st = render_pixels(scene, o, d, cfg, backend.intersect, collect_stats=True)
        return st["rays_traced"]

    frame = orbit_camera(0.01, cfg)
    return int(stats_step(
        scene,
        jnp.asarray(frame.proj_inv, jnp.float32),
        jnp.asarray(frame.origin, jnp.float32),
    )) * cfg.spp


def device_kernel_ms(render, scene, cfg, n=4, agg=min):
    """Device time per frame from a profiler trace: the summed durations
    of the GPU's stream events for each of ``n`` frames (``agg`` over
    them; pass ``agg=median`` for angle-sensitive scenes). The trace goes
    to ``chiprun_out/bench_trace`` in the checkout."""
    here = os.path.dirname(os.path.abspath(__file__))
    td = os.path.join(here, "chiprun_out", "bench_trace")
    shutil.rmtree(td, ignore_errors=True)
    per_frame = []
    for k in range(n):
        frame = orbit_camera(0.3 + 0.017 * k, cfg)
        sub = os.path.join(td, str(k))
        with jax.profiler.trace(sub):
            render(scene, frame).block_until_ready()
        paths = glob.glob(os.path.join(sub, "plugins", "profile", "*",
                                       "*.xplane.pb"))
        if not paths:
            return None
        total_ns = 0
        for plane in jax.profiler.ProfileData.from_file(paths[0]).planes:
            if "/device:GPU" not in plane.name:
                continue
            for line in plane.lines:
                if "stream" in line.name.lower():
                    total_ns += sum(ev.duration_ns for ev in line.events)
        per_frame.append(total_ns / 1e6)
    return agg(per_frame) if any(per_frame) else None


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _loop_dt(render, scene, cfg, n=10):
    """Seconds per frame of a 2-deep pipelined render loop: each frame's
    checksum is enqueued right after it, and the host blocks on the
    previous frame's checksum while the current frame runs."""
    prev = None
    t0 = time.time()
    for k in range(n):
        img = render(scene, orbit_camera(0.1 + 0.013 * k, cfg))
        s = jnp.sum(img[0, 0])
        if prev is not None:
            float(prev)
        prev = s
    float(prev)
    return (time.time() - t0) / n


def main():
    """The full cumulative JSON line is printed (and flushed) right after
    the headline measurement and again after every extra (ref_demo, ott,
    config5, spp4), so a timeout loses only the extras not yet measured.
    ``RRT_BENCH_BUDGET_S`` (default 1800 s wall) skips remaining extras
    once exceeded."""
    t_start = time.time()
    budget_s = float(os.environ.get("RRT_BENCH_BUDGET_S", "1800"))
    asset_dir = os.environ.get("RRT_ASSET_DIR", ".")

    def budget_left():
        return budget_s - (time.time() - t_start)

    small = bool(os.environ.get("RRT_BENCH_SMALL"))
    cfg = RenderConfig(
        width=256 if small else 1920,
        height=128 if small else 1080,
        scene_path=os.path.join(asset_dir, "monkey.obj"),
        max_refract_depth=4,
    )
    scene, meta = load_scene(cfg)
    scene = scene_to_device(scene)
    backend = get_backend(cfg.backend)
    render = make_renderer(cfg)

    # Compile (AOT, no execution) and the first dispatch+sync are timed
    # separately.
    frame0 = orbit_camera(0.01, cfg)
    t0 = time.time()
    render.jitted.lower(scene, jnp.asarray(frame0.proj_inv),
                        jnp.asarray(frame0.origin)).compile()
    compile_s = time.time() - t0
    t0 = time.time()
    img = render(scene, frame0)
    float(jnp.sum(img[0, 0]))
    first_sync_s = time.time() - t0

    dense_rays = rays_per_frame(cfg)

    # Per-frame latency, full sync included.
    times = []
    for k in range(6):
        t0 = time.time()
        img = render(scene, orbit_camera(0.02 + 0.013 * k, cfg))
        float(jnp.sum(img[0, 0]))
        times.append(time.time() - t0)
    lat = min(times)
    dt = min(_loop_dt(render, scene, cfg), lat)

    result = {
        "metric": ("FPS, monkey.obj 256x128 4-bounce (RRT_BENCH_SMALL smoke)"
                   if small else
                   "FPS, monkey.obj 1920x1080 4-bounce refraction, 1 card"),
        "value": round(1.0 / dt, 2),
        "unit": "FPS",
        "frame_ms": round(dt * 1e3, 1),
        "frame_latency_ms": round(lat * 1e3, 1),
        "mrays_dense": round(dense_rays / dt / 1e6, 1),
        "dense_rays_per_frame": dense_rays,
        "tris": meta.num_real_tris,
        "backend": backend.name,
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "compile_s": round(compile_s, 1),
        "first_sync_s": round(first_sync_s, 1),
    }

    def emit():
        print(json.dumps(result), flush=True)

    emit()  # headline is now safe whatever happens below

    def extra(name, min_budget_s, fn):
        """Run one extra unless the wall budget cannot cover it; emits
        the refreshed cumulative line either way."""
        if budget_left() < min_budget_s:
            result[name + "_note"] = (
                f"skipped (RRT_BENCH_BUDGET_S: {budget_left():.0f} s left "
                f"< {min_budget_s} s floor)")
        else:
            fn()
        emit()

    def x_device_ms():
        dev_ms = device_kernel_ms(render, scene, cfg)
        if dev_ms:
            result["device_ms"] = round(dev_ms, 1)

    def x_live_rays():
        live_rays = count_live_rays(scene, cfg)
        result["live_rays_per_frame"] = live_rays
        result["mrays_live"] = round(live_rays / dt / 1e6, 1)

    extra("device_ms", 30, x_device_ms)
    extra("live_rays", 60, x_live_rays)

    if small:
        # The CPU smoke only checks the JSON contract.
        result["ref_demo_note"] = "skipped (RRT_BENCH_SMALL)"
        emit()
        return

    def device_extra(prefix, cfg_x, scene_x, note, agg=min, n=4):
        render_x = make_renderer(cfg_x)
        img_x = render_x(scene_x, orbit_camera(0.01, cfg_x))
        float(jnp.sum(img_x[0, 0]))
        ms = device_kernel_ms(render_x, scene_x, cfg_x, n=n, agg=agg)
        if ms:
            result.update({f"{prefix}_device_ms": round(ms, 1),
                           f"{prefix}_fps_device": round(1e3 / ms, 1),
                           f"{prefix}_note": note})

    def x_ref_demo():
        # The reference's demo config: shell.obj at 1024x768, 5 bounces
        # (RefractionDemo.cpp:537,589-590; RayTracing.hlsl:82,110). The
        # reference presents with vsync and stalls every frame
        # (RefractionDemo.cpp:609-611), so its ceiling is 60 Hz.
        cfg_ref = RenderConfig(
            width=1024, height=768,
            scene_path=os.path.join(asset_dir, "shell.obj"))
        sc, _ = load_scene(cfg_ref)
        device_extra("ref_demo", cfg_ref, scene_to_device(sc),
                     "shell.obj 1024x768 5-bounce, the reference's demo "
                     "config")

    extra("ref_demo", 180, x_ref_demo)

    # Stress asset (ott.obj, 12,877 tris — the reference's largest scene)
    # at the demo's bounce caps, 1080p.
    scene_ott = [None]  # kept for the config5 extra

    def x_ott():
        cfg_ott = RenderConfig(
            width=1920, height=1080,
            scene_path=os.path.join(asset_dir, "ott.obj"),
            max_refract_depth=5)
        sc, _ = load_scene(cfg_ott)
        sc = scene_to_device(sc)
        scene_ott[0] = (sc, cfg_ott)
        device_extra("ott", cfg_ott, sc, "ott.obj 1920x1080 5-bounce "
                     "(stress asset, 12,877 tris)", agg=median, n=6)

    extra("ott", 240, x_ott)

    def x_config5():
        # Staged config 5: ott.obj + 4x supersampling at 1080p.
        if scene_ott[0] is None:
            raise RuntimeError("ott scene unavailable (x_ott skipped?)")
        sc, cfg_ott = scene_ott[0]
        device_extra("config5", cfg_ott.replace(spp=4), sc,
                     "config 5: ott.obj 1920x1080 5-bounce spp=4",
                     agg=median)

    extra("config5", 240, x_config5)

    def x_spp4():
        # spp=4 on the headline scene: all four samples in one dispatch.
        cfg4 = cfg.replace(spp=4)
        render4 = make_renderer(cfg4)
        float(jnp.sum(render4(scene, orbit_camera(0.01, cfg4))[0, 0]))
        dt4 = _loop_dt(render4, scene, cfg4, n=6)
        result["spp4_frame_ms"] = round(dt4 * 1e3, 1)

    extra("spp4", 120, x_spp4)


if __name__ == "__main__":
    main()
