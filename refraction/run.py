"""CLI frame driver — the WinMain / drawFrame equivalent (WinMain.cpp:37-59,
RefractionDemo.cpp:555-612), headless.

The reference opens a window, orbits the camera at 0.01 rad/frame and
presents vsync-locked with a full CPU<->GPU stall per frame. This driver
renders the same orbit on the default JAX device with *pipelined* dispatch
(frame N+1 is enqueued while frame N drains — the async behavior the
reference's author left as a TODO, RefractionDemo.cpp:520-521), prints
per-frame stats, and writes PNG frames / a final accumulation instead of
presenting.

Examples:
  python -m refraction.run --scene shell.obj --envmap env.png \
      --frames 8 --out orbit/                                     # demo cfg
  python -m refraction.run --scene monkey.obj --width 1920 \
      --height 1080 --bounces 4 --frames 1 --out monkey.png
  python -m refraction.run --baseline 3 --frames 1            # staged cfg

``python chip_smoke.py`` generates stand-in assets and drives this CLI.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np

from refraction.camera import orbit_camera
from refraction.config import DEFAULT_ASSET_DIR, RenderConfig, baseline_config
from refraction.io.png import write_png
from refraction.render import Accumulator, make_renderer
from refraction.scene import load_instanced, load_scene, scene_to_device
from refraction.utils.stats import FrameStats, log, setup_logging


def tonemap(img: np.ndarray, linear: bool = False) -> np.ndarray:
    """Display transform. Default: clamp + gamma 2.2 (linear radiance looks
    right in a PNG viewer). ``linear=True`` is the exact reference display
    transform — clamp only: the reference presents clamped *linear*
    radiance into an R8G8B8A8_UNORM target with no gamma
    (RefractionDemo.cpp:430, copy to backbuffer at :596-604), so a
    ``--linear`` PNG is pixel-comparable to the reference's window."""
    clamped = np.clip(np.asarray(img), 0.0, 1.0)
    return clamped if linear else clamped ** (1.0 / 2.2)


def build_config(args) -> RenderConfig:
    if args.baseline:
        cfg = baseline_config(args.baseline)
    else:
        cfg = RenderConfig()
    overrides = {}
    if args.scene:
        path = args.scene
        if not os.path.exists(path):
            path = os.path.join(DEFAULT_ASSET_DIR, args.scene)
        overrides["scene_path"] = path
    if args.envmap:
        overrides["envmap_path"] = args.envmap
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.bounces is not None:
        overrides["max_refract_depth"] = args.bounces
    if args.spp:
        overrides["spp"] = args.spp
    if args.backend:
        overrides["backend"] = args.backend
    if args.ior is not None:
        overrides["ior"] = args.ior
    if args.aspect is not None:
        overrides["aspect"] = args.aspect
    return cfg.replace(**overrides) if overrides else cfg


def main(argv=None, stats: FrameStats | None = None) -> int:
    """Run the CLI. ``stats`` (optional) receives every frame's time, so
    an in-process caller can read them back."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", help="OBJ path (or name under the asset dir)")
    p.add_argument("--envmap", help="HDR/PNG environment map path")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--bounces", type=int, help="max refraction depth (ref: 5)")
    p.add_argument("--spp", type=int, help="supersamples per pixel")
    p.add_argument("--ior", type=float, help="index of refraction (ref: 1.3)")
    p.add_argument("--aspect", type=float,
                   help="camera aspect override (default: width/height;"
                        " the reference's literal 1.333 at 1024x768)")
    p.add_argument("--mtl-ior", action="store_true",
                   help="take the IOR from the scene's .mtl Ni (the"
                        " reference ships ott.mtl Ni=1.45 but ignores it)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler trace of one frame to DIR")
    p.add_argument("--backend", choices=["auto", "xla", "pallas"])
    p.add_argument("--baseline", type=int, choices=[1, 2, 3, 4, 5],
                   help="start from a staged config (config.baseline_config)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--angle", type=float, default=0.01,
                   help="initial orbit angle (ref: 0.01)")
    p.add_argument("--out", default="frame.png",
                   help="output PNG path, or a directory/prefix for --frames>1")
    p.add_argument("--accumulate", action="store_true",
                   help="average all frames into one image (progressive mode)")
    p.add_argument("--resume", help="resume an --accumulate render from a .npz")
    p.add_argument("--raw", action="store_true",
                   help="also save linear radiance .npy (per frame when"
                        " --frames>1 without --accumulate)")
    p.add_argument("--linear", action="store_true",
                   help="display transform = clamp only (no gamma): the"
                        " reference's exact UNORM present"
                        " (RefractionDemo.cpp:430,596-604). Default adds"
                        " gamma 2.2 for PNG viewing")
    p.add_argument("--instances", metavar="SPEC.json",
                   help="render N placed copies of meshes (TLAS-with-N-"
                        "instances): JSON list of {obj, translate, scale,"
                        " rotate_y_deg, mask} or {obj, transform: 3x4}")
    p.add_argument("--heatmap", metavar="PATH.png",
                   help="render ONE per-pixel ray-count heatmap (bounce "
                        "cost map) to PATH.png and exit (diagnostic; "
                        "uses the XLA wavefront path)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the frame over N local devices (pixel data"
                        " parallelism; 0 = single device): each device"
                        " renders a round-robin slice of the image")
    p.add_argument("--serve", type=int, metavar="PORT",
                   help="serve the orbit live over HTTP (the reference's"
                        " window, headless): open http://HOST:PORT/ in a"
                        " browser while frames render")
    args = p.parse_args(argv)

    setup_logging()
    out_dir = os.path.dirname(args.out)
    if out_dir:  # --out help: "or a directory/prefix for --frames>1"
        os.makedirs(out_dir, exist_ok=True)
    cfg = build_config(args)

    import jax

    from refraction.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    log.info("scene=%s envmap=%s %dx%d bounces=%d spp=%d backend=%s device=%s",
             cfg.scene_path, cfg.envmap_path, cfg.width, cfg.height,
             cfg.max_refract_depth, cfg.spp, cfg.backend, jax.devices()[0])

    if args.mtl_ior:
        from refraction.io.mtl import ior_for_scene

        ior_src = cfg.scene_path
        if args.instances:
            # --mtl-ior applies to the scene actually rendered: take Ni
            # from the FIRST instance's .mtl (paths resolve like
            # scene.load_instanced: as given, else under the asset dir).
            import json as _json

            with open(args.instances) as f:
                spec = _json.load(f)
            if isinstance(spec, dict):
                spec = spec["instances"]
            if spec:
                ior_src = spec[0]["obj"]
                if not os.path.exists(ior_src):
                    ior_src = os.path.join(
                        os.path.dirname(cfg.scene_path), spec[0]["obj"])
        cfg = cfg.replace(ior=ior_for_scene(ior_src, cfg.ior))
        log.info("IOR from MTL (%s): %.4g", ior_src, cfg.ior)

    if args.instances:
        scene, meta = load_instanced(args.instances, cfg)
    else:
        scene, meta = load_scene(cfg)
    log.info("tris=%d (padded %d), clusters=%d, envmap=%s",
             meta.num_real_tris, meta.num_padded_tris,
             scene.num_clusters, scene.envmap.shape)
    scene = scene_to_device(scene)

    if args.heatmap:
        from refraction.render import heatmap_to_rgb, render_heatmap

        counts = render_heatmap(scene, cfg, angle=args.angle)
        write_png(args.heatmap, heatmap_to_rgb(counts))
        log.info("heatmap: max %d rays/pixel, mean %.2f -> %s",
                 int(counts.max()), float(counts.mean()), args.heatmap)
        return 0

    if args.devices and args.devices > 1:
        from refraction.parallel.sharding import (
            make_mesh, make_sharded_renderer)

        if len(jax.devices()) < args.devices:
            p.error(f"--devices {args.devices}: only "
                    f"{len(jax.devices())} devices visible "
                    f"({jax.devices()})")
        renderer = make_sharded_renderer(cfg, make_mesh(args.devices))
        log.info("pixel-DP over %d devices", args.devices)
    else:
        renderer = make_renderer(cfg)

    acc = None
    if args.accumulate:
        acc = Accumulator.load(args.resume) if args.resume else Accumulator(
            cfg.height, cfg.width)

    if stats is None:
        stats = FrameStats()
    angle = args.angle
    pending = None  # (device_image, frame_index) — pipelined previous frame

    import jax.numpy as jnp

    @jax.jit
    def _to_u8(img):
        # Device-side display transform: quarters the host transfer (the
        # equivalent of the reference's R8G8B8A8_UNORM render target,
        # RefractionDemo.cpp:430). --linear drops the gamma lift: clamp
        # only, the reference's exact UNORM present.
        disp = jnp.clip(img, 0.0, 1.0)
        if not args.linear:
            disp = disp ** jnp.float32(1.0 / 2.2)
        return (disp * 255.0 + 0.5).astype(jnp.uint8)

    serve = None
    if args.serve is not None:
        from refraction.viewer import FrameServer

        serve = FrameServer(port=args.serve)
        log.info("live viewer at http://0.0.0.0:%d/", serve.port)

    def drain(entry):
        img_dev, idx = entry
        if serve is not None:
            serve.publish(np.asarray(_to_u8(img_dev)),
                          {"frame": idx, "fps": round(stats.fps, 2)})
        if acc is not None or args.frames == 1:
            host = np.asarray(img_dev)  # full radiance needed on host
            if acc is not None:
                acc.add(host)
            return host
        if serve is not None and not args.raw:
            return None  # live view only: no per-frame files unless the
            #               user explicitly asked for them (--raw)
        # --frames>1 without --accumulate: per-frame outputs.
        base, ext = os.path.splitext(args.out)
        write_png(f"{base}_{idx:04d}{ext or '.png'}",
                  np.asarray(_to_u8(img_dev)))
        if args.raw:
            np.save(f"{base}_{idx:04d}.npy", np.asarray(img_dev))
        return None

    if args.profile:
        import jax as _jax

        renderer(scene, orbit_camera(angle, cfg)).block_until_ready()
        with _jax.profiler.trace(args.profile):
            renderer(scene, orbit_camera(angle, cfg)).block_until_ready()
        log.info("profiler trace written to %s", args.profile)

    host_img = None
    # --frames 0 = endless orbit (the reference's WinMain message pump,
    # WinMain.cpp:46-59) — used with --serve for live viewing; stops on
    # SIGINT/SIGTERM.
    frame_iter = range(args.frames) if args.frames else itertools.count()
    try:
        for i in frame_iter:
            stats.start()
            img = renderer(scene, orbit_camera(angle, cfg))
            if pending is not None:
                host_img = drain(pending)  # overlap: drain N-1 while N runs
            pending = (img, i)
            img.block_until_ready()
            stats.stop()
            if i % 10 == 0 or i == args.frames - 1:
                log.info("%s", stats.line())
            angle += cfg.orbit_speed    # RefractionDemo.cpp:567
    except KeyboardInterrupt:
        log.info("interrupted after %d frames", stats.frames)

    if pending is not None:
        host_img = drain(pending)

    final = acc.image if acc is not None else host_img
    if acc is not None and args.frames > 1:
        log.info("accumulated %d frames", acc.count)
        acc.save(os.path.splitext(args.out)[0] + "_state.npz")
    if (args.frames == 1 or acc is not None) and final is not None:
        write_png(args.out if args.out.endswith(".png") else args.out + ".png",
                  tonemap(final, linear=args.linear))
    if args.raw and final is not None:
        np.save(os.path.splitext(args.out)[0] + ".npy", final)
    log.info("done: %d frames, %.2f fps avg -> %s", stats.frames, stats.fps,
             args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
