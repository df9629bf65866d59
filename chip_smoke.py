#!/usr/bin/env python
"""Smoke test of the renderer on one GPU, end to end, at the demo's size.

    python chip_smoke.py                 # one card: every phase below
    python chip_smoke.py --devices 4     # four cards: the multi-card phase

It generates its scenes from a fixed seed (``io/primitives.py``), writes
them as OBJ/PNG under ``--out``, and drives the main path through the
entry points a user calls: ``make_renderer`` -> ``render_pixels`` and
``python -m refraction.run`` (``run.main`` in-process).

- *demo*: a 1,600-triangle nested dielectric shell (the stand-in for the
  reference's 1,536-triangle ``shell.obj``) at 1024x768, refraction depth
  5, reflection depth 2, IOR 1.3, orbit camera, 512x1024 envmap;
- *stress*: an 11,520-triangle three-layer shell (the stand-in for the
  12,877-triangle ``ott.obj``) at 1920x1080, 5 bounces.

Phases (each takes the sizes and an ``interpret`` flag, so a CPU test can
rehearse them at a tiny size with the Pallas interpreter):

1. ``kernel``: the intersection kernel compiled at both sizes, and
   compared with ``xla_intersect`` on the live lanes of every wavefront
   round of each frame.
2. ``frames``: full frames through ``make_renderer`` with the XLA and the
   kernel backend in turns (xla, kernel, kernel, xla): compile seconds,
   ``memory_analysis()``, median frame time, and the two images compared.
3. ``oracle``: a 128x96 demo frame on the kernel path against the NumPy
   oracle.
4. ``cli``: both stand-ins through ``run.main``.
5. ``gpu_tests``: the ``gpu``-marked tests, in this process.

``--devices 4`` runs only pixel-DP, sample-SP and triangle-TP across four
cards, each against the same work on one card.

Every comparison prints its tolerance. Any failed phase fails the run.
The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed. Without a GPU the script
exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20240611


@dataclasses.dataclass(frozen=True)
class Sizes:
    demo: tuple[int, int] = (1024, 768)              # width, height
    stress: tuple[int, int] = (1920, 1080)
    envmap: tuple[int, int] = (512, 1024)            # height, width
    demo_layers: tuple = ((3, 1.2), (2, 0.9))        # 1,600 triangles
    stress_layers: tuple = ((4, 1.2), (4, 1.0), (3, 0.6))  # 11,520
    oracle: tuple[int, int] = (128, 96)
    frames: int = 10
    big_subdiv: int = 6                              # 81,920 triangles
    tp_rays: int = 1 << 18


FULL = Sizes()
TINY = Sizes(demo=(32, 24), stress=(48, 32), envmap=(32, 64),
             demo_layers=((1, 1.2), (0, 0.9)),
             stress_layers=((1, 1.2), (1, 1.0), (0, 0.6)),
             oracle=(16, 12), frames=2, big_subdiv=2, tp_rays=512)

# Tolerances (reasons in PERF.md, "Correctness on the card").
HIT_AGREE_MIN = 0.9999   # live lanes whose hit and winner agree
T_REL_MAX = 1e-5         # |dt| / max(1, t) where both hit the same triangle
IMG_RMSE_MAX = 1e-4      # linear radiance, kernel frame vs XLA frame
IMG_PIXEL_TOL = 1e-3     # per-pixel max abs difference ...
IMG_PIXEL_SHARE = 0.999  # ... met by at least this share of pixels
ORACLE_RMSE_MAX = 1e-4   # card vs NumPy oracle
MULTI_ATOL = 2e-6        # several cards vs one card, per value


def say(*parts) -> None:
    print(*parts, flush=True)


def gpu_name_and_power() -> str:
    """The card's name and power limit, from a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def rmse(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def check(name: str, ok: bool, detail: str) -> None:
    say(f"  {'PASS' if ok else 'FAIL'} {name}: {detail}")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


# --------------------------------------------------------------- assets ---

def make_assets(out_dir: str, sizes: Sizes, seed: int = SEED) -> dict:
    """Write the demo and stress stand-ins and the envmap; returns paths."""
    from refraction.io.objmesh import write_obj
    from refraction.io.png import write_png
    from refraction.io.primitives import (
        make_nested_shell, make_seeded_envmap)

    os.makedirs(out_dir, exist_ok=True)
    paths = {"demo": os.path.join(out_dir, "demo_shell.obj"),
             "stress": os.path.join(out_dir, "stress_shell.obj"),
             "envmap": os.path.join(out_dir, "envmap.png")}
    write_obj(paths["demo"], make_nested_shell(sizes.demo_layers))
    write_obj(paths["stress"], make_nested_shell(sizes.stress_layers))
    env = make_seeded_envmap(*sizes.envmap, seed=seed)
    write_png(paths["envmap"], (env * 255.0 + 0.5).astype(np.uint8))
    return paths


def load(cfg):
    from refraction.scene import load_scene, scene_to_device

    scene, meta = load_scene(cfg)
    return scene_to_device(scene), meta


def configs(paths: dict, sizes: Sizes):
    from refraction.config import RenderConfig

    base = RenderConfig(envmap_path=paths["envmap"])  # demo caps, IOR 1.3
    demo = base.replace(width=sizes.demo[0], height=sizes.demo[1],
                        scene_path=paths["demo"])
    stress = base.replace(width=sizes.stress[0], height=sizes.stress[1],
                          scene_path=paths["stress"])
    return {"demo": demo, "stress": stress}


def kernel_backend(interpret: bool):
    from refraction.ops.backends import get_backend

    return get_backend("pallas", interpret=interpret)


# --------------------------------------------------------------- phases ---

def phase_kernel(scene, cfg, interpret: bool, label: str) -> dict:
    """Kernel vs ``xla_intersect`` on the live lanes of every round of
    one frame (the XLA result drives the wavefront)."""
    import jax
    import jax.numpy as jnp

    from refraction.camera import CameraFrame, orbit_camera
    from refraction.integrator import render_pixels
    from refraction.ops.backends import xla_intersect
    from refraction.render import tiled_primary_rays

    kernel = kernel_backend(interpret).intersect
    rounds = []

    def both(scene, o, d, wf, alive, tmin, tmax):
        hx, tx, ix, _ = xla_intersect(scene, o, d, wf, alive, tmin, tmax)
        hk, tk, ik, _ = kernel(scene, o, d, wf, alive, tmin, tmax)
        hx = hx & alive
        agree = (hk == hx) & (~hx | (ik == ix))
        same = hk & hx & (ik == ix)
        rel = jnp.where(same, jnp.abs(tk - tx)
                        / jnp.maximum(1.0, jnp.abs(tx)), 0.0)
        rounds.append(jnp.stack([
            jnp.sum(alive).astype(jnp.float32),
            jnp.sum(alive & ~agree).astype(jnp.float32),
            jnp.max(rel)]))
        return hx, tx, ix, None

    @jax.jit
    def run(scene, proj_inv, origin):
        rounds.clear()
        o, d = tiled_primary_rays(CameraFrame(origin, proj_inv), cfg)
        render_pixels(scene, o, d, cfg, both)
        return jnp.stack(rounds)

    frame = orbit_camera(0.01, cfg)
    args = (scene, jnp.asarray(frame.proj_inv), jnp.asarray(frame.origin))
    t0 = time.perf_counter()
    compiled = run.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    stats = np.asarray(compiled(*args))
    live, bad, worst = stats[:, 0], stats[:, 1], stats[:, 2]
    say(f"[kernel {label}] {cfg.width}x{cfg.height}, {scene.num_tris} tris, "
        f"compile (xla+kernel comparison program) {compile_s:.2f} s; "
        f"{memory_line(compiled)}")
    for k, (n, b, w) in enumerate(stats):
        say(f"  round {k}: live {int(n)}, disagree {int(b)}, "
            f"max |dt|/max(1,t) {w:.3e}")
    share = 1.0 - float(bad.sum()) / max(float(live.sum()), 1.0)
    check(f"kernel {label} hit+winner agreement", share >= HIT_AGREE_MIN,
          f"{share:.6f} of {int(live.sum())} live lanes "
          f"(need >= {HIT_AGREE_MIN})")
    check(f"kernel {label} t", float(worst.max()) <= T_REL_MAX,
          f"max |dt|/max(1,t) {float(worst.max()):.3e} (need <= {T_REL_MAX})")
    return {"compile_s": compile_s, "agree": share,
            "t_rel": float(worst.max())}


def _compile_renderer(render, scene, cfg):
    import jax.numpy as jnp

    from refraction.camera import orbit_camera

    frame = orbit_camera(0.01, cfg)
    args = (scene, jnp.asarray(frame.proj_inv), jnp.asarray(frame.origin))
    t0 = time.perf_counter()
    lowered = render.jitted.lower(*args)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    return compiled, t1 - t0, t2 - t1


def _time_frames(compiled, scene, cfg, n: int):
    """Median of ``n`` orbit frames, each ended by block_until_ready."""
    import jax.numpy as jnp

    from refraction.camera import orbit_camera

    frames = [orbit_camera(0.01 + cfg.orbit_speed * k, cfg)
              for k in range(n)]
    args = [(jnp.asarray(f.proj_inv), jnp.asarray(f.origin)) for f in frames]
    compiled(scene, *args[0]).block_until_ready()  # warm
    times = []
    for a in args:
        t0 = time.perf_counter()
        compiled(scene, *a).block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(m, f, 0) / 2**20:.1f} MiB"
        for f in fields)


def phase_frames(scene, cfg, sizes: Sizes, interpret: bool, label: str,
                 backends=("xla", "pallas")) -> dict:
    """Full frames through make_renderer, backends in turns (a, b, b, a)."""
    from refraction.camera import orbit_camera
    from refraction.ops.backends import get_backend
    from refraction.render import make_renderer

    compiled = {}
    for name in backends:
        b = get_backend(name, interpret=interpret)
        render = make_renderer(cfg, b.intersect)
        compiled[name], lower_s, compile_s = _compile_renderer(
            render, scene, cfg)
        say(f"[frames {label}] {name}: {cfg.width}x{cfg.height} "
            f"{scene.num_tris} tris, trace+lower {lower_s:.2f} s, "
            f"compile {compile_s:.2f} s; {memory_line(compiled[name])}")
    order = list(backends) + list(reversed(backends))
    medians = {name: [] for name in backends}
    for name in order:
        med, times = _time_frames(compiled[name], scene, cfg, sizes.frames)
        medians[name].append(med)
        say(f"[frames {label}] {name}: median {med * 1e3:.3f} ms over "
            f"{len(times)} frames (min {min(times) * 1e3:.3f}, max "
            f"{max(times) * 1e3:.3f})")
    import jax.numpy as jnp

    frame = orbit_camera(0.01, cfg)
    args = (scene, jnp.asarray(frame.proj_inv), jnp.asarray(frame.origin))
    imgs = {name: np.asarray(c(*args)) for name, c in compiled.items()}
    for name, img in imgs.items():
        check(f"frame {label} {name} finite",
              img.shape == (cfg.height, cfg.width, 3)
              and bool(np.isfinite(img).all()) and float(img.max()) > 0,
              f"shape {img.shape}, max {float(img.max()):.4f}")
    if len(backends) == 2:
        a, b = (imgs[n] for n in backends)
        err = rmse(a, b)
        close = float(np.mean(np.abs(a - b).max(axis=-1) <= IMG_PIXEL_TOL))
        check(f"frame {label} {backends[1]} vs {backends[0]} RMSE",
              err <= IMG_RMSE_MAX, f"{err:.3e} (need <= {IMG_RMSE_MAX})")
        check(f"frame {label} pixels within {IMG_PIXEL_TOL}",
              close >= IMG_PIXEL_SHARE,
              f"{close:.6f} (need >= {IMG_PIXEL_SHARE})")
    return {name: statistics.median(v) for name, v in medians.items()}


def phase_oracle(paths: dict, sizes: Sizes, interpret: bool) -> float:
    """The kernel path at ``sizes.oracle`` on the demo stand-in against
    the NumPy oracle."""
    from oracle.numpy_tracer import render_oracle
    from refraction.render import render_frame

    from refraction.scene import load_scene, scene_to_device

    cfg = configs(paths, sizes)["demo"].replace(
        width=sizes.oracle[0], height=sizes.oracle[1])
    scene, _ = load_scene(cfg)
    b = kernel_backend(interpret)
    img = np.asarray(render_frame(scene_to_device(scene), cfg, angle=0.35,
                                  intersect_fn=b.intersect))
    ref = render_oracle(scene, cfg, angle=0.35)
    err = rmse(img, ref)
    diff = np.abs(img - ref).max(axis=-1)
    worst = np.argsort(diff.reshape(-1))[::-1][:5]
    say("[oracle] worst pixels (y, x, max abs diff): " + ", ".join(
        f"({i // cfg.width}, {i % cfg.width}, {diff.reshape(-1)[i]:.2e})"
        for i in worst))
    check("oracle RMSE", err <= ORACLE_RMSE_MAX,
          f"{err:.3e} at {cfg.width}x{cfg.height} "
          f"(need <= {ORACLE_RMSE_MAX})")
    return err


def phase_cli(paths: dict, sizes: Sizes, interpret: bool,
              out_dir: str) -> dict:
    """Both stand-ins through ``run.main``. The CLI has no interpreter, so
    a rehearsal (``interpret``) drives it with the XLA backend."""
    from refraction import run
    from refraction.io.png import load_png
    from refraction.utils.stats import FrameStats

    backend = "xla" if interpret else "pallas"
    out = {}
    for label, (w, h) in (("demo", sizes.demo), ("stress", sizes.stress)):
        png = os.path.join(out_dir, f"cli_{label}.png")
        stats = FrameStats(window=sizes.frames + 1)
        t0 = time.perf_counter()
        rc = run.main(["--scene", paths[label], "--envmap", paths["envmap"],
                       "--width", str(w), "--height", str(h),
                       "--bounces", "5", "--backend", backend,
                       "--frames", str(sizes.frames + 1), "--accumulate",
                       "--out", png], stats=stats)
        wall = time.perf_counter() - t0
        check(f"cli {label} exit code", rc == 0, str(rc))
        img = load_png(png)
        check(f"cli {label} image", img.shape[:2] == (h, w)
              and int(img.max()) > 0, f"{png} shape {img.shape}")
        med = statistics.median(stats.times[1:])
        say(f"[cli {label}] {w}x{h}, backend {backend}: first frame "
            f"(compile included) {stats.times[0]:.2f} s, median "
            f"{med * 1e3:.3f} ms over {len(stats.times) - 1} frames, "
            f"run.main wall {wall:.2f} s")
        out[label] = med
    return out


def phase_gpu_tests() -> None:
    """The ``gpu``-marked tests, run in this process (one process per
    card)."""
    import pytest

    rc = pytest.main([os.path.join(HERE, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    check("gpu-marked tests", rc == 0, f"pytest exit code {rc}")


def phase_big(sizes: Sizes, interpret: bool, envmap_path: str) -> dict:
    """1080p 4-bounce frames of the 81,920-triangle icosphere through the
    kernel (a brute-force frame would take over a minute on an H100:
    PERF.md). Not a default phase."""
    from refraction.config import RenderConfig
    from refraction.io.primitives import make_icosphere
    from refraction.io.texture import load_texture
    from refraction.scene import build_scene, scene_to_device

    scene, _ = build_scene(make_icosphere(sizes.big_subdiv, 1.2),
                           load_texture(envmap_path))
    cfg = RenderConfig(width=sizes.stress[0], height=sizes.stress[1],
                       max_refract_depth=4)
    return phase_frames(scene_to_device(scene), cfg, sizes, interpret,
                        "big", backends=("pallas",))


# ------------------------------------------------------------ multi-card ---

def _median_ms(render, scene, cfg, n: int) -> float:
    from refraction.camera import orbit_camera

    times = []
    for k in range(n):
        frame = orbit_camera(0.3 + cfg.orbit_speed * k, cfg)
        t0 = time.perf_counter()
        render(scene, frame).block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_multi(paths: dict, sizes: Sizes, interpret: bool,
                ndev: int) -> None:
    """Pixel-DP, sample-SP and triangle-TP over ``ndev`` devices, each
    against the same work on one device."""
    import jax
    import jax.numpy as jnp

    from refraction.camera import orbit_camera
    from refraction.io.primitives import make_icosphere
    from refraction.io.texture import load_texture
    from refraction.ops.backends import xla_intersect
    from refraction.parallel.sharding import (
        make_mesh, make_mesh2d, make_sample_sharded_renderer,
        make_sharded_renderer, make_trisharded_intersect)
    from refraction.render import make_renderer
    from refraction.scene import build_scene, scene_to_device

    if len(jax.devices()) < ndev:
        raise RuntimeError(f"need {ndev} devices, have {jax.devices()}")
    b = kernel_backend(interpret)
    cfg = configs(paths, sizes)["stress"]
    scene, _ = load(cfg)

    def one_vs_many(label, cfg, many, exact: bool):
        frame = orbit_camera(0.3, cfg)
        one = make_renderer(cfg, b.intersect)
        t0 = time.perf_counter()
        ref = np.asarray(one(scene, frame))
        t1 = time.perf_counter()
        got = np.asarray(many(scene, frame))
        t2 = time.perf_counter()
        diff = np.abs(got - ref).max(axis=-1)
        say(f"[{label}] {cfg.width}x{cfg.height} spp {cfg.spp} over {ndev} "
            f"devices; first calls (compile included): one {t1 - t0:.2f} s, "
            f"{ndev} {t2 - t1:.2f} s; median of {sizes.frames} frames: one "
            f"{_median_ms(one, scene, cfg, sizes.frames):.3f} ms, {ndev} "
            f"{_median_ms(many, scene, cfg, sizes.frames):.3f} ms; "
            f"{int((diff > MULTI_ATOL).sum())} of {diff.size} pixels differ "
            f"by more than {MULTI_ATOL}")
        if exact:
            check(f"{label} vs one device", float(diff.max()) <= MULTI_ATOL,
                  f"max abs diff {float(diff.max()):.3e} "
                  f"(need <= {MULTI_ATOL})")
            return
        err = rmse(got, ref)
        close = float(np.mean(diff <= IMG_PIXEL_TOL))
        check(f"{label} vs one device RMSE", err <= IMG_RMSE_MAX,
              f"{err:.3e} (need <= {IMG_RMSE_MAX})")
        check(f"{label} vs one device pixels within {IMG_PIXEL_TOL}",
              close >= IMG_PIXEL_SHARE,
              f"{close:.6f} (need >= {IMG_PIXEL_SHARE})")

    # Pixel-DP traces the same rays per pixel as one device: held to
    # MULTI_ATOL. Sample-SP builds its rays in another program (stacked
    # samples), where the GPU compiler may contract other multiply-adds,
    # so an ulp in a ray direction can flip a grazing hit: held to the
    # frame bounds.
    one_vs_many("pixel-DP", cfg, make_sharded_renderer(
        cfg, make_mesh(ndev), b.intersect), exact=True)
    cfg4 = cfg.replace(spp=4)
    one_vs_many("sample-SP", cfg4, make_sample_sharded_renderer(
        cfg4, make_mesh2d(ndev, sample_devs=2), b.intersect), exact=False)

    big, _ = build_scene(make_icosphere(sizes.big_subdiv, 1.2),
                         load_texture(paths["envmap"]), cluster_size=ndev * 8)
    big = scene_to_device(big)
    rng = np.random.default_rng(SEED)
    n = sizes.tp_rays
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-3.0 * d + 0.5 * rng.normal(size=(n, 3))).astype(np.float32)
    wf = jnp.asarray(rng.random(n) < 0.5)
    live = jnp.ones(n, bool)
    lim = (jnp.float32(1e-4), jnp.float32(100.0))
    tp = make_trisharded_intersect(make_mesh(ndev))
    got = jax.jit(lambda s, o, d: tp(s, o, d, wf, live, *lim)[:3])(
        big, jnp.asarray(o), jnp.asarray(d))
    ref = jax.jit(lambda s, o, d: xla_intersect(s, o, d, wf, live, *lim)[:3])(
        big, jnp.asarray(o), jnp.asarray(d))
    (hg, tg, ig), (hr, tr, ir) = ([np.asarray(x) for x in r]
                                  for r in (got, ref))
    m = hg & hr
    err = float(np.abs(tg[m] - tr[m]).max()) if m.any() else 0.0
    say(f"[triangle-TP] {big.num_tris} tris over {ndev} devices, {n} rays, "
        f"{int(hr.sum())} hits")
    check("triangle-TP vs one-device xla_intersect",
          bool((hg == hr).all() and (ig[m] == ir[m]).all())
          and err <= MULTI_ATOL,
          f"hits and winners equal, max |dt| {err:.3e} "
          f"(need <= {MULTI_ATOL})")


# ------------------------------------------------------------------ main ---

ALL_PHASES = ("kernel", "frames", "oracle", "cli", "gpu_tests")


def run_single(paths: dict, sizes: Sizes, interpret: bool, out_dir: str,
               phases=ALL_PHASES) -> dict:
    results = {}
    cfgs = configs(paths, sizes)
    scenes = {k: load(c)[0] for k, c in cfgs.items()}
    if "kernel" in phases:
        for label in ("demo", "stress"):
            results[f"kernel_{label}"] = phase_kernel(
                scenes[label], cfgs[label], interpret, label)
    if "frames" in phases:
        for label in ("demo", "stress"):
            results[f"frames_{label}"] = phase_frames(
                scenes[label], cfgs[label], sizes, interpret, label)
    if "big" in phases:
        results["frames_big"] = phase_big(sizes, interpret, paths["envmap"])
    if "oracle" in phases:
        results["oracle_rmse"] = phase_oracle(paths, sizes, interpret)
    if "cli" in phases:
        results["cli"] = phase_cli(paths, sizes, interpret, out_dir)
    if "gpu_tests" in phases:
        phase_gpu_tests()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the multi-card phase")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke"),
                    help="directory for the generated assets and images")
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of "
                         f"{', '.join(ALL_PHASES + ('big',))}")
    args = ap.parse_args(argv)
    phases = tuple(p for p in args.phases.split(",") if p)
    unknown = set(phases) - set(ALL_PHASES + ("big",))
    if unknown:
        ap.error(f"unknown phases: {', '.join(sorted(unknown))}")

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (devices: {devs})", file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: --devices {args.devices} but only {len(devs)} "
              "visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from refraction.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    say(f"jax {jax.__version__}, devices: {devs}")
    paths = make_assets(args.out, FULL)
    if args.devices > 1:
        phase_multi(paths, FULL, False, args.devices)
    else:
        run_single(paths, FULL, False, args.out, phases)
    say(f"nvidia-smi: {gpu_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.devices}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
