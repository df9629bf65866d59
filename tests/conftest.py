"""Test harness config: an 8-device virtual CPU platform by default.

The fast and slow tiers run on the CPU (``JAX_PLATFORMS=cpu``); sharding
tests use the standard JAX trick of faking an 8-device mesh on CPU
(SURVEY.md 4, "multi-chip without a cluster"). Must run before jax
initializes, hence the env mutation at import. Tests marked ``gpu`` need
a card; the ``gpu`` fixture skips them elsewhere. On the card run them
with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` (or through
``python chip_smoke.py``, which runs them in its own process).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from refraction.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: the integrator's unrolled wavefront takes
# minutes to compile cold on XLA:CPU; cached reruns take seconds.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from refraction.config import RenderConfig  # noqa: E402
from refraction.io.objmesh import MeshData, write_obj  # noqa: E402
from refraction.io.png import write_png  # noqa: E402
from refraction.io.primitives import (  # noqa: E402
    make_cube,
    make_gradient_envmap,
    make_icosphere,
    make_nested_shell,
    make_seeded_envmap,
)
from refraction.scene import build_scene  # noqa: E402

# Generated stand-ins under the reference's asset names (the reference's
# own OBJ/PNG files are not part of this repository).
STRESS_LAYERS = ((4, 1.2), (4, 1.0), (3, 0.6))


def _monkey_standin() -> MeshData:
    m = make_icosphere(subdiv=2, radius=1.0)
    scale = np.asarray([1.1, 0.8, 0.9], np.float32)
    return MeshData(m.positions * scale, m.normals / scale, m.uvs)


@pytest.fixture(scope="session")
def asset_dir(tmp_path_factory):
    """A directory of generated assets named like the reference's:
    cube/sphere/monkey/shell/ott.obj and envmap.png."""
    d = tmp_path_factory.mktemp("assets")
    meshes = {
        "cube.obj": make_cube(1.0),
        "sphere.obj": make_icosphere(subdiv=2, radius=1.0),
        "monkey.obj": _monkey_standin(),
        "shell.obj": make_nested_shell(),
        "ott.obj": make_nested_shell(STRESS_LAYERS),
    }
    for name, mesh in meshes.items():
        write_obj(str(d / name), mesh)
    env = make_seeded_envmap(64, 128, seed=7)
    write_png(str(d / "envmap.png"), (env * 255.0 + 0.5).astype(np.uint8))
    return str(d)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu` on the card, or `python chip_smoke.py`")


@pytest.fixture(scope="session")
def cube_scene():
    scene, meta = build_scene(make_cube(2.0), make_gradient_envmap(), cluster_size=8)
    return scene, meta


@pytest.fixture(scope="session")
def sphere_scene():
    scene, meta = build_scene(
        make_icosphere(subdiv=2, radius=1.2), make_gradient_envmap(), cluster_size=32
    )
    return scene, meta


@pytest.fixture(scope="session")
def small_cfg():
    return RenderConfig(width=64, height=48)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))
