"""CPU rehearsal of chip_smoke.py at a tiny size: every phase runs with
the Pallas interpreter (the script itself refuses to run without a GPU)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from refraction.io.objmesh import parse_obj
from refraction.io.texture import load_texture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("smoke"))
    paths = cs.make_assets(out, cs.TINY)
    cfgs = cs.configs(paths, cs.TINY)
    return out, paths, cfgs, {k: cs.load(c)[0] for k, c in cfgs.items()}


def test_assets_are_generated(tiny):
    _, paths, _, _ = tiny
    assert parse_obj(paths["demo"]).num_tris == 100
    assert parse_obj(paths["stress"]).num_tris == 180
    env = load_texture(paths["envmap"])
    assert env.shape == (*cs.TINY.envmap, 3) and env.max() > 0


def test_full_size_stand_ins():
    """The full-size stand-ins have the triangle counts the docs state."""
    from refraction.io.primitives import make_nested_shell

    assert make_nested_shell(cs.FULL.demo_layers).num_tris == 1600
    assert make_nested_shell(cs.FULL.stress_layers).num_tris == 11520


@pytest.mark.parametrize("label", ["demo", "stress"])
def test_kernel_phase(tiny, label):
    _, _, cfgs, scenes = tiny
    r = cs.phase_kernel(scenes[label], cfgs[label], True, label)
    assert r["agree"] == 1.0 and r["t_rel"] <= cs.T_REL_MAX


def test_frames_phase(tiny):
    _, _, cfgs, scenes = tiny
    r = cs.phase_frames(scenes["demo"], cfgs["demo"], cs.TINY, True, "demo")
    assert set(r) == {"xla", "pallas"} and all(v > 0 for v in r.values())


def test_oracle_phase(tiny):
    _, paths, _, _ = tiny
    assert cs.phase_oracle(paths, cs.TINY, True) <= cs.ORACLE_RMSE_MAX


def test_cli_phase(tiny):
    out, paths, _, _ = tiny
    r = cs.phase_cli(paths, cs.TINY, True, out)
    assert set(r) == {"demo", "stress"}


def test_multi_phase(tiny):
    """Pixel-DP, sample-SP and triangle-TP on 4 of the 8 virtual devices."""
    _, paths, _, _ = tiny
    cs.phase_multi(paths, cs.TINY, True, 4)


def test_check_fails_loudly():
    with pytest.raises(AssertionError, match="x: y"):
        cs.check("x", False, "y")


def test_unknown_phase_rejected():
    with pytest.raises(SystemExit):
        cs.main(["--phases", "kernel,no-such-phase"])


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_lone_script_fails(tmp_path):
    """Copied alone into an empty directory, the script fails and prints
    no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
