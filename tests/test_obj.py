"""OBJ parser unit tests (reference semantics: Mesh.cpp:6-37)."""

import os

import numpy as np
import pytest

from refraction.io.objmesh import parse_obj, parse_obj_text

REF_DIR = "/root/reference"

SIMPLE = """
# comment
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 1
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
vn 0 1 0
f 1/1/1 2/2/1 3/3/1
f 1/1/2 2/2/2 3/3/2 4/1/1
f 1/1 2/2 3/3
f 1//1 2//1 3//1
o name
s off
usemtl whatever
"""


def test_parse_simple():
    m = parse_obj_text(SIMPLE)
    # face 1: full v/vt/vn triangle -> kept
    # face 2: quad -> sscanf matches first 9 ints -> first 3 corners kept
    # face 3: v/vt only -> sscanf mismatch -> skipped
    # face 4: v//vn -> sscanf mismatch -> skipped
    assert m.num_tris == 2
    assert m.num_verts == 6
    np.testing.assert_allclose(m.positions[0, 1], [1, 0, 0])
    np.testing.assert_allclose(m.normals[0, 0], [0, 0, 1])
    np.testing.assert_allclose(m.normals[1, 0], [0, 1, 0])
    np.testing.assert_allclose(m.uvs[0, 2], [0, 1])
    flat = m.flat_vertices()
    assert flat.shape == (6, 8)
    np.testing.assert_allclose(flat[1, :3], [1, 0, 0])


def test_parse_empty_and_garbage():
    assert parse_obj_text("").num_tris == 0
    assert parse_obj_text("f 1/1/1 2/2/2 9/9/9\nv 0 0 0").num_tris == 0  # OOB skipped


@pytest.mark.skipif(not os.path.exists(os.path.join(REF_DIR, "cube.obj")),
                    reason="reference assets not mounted")
def test_parse_reference_cube():
    m = parse_obj(os.path.join(REF_DIR, "cube.obj"))
    # SURVEY.md 2.3: 8 v / 12 tri.
    assert m.num_tris == 12
    assert m.num_verts == 36
    # Cube extents should be symmetric.
    p = m.positions.reshape(-1, 3)
    assert np.allclose(-p.min(0), p.max(0), atol=1e-5)


@pytest.mark.skipif(not os.path.exists(os.path.join(REF_DIR, "shell.obj")),
                    reason="reference assets not mounted")
def test_parse_reference_shell_and_monkey():
    shell = parse_obj(os.path.join(REF_DIR, "shell.obj"))
    assert shell.num_tris == 1536  # SURVEY.md 2.3
    monkey = parse_obj(os.path.join(REF_DIR, "monkey.obj"))
    assert monkey.num_tris == 967  # SURVEY.md 2.3
