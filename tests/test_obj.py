"""OBJ loader tests: native C++ parser vs NumPy fallback parity."""
import numpy as np
import pytest

import raycore as rc
from raycore.scene.obj import (_parse_obj_native, _parse_obj_python,
                                   load_obj)

OBJ = """\
# quad + tri, with vt/vn syntax and a relative index
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
vn 0 0 1
f 1/1/1 2/2/2 3/3/3 4/4/4
f 1//1 2//2 -1//5
"""


@pytest.fixture
def obj_file(tmp_path):
    p = tmp_path / "mesh.obj"
    p.write_text(OBJ)
    return str(p)


def test_python_parser(obj_file):
    v, f, n = _parse_obj_python(obj_file)
    assert v.shape == (5, 3)
    # Quad fan-triangulates to 2 faces + 1 triangle = 3.
    assert f.shape == (3, 3)
    np.testing.assert_array_equal(f[0], [0, 1, 2])
    np.testing.assert_array_equal(f[1], [0, 2, 3])
    np.testing.assert_array_equal(f[2], [0, 1, 4])  # -1 => vertex 5
    assert n is not None and n.shape == (5, 3)


def test_native_matches_python(obj_file):
    native = _parse_obj_native(obj_file)
    if native is None:
        pytest.skip("no g++ toolchain available")
    v1, f1, n1 = native
    v2, f2, n2 = _parse_obj_python(obj_file)
    np.testing.assert_allclose(v1, v2)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_allclose(n1, n2)


def test_load_obj_traceable(obj_file):
    tris = load_obj(obj_file)
    assert tris.vertices.shape[0] == 3
    r = rc.closest_hit_brute(tris, rc.Ray.create(o=[0.5, 0.4, -2.0],
                                                 d=[0.0, 0, 1.0]))
    assert bool(r.hit)
    assert float(r.t) == pytest.approx(2.0, abs=1e-5)
