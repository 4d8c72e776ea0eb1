"""chip_smoke.py's phases at tiny sizes on the CPU, called directly, and
its refusal to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    return cs.phase_build(2000)


def test_device_phase_refuses_cpu():
    with pytest.raises(cs.PhaseError, match="not 'gpu'"):
        cs.phase_device()
    dev = cs.phase_device("cpu")
    assert dev["platform"] == "cpu" and dev["count"] == len(jax.devices())


def test_closest_phase_tiny(built):
    scene, static = built
    cs.phase_closest(scene, static, 1024, 256, sample=256)


def test_any_phase_tiny(built):
    scene, static = built
    cs.phase_closest(scene, static, 1024, 256, sample=64)
    cs.phase_any(scene, 1024, 256, sample=256)


def test_instanced_phase_tiny():
    cs.phase_instanced(4, 256, sample=128)


def test_frame_phase_tiny():
    cs.phase_frame(32, 24, 2)


def test_sharded_phase_tiny(built):
    scene, static = built
    cs.phase_sharded(scene, static, 4096, 4)


def test_compare_flags_hit_mismatch(built):
    scene, _ = built
    rays = cs.wl.primary_rays(64)
    ref = cs.brute_reference(scene.prims, rays)
    got = ref.replace(hit=~ref.hit)
    with pytest.raises(cs.PhaseError):
        cs.compare("flipped", ref, got)


def test_main_fails_without_gpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_script_alone_fails(tmp_path):
    """Copied away from the package, the script must fail and print no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_package_imports_without_flax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'flax':\n"
        "            raise ImportError('flax is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import raycore as rc, jax.numpy as jnp, json\n"
        "r = rc.Ray.create(o=jnp.zeros((2, 3)), d=jnp.ones((2, 3)))\n"
        "r = r.replace(t_max=jnp.full((2,), 5.0))\n"
        "print(json.dumps({'flax': 'flax' in sys.modules,\n"
        "                  't_max': float(r.t_max[0])}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == {"flax": False, "t_max": 5.0}
