"""bench.py and __graft_entry__ smoke tests (tiny CPU configs)."""
import json
import os
import subprocess
import sys
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(env_extra, args=None):
    env = dict(os.environ)
    env.update(env_extra)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable] + (args or ["bench.py"]),
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    return out


@pytest.mark.slow
def test_bench_emits_json_line():
    out = _run({"RAYCORE_BENCH_TRIS": "2000", "RAYCORE_BENCH_RAYS": "4096",
                "RAYCORE_BENCH_REPS": "1", "RAYCORE_BENCH_CLUSTER": "64"})
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "closest_hit_primary_mrays_per_s"
    assert rec["unit"] == "Mrays/s"
    assert rec["value"] > 0
    assert "vs_baseline" in rec
    assert rec["hit_frac"] > 0.5
    assert rec["device"]["platform"] == "cpu"


@pytest.mark.slow
def test_bench_traversal_engine():
    out = _run({"RAYCORE_BENCH_TRIS": "500", "RAYCORE_BENCH_RAYS": "1024",
                "RAYCORE_BENCH_REPS": "1",
                "RAYCORE_BENCH_ENGINE": "traversal"})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] > 0


def test_bench_refuses_without_gpu():
    """Without a GPU and without an explicit CPU rehearsal, bench.py
    exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["JAX_PLATFORMS"] = "cpu,"           # not the rehearsal switch
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert '"metric"' not in out.stdout


@pytest.mark.slow
def test_graft_entry_main():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["DRYRUN_DEVICES"] = "4"
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags
                            + " --xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "__graft_entry__.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "entry ok" in out.stdout
    assert "dryrun_multichip(4) ok" in out.stdout


@pytest.mark.slow
def test_examples_run_small():
    """Examples execute end-to-end on CPU with tiny configs."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for script, args in (("examples/particles_dynamic.py", ["64"]),
                         ("examples/dynamic_refit.py", ["16"]),
                         ("examples/articulated.py", [])):
        out = subprocess.run([sys.executable, script] + args, cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=900)
        assert out.returncode == 0, f"{script}: {out.stderr[-1500:]}"
