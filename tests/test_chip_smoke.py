"""`chip_smoke.py` on the CPU: each phase at a tiny size, called as a
function (the compositor through the Pallas interpreter), and the script's
refusal to report a result without a GPU or without the repository."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

chip_smoke._import_repo()


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    p = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert p.returncode == 3, p.stderr[-2000:]
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_exits_nonzero_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert p.returncode == 2, p.stderr[-2000:]
    assert p.stdout.strip() == ""


def test_phase_device_reports_jax_devices():
    d = chip_smoke.phase_device(require_gpu=False)
    assert d["platform"] == "cpu" and d["count"] == len(jax.devices())
    with pytest.raises(chip_smoke.NoGpu):
        chip_smoke.phase_device()


@pytest.mark.parametrize("sh_degree,mode", [(3, 0), (0, 2)], ids=["config1", "config0"])
def test_phase_frames(sh_degree, mode):
    res, g = chip_smoke.phase_frames("tiny", 3000, 128, 96, sh_degree, mode,
                                     iters=1, kernel_interpret=True)
    assert g.count == 3000
    assert res["composite_max_abs"] <= chip_smoke.COMPOSITE_ATOL
    assert all(c > 0.01 for c in res["covered"])
    assert 0 < res["entries_live"] <= res["entries_slots"]


def test_phase_gated():
    sizes = {k: dict(n=2000, w=128, h=96) for k in ("config2", "config3", "config4")}
    res = chip_smoke.phase_gated(sizes=sizes, iters=1)
    assert set(res) == {"config2", "config3", "config4"}
    assert all(r["covered"] > 0.01 for r in res.values())


def test_phase_serve():
    res = chip_smoke.phase_serve(n=2000, w=96, h=64, requests=3)
    assert len(res["request_s"]) == 3


def test_phase_multi_on_four_cpu_devices():
    res = chip_smoke.phase_multi(n=4000, w=128, h=96, n_dev=4)
    assert res["default_ragged"] is False
    assert res["all_to_all"]["ok"] and res["all_to_all"]["overflow"] == 0
    assert res["all_to_all"]["single"]["mean_abs"] < chip_smoke.SHARDED_MEAN
    assert res["control"]["mean_abs"] < chip_smoke.SHARDED_MEAN
    assert "UNIMPLEMENTED" in res["ragged"]["error"]


def test_phase_cli_matches_golden():
    res = chip_smoke.phase_cli(platform="cpu")
    assert res["mean_u8"] < 1.0
