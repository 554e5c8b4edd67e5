"""chip_smoke.py: its phases rehearsed on the CPU at toy sizes, and its
refusal to run anywhere but on a GPU inside a checkout."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)   # dataclasses need it
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["offline", "live", "serving", "evm"])
def test_rehearse_phase(smoke, phase):
    """Each single-card phase runs end to end at toy size and passes its own
    reference comparisons."""
    res = getattr(smoke, f"phase_{phase}")(smoke.TOY, 0)
    assert res["frames" if phase != "serving" else "frames_per_client"] > 0
    if phase == "offline":
        assert res["bpm_mae_vs_cpu_reference"] <= smoke.TOL_BPM_MAE
    if phase == "live":
        assert res["landmark_rms_vs_oracle_px"] <= smoke.TOL_LANDMARK_RMS_PX
    if phase == "serving":
        assert res["tick_errors"] == 0


def _run(args, cwd, path_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    if path_extra:
        env["PATH"] = path_extra + os.pathsep + env.get("PATH", "")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_a_cpu_device(tmp_path):
    """With a card reported but JAX on the CPU, the script exits non-zero
    and prints no ok line: it never falls back to the CPU."""
    fake = tmp_path / "bin"
    fake.mkdir()
    smi = fake / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'Fake Card, 700.00 W'\n")
    smi.chmod(0o755)
    out = _run([SCRIPT], REPO, str(fake))
    assert out.returncode == 2, out.stderr[-2000:]
    assert "Fake Card, 700.00 W" in out.stdout
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
