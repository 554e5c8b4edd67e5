"""Multi-host DCN path, tested with two real localhost processes.

SURVEY §2C: multi-host stream farms ride `jax.distributed`.  This launches
a coordinator + worker (4 virtual CPU devices each), runs the batched
monitoring pipeline over the 2x4-device cluster mesh, and checks the
allgathered result against a single-process reference (see
``tests/dcn_worker.py``).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_stream_farm(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    keep = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([_REPO] + keep)
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(_REPO, "tests", "dcn_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    # both workers saw the same global result
    r0 = json.load(open(tmp_path / "ok_0.json"))
    r1 = json.load(open(tmp_path / "ok_1.json"))
    assert r0["bpm_last"] == r1["bpm_last"]
    assert len(r0["bpm_last"]) == 8
    # production-weights farm stage (runs when the .task asset exists):
    # identical allgathered greens on both hosts, all 8 streams tracked.
    if "mp_green_last" in r0:
        assert r0["mp_green_last"] == r1["mp_green_last"]
        assert len(r0["mp_green_last"]) == 8
    # SPMD serving farm: host 0's frames crossed DCN (same checksum on a
    # host that synthesized only zeros), every slot recovered its BPM, and
    # both hosts fetched identical per-slot outputs.
    assert r0["serve_src_sum"] == r1["serve_src_sum"] != 0
    assert r0["serve_bpm_last"] == r1["serve_bpm_last"]
    assert len(r0["serve_bpm_last"]) == 8
