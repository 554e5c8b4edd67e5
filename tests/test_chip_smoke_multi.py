"""chip_smoke.py --multi rehearsed on four virtual CPU devices: the stream
farm, the slot-sharded pool and the time-sharded recording each equal
their one-device runs."""

import importlib.util
import os
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rehearse_multi():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", smoke)   # dataclasses need it
    spec.loader.exec_module(smoke)
    devices = jax.devices()[:4]
    assert len(devices) == 4
    res = smoke.phase_multi(smoke.TOY, 0, devices)
    assert res["devices"] == 4
    assert res["pool"]["valid_bpm_answers"] > 0
    assert res["long"]["frames"] == smoke.TOY.long_frames
