"""Serving pool tests: batched slots == the single live path, slot
lifecycle (attach/reset/detach), skipped-tick hold, and the TCP front-end.

The pool multiplexes many clients onto one device dispatch per tick
(``vhr_tpu/serving.py``); the reference serves exactly one camera per
process (``rppg_LIVESTREAM.py:256-366``)."""

import threading

import numpy as np
import pytest
import jax.numpy as jnp

from vhr_tpu import serving
from vhr_tpu.pipeline import live
from vhr_tpu.utils.synth import SynthSpec, synthesize


@pytest.fixture(scope="module")
def clip():
    return synthesize(SynthSpec(duration_s=14.0, bpm=84.0, height=48,
                                width=64, fps=10.0, noise_std=0.5))


@pytest.fixture(scope="module")
def clip2():
    return synthesize(SynthSpec(duration_s=14.0, bpm=66.0, height=48,
                                width=64, fps=10.0, noise_std=0.5, seed=7))


def _single_trace(cfg, frames):
    st = live.init_state(cfg)
    stp = live.make_step(cfg, donate=False)
    outs = []
    for f in frames:
        st, o = stp(st, jnp.asarray(f))
        outs.append(o)
    return outs


def test_pool_matches_single_path(clip, clip2):
    """Two occupied slots must each reproduce the single-stream live step
    exactly (same holdover, SOS, masked-Welch semantics, just batched)."""
    cfg = live.LiveConfig(fps=clip.fps)
    srv = serving.BpmServer(cfg, n_slots=3, donate=False)
    a, b = srv.attach(), srv.attach()
    outs_a, outs_b = [], []
    for fa, fb in zip(clip.frames, clip2.frames):
        outs = srv.tick({a: fa, b: fb})
        outs_a.append(outs[a])
        outs_b.append(outs[b])
    ref_a = _single_trace(cfg, clip.frames)
    ref_b = _single_trace(cfg, clip2.frames)
    for got, ref in ((outs_a, ref_a), (outs_b, ref_b)):
        np.testing.assert_allclose(
            np.array([float(o.green_raw) for o in got]),
            np.array([float(o.green_raw) for o in ref]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            np.array([float(o.bpm) for o in got]),
            np.array([float(o.bpm) for o in ref]), rtol=0, atol=1e-4)
        assert ([bool(o.bpm_valid) for o in got]
                == [bool(o.bpm_valid) for o in ref])
        assert ([bool(o.face_valid) for o in got]
                == [bool(o.face_valid) for o in ref])
    # Both subjects resolve their own injected rates.
    assert bool(outs_a[-1].bpm_valid) and bool(outs_b[-1].bpm_valid)
    assert abs(float(outs_a[-1].bpm) - 84.0) <= 8.0
    assert abs(float(outs_b[-1].bpm) - 66.0) <= 8.0


def test_pool_reattach_resets_slot(clip):
    """Detach + attach recycles the slot with zeroed state: the fresh
    client re-runs acquisition from scratch, unaffected by its
    predecessor's ring."""
    cfg = live.LiveConfig(fps=clip.fps)
    srv = serving.BpmServer(cfg, n_slots=1, donate=False)
    s = srv.attach()
    first = [srv.tick({s: f})[s] for f in clip.frames]
    assert bool(first[-1].bpm_valid)
    srv.detach(s)
    s2 = srv.attach()
    assert s2 == s
    again = [srv.tick({s2: f})[s2] for f in clip.frames]
    np.testing.assert_allclose(
        np.array([float(o.green_filtered) for o in again]),
        np.array([float(o.green_filtered) for o in first]),
        rtol=0, atol=1e-5)
    assert not bool(again[0].bpm_valid)      # acquisition restarted


def test_pool_skipped_tick_holds_state(clip):
    """A slot that misses a tick advances nothing: interleaving idle ticks
    leaves its output trace identical to contiguous feeding."""
    cfg = live.LiveConfig(fps=clip.fps)
    srv = serving.BpmServer(cfg, n_slots=2, donate=False)
    a, b = srv.attach(), srv.attach()
    outs_a = []
    n = 40
    for i, f in enumerate(clip.frames[:n]):
        outs_a.append(srv.tick({a: f, b: clip.frames[0]})[a])
        if i % 2 == 0:                       # a skips every other tick
            srv.tick({b: clip.frames[0]})
    ref_a = _single_trace(cfg, clip.frames[:n])
    np.testing.assert_allclose(
        np.array([float(o.green_filtered) for o in outs_a]),
        np.array([float(o.green_filtered) for o in ref_a]),
        rtol=0, atol=5e-4)   # float32 reassociation across the batched vmap


def test_pool_snapshot_restore_roundtrip(clip, tmp_path):
    """snapshot() mid-stream + restore() into a FRESH server continues the
    trace exactly (np.savez roundtrip included) — server restarts don't
    lose the 10-30 s acquisition warm-up."""
    cfg = live.LiveConfig(fps=clip.fps)
    srv = serving.BpmServer(cfg, n_slots=2, donate=False)
    a = srv.attach()
    cut = 60
    first = [srv.tick({a: f})[a] for f in clip.frames[:cut]]
    np.savez(tmp_path / "pool.npz", **srv.snapshot())

    srv2 = serving.BpmServer(cfg, n_slots=2, donate=False)
    with np.load(tmp_path / "pool.npz") as snap:
        srv2.restore(snap)
    assert srv2.active_slots == [a]
    rest = [srv2.tick({a: f})[a] for f in clip.frames[cut:]]

    ref = _single_trace(cfg, clip.frames)
    got = first + rest
    np.testing.assert_allclose(
        np.array([float(o.green_filtered) for o in got]),
        np.array([float(o.green_filtered) for o in ref]),
        rtol=0, atol=5e-4)
    assert ([bool(o.bpm_valid) for o in got]
            == [bool(o.bpm_valid) for o in ref])


def test_pool_slot_exhaustion_and_geometry():
    cfg = live.LiveConfig(fps=10.0)
    srv = serving.BpmServer(cfg, n_slots=1, donate=False)
    srv.attach()
    with pytest.raises(RuntimeError, match="busy"):
        srv.attach()
    # One frame geometry per pool: a second shape is refused.
    srv.tick({0: np.zeros((16, 24, 3), np.uint8)})
    with pytest.raises(ValueError, match="geometry"):
        srv.tick({0: np.zeros((16, 32, 3), np.uint8)})


def test_pool_i420_transfer_matches_bgr(clip):
    """transfer='i420' reconstructs BGR on device; ROI means shift only by
    the chroma-subsample loss (<1.5 u8 spatially averaged — the live
    pipeline's bound, tests/test_live.py)."""
    cfg = live.LiveConfig(fps=clip.fps, ring_len=64)
    srv_b = serving.BpmServer(cfg, n_slots=1, donate=False)
    srv_p = serving.BpmServer(cfg, n_slots=1, transfer="i420", donate=False)
    a = srv_b.attach()
    c = srv_p.attach()
    for f in clip.frames[:30]:
        ob = srv_b.tick({a: f})[a]
        op = srv_p.tick({c: live.bgr_to_i420_host(f)})[c]
        assert abs(float(ob.green_raw) - float(op.green_raw)) < 1.5


def test_serve_bpm_cli_smoke(clip):
    """The CLI app end to end: bounded serve, one client, ordered
    answers."""
    import socket as sk
    import time

    from vhr_tpu.apps import serve_bpm

    s = sk.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    h, w = clip.frames[0].shape[:2]
    th = threading.Thread(target=serve_bpm.main, daemon=True, args=(
        ["--host", "127.0.0.1", "--port", str(port), "--height", str(h),
         "--width", str(w), "--slots", "2", "--fps", str(clip.fps),
         "--max-seconds", "120"],))
    th.start()
    c = None
    for _ in range(300):
        try:
            c = serving.BpmClient("127.0.0.1", port, timeout=60.0)
            break
        except OSError:
            time.sleep(0.1)
    assert c is not None, "server never came up"
    n = 12
    for f in clip.frames[:n]:
        c.send(f)
    outs = [c.recv() for _ in range(n)]
    c.close()
    assert [o["seq"] for o in outs] == list(range(n))
    assert all("bpm" in o for o in outs)


def test_pool_detect_every_matches_single(clip):
    """detect_every=N on the pool cond-skips the whole batched detector on
    off-phase ticks (pool-tick phase).  For always-active slots the pool
    phase equals each slot's frame phase, so outputs match the single live
    step with the same cadence."""
    cfg = live.LiveConfig(fps=clip.fps, detect_every=4)
    srv = serving.BpmServer(cfg, n_slots=2, donate=False)
    a = srv.attach()
    n = 40
    outs = [srv.tick({a: f})[a] for f in clip.frames[:n]]
    ref = _single_trace(cfg, clip.frames[:n])
    np.testing.assert_allclose(
        np.array([float(o.green_filtered) for o in outs]),
        np.array([float(o.green_filtered) for o in ref]),
        rtol=0, atol=5e-4)
    assert ([bool(o.face_valid) for o in outs]
            == [bool(o.face_valid) for o in ref])


def test_pool_multiface_matches_single():
    """k_faces=2 slots run the K-track identity-matched holdover per slot;
    outputs (leading (K,) axis) match the single-client step_multi."""
    from vhr_tpu.utils.synth import FaceSpec, synthesize_multi

    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=66.0),
         FaceSpec(center=(0.72, 0.5), bpm=90.0)),
        duration_s=4.0)
    cfg = live.LiveConfig(fps=duo.fps)
    srv = serving.BpmServer(cfg, n_slots=2, donate=False, k_faces=2)
    a = srv.attach()
    outs = [srv.tick({a: f})[a] for f in duo.frames]

    st = live.init_state_multi(cfg, 2)
    stp = live.make_step_multi(cfg, 2, donate=False)
    refs = []
    for f in duo.frames:
        st, o = stp(st, jnp.asarray(f))
        refs.append(o)
    np.testing.assert_allclose(
        np.stack([np.asarray(o.green_filtered) for o in outs]),
        np.stack([np.asarray(o.green_filtered) for o in refs]),
        rtol=1e-4, atol=1e-3)   # float32 reassociation (batched vmap)
    np.testing.assert_array_equal(
        np.stack([np.asarray(o.face_valid) for o in outs]),
        np.stack([np.asarray(o.face_valid) for o in refs]))
    np.testing.assert_array_equal(
        np.stack([np.asarray(o.box) for o in outs]),
        np.stack([np.asarray(o.box) for o in refs]))
    assert outs[-1].box.shape == (2, 4)


def test_pool_sharded_over_mesh(clip, clip2):
    """mesh= shards the slot axis across devices (multi-chip serving, zero
    steady-state collectives); outputs match the unsharded pool."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("slot",))
    cfg = live.LiveConfig(fps=clip.fps)
    srv_m = serving.BpmServer(cfg, n_slots=8, donate=False, mesh=mesh)
    srv_1 = serving.BpmServer(cfg, n_slots=8, donate=False)
    a_m, b_m = srv_m.attach(), srv_m.attach()
    a_1, b_1 = srv_1.attach(), srv_1.attach()
    n = 30
    for fa, fb in zip(clip.frames[:n], clip2.frames[:n]):
        om = srv_m.tick({a_m: fa, b_m: fb})
        o1 = srv_1.tick({a_1: fa, b_1: fb})
        for sm, s1 in ((a_m, a_1), (b_m, b_1)):
            assert abs(float(om[sm].green_filtered)
                       - float(o1[s1].green_filtered)) < 5e-4
            assert bool(om[sm].face_valid) == bool(o1[s1].face_valid)
    with pytest.raises(ValueError, match="divide"):
        serving.BpmServer(cfg, n_slots=3, mesh=mesh)


def test_tcp_server_survives_malformed_clients(clip):
    """Garbage hello and wrong-length frames get an error line and a clean
    hangup; the pool and other clients are unaffected."""
    import json as js
    import socket as sk
    import struct

    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]

    bad1 = sk.create_connection(("127.0.0.1", port), timeout=30)
    bad1.sendall(b"not json at all\n")
    assert "error" in js.loads(bad1.makefile("rb").readline().decode())
    bad1.close()

    # Valid JSON but not an object -- still a clean error line.
    bad1b = sk.create_connection(("127.0.0.1", port), timeout=30)
    bad1b.sendall(b"[1, 2, 3]\n")
    assert "error" in js.loads(bad1b.makefile("rb").readline().decode())
    bad1b.close()

    # Wrong wire format for this pool: rejected at hello (a mismatched
    # client would otherwise crash the tick with a geometry error).
    with pytest.raises(ConnectionError, match="transfer"):
        serving.BpmClient("127.0.0.1", port, transfer="i420")

    bad2 = serving.BpmClient("127.0.0.1", port)
    bad2.sock.sendall(struct.pack("<I", 13) + b"x" * 13)   # wrong length
    line = js.loads(bad2.rfile.readline().decode())
    assert "error" in line and "13" in line["error"]

    good = serving.BpmClient("127.0.0.1", port)
    for f in clip.frames[:5]:
        good.send(f)
    outs = [good.recv() for _ in range(5)]
    assert [o["seq"] for o in outs] == list(range(5))
    good.close()
    srv.shutdown()


def test_tcp_resume_slot_after_restore(clip):
    """A client reclaims its warm slot over TCP after a snapshot/restore
    'restart': the resumed stream continues the acquisition instead of
    starting over, and double-resume of the same slot is refused."""
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    cut = 100
    c = serving.BpmClient("127.0.0.1", port)
    slot = c.slot
    for f in clip.frames[:cut]:
        c.send(f)
    outs1 = [c.recv() for _ in range(cut)]
    snap = pool.snapshot()
    srv.shutdown()

    pool2 = serving.BpmServer(cfg, n_slots=2, donate=False)
    pool2.restore(snap)
    srv2 = serving.serve_forever("127.0.0.1", 0, pool2,
                                 frame_shape=clip.frames[0].shape[:2])
    port2 = srv2.server_address[1]
    c2 = serving.BpmClient("127.0.0.1", port2, resume_slot=slot)
    assert c2.slot == slot
    with pytest.raises(ConnectionError, match="not resumable"):
        serving.BpmClient("127.0.0.1", port2, resume_slot=slot)
    for f in clip.frames[cut:]:
        c2.send(f)
    outs2 = [c2.recv() for _ in range(len(clip.frames) - cut)]
    c2.close()
    srv2.shutdown()

    ref = _single_trace(cfg, clip.frames)
    got = outs1 + outs2
    np.testing.assert_allclose(
        np.array([o["bpm"] for o in got]),
        np.array([float(r.bpm) for r in ref]), rtol=0, atol=1e-3)
    assert [o["bpm_valid"] for o in got] == [bool(r.bpm_valid) for r in ref]


def test_tcp_server_two_clients(clip, clip2):
    """End-to-end over localhost TCP: two clients stream concurrently;
    every accepted frame is answered in order and both recover their
    injected BPM."""
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=4, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    results = {}

    def run_client(name, frames):
        c = serving.BpmClient("127.0.0.1", port)
        outs = []
        for f in frames:
            c.send(f)
        for _ in range(len(frames)):
            outs.append(c.recv())
        c.close()
        results[name] = outs

    t1 = threading.Thread(target=run_client, args=("a", list(clip.frames)))
    t2 = threading.Thread(target=run_client, args=("b", list(clip2.frames)))
    t1.start(); t2.start()
    t1.join(timeout=300); t2.join(timeout=300)
    assert not t1.is_alive() and not t2.is_alive()
    for name, target in (("a", 84.0), ("b", 66.0)):
        outs = results[name]
        assert len(outs) == len(clip.frames)
        assert [o["seq"] for o in outs] == list(range(len(outs)))
        assert outs[-1]["bpm_valid"]
        assert abs(outs[-1]["bpm"] - target) <= 8.0
    srv.shutdown()


def test_tcp_stats_endpoint(clip):
    """A {"stats": true} hello returns pool telemetry (tick EMA, slots,
    frames served) and hangs up without touching the pool."""
    import json as js
    import socket as sk

    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=3, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    c = serving.BpmClient("127.0.0.1", port)
    for f in clip.frames[:10]:
        c.send(f)
    outs = [c.recv() for _ in range(10)]
    assert len(outs) == 10

    st = sk.create_connection(("127.0.0.1", port), timeout=30)
    st.sendall(b'{"stats": true}\n')
    stats = js.loads(st.makefile("rb").readline().decode())
    st.close()
    assert stats["slots"] == 3 and stats["attached"] == 1
    assert stats["frames"] >= 10 and stats["ticks"] >= 1
    assert stats["tick_ms_ema"] > 0
    c.close()
    srv.shutdown()


def test_serve_bpm_client_mode(clip, tmp_path, capsys):
    """--connect streams a video file to a running pool (geometry and wire
    format advertised by the stats hello) and drains answers cleanly.
    Full BPM recovery through this path is covered by the paced 16 s drive
    (needs >9 s of frames for a valid Welch); here we pin the wiring."""
    from vhr_tpu.apps import serve_bpm
    from vhr_tpu.io import video as vio

    path = tmp_path / "c.mp4"
    vio.write_video(clip.frames, str(path), clip.fps)
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    rc = serve_bpm.main(["--connect", f"127.0.0.1:{port}",
                         "--video", str(path), "--max-frames", "40"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "sent 40 frames" in out
    assert "server error" not in out
    srv.shutdown()


def test_tcp_soak_chaos(clip, clip2):
    """Soak the front-end with misbehaving peers: interleaved bursts, an
    abrupt disconnect (never reads its answers), and a stalled reader —
    the healthy client must get every answer in order and the dropped
    slot must free for a newcomer."""
    import socket as sk
    import struct
    import time

    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=3, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2],
                                io_timeout=5.0)
    port = srv.server_address[1]

    a = serving.BpmClient("127.0.0.1", port, timeout=120.0)

    # B: sends 30 frames then slams the socket shut without reading.
    b = serving.BpmClient("127.0.0.1", port, timeout=120.0)
    b_slot = b.slot
    for f in clip2.frames[:30]:
        b.send(f)
    b.sock.close()

    # C: a stalled reader — sends frames, never recv()s.
    c = serving.BpmClient("127.0.0.1", port, timeout=120.0)
    for f in clip2.frames[:60]:
        c.send(f)

    # A (healthy) interleaves three bursts and reads everything back.
    outs = []
    n = 120
    for start in (0, 40, 80):
        for f in clip.frames[start:start + 40]:
            a.send(f)
        for _ in range(40):
            outs.append(a.recv())
    assert [o["seq"] for o in outs] == list(range(n))
    a.close()

    # B's abrupt exit must free its slot for a newcomer.
    deadline = time.time() + 30
    while b_slot in pool.active_slots and time.time() < deadline:
        time.sleep(0.2)
    assert b_slot not in pool.active_slots
    d = serving.BpmClient("127.0.0.1", port, timeout=120.0)
    for f in clip.frames[:3]:
        d.send(f)
    assert [o["seq"] for o in (d.recv() for _ in range(3))] == [0, 1, 2]
    d.close()
    c.sock.close()
    srv.shutdown()


# --- WebSocket front-end (same port, auto-detected; RFC 6455) ------------


def test_ws_client_matches_tcp_client(clip):
    """A browser-style WebSocket client and a raw-TCP client stream the
    same frames into one pool on ONE port and read identical BPM lines."""
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=4, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    ws = serving.WsBpmClient("127.0.0.1", port)
    tc = serving.BpmClient("127.0.0.1", port)
    for f in clip.frames:
        ws.send(f)
        tc.send(f)
    w_outs = [ws.recv() for _ in clip.frames]
    t_outs = [tc.recv() for _ in clip.frames]
    ws.close()
    tc.close()
    assert [o["seq"] for o in w_outs] == list(range(len(clip.frames)))
    assert w_outs[-1]["bpm_valid"]
    assert abs(w_outs[-1]["bpm"] - 84.0) <= 8.0
    # Same frames, same pool tick -> identical answers on both protocols.
    assert [o["bpm"] for o in w_outs] == [o["bpm"] for o in t_outs]
    srv.shutdown()


def test_ws_stats_and_bad_handshake(clip):
    import socket as socket_mod
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    st = serving.WsBpmClient("127.0.0.1", port,
                             hello_extra={"stats": True})
    assert st.slot is None
    assert st.stats["slots"] == 2 and st.stats["transfer"] == "bgr"
    st.sock.close()
    # An HTTP request that is not a WebSocket upgrade gets a clean 400.
    s = socket_mod.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    assert s.recv(100).startswith(b"HTTP/1.1 400")
    s.close()
    # The pool is untouched: a real client still attaches.
    c = serving.WsBpmClient("127.0.0.1", port)
    assert c.slot is not None
    c.close()
    srv.shutdown()


def test_ws_protocol_robustness(clip):
    """Wrong-size binary frames are answered with an error; pings are
    ponged mid-stream; a fragmented hello still parses."""
    import json as json_mod
    import struct as struct_mod
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]

    # Wrong payload size -> {"error": ...} then hangup; slot is freed.
    c = serving.WsBpmClient("127.0.0.1", port)
    c._send_msg(b"\x00" * 16, 0x2)
    out = c.recv()
    assert "error" in out and "16" in out["error"]
    c.sock.close()

    # Ping mid-stream -> pong (the client answers pings transparently,
    # so recv() succeeding across a server ping is the assertion); also
    # send our own ping and watch for the pong.
    c2 = serving.WsBpmClient("127.0.0.1", port)
    c2._send_msg(b"hb", 0x9)
    fin, op, payload = serving._ws_read_frame(c2.rfile, 1 << 20,
                                              require_mask=False)
    assert op == 0xA and payload == b"hb"
    c2.send(clip.frames[0])
    assert c2.recv()["seq"] == 0
    c2.close()

    # Fragmented hello: the text message arrives in two frames.
    import socket as socket_mod
    import base64 as b64
    import os as os_mod
    s = socket_mod.create_connection(("127.0.0.1", port), timeout=30)
    key = b64.b64encode(os_mod.urandom(16)).decode()
    s.sendall((f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
    rf = s.makefile("rb")
    assert b"101" in rf.readline()
    while rf.readline() not in (b"\r\n", b""):
        pass
    hello = json_mod.dumps({"transfer": "bgr"}).encode()

    def frag(payload, opcode, fin):
        b0 = (0x80 if fin else 0) | opcode
        mask = os_mod.urandom(4)
        hdr = bytes((b0, 0x80 | len(payload)))
        s.sendall(hdr + mask + serving._ws_mask(payload, mask))

    frag(hello[:5], 0x1, fin=False)
    frag(hello[5:], 0x0, fin=True)
    fin, op, payload = serving._ws_read_frame(rf, 1 << 20,
                                              require_mask=False)
    assert op == 0x1 and "slot" in json_mod.loads(payload.decode())
    # Clean close frame -> server echoes it.
    frag(b"", 0x8, fin=True)
    fin, op, _ = serving._ws_read_frame(rf, 1 << 20, require_mask=False)
    assert op == 0x8
    s.close()
    srv.shutdown()


def test_auth_token_both_protocols(clip):
    """A server started with auth_token rejects token-less and wrong-token
    hellos on BOTH protocols (stats included) and accepts the shared
    secret — BPM streams are physiological data (ADVICE r3)."""
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2],
                                auth_token="s3cret")
    port = srv.server_address[1]
    with pytest.raises(ConnectionError, match="token"):
        serving.BpmClient("127.0.0.1", port)
    with pytest.raises(ConnectionError, match="token"):
        serving.BpmClient("127.0.0.1", port, token="wrong")
    with pytest.raises(ConnectionError, match="token"):
        serving.WsBpmClient("127.0.0.1", port)
    c = serving.BpmClient("127.0.0.1", port, token="s3cret")
    w = serving.WsBpmClient("127.0.0.1", port, token="s3cret")
    c.send(clip.frames[0]); w.send(clip.frames[0])
    assert c.recv()["seq"] == 0 and w.recv()["seq"] == 0
    # Only the two authorized clients hold slots — the rejected hellos
    # never consumed pool capacity.
    assert len(pool._attached) == 2
    c.close(); w.close()
    srv.shutdown()


def test_ws_origin_allowlist(clip):
    """Browser-origin WebSocket upgrades are denied by default (403) and
    admitted only when the Origin is allow-listed; non-browser clients
    (no Origin header) are unaffected (ADVICE r3: DNS-rebinding guard)."""
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    with pytest.raises(ConnectionError, match="403"):
        serving.WsBpmClient("127.0.0.1", port, origin="http://evil.example")
    ok = serving.WsBpmClient("127.0.0.1", port)    # no Origin: fine
    ok.close()
    srv.shutdown()

    srv2 = serving.serve_forever("127.0.0.1", 0, pool,
                                 frame_shape=clip.frames[0].shape[:2],
                                 ws_origins=("http://app.example",))
    port2 = srv2.server_address[1]
    good = serving.WsBpmClient("127.0.0.1", port2,
                               origin="http://app.example")
    good.send(clip.frames[0])
    assert good.recv()["seq"] == 0
    good.close()
    with pytest.raises(ConnectionError, match="403"):
        serving.WsBpmClient("127.0.0.1", port2, origin="http://evil.example")
    srv2.shutdown()


def test_ws_control_frame_rules():
    """RFC 6455 5.1/5.5: unmasked client frames of ANY opcode, fragmented
    control frames, and >125-byte control payloads are all rejected."""
    import io as io_mod
    import struct as struct_mod

    def feed(b0, b1, payload=b"", mask=b"\x00\x00\x00\x00"):
        buf = bytes((b0, b1)) + (mask if (b1 & 0x80) else b"") + payload
        return io_mod.BytesIO(buf)

    # Unmasked close frame (opcode 8) from a client: rejected.
    with pytest.raises(ValueError, match="masked"):
        serving._ws_read_frame(feed(0x88, 0x00), 1 << 20, require_mask=True)
    # Fragmented ping (FIN clear, opcode 9): rejected.
    with pytest.raises(ValueError, match="fragmented"):
        serving._ws_read_frame(feed(0x09, 0x80), 1 << 20, require_mask=True)
    # Control frame with a 126-byte payload: rejected before length ext.
    with pytest.raises(ValueError, match="125"):
        serving._ws_read_frame(feed(0x89, 0x80 | 126), 1 << 20,
                               require_mask=True)
    # Masked, whole, short ping still parses.
    fin, op, payload = serving._ws_read_frame(
        feed(0x89, 0x80 | 2, b"hb"), 1 << 20, require_mask=True)
    assert fin and op == 0x9 and payload == b"hb"


def test_serve_forever_rejects_multihost_pool(clip, monkeypatch):
    """serve_forever refuses a multi-process pool: its tick loop is driven
    by host-local client traffic, which would break the SPMD collective
    contract inside tick/fetch/snapshot (ADVICE r3)."""
    cfg = live.LiveConfig(fps=clip.fps)
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    monkeypatch.setattr(pool, "_multiproc", True)
    with pytest.raises(ValueError, match="SPMD|multi-host|every"):
        serving.serve_forever("127.0.0.1", 0, pool,
                              frame_shape=clip.frames[0].shape[:2])


def test_pool_projection_method_matches_single(clip, clip2):
    """A method='pos' pool reproduces the single-stream live step exactly
    (the motion-robust constructions reach the serving surface with the
    same per-slot semantics)."""
    cfg = live.LiveConfig(fps=clip.fps, ring_len=120, method="pos")
    srv = serving.BpmServer(cfg, n_slots=2, donate=False)
    a, b = srv.attach(), srv.attach()
    outs_a = []
    for fa, fb in zip(clip.frames, clip2.frames):
        outs_a.append(srv.tick({a: fa, b: fb})[a])
    ref_a = _single_trace(cfg, clip.frames)
    np.testing.assert_allclose(
        np.array([float(o.bpm) for o in outs_a]),
        np.array([float(o.bpm) for o in ref_a]), rtol=0, atol=1e-3)
    assert ([bool(o.bpm_valid) for o in outs_a]
            == [bool(o.bpm_valid) for o in ref_a])
    assert bool(outs_a[-1].bpm_valid)
    assert abs(float(outs_a[-1].bpm) - 84.0) <= 8.0


def test_served_adaptive_client_rejects_flicker():
    """The offline flicker scenario (tests/test_adaptive.py), end-to-end
    through a served TCP client: an adaptive pool routes away from the
    flicker-captured green mean and reports which method won."""
    flick = synthesize(SynthSpec(duration_s=16.0, bpm=72.0, height=48,
                                 width=64, fps=10.0, noise_std=0.3,
                                 flicker_bpm=120.0, flicker_amp=0.15))
    cfg = live.LiveConfig(fps=flick.fps, ring_len=120, method="adaptive")
    pool = serving.BpmServer(cfg, n_slots=2, donate=False)
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=flick.frames[0].shape[:2])
    port = srv.server_address[1]
    c = serving.BpmClient("127.0.0.1", port)
    for f in flick.frames:
        c.send(f)
    outs = [c.recv() for _ in flick.frames]
    c.close()
    srv.shutdown()
    last = outs[-1]
    assert last["bpm_valid"]
    assert abs(last["bpm"] - 72.0) <= 6.0             # pulse, not flicker
    assert last["method"] in ("chrom", "pos", "omit")  # observability
