"""Production serving: an S-slot batched live BPM engine + TCP front-end.

The reference's live app serves exactly one webcam per Python process —
``main()`` owns the camera, the globals, and the matplotlib window
(``/root/reference/rppg_LIVESTREAM.py:256-366``).  Deployed at scale, one
accelerator should instead multiplex many independent live clients: this
module pools ``n_slots`` subjects, carries their :class:`~vhr_tpu
.pipeline.live.LiveState` as ONE batched pytree, and advances every
active slot with ONE device dispatch per server tick.

Design points:

- **One dispatch serves all clients.**  Frames from active clients stack
  into an ``(S, H, W, 3)`` batch; detection runs once over the flat
  batch (detectors are frame-local — the per-stream vmap structure alone
  cost 3x on the MediaPipe port, see ``parallel/streams.py``); the
  per-slot DSP (streaming SOS, ring Welch) is vmapped pure math.
- **Slots are masks, not shapes.**  Attach/detach/missed-frame are all an
  ``active`` mask over a fixed ``(S, ...)`` state: one compile, reused
  for every population of clients (SURVEY §7 "dynamic-shape poison").
- **Outputs cross back as one packed tensor** — a single device->host
  fetch per tick, as in the live pipeline
  (``pipeline/live.py::LivePipeline``).

The front-end (:func:`serve_forever`, CLI in ``apps/serve_bpm.py``)
speaks TWO protocols on ONE port, auto-detected from the first bytes:

- raw TCP (first byte ``{``): a minimal length-prefixed protocol (JSON
  hello + raw frames in; JSON BPM lines out) for camera hosts;
- WebSocket (first bytes ``GET``): a first-party RFC 6455 server (no
  external packages) so *browser* clients can stream ``getUserMedia``
  frames straight to the pool — hello and BPM lines are text messages,
  frame payloads are binary messages.  The reference's browser story is
  nonexistent (its live app owns a local cv2 window,
  ``rppg_LIVESTREAM.py:256-366``).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import os
import queue
import socket
import socketserver
import struct
import threading
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dsp import filters
from .models import skin_detector
from .ops import reduce as vreduce
from .ops import roi as vroi
from .pipeline.live import (LiveConfig, LiveOutput, LiveState,
                            MultiLiveState, _method_bpm, _sos,
                            init_state, init_state_multi, pack_output,
                            unpack_output)

__all__ = ["BpmServer", "init_state_batched", "serve_forever", "BpmClient",
           "WsBpmClient"]


def init_state_batched(cfg: LiveConfig, n_slots: int,
                       k_faces: int = 1):
    """A :class:`LiveState` (or :class:`MultiLiveState` for
    ``k_faces > 1``) with a leading ``(S,)`` slot axis (all zeros — the
    single-slot init broadcast, so a zeroed slot IS a fresh slot)."""
    one = (init_state(cfg) if k_faces == 1
           else init_state_multi(cfg, k_faces))
    return jax.tree.map(
        lambda x: jnp.zeros((n_slots,) + x.shape, x.dtype), one)


def _finish_batched(state: LiveState, cfg: LiveConfig, sos, S: int,
                    active: jnp.ndarray, means: jnp.ndarray,
                    green: jnp.ndarray, face_valid: jnp.ndarray,
                    new_last: jnp.ndarray, new_budget: jnp.ndarray,
                    new_has: jnp.ndarray
                    ) -> Tuple[LiveState, jnp.ndarray]:
    """Common tail of the batched tick: per-slot streaming SOS push,
    masked ring/Welch writes, method BPM, and state/output assembly.  ``face_valid`` must
    already be masked by ``active`` (inactive slots advance nothing)."""
    filt, zi = jax.vmap(
        lambda z, g: filters.sos_stream_push(sos, z, g))(state.zi, green)

    ptr = jnp.mod(state.count, cfg.ring_len)                   # (S,)
    s_idx = jnp.arange(S)
    ring_raw = jnp.where(face_valid[:, None],
                         state.ring_raw.at[s_idx, ptr].set(green),
                         state.ring_raw)
    ring_filt = jnp.where(face_valid[:, None],
                          state.ring_filt.at[s_idx, ptr].set(filt),
                          state.ring_filt)
    ring_bgr = jnp.where(face_valid[:, None, None],
                         state.ring_bgr.at[s_idx, ptr].set(means),
                         state.ring_bgr)
    count = state.count + face_valid.astype(jnp.int32)
    zi = jnp.where(face_valid[:, None, None], zi, state.zi)

    bpm, bpm_valid, choice = jax.vmap(
        lambda rr, rb, rf, c: _method_bpm(cfg, rr, rb, rf, c))(
        ring_raw, ring_bgr, ring_filt, count)

    new_state = LiveState(ring_raw=ring_raw, ring_filt=ring_filt,
                          count=count, zi=zi, last_box=new_last,
                          hold_budget=new_budget, has_last=new_has,
                          frame_idx=state.frame_idx + active.astype(jnp.int32),
                          ring_bgr=ring_bgr)
    out = LiveOutput(bpm=bpm, bpm_valid=bpm_valid, green_raw=green,
                     green_filtered=filt, box=new_last,
                     face_valid=face_valid, choice=choice)
    return new_state, pack_output(out)                         # (S, 10)


def _step_batched_impl(state: LiveState, frames: jnp.ndarray,
                       active: jnp.ndarray, reset: jnp.ndarray,
                       pool_phase: jnp.ndarray, det_args,
                       cfg: LiveConfig, det_fn
                       ) -> Tuple[LiveState, jnp.ndarray]:
    """One tick: advance all S slots from their (S, H, W, 3) frames.

    Per-slot semantics are exactly ``pipeline.live._step_impl``'s (holdover,
    cadence 'attempted' budget rule, masked ring/Welch) — pinned equal in
    ``tests/test_serving.py`` — lifted to a leading slot axis:

    - ``reset[s]``: zero slot s's state first (a client just attached).
    - ``active[s]``: slot s received a frame this tick; inactive slots
      advance nothing (no ring write, no budget drain, no frame_idx).
    - detection runs ONCE over the whole (S,...) batch.  With
      ``detect_every > 1`` the cadence phase is the POOL TICK counter
      (``pool_phase``), not per-slot frame counts: slots tick in lockstep,
      so the predicate is uniform and the whole detector pass cond-skips
      on off-cadence ticks (real compute saving — the production detector
      dominates the tick).  For always-active slots this is identical to
      the single live step's per-frame phase; a slot that skips ticks
      tracks the pool's cadence rather than its own.
    """
    S, H, W, _ = frames.shape
    sos = _sos(cfg)

    state = jax.tree.map(
        lambda x: jnp.where(reset.reshape((S,) + (1,) * (x.ndim - 1)),
                            jnp.zeros_like(x), x), state)

    def run_det(fr):
        if det_fn is None:
            b, v = skin_detector.detect_faces(fr)
        else:
            b, v = det_fn(*det_args, fr)
        return b.astype(jnp.int32), v

    if cfg.detect_every > 1:
        pool_attempt = jax.lax.rem(
            pool_phase.astype(jnp.int32), jnp.int32(cfg.detect_every)) == 0
        boxes, v_det = jax.lax.cond(
            pool_attempt, run_det,
            lambda fr: (jnp.zeros((S, 4), jnp.int32),
                        jnp.zeros((S,), bool)),
            frames)
        attempt = jnp.logical_and(pool_attempt, active)        # (S,)
    else:
        boxes, v_det = run_det(frames)
        attempt = active
    v = jnp.logical_and(v_det, attempt)

    # Holdover with the cadence 'attempted' semantics (live._step_impl).
    new_last = jnp.where(v[:, None], boxes, state.last_box)
    new_has = jnp.logical_or(v, state.has_last)
    failed = jnp.logical_and(~v, attempt)
    reuse_ok = jnp.logical_and(
        failed, jnp.logical_and(state.has_last, state.hold_budget > 0))
    tracked = jnp.logical_and(~attempt, state.has_last)
    new_budget = jnp.where(v, cfg.roi.landmark_hold_frames,
                           jnp.where(reuse_ok, state.hold_budget - 1,
                                     state.hold_budget))
    face_valid = jnp.logical_and(
        jnp.logical_or(v, jnp.logical_or(reuse_ok, tracked)), active)

    rois = vroi.measurement_roi(new_last, cfg.roi, W, H, cfg.roi_site)
    rois = jnp.where(face_valid[:, None], rois, 0)
    means, _ = vreduce.roi_channel_means(frames, rois)         # (S, 3)
    green = means[:, 1]
    return _finish_batched(state, cfg, sos, S, active, means, green,
                           face_valid, new_last, new_budget, new_has)


def _step_multi_batched_impl(state: MultiLiveState, frames: jnp.ndarray,
                             active: jnp.ndarray, reset: jnp.ndarray,
                             pool_phase: jnp.ndarray, det_args,
                             cfg: LiveConfig, k_faces: int, det_fn
                             ) -> Tuple[MultiLiveState, jnp.ndarray]:
    """K-subject variant of :func:`_step_batched_impl`: each slot monitors
    ``k_faces`` subjects (``pipeline.live._step_multi_impl`` semantics,
    lifted to a leading slot axis).  Detection is one flat (S,...) batch;
    the identity-matched K-track holdover is vmapped pure math per slot.
    """
    S, H, W, _ = frames.shape
    K = k_faces
    sos = _sos(cfg)

    state = jax.tree.map(
        lambda x: jnp.where(reset.reshape((S,) + (1,) * (x.ndim - 1)),
                            jnp.zeros_like(x), x), state)

    def run_det(fr):
        if det_fn is None:
            from .models.multiface import detect_faces_multi
            b, v = detect_faces_multi(fr, K)
        else:
            b, v = det_fn(*det_args, fr)
        return b.astype(jnp.int32), v                          # (S,K,4),(S,K)

    if cfg.detect_every > 1:
        pool_attempt = jax.lax.rem(
            pool_phase.astype(jnp.int32), jnp.int32(cfg.detect_every)) == 0
        cand, cval = jax.lax.cond(
            pool_attempt, run_det,
            lambda fr: (jnp.zeros((S, K, 4), jnp.int32),
                        jnp.zeros((S, K), bool)),
            frames)
        attempt = jnp.logical_and(pool_attempt, active)        # (S,)
    else:
        cand, cval = run_det(frames)
        attempt = active

    carry = (state.last_box, state.hold_budget, state.has_last)
    (new_last, new_budget, new_has), (boxes, face_valid) = jax.vmap(
        lambda c, cd, cv, at: vroi.holdover_multi_step(
            c, cd, cv, cfg.roi.landmark_hold_frames, attempted=at))(
        carry, cand, cval, attempt)
    face_valid = jnp.logical_and(face_valid, active[:, None])  # (S,K)

    rois = vroi.measurement_roi(boxes.reshape(S * K, 4), cfg.roi, W, H,
                                cfg.roi_site).reshape(S, K, 4)
    rois = jnp.where(face_valid[..., None], rois, 0)
    # One frame read per slot for all K ROIs (roi_channel_means_multi).
    means, _ = vreduce.roi_channel_means_multi(frames, rois)   # (S,K,3)
    green = means[..., 1]                                      # (S,K)

    filt, zi = jax.vmap(jax.vmap(
        lambda z, g: filters.sos_stream_push(sos, z, g)))(state.zi, green)

    ptr = jnp.mod(state.count, cfg.ring_len)                   # (S,K)
    s_idx = jnp.arange(S)[:, None]
    k_idx = jnp.arange(K)[None, :]
    ring_raw = jnp.where(face_valid[..., None],
                         state.ring_raw.at[s_idx, k_idx, ptr].set(green),
                         state.ring_raw)
    ring_filt = jnp.where(face_valid[..., None],
                          state.ring_filt.at[s_idx, k_idx, ptr].set(filt),
                          state.ring_filt)
    ring_bgr = jnp.where(face_valid[..., None, None],
                         state.ring_bgr.at[s_idx, k_idx, ptr].set(means),
                         state.ring_bgr)
    count = state.count + face_valid.astype(jnp.int32)
    zi = jnp.where(face_valid[..., None, None], zi, state.zi)

    bpm, bpm_valid, choice = jax.vmap(jax.vmap(
        lambda rr, rb, rf, c: _method_bpm(cfg, rr, rb, rf, c)))(
        ring_raw, ring_bgr, ring_filt, count)

    new_state = MultiLiveState(
        ring_raw=ring_raw, ring_filt=ring_filt, count=count, zi=zi,
        last_box=new_last, hold_budget=new_budget, has_last=new_has,
        frame_idx=state.frame_idx + active.astype(jnp.int32),
        ring_bgr=ring_bgr)
    out = LiveOutput(bpm=bpm, bpm_valid=bpm_valid, green_raw=green,
                     green_filtered=filt, box=boxes, face_valid=face_valid,
                     choice=choice)
    return new_state, pack_output(out)                         # (S, K, 10)


_unpack = unpack_output


class BpmServer:
    """S-slot live BPM pool: one device, many monitored subjects.

    >>> srv = BpmServer(LiveConfig(fps=30.0), n_slots=8)
    >>> a, b = srv.attach(), srv.attach()
    >>> outs = srv.tick({a: frame_a, b: frame_b})   # ONE device dispatch
    >>> outs[a].bpm, outs[b].bpm

    All clients share one frame geometry per server (the batch is a static
    shape; front-ends resize heterogeneous cameras before the pool, the
    same way the reference fixes its camera geometry at startup).
    ``transfer="i420"`` takes ``(H*3//2, W)`` planar frames and
    reconstructs BGR on device (2x fewer wire bytes — see
    ``pipeline.live.bgr_to_i420_host``).
    """

    def __init__(self, cfg: LiveConfig = LiveConfig(), n_slots: int = 8,
                 detector=None, transfer: str = "bgr",
                 donate: bool = True, mesh=None, slot_axis: str = "slot",
                 k_faces: int = 1):
        """``mesh``: shard the slot axis over a ``jax.sharding.Mesh`` —
        multi-device serving with zero steady-state collectives (slots are
        independent; detection/DSP partition along the batch).  ``n_slots``
        must divide evenly across the mesh.

        ``k_faces > 1``: every slot monitors K subjects (the reference
        *requests* ``num_faces=2`` but uses one face,
        ``rppg_LIVESTREAM.py:308,339``); outputs gain a leading ``(K,)``
        axis per slot and ``detector`` must follow the multi-face contract
        (``frames -> (boxes (S, K, 4), valid (S, K))``)."""
        if transfer not in ("bgr", "i420"):
            raise ValueError(f"transfer must be 'bgr' or 'i420', "
                             f"got {transfer!r}")
        from .pipeline.offline import _split_detector as _split
        det_fn, det_args = (None, ()) if detector is None else _split(detector)
        self.cfg = cfg
        self.n_slots = n_slots
        self.k_faces = k_faces
        self.transfer = transfer
        self._i420 = transfer == "i420"
        self._lock = threading.Lock()
        self._attached = [False] * n_slots
        self._needs_reset = np.zeros((n_slots,), bool)
        self._state = init_state_batched(cfg, n_slots, k_faces)
        self._sharding = None
        # Multi-host (DCN) pools: when the mesh spans processes the pool
        # runs SPMD — every process constructs the server and performs the
        # SAME attach/tick sequence (host 0 is the camera/front-end source
        # and broadcasts frames, e.g. multihost_utils.broadcast_one_to_all;
        # tests/dcn_worker.py is the working example).  Global arrays are
        # then assembled per-process from the replicated host batch, and
        # fetch() allgathers the packed result to every host.
        self._multiproc = False
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            n_mesh = int(np.prod(mesh.devices.shape))
            if n_slots % n_mesh:
                raise ValueError(f"n_slots={n_slots} must divide across "
                                 f"the {n_mesh}-device mesh")
            self._sharding = NamedSharding(mesh, P(slot_axis))
            self._multiproc = jax.process_count() > 1
            self._state = jax.tree.map(
                lambda x: self._put(np.asarray(x)), self._state)

        def f(state, frames, active, reset, phase, args):
            if self._i420:
                from .ops import color as vcolor
                S = frames.shape[0]
                h = frames.shape[1] * 2 // 3
                w = frames.shape[2]
                flat = vcolor.i420_to_bgr_flat(frames.reshape(S, -1), h, w)
                frames = flat.reshape(S, h, w, 3)
            if k_faces > 1:
                return _step_multi_batched_impl(state, frames, active,
                                                reset, phase, args, cfg,
                                                k_faces, det_fn)
            return _step_batched_impl(state, frames, active, reset, phase,
                                      args, cfg, det_fn)

        jitted = jax.jit(f, donate_argnums=(0,) if donate else ())
        self._step = lambda s, fr, ac, rs, ph: jitted(s, fr, ac, rs, ph,
                                                      det_args)
        self._tick_count = 0      # pool cadence phase (detect_every)
        self._frame_shape: Optional[tuple] = None

    def _put(self, arr):
        """Host (globally replicated) array -> device array under the
        pool's sharding.  Single-process: plain device_put.  Multi-host:
        each process contributes its addressable shards from the same
        replicated host batch (``make_array_from_callback``)."""
        if self._sharding is None:
            return jnp.asarray(arr)
        if self._multiproc:
            a = np.asarray(arr)
            return jax.make_array_from_callback(
                a.shape, self._sharding, lambda idx: a[idx])
        return jax.device_put(arr, self._sharding)

    def attach(self) -> int:
        """Claim a free slot (its state zeroes on the next tick)."""
        with self._lock:
            for s in range(self.n_slots):
                if not self._attached[s]:
                    self._attached[s] = True
                    self._needs_reset[s] = True
                    return s
        raise RuntimeError(f"all {self.n_slots} slots busy")

    def detach(self, slot: int) -> None:
        with self._lock:
            self._attached[slot] = False

    def attached(self, slot: int) -> bool:
        with self._lock:
            return 0 <= slot < self.n_slots and self._attached[slot]

    @property
    def active_slots(self) -> list:
        with self._lock:
            return [s for s in range(self.n_slots) if self._attached[s]]

    # Snapshot schema: v2 keys leaves by state-field NAME (schema-change
    # safe — a restore into a state with new fields zero-fills them); v1
    # (pre-r4, implicit) used positional leaf{i} keys, which silently
    # misalign when fields are added (e.g. ring_bgr).
    _SNAP_SCHEMA = 2

    def snapshot(self) -> dict:
        """Serializable pool state (host numpy): every slot's rings, SOS
        state, tracks, plus the attach map and cadence phase.  A server
        restart restores mid-acquisition windows instead of losing the
        10-30 s warm-up (the checkpoint/resume story of SURVEY §5, lifted
        to serving).  Save with ``np.savez(path, **snap)``.

        Multi-host pools: contains a DCN allgather — every process must
        call ``snapshot()`` at the same point in its tick sequence (the
        SPMD contract; an admin snapshot on one host alone deadlocks)."""
        with self._lock:
            fields = self._state._asdict()
            if self._multiproc:
                from jax.experimental import multihost_utils
                fields = {k: multihost_utils.process_allgather(v, tiled=True)
                          for k, v in fields.items()}
            snap = {f"state.{k}": np.asarray(v) for k, v in fields.items()}
            snap["schema"] = np.int64(self._SNAP_SCHEMA)
            snap["attached"] = np.asarray(self._attached)
            snap["needs_reset"] = self._needs_reset.copy()
            snap["tick_count"] = np.int64(self._tick_count)
            return snap

    def restore(self, snap: dict) -> None:
        """Inverse of :meth:`snapshot` (accepts an ``np.load`` mapping).

        v2 snapshots restore by field name; a field absent from the
        snapshot (older snapshot, newer state — e.g. ``ring_bgr``) keeps
        its zero-init value with a warning instead of an opaque unflatten
        error.  Legacy v1 (positional ``leaf{i}``) snapshots are accepted
        only when the leaf count matches the current state exactly."""
        with self._lock:
            cur = self._state._asdict()
            if "schema" in snap or any(
                    k.startswith("state.") for k in snap):
                new = {}
                for k, v in cur.items():
                    key = f"state.{k}"
                    if key in snap:
                        new[k] = self._put(
                            np.asarray(snap[key]).astype(v.dtype))
                    else:
                        import sys
                        print(f"[pool] snapshot lacks field {k!r} "
                              f"(older schema); keeping zero init",
                              file=sys.stderr)
                        new[k] = v
                self._state = type(self._state)(**new)
            else:                      # legacy v1 positional format
                leaves, treedef = jax.tree.flatten(self._state)
                n = sum(1 for k in snap if str(k).startswith("leaf"))
                if n != len(leaves):
                    raise ValueError(
                        f"legacy snapshot has {n} leaves but the current "
                        f"pool state has {len(leaves)} fields — "
                        f"re-snapshot with this version (schema v2)")
                new = [np.asarray(snap[f"leaf{i}"]).astype(leaves[i].dtype)
                       for i in range(len(leaves))]
                self._state = jax.tree.unflatten(
                    treedef, [self._put(x) for x in new])
            self._attached = [bool(b) for b in np.asarray(snap["attached"])]
            self._needs_reset = np.asarray(snap["needs_reset"]).copy()
            self._tick_count = int(snap["tick_count"])

    def tick(self, frames: Dict[int, np.ndarray]) -> Dict[int, LiveOutput]:
        """Advance every slot that supplied a frame; one device dispatch,
        one packed fetch.  Slots without a frame this tick hold all state
        (a skipped camera frame, not a dropout).

        Multi-host pools run SPMD: every process must perform the SAME
        attach/tick/fetch/snapshot sequence with the same arguments
        (host 0 broadcasts frames; ``tests/dcn_worker.py``) — asymmetric
        calls deadlock or silently diverge on the collectives inside."""
        return self.fetch(self.tick_async(frames))

    def tick_async(self, frames: Dict[int, np.ndarray]):
        """Like :meth:`tick` but returns an un-materialized handle
        ``(slots, packed)`` — JAX dispatch is asynchronous, so the device
        starts the tick while the host moves on.  Materialize with
        :meth:`fetch` one tick later to overlap the result round trip with
        the next tick's host work (the ``LivePipeline`` 1-deep overlap,
        lifted to the pool)."""
        if not frames:
            return None
        shape = next(iter(frames.values())).shape
        if self._frame_shape is None:
            self._frame_shape = shape
        elif shape != self._frame_shape:
            raise ValueError(f"pool frame geometry is {self._frame_shape}; "
                             f"got {shape} (resize before the pool)")
        batch = np.zeros((self.n_slots,) + shape, np.uint8)
        active = np.zeros((self.n_slots,), bool)
        with self._lock:
            for s, f in frames.items():
                if not self._attached[s]:
                    raise KeyError(f"slot {s} is not attached")
                batch[s] = f
                active[s] = True
            reset = self._needs_reset.copy()
            self._needs_reset[:] = False
            b, ac, rs = (self._put(batch), self._put(active),
                         self._put(reset))
            # The state swap happens under the lock: the step DONATES the
            # old state's buffers, so a concurrent snapshot() must never
            # see them (dispatch is async -- the lock is held only for the
            # enqueue, not the device work).
            self._state, packed = self._step(self._state, b, ac, rs,
                                             jnp.int32(self._tick_count))
            self._tick_count += 1
        return (list(frames), packed)

    def fetch(self, handle) -> Dict[int, LiveOutput]:
        """Materialize a :meth:`tick_async` handle (ONE blocking fetch;
        on a multi-host pool this is the tick's single DCN allgather —
        every host sees every slot's output, and every host must call
        fetch() at the same point in its tick sequence — the SPMD
        contract of :meth:`tick`)."""
        if handle is None:
            return {}
        slots, packed = handle
        if self._multiproc:
            from jax.experimental import multihost_utils
            a = np.asarray(
                multihost_utils.process_allgather(packed, tiled=True))
        else:
            a = np.asarray(packed)
        return {s: _unpack(a[s]) for s in slots}


# ---------------------------------------------------------------------------
# TCP front-end: length-prefixed frames in, JSON BPM lines out.
#
# Wire protocol (little-endian):
#   client -> server:  one JSON-object hello line, e.g.
#                      {"transfer": "bgr"}\n -- "transfer" MUST match the
#                      pool's configured wire format; optional
#                      "resume_slot": k reclaims a warm restored slot
#                      (attached in the snapshot, no live connection).
#                      Then per frame: u32 payload length + raw uint8 bytes
#                      (H*W*3 BGR, or (H*3/2)*W planar I420); length 0 = bye
#   server -> client:  {"slot": k} on accept (or {"error": ...} + hangup),
#                      then one JSON line per processed frame:
#       {"seq": k, "bpm": f, "bpm_valid": b, "face_valid": b, "box": [4]}
#       (k_faces > 1 pools send lists: one entry per monitored subject)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ClientConn:
    slot: int
    inbox: "queue.Queue[np.ndarray]"
    wfile: object
    seq: int = 0
    closing: bool = False
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # Serializes BPM lines (tick thread) against error lines (handler
    # thread) on the same socket -- interleaved sendalls would corrupt the
    # JSON-lines stream.
    wlock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return buf


class _BpmTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, pool: BpmServer, frame_shape: tuple,
                 max_queue: int = 64, io_timeout: float = 300.0,
                 auth_token: Optional[str] = None,
                 ws_origins: Optional[tuple] = None):
        self.pool = pool
        self.frame_shape = tuple(frame_shape)
        self.max_queue = max_queue
        # Access control: BPM output is physiological data.  auth_token
        # (when set) must match the hello's {"token": ...} on BOTH
        # protocols.  ws_origins governs *browser* clients: a WebSocket
        # upgrade that carries an Origin header is rejected unless the
        # origin is allow-listed (or ws_origins is ("*",)) — by default
        # NO browser origin is accepted, so a random webpage (or a DNS
        # rebinding page) on the operator's LAN cannot silently attach
        # pool slots.  Non-browser WS clients send no Origin and are
        # governed by auth_token alone.
        self.auth_token = auth_token
        self.ws_origins = tuple(ws_origins) if ws_origins else ()
        # One socket timeout covers reads AND writes: a client that stops
        # READING its BPM lines would otherwise block the tick thread's
        # sendall forever (head-of-line DoS on the whole pool); a client
        # idle longer than this is dropped cleanly.
        self.io_timeout = io_timeout
        # Live telemetry (read by the {"stats": true} hello): tick-duration
        # EMA + totals, so operators can watch pool load without a profiler.
        self.stats = {"ticks": 0, "frames": 0, "tick_ms_ema": 0.0,
                      "tick_errors": 0}
        self.clients: Dict[int, _ClientConn] = {}
        self.clients_lock = threading.Lock()
        self._stop = threading.Event()
        super().__init__(addr, _BpmHandler)
        self._tick_thread = threading.Thread(target=self._tick_loop,
                                             daemon=True)
        self._tick_thread.start()

    def _tick_loop(self):
        """Drain one frame per connected client per tick — every frame is
        processed, in order, and the batch dimension is the economy.  Slot
        release is owned HERE (after the inbox drains), so a tick never
        races a handler's detach.

        The loop is 1-deep PIPELINED (the ``LivePipeline`` overlap, lifted
        to the pool): tick N+1 dispatches before tick N's packed result is
        fetched, so the result's device->host round trip overlaps the
        next tick's host work.  Answer lag is at most one tick; when no new
        frames arrive the pending tick flushes immediately, so idle-pool
        latency is unchanged."""
        import time
        pending = None                        # (outs_for, handle, t0)
        while not self._stop.is_set():
            with self.clients_lock:
                conns = list(self.clients.values())
            frames, outs_for = {}, []
            for c in conns:
                try:
                    frames[c.slot] = c.inbox.get_nowait()
                    outs_for.append(c)
                except queue.Empty:
                    if c.closing and pending is None:
                        with self.clients_lock:
                            self.clients.pop(c.slot, None)
                        self.pool.detach(c.slot)
                        c.done.set()
            if not frames and pending is None:
                time.sleep(0.001)
                continue
            t0 = time.perf_counter()
            handle = None
            if frames:
                try:
                    handle = self.pool.tick_async(frames)
                except Exception as e:       # noqa: BLE001 -- one bad tick
                    # must not kill the only thread serving the pool:
                    # answer the affected clients and keep going.
                    self._answer_error(outs_for, e)
                    handle = None
            prev, pending = pending, ((outs_for, handle, t0)
                                      if handle is not None else None)
            if prev is None:
                continue
            outs_for, handle, t0 = prev
            try:
                outs = self.pool.fetch(handle)   # blocks on tick N-1 only
            except Exception as e:               # noqa: BLE001
                self._answer_error(outs_for, e)
                self.stats["tick_errors"] += 1
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            st = self.stats
            st["ticks"] += 1
            st["frames"] += len(outs)
            st["tick_ms_ema"] = (dt_ms if st["ticks"] == 1 else
                                 0.95 * st["tick_ms_ema"] + 0.05 * dt_ms)
            multi = self.pool.k_faces > 1
            for c in outs_for:
                o = outs[c.slot]
                if multi:   # one entry per monitored subject (K,)
                    msg = {"seq": c.seq,
                           "bpm": np.round(np.asarray(o.bpm), 4).tolist(),
                           "bpm_valid": np.asarray(o.bpm_valid).tolist(),
                           "face_valid": np.asarray(o.face_valid).tolist(),
                           "box": np.asarray(o.box).tolist()}
                else:
                    msg = {"seq": c.seq, "bpm": round(float(o.bpm), 4),
                           "bpm_valid": bool(o.bpm_valid),
                           "face_valid": bool(o.face_valid),
                           "box": [int(x) for x in np.asarray(o.box)]}
                if self.pool.cfg.method == "adaptive":
                    # Selection observability: which pulse construction
                    # (index into cfg.adaptive_methods) won this tick.
                    ms = self.pool.cfg.adaptive_methods
                    ch = np.asarray(o.choice)
                    msg["method"] = (
                        [ms[int(k)] for k in ch.ravel()] if multi
                        else ms[int(ch)])
                line = json.dumps(msg) + "\n"
                c.seq += 1
                with c.wlock:
                    try:
                        c.wfile.write(line.encode())
                        c.wfile.flush()
                    except OSError:          # dead or stalled reader
                        c.closing = True     # (io_timeout) -- drop it

    def _answer_error(self, outs_for, e) -> None:
        err = (json.dumps({"error": f"tick failed: {e!r}"}) + "\n").encode()
        for c in outs_for:
            with c.wlock:
                try:
                    c.wfile.write(err)
                    c.wfile.flush()
                except OSError:
                    c.closing = True
        self.stats["tick_errors"] += 1

    def shutdown(self):
        self._stop.set()
        super().shutdown()


# --- WebSocket (RFC 6455) wire layer: first-party, stdlib + numpy only ---

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class _WsClosed(Exception):
    """Peer sent a close frame (clean WebSocket end)."""


class _FramePayloadError(ValueError):
    """A protocol-level frame error worth answering before hangup."""


def _ws_send(wfile, payload: bytes, opcode: int) -> None:
    """One unmasked server->client frame (servers MUST NOT mask)."""
    b0 = 0x80 | opcode                                   # FIN + opcode
    n = len(payload)
    if n < 126:
        hdr = bytes((b0, n))
    elif n < 65536:
        hdr = bytes((b0, 126)) + struct.pack(">H", n)
    else:
        hdr = bytes((b0, 127)) + struct.pack(">Q", n)
    wfile.write(hdr + payload)
    wfile.flush()


def _ws_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR (un)masking, vectorized — frame payloads are whole camera
    frames, so the per-byte Python loop in most textbook implementations
    would dominate the wire cost."""
    n = len(payload)
    if n == 0:
        return payload
    a = np.frombuffer(payload, np.uint8)
    m = np.frombuffer(mask, np.uint8)
    pad = (-n) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    return (a.reshape(-1, 4) ^ m).tobytes()[:n]


def _ws_read_frame(rfile, max_len: int, require_mask: bool = True):
    """One raw frame -> (fin, opcode, unmasked payload).  Servers pass
    ``require_mask=True`` (client data frames MUST be masked per RFC
    6455); clients read unmasked server frames with ``False``."""
    hdr = _read_exact(rfile, 2)
    if hdr[0] & 0x70:
        raise ValueError("RSV bits set (extensions not negotiated)")
    fin = bool(hdr[0] & 0x80)
    op = hdr[0] & 0x0F
    masked = bool(hdr[1] & 0x80)
    n = hdr[1] & 0x7F
    if op >= 8:                                  # control frame rules
        if not fin:
            raise ValueError("fragmented control frame (RFC 6455 5.5)")
        if n > 125:
            raise ValueError("control frame payload > 125 (RFC 6455 5.5)")
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(rfile, 8))
    if n > max_len + 16:
        raise ValueError(f"frame too long ({n} > {max_len})")
    if require_mask and not masked:
        # ALL client frames must be masked, control frames included
        # (RFC 6455 5.1) — not just data opcodes.
        raise ValueError("client frames must be masked (RFC 6455)")
    mask = _read_exact(rfile, 4) if masked else b""
    payload = _read_exact(rfile, n)
    if masked:
        payload = _ws_mask(payload, mask)
    return fin, op, payload


class _WsWriter:
    """File-like adapter for :class:`_ClientConn`: each ``.write()`` is
    framed as ONE text message (the tick loop writes exactly one JSON line
    per call).  No internal locking — callers hold the conn's ``wlock``,
    same as the raw-TCP path."""

    def __init__(self, wfile):
        self._wfile = wfile

    def write(self, data: bytes) -> None:
        _ws_send(self._wfile, data, 0x1)

    def flush(self) -> None:
        pass


class _BpmHandler(socketserver.StreamRequestHandler):
    def _error(self, msg: str, conn=None, writer=None) -> None:
        w = writer if writer is not None else self.wfile
        data = (json.dumps({"error": msg}) + "\n").encode()
        try:
            if conn is not None:
                with conn.wlock:
                    w.write(data)
                    w.flush()
            else:
                w.write(data)
                w.flush()
        except OSError:
            pass

    def handle(self):
        srv: _BpmTCPServer = self.server
        self.connection.settimeout(srv.io_timeout)
        try:
            line = self.rfile.readline(65537)
        except OSError:
            return
        # One port, two protocols: a WebSocket upgrade starts with an HTTP
        # request line; the raw-TCP protocol starts with a JSON hello.
        if line.startswith(b"GET"):
            self._handle_ws(line)
        else:
            self._handle_tcp(line)

    def _parse_hello(self, raw: bytes):
        """Shared hello validation -> (hello, transfer, resume).  Raises
        ValueError on anything malformed (the pool is untouched)."""
        srv: _BpmTCPServer = self.server
        if len(raw) > 65536:
            raise ValueError("hello too long")
        hello = json.loads(raw.decode() or "{}")
        if not isinstance(hello, dict):
            raise ValueError("hello must be a JSON object")
        if srv.auth_token is not None and not hmac.compare_digest(
                str(hello.get("token", "")), srv.auth_token):
            # constant-time compare: the token is a shared secret arriving
            # over the network
            raise ValueError("bad or missing auth token")
        transfer = hello.get("transfer", "bgr")
        if not hello.get("stats") and transfer != srv.pool.transfer:
            raise ValueError(
                f"pool expects transfer={srv.pool.transfer!r}, "
                f"client sent {transfer!r}")
        resume = hello.get("resume_slot")
        if resume is not None and not isinstance(resume, int):
            raise ValueError("resume_slot must be an integer")
        return hello, transfer, resume

    def _handle_tcp(self, line: bytes):
        try:
            hello, transfer, resume = self._parse_hello(line)
        except (ValueError, UnicodeDecodeError) as e:
            self._error(f"bad hello: {e}")
            return

        def make_recv(nbytes, shape, conn):
            def recv():
                (n,) = struct.unpack("<I", _read_exact(self.rfile, 4))
                if n == 0:
                    return None
                if n != nbytes:
                    raise _FramePayloadError(
                        f"frame payload {n} != expected {nbytes} "
                        f"for {transfer}")
                return np.frombuffer(_read_exact(self.rfile, n),
                                     np.uint8).reshape(shape)
            return recv

        self._session(hello, transfer, resume, self.wfile, make_recv)

    # --- WebSocket path -----------------------------------------------------

    def _handle_ws(self, request_line: bytes):
        srv: _BpmTCPServer = self.server
        headers = {}
        try:
            while True:
                l = self.rfile.readline(65537)
                if l in (b"\r\n", b"\n", b""):
                    break
                if b":" in l:
                    k, v = l.split(b":", 1)
                    headers[k.strip().lower()] = v.strip()
            key = headers.get(b"sec-websocket-key")
            if (headers.get(b"upgrade", b"").lower() != b"websocket"
                    or key is None):
                self.wfile.write(b"HTTP/1.1 400 Bad Request\r\n"
                                 b"Connection: close\r\n\r\n")
                self.wfile.flush()
                return
            origin = headers.get(b"origin")
            if origin is not None:
                # Browser-originated upgrade: enforce the allowlist (a
                # webpage cannot speak the raw-TCP protocol, but it CAN
                # open a WebSocket to any host the browser reaches —
                # including via DNS rebinding).  Default: deny all.
                try:
                    o = origin.decode("ascii")
                except UnicodeDecodeError:
                    o = None
                if not ("*" in srv.ws_origins or
                        (o is not None and o in srv.ws_origins)):
                    self.wfile.write(b"HTTP/1.1 403 Forbidden\r\n"
                                     b"Connection: close\r\n\r\n")
                    self.wfile.flush()
                    return
            accept = base64.b64encode(
                hashlib.sha1(key + _WS_GUID).digest())
            self.wfile.write(
                b"HTTP/1.1 101 Switching Protocols\r\n"
                b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                b"Sec-WebSocket-Accept: " + accept + b"\r\n\r\n")
            self.wfile.flush()
        except OSError:
            return
        writer = _WsWriter(self.wfile)
        try:
            op, data = self._ws_read_message(None, 65536)
            if op != 1:
                raise ValueError("hello must be a text message")
            hello, transfer, resume = self._parse_hello(data)
        except (_WsClosed, EOFError, OSError):
            return
        except (ValueError, UnicodeDecodeError) as e:
            self._error(f"bad hello: {e}", writer=writer)
            return

        def make_recv(nbytes, shape, conn):
            def recv():
                while True:
                    try:
                        op, data = self._ws_read_message(
                            conn, max(nbytes, 65536))
                    except _WsClosed:
                        return None
                    if op == 1:            # text mid-stream: only "bye"
                        try:
                            msg = json.loads(data.decode())
                        except (ValueError, UnicodeDecodeError):
                            raise _FramePayloadError("bad text message")
                        if msg.get("bye"):
                            return None
                        continue
                    if len(data) != nbytes:
                        raise _FramePayloadError(
                            f"frame payload {len(data)} != expected "
                            f"{nbytes} for {transfer}")
                    return np.frombuffer(data, np.uint8).reshape(shape)
            return recv

        self._session(hello, transfer, resume, writer, make_recv)

    def _ws_read_message(self, conn, max_len: int):
        """Next data message -> (opcode, payload bytes): assembles
        fragments, answers pings in place (under the conn's write lock so
        pongs never interleave with tick-thread BPM lines), raises
        :class:`_WsClosed` on a close frame (after echoing it)."""
        first_op, buf = None, b""
        while True:
            fin, op, payload = _ws_read_frame(self.rfile, max_len)
            if op == 8:                                   # close
                self._ws_control(conn, 8, payload[:125])
                raise _WsClosed
            if op == 9:                                   # ping -> pong
                self._ws_control(conn, 10, payload)
                continue
            if op == 10:                                  # unsolicited pong
                continue
            if op in (1, 2):
                if first_op is not None:
                    raise ValueError("new message mid-fragment")
                if fin:
                    return op, payload
                first_op, buf = op, payload
            elif op == 0:
                if first_op is None:
                    raise ValueError("continuation without a start frame")
                buf += payload
                if len(buf) > max_len + 16:
                    raise ValueError("fragmented message too long")
                if fin:
                    return first_op, buf
            else:
                raise ValueError(f"unsupported opcode {op}")

    def _ws_control(self, conn, opcode: int, payload: bytes) -> None:
        try:
            if conn is not None:
                with conn.wlock:
                    _ws_send(self.wfile, payload, opcode)
            else:
                _ws_send(self.wfile, payload, opcode)
        except OSError:
            pass

    # --- protocol-agnostic slot session --------------------------------------

    def _session(self, hello: dict, transfer: str, resume, writer,
                 make_recv):
        """Everything after a validated hello, shared by both protocols:
        stats reply, slot attach/resume, frame pump into the tick loop's
        inbox, and teardown.  ``writer`` frames one JSON line per
        ``.write()`` (raw wfile for TCP, :class:`_WsWriter` for WS);
        ``make_recv(nbytes, shape, conn)`` builds the per-protocol frame
        reader (returns an array per frame, ``None`` on clean end, raises
        :class:`_FramePayloadError` on protocol errors)."""
        srv: _BpmTCPServer = self.server
        if hello.get("stats"):
            with srv.clients_lock:
                connected = len(srv.clients)
            payload = dict(srv.stats,
                           slots=srv.pool.n_slots,
                           attached=len(srv.pool.active_slots),
                           connected=connected,
                           k_faces=srv.pool.k_faces,
                           transfer=srv.pool.transfer,
                           height=srv.frame_shape[0],
                           width=srv.frame_shape[1])
            payload["tick_ms_ema"] = round(payload["tick_ms_ema"], 3)
            try:
                writer.write((json.dumps(payload) + "\n").encode())
                writer.flush()
            except OSError:
                pass
            return
        h, w = srv.frame_shape
        nbytes = (h * 3 // 2) * w if transfer == "i420" else h * w * 3
        shape = ((h * 3 // 2, w) if transfer == "i420" else (h, w, 3))
        conn = _ClientConn(slot=-1,
                           inbox=queue.Queue(maxsize=srv.max_queue),
                           wfile=writer)
        if resume is not None:
            # Reclaim a warm restored slot: attached in the pool (the
            # snapshot's attach map) but with no live connection.  The
            # check and the registration are atomic under clients_lock so
            # two resumers cannot adopt the same slot.
            with srv.clients_lock:
                if resume in srv.clients or not srv.pool.attached(resume):
                    self._error(f"slot {resume} is not resumable",
                                writer=writer)
                    return
                conn.slot = slot = resume        # no reset: state is warm
                srv.clients[slot] = conn
        else:
            try:
                slot = srv.pool.attach()
            except RuntimeError as e:
                self._error(str(e), writer=writer)
                return
            conn.slot = slot
            with srv.clients_lock:
                srv.clients[slot] = conn
        recv_frame = make_recv(nbytes, shape, conn)
        try:
            with conn.wlock:
                writer.write((json.dumps({"slot": slot}) + "\n").encode())
                writer.flush()
            while True:
                frame = recv_frame()
                if frame is None:
                    break
                while not conn.closing:      # don't wedge on a full inbox
                    try:                     # after the tick loop drops us
                        conn.inbox.put(frame, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if conn.closing:
                    break
        except _FramePayloadError as e:
            self._error(str(e), conn, writer)
            # hang up; queued frames still drain
        except (ValueError, EOFError, OSError):
            pass
        finally:
            # The tick loop owns slot release: it drains the inbox (every
            # accepted frame is answered), then detaches and signals.
            conn.closing = True
            conn.done.wait(timeout=30.0)


def serve_forever(host: str, port: int, pool: BpmServer,
                  frame_shape: tuple, io_timeout: float = 300.0,
                  auth_token: Optional[str] = None,
                  ws_origins: Optional[tuple] = None) -> _BpmTCPServer:
    """Start the TCP front-end on a background thread; returns the server
    (``.server_address`` has the bound port; call ``.shutdown()``).

    ``auth_token``: when set, every hello (raw TCP and WebSocket, stats
    included) must carry a matching ``{"token": ...}`` field.
    ``ws_origins``: allowlist for *browser* WebSocket upgrades — an
    upgrade carrying an Origin header is rejected with 403 unless its
    origin is listed (``("*",)`` allows any).  Default: deny all browser
    origins.  Either way, do not expose the port beyond trusted hosts
    without a token — BPM streams are physiological data.

    Multi-host pools are rejected: the tick loop here is driven by
    host-local client traffic, but a multi-process pool's tick/fetch/
    snapshot contain collectives and MUST run the same call sequence on
    every host (see :class:`BpmServer`; ``tests/dcn_worker.py`` is the
    working SPMD example)."""
    if pool._multiproc:
        raise ValueError(
            "serve_forever drives ticks from host-local client traffic; "
            "a multi-host pool must run the SPMD tick sequence on every "
            "host (tick/fetch/snapshot contain collectives — see "
            "BpmServer and tests/dcn_worker.py)")
    srv = _BpmTCPServer((host, port), pool, frame_shape,
                        io_timeout=io_timeout, auth_token=auth_token,
                        ws_origins=ws_origins)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


class BpmClient:
    """Minimal client for the TCP protocol (test + reference harness).

    >>> c = BpmClient("127.0.0.1", port)
    >>> c.send(frame); out = c.recv()      # dicts per processed frame
    """

    def __init__(self, host: str, port: int, transfer: str = "bgr",
                 timeout: float = 30.0, resume_slot: Optional[int] = None,
                 token: Optional[str] = None):
        """``resume_slot``: reclaim a warm slot after a server restart
        with ``--restore`` (the snapshot keeps the attach map).
        ``token``: shared secret for servers started with
        ``auth_token``."""
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.transfer = transfer
        hello = {"transfer": transfer}
        if resume_slot is not None:
            hello["resume_slot"] = resume_slot
        if token is not None:
            hello["token"] = token
        self.sock.sendall((json.dumps(hello) + "\n").encode())
        accept = json.loads(self.rfile.readline().decode())
        if "error" in accept:
            self.sock.close()
            raise ConnectionError(accept["error"])
        self.slot = accept["slot"]

    def send(self, frame: np.ndarray) -> None:
        raw = np.ascontiguousarray(frame, np.uint8).tobytes()
        self.sock.sendall(struct.pack("<I", len(raw)) + raw)

    def recv(self) -> dict:
        return json.loads(self.rfile.readline().decode())

    def close(self) -> None:
        try:
            self.sock.sendall(struct.pack("<I", 0))
        except OSError:
            pass
        self.sock.close()


class WsBpmClient:
    """WebSocket counterpart of :class:`BpmClient` (same surface: ``slot``,
    ``send``, ``recv``, ``close``) — masks client frames per RFC 6455, so
    it exercises exactly the path a browser takes.  ``hello_extra`` merges
    extra hello fields (e.g. ``{"stats": True}`` -> the reply lands in
    ``self.stats`` and ``slot`` is ``None``)."""

    def __init__(self, host: str, port: int, transfer: str = "bgr",
                 timeout: float = 30.0, resume_slot: Optional[int] = None,
                 hello_extra: Optional[dict] = None,
                 token: Optional[str] = None,
                 origin: Optional[str] = None):
        """``token``: shared secret for ``auth_token`` servers.
        ``origin``: send an Origin header (what a browser does) — the
        server rejects it with 403 unless allow-listed via
        ``ws_origins``."""
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.transfer = transfer
        key = base64.b64encode(os.urandom(16)).decode()
        req = (f"GET /bpm HTTP/1.1\r\nHost: {host}:{port}\r\n"
               f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
               + (f"Origin: {origin}\r\n" if origin is not None else "")
               + f"Sec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n")
        self.sock.sendall(req.encode())
        status = self.rfile.readline()
        if b"101" not in status:
            self.sock.close()
            raise ConnectionError(f"handshake refused: {status!r}")
        want = base64.b64encode(
            hashlib.sha1(key.encode() + _WS_GUID).digest())
        got = None
        while True:
            l = self.rfile.readline()
            if l in (b"\r\n", b"\n", b""):
                break
            if l.lower().startswith(b"sec-websocket-accept:"):
                got = l.split(b":", 1)[1].strip()
        if got != want:
            self.sock.close()
            raise ConnectionError("bad Sec-WebSocket-Accept")
        hello = {"transfer": transfer}
        if resume_slot is not None:
            hello["resume_slot"] = resume_slot
        if token is not None:
            hello["token"] = token
        if hello_extra:
            hello.update(hello_extra)
        self._send_msg(json.dumps(hello).encode(), 0x1)
        first = json.loads(self._recv_text())
        self.stats: Optional[dict] = None
        self.slot: Optional[int] = None
        if hello.get("stats"):
            self.stats = first
        elif "error" in first:
            self.sock.close()
            raise ConnectionError(first["error"])
        else:
            self.slot = first["slot"]

    def _send_msg(self, payload: bytes, opcode: int) -> None:
        b0 = 0x80 | opcode
        n = len(payload)
        if n < 126:
            hdr = bytes((b0, 0x80 | n))
        elif n < 65536:
            hdr = bytes((b0, 0x80 | 126)) + struct.pack(">H", n)
        else:
            hdr = bytes((b0, 0x80 | 127)) + struct.pack(">Q", n)
        mask = os.urandom(4)
        self.sock.sendall(hdr + mask + _ws_mask(payload, mask))

    def _recv_text(self) -> str:
        first_op, buf = None, b""
        while True:
            fin, op, payload = _ws_read_frame(self.rfile, 1 << 20,
                                              require_mask=False)
            if op == 8:
                raise ConnectionError("server closed")
            if op == 9:
                self._send_msg(payload, 0xA)             # pong
                continue
            if op == 10:
                continue
            if op in (1, 2):
                if fin:
                    return payload.decode()
                first_op, buf = op, payload
            elif op == 0:
                buf += payload
                if fin:
                    return buf.decode()

    def send(self, frame: np.ndarray) -> None:
        self._send_msg(np.ascontiguousarray(frame, np.uint8).tobytes(), 0x2)

    def recv(self) -> dict:
        return json.loads(self._recv_text())

    def close(self) -> None:
        try:
            self._send_msg(json.dumps({"bye": True}).encode(), 0x1)
            self._send_msg(b"", 0x8)
        except OSError:
            pass
        self.sock.close()
