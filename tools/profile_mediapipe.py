"""Stage decomposition of the production MediaPipe face path on a GPU.

The path runs ~287 MFLOPs/frame.  This script times each stage in
isolation, scan-amortized (many frames per timed call, sync by fetching a
scalar, median of 3).  Isolated-stage times overstate the end-to-end cost:
stages fuse and overlap inside the full program, so trust end-to-end
deltas; a profiler trace of the full program is the better instrument.

Run from the repository root: python tools/profile_mediapipe.py [stage ...]
"""
import time
import numpy as np
import jax
import jax.numpy as jnp
import functools

from vhr_tpu.models import mediapipe_face as mp
from vhr_tpu.utils.realface import real_face_image

T, H, W = 64, 720, 1280

img = real_face_image()
frame = np.full((H, W, 3), 96, np.uint8)            # portrait on a canvas
frame[(H - img.shape[0]) // 2:(H + img.shape[0]) // 2,
      (W - img.shape[1]) // 2:(W + img.shape[1]) // 2] = img
frames = jnp.asarray(np.broadcast_to(frame[None], (T, H, W, 3)).copy())
params, det_apply, lm_apply = mp.load_face_models()
params_bf, det_apply_bf, lm_apply_bf = mp.load_face_models(
    compute_dtype=jnp.bfloat16)
jax.block_until_ready(frames)


import sys
_ONLY = set(sys.argv[1:])


def timed(fn, reps, label, per_frames):
    """fn(carry:int32, i:uint8) -> int32, scanned `reps` times inside jit."""
    if _ONLY and not any(k.lower() in label.lower() for k in _ONLY):
        return None
    @jax.jit
    def run(seed):
        def body(c, i):
            return fn(c, i + seed), None
        out, _ = jax.lax.scan(body, jnp.int32(0),
                              jnp.arange(reps, dtype=jnp.uint8))
        return out

    v = int(run(jnp.uint8(0)))  # compile+warm, sync via scalar fetch
    ts = []
    for s in range(1, 4):
        t0 = time.perf_counter()
        v = int(run(jnp.uint8(s)))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    us = dt / (reps * per_frames) * 1e6
    print(f"{label:34s} {us:9.2f} us/frame   "
          f"({reps*per_frames} frames/call, {dt*1e3:.0f} ms/call)")
    return us


def perturb(x, i, scale=4):
    if x.dtype == jnp.uint8:
        d = jax.lax.rem(i.astype(jnp.uint8), jnp.uint8(scale))
    else:
        d = i.astype(x.dtype) * jnp.asarray(1e-3, x.dtype)
    return jax.lax.optimization_barrier(x + d)


# --- stage inputs (precomputed lazily per requested stage group) ---
def _want(*keys):
    return not _ONLY or any(k.lower() in lbl.lower() or lbl.lower() in k.lower()
                            for k in _ONLY for lbl in keys)

lb = rects0 = flat_crops = reg = cls = lm_out = None
anchors = jnp.asarray(mp.blazeface_anchors())
if _want("letterbox", "conv net", "nms", "e2e", "end-to-end", "det net",
         "mesh net"):
    lb = mp._letterbox(frames, mp._DET_SIZE, -1.0, 1.0)      # (T,128,128,3)
if _want("crop", "mesh", "nms", "proj"):
    rects, scores, ok = mp.detect_faces_mp(params, det_apply, frames, 1)
    rects0 = rects._replace(rot=jnp.zeros_like(rects.rot))
if _want("mesh", "proj"):
    crops = mp._crop_faces(frames, rects0, mp._LM_SIZE, mode="axis")
    flat_crops = crops.reshape(T, 256, 256, 3)
if _want("nms"):
    reg, cls = det_apply(params.det, lb)
if _want("proj"):
    lm_out = lm_apply(params.lm, flat_crops)
jax.block_until_ready([a for a in (lb, flat_crops, reg, lm_out)
                       if a is not None])

print(f"\n=== stage decomposition, T={T}, {H}x{W} ===")

# end-to-end for reference
def e2e(c, i):
    fr = perturb(frames, i)
    boxes, valid = mp._detect_single(params, det_apply, lm_apply, fr)
    return c + jnp.sum(boxes) + jnp.sum(valid)
e2e_us = timed(e2e, 48, "END-TO-END (axis)", T)

# 1. letterbox
def st_letterbox(c, i):
    fr = perturb(frames, i)
    x = mp._letterbox(fr, mp._DET_SIZE, -1.0, 1.0)
    return c + jnp.sum(x[0, 64, 64]).astype(jnp.int32)
timed(st_letterbox, 128, "letterbox 720p->128", T)

# 2. det conv net (on pre-letterboxed input)
def st_detnet(c, i):
    x = perturb(lb, i)
    reg, cls = jax.vmap(lambda xi: det_apply(params.det, xi[None]))(x)
    return c + jnp.sum(reg[:, 0, 0]).astype(jnp.int32)
timed(st_detnet, 256, "BlazeFace conv net f32", T)

def st_detnet_bf(c, i):
    x = perturb(lb, i)
    reg, cls = jax.vmap(lambda xi: det_apply_bf(params_bf.det, xi[None]))(x)
    return c + jnp.sum(reg[:, 0, 0, 0]).astype(jnp.int32)
timed(st_detnet_bf, 256, "BlazeFace conv net bf16", T)

# 2b. det conv as a single flat batch (no vmap wrapper)
def st_detnet_flat(c, i):
    x = perturb(lb, i)
    reg, cls = det_apply(params.det, x)
    return c + jnp.sum(reg[0, 0]).astype(jnp.int32)
timed(st_detnet_flat, 256, "BlazeFace conv net f32 FLAT", T)

# 3. decode + NMS + rect
def st_nms(c, i):
    r = perturb(reg, i)
    b, s, kp = mp._decode_detections(r, cls, anchors)
    bb, ss, kk, okk = jax.vmap(
        functools.partial(mp._weighted_nms, k_faces=1))(b, s, kp)
    rr = mp._detection_to_rect(bb, kk, H, W)
    return c + jnp.sum(rr.cx).astype(jnp.int32)
timed(st_nms, 256, "decode+NMS+rect", T)

# 4. axis crop (full-frame read + 2 matmuls)
def st_crop(c, i):
    fr = perturb(frames, i)
    cr = mp._crop_faces(fr, rects0, mp._LM_SIZE, mode="axis")
    return c + jnp.sum(cr[0, 0, 128, 128]).astype(jnp.int32)
timed(st_crop, 64, "axis matmul crop 256^2", T)

# 5. landmark conv net
def st_lmnet(c, i):
    x = perturb(flat_crops, i)
    out = jax.vmap(lambda xi: lm_apply(params.lm, xi[None]))(x)
    return c + jnp.sum(out[0][:, 0, 0]).astype(jnp.int32)
timed(st_lmnet, 64, "face-mesh conv net f32", T)

def st_lmnet_bf(c, i):
    x = perturb(flat_crops, i)
    out = jax.vmap(lambda xi: lm_apply_bf(params_bf.lm, xi[None]))(x)
    return c + jnp.sum(out[0][:, 0, 0]).astype(jnp.int32)
timed(st_lmnet_bf, 64, "face-mesh conv net bf16", T)

def st_lmnet_flat(c, i):
    x = perturb(flat_crops, i)
    out = lm_apply(params.lm, x)
    return c + jnp.sum(out[0][0]).astype(jnp.int32)
timed(st_lmnet_flat, 64, "face-mesh conv net f32 FLAT", T)

# 6. projection + bbox glue
lm3 = lm_out[0].reshape(T, 1, 478, 3)
def st_proj(c, i):
    l = perturb(lm3, i)
    rt = jax.tree.map(lambda a: a.reshape(T, 1), rects0)
    px = jax.vmap(jax.vmap(mp._project_landmarks))(l, rt)
    bb = mp._landmarks_to_bbox(px[:, 0], H, W)
    return c + jnp.sum(bb).astype(jnp.int32)
timed(st_proj, 512, "project+bbox glue", T)

# --- round-4 variants -------------------------------------------------------
params_ba, det_apply_ba, lm_apply_ba = mp.load_face_models(
    activation_dtype=jnp.bfloat16)

def e2e_bf16act(c, i):
    fr = perturb(frames, i)
    boxes, valid = mp._detect_single(params_ba, det_apply_ba, lm_apply_ba, fr)
    return c + jnp.sum(boxes) + jnp.sum(valid)
timed(e2e_bf16act, 48, "E2E r4 bf16-activations", T)

def st_lmnet_ba(c, i):
    x = perturb(flat_crops, i)
    out = lm_apply_ba(params_ba.lm, x)
    return c + jnp.sum(out[0][0]).astype(jnp.int32)
timed(st_lmnet_ba, 96, "mesh net bf16-act FLAT", T)

def st_detnet_ba(c, i):
    x = perturb(lb, i)
    reg, cls = det_apply_ba(params_ba.det, x)
    return c + jnp.sum(reg[0, 0]).astype(jnp.int32)
timed(st_detnet_ba, 256, "det net bf16-act FLAT", T)


# --- product configuration ---------------------------------------------------
# Product default: bf16 activations + bf16 letterbox/crop interchange
# (io_dtype tag on the applies).  Stage sums exceed e2e — stages
# fuse/overlap inside the e2e program; trust e2e deltas.
params_r4, det_r4, lm_r4 = mp.load_face_models(
    compute_dtype=jnp.bfloat16, activation_dtype=jnp.bfloat16)

def e2e_r4(c, i):
    fr = perturb(frames, i)
    boxes, valid = mp._detect_single(params_r4, det_r4, lm_r4, fr)
    return c + jnp.sum(boxes) + jnp.sum(valid)
timed(e2e_r4, 48, "E2E r4 product default (T=64)", T)
