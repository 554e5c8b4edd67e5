"""Tests for the first-party TFLite reader and the MediaPipe face port.

TF/mediapipe are not in this image, so correctness rests on three legs:
(1) two independent executors (JAX product path vs numpy im2col oracle)
agreeing on the real graphs, (2) graph-structure pins against the known
BlazeFace/face-mesh architecture, and (3) behavioral checks — the
production weights must actually find a face, track rotation, and drive
the rPPG pipeline end-to-end.

Reference consumer being matched: FaceLandmarker at
``/root/reference/analysis/utils/roi.py:70-110``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vhr_tpu.models import mediapipe_face as mpf
from vhr_tpu.models.tflite import load_task_models
from vhr_tpu.models.tflite_exec import (NumpyInterpreter, SUPPORTED_OPS,
                                        build_jax, fold_dequantize)

TASK = mpf.default_task_path()


@pytest.fixture(scope="module")
def models():
    return load_task_models(TASK)


def draw_face(H=256, W=320, cx=160, cy=130, rx=55, ry=75):
    """A schematic face (skin ellipse, eyes, brows, nose, mouth, hair) that
    the production BlazeFace detects at score ~0.84."""
    import cv2
    img = np.full((H, W, 3), (60, 70, 80), np.uint8)
    cv2.ellipse(img, (cx, cy), (rx, ry), 0, 0, 360, (130, 165, 200), -1)
    cv2.ellipse(img, (cx, cy - ry + 18), (rx - 6, 26), 0, 180, 360,
                (40, 60, 80), -1)
    for ex in (cx - 22, cx + 22):
        cv2.circle(img, (ex, cy - 15), 9, (255, 255, 255), -1)
        cv2.circle(img, (ex, cy - 15), 5, (40, 30, 30), -1)
        cv2.line(img, (ex - 12, cy - 30), (ex + 12, cy - 32),
                 (50, 50, 60), 3)
    cv2.line(img, (cx, cy - 5), (cx - 6, cy + 14), (90, 120, 150), 3)
    cv2.ellipse(img, (cx, cy + 34), (18, 9), 0, 0, 180, (60, 60, 120), 3)
    return img


# --- flatbuffer reader ------------------------------------------------------

def test_parse_graph_structure(models):
    det = models["face_detector.tflite"].graph
    lm = models["face_landmarks_detector.tflite"].graph
    # BlazeFace short-range: 128px input, 896 anchors x (16 coords | 1 score)
    assert det.tensors[det.inputs[0]].shape == (1, 128, 128, 3)
    out_shapes = {det.tensors[i].shape for i in det.outputs}
    assert out_shapes == {(1, 896, 16), (1, 896, 1)}
    # face mesh: 256px input, 478 xyz landmarks + presence logit
    assert lm.tensors[lm.inputs[0]].shape == (1, 256, 256, 3)
    assert (1, 1, 1, 1434) in {lm.tensors[i].shape for i in lm.outputs}
    # every DEQUANTIZE input is an fp16 constant (foldable)
    for g in (det, lm):
        for op in g.operators:
            if op.op == "DEQUANTIZE":
                t = g.tensors[op.inputs[0]]
                assert t.data is not None and t.dtype == np.float16


@pytest.mark.parametrize("name", ["face_detector.tflite",
                                  "face_landmarks_detector.tflite",
                                  "face_blendshapes.tflite"])
def test_struct_reader_matches_flatbuffers_oracle(name):
    """The first-party struct vtable reader vs the ``flatbuffers`` package's
    own Table navigation on the committed .task, field by field: every
    tensor's shape, type, buffer bytes and name, every operator's opcode,
    inputs and outputs."""
    import zipfile

    flatbuffers = pytest.importorskip("flatbuffers")
    from flatbuffers import number_types as NT

    from vhr_tpu.models.tflite import (BUILTIN_NAMES, TENSOR_DTYPES,
                                       parse_tflite)

    with zipfile.ZipFile(TASK) as z:
        data = z.read(name)
    ours = parse_tflite(data).graph

    def table(buf, pos):
        return flatbuffers.table.Table(buf, pos)

    def field(t, fid):
        return t.Offset(4 + 2 * fid)

    def vec_tables(t, fid):
        o = field(t, fid)
        start = t.Vector(o)
        return [table(t.Bytes, t.Indirect(start + 4 * i))
                for i in range(t.VectorLen(o))]

    def vec_i32(t, fid):
        o = field(t, fid)
        if o == 0:
            return []
        start = t.Vector(o)
        return [t.Get(NT.Int32Flags, start + 4 * i)
                for i in range(t.VectorLen(o))]

    def scalar(t, fid, flags):
        o = field(t, fid)
        return 0 if o == 0 else t.Get(flags, o + t.Pos)

    model = table(data, flatbuffers.encode.Get(flatbuffers.packer.uoffset,
                                               data, 0))
    buffers = []
    for b in vec_tables(model, 4):
        o = field(b, 0)
        buffers.append(b"" if o == 0 else bytes(
            b.Bytes[b.Vector(o):b.Vector(o) + b.VectorLen(o)]))
    codes = []
    for oc in vec_tables(model, 1):
        c = scalar(oc, 3, NT.Int32Flags) or scalar(oc, 0, NT.Int8Flags)
        codes.append(c)
    sg = vec_tables(model, 2)[0]
    tensors = vec_tables(sg, 0)
    assert len(tensors) == len(ours.tensors)
    for t, mine in zip(tensors, ours.tensors):
        assert tuple(vec_i32(t, 0)) == mine.shape
        assert TENSOR_DTYPES[scalar(t, 1, NT.Int8Flags)] == mine.dtype
        raw = buffers[scalar(t, 2, NT.Uint32Flags)]
        assert (mine.data.tobytes() if mine.data is not None else b"") == raw
        o = field(t, 3)
        assert (t.String(o + t.Pos).decode() if o else "") == mine.name
    ops = vec_tables(sg, 3)
    assert len(ops) == len(ours.operators)
    for op, mine in zip(ops, ours.operators):
        assert BUILTIN_NAMES.get(codes[scalar(op, 0, NT.Uint32Flags)],
                                 mine.op) == mine.op
        assert vec_i32(op, 1) == mine.inputs
        assert vec_i32(op, 2) == mine.outputs
    assert vec_i32(sg, 1) == ours.inputs and vec_i32(sg, 2) == ours.outputs


def test_fold_leaves_supported_subset(models):
    for name in ("face_detector.tflite", "face_landmarks_detector.tflite"):
        g = fold_dequantize(models[name].graph)
        assert {op.op for op in g.operators} <= SUPPORTED_OPS


def test_jax_vs_numpy_oracle_detector(models):
    g = models["face_detector.tflite"].graph
    params, apply = build_jax(g)
    oracle = NumpyInterpreter(g)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    out_j = jax.jit(apply)(params, jnp.asarray(x))
    out_n = oracle(x)
    for a, b in zip(out_j, out_n):
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(np.asarray(a) / scale, b / scale,
                                   atol=2e-5)


@pytest.mark.slow
def test_jax_vs_numpy_oracle_landmarks(models):
    g = models["face_landmarks_detector.tflite"].graph
    params, apply = build_jax(g)
    oracle = NumpyInterpreter(g)
    x = np.random.default_rng(1).uniform(0, 1, (1, 256, 256, 3)) \
        .astype(np.float32)
    out_j = jax.jit(apply)(params, jnp.asarray(x))
    out_n = oracle(x)
    for a, b in zip(out_j, out_n):
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(np.asarray(a) / scale, b / scale,
                                   atol=2e-4)


# --- graph-logic units ------------------------------------------------------

def test_anchor_grid():
    a = mpf.blazeface_anchors()
    assert a.shape == (896, 2)
    # stride-8 map: first cell center, 2 anchors per cell
    np.testing.assert_allclose(a[0], [0.5 / 16, 0.5 / 16])
    np.testing.assert_allclose(a[1], a[0])
    np.testing.assert_allclose(a[2], [1.5 / 16, 0.5 / 16])
    # merged stride-16 maps: 6 anchors per cell starting at index 512
    np.testing.assert_allclose(a[512], [0.5 / 8, 0.5 / 8])
    np.testing.assert_allclose(a[517], a[512])
    np.testing.assert_allclose(a[518], [1.5 / 8, 0.5 / 8])


def test_weighted_nms_blends_and_separates():
    # two clusters: three overlapping boxes around x=0.3, one at x=0.7
    boxes = jnp.asarray([[0.25, 0.25, 0.45, 0.45],
                         [0.26, 0.24, 0.46, 0.44],
                         [0.24, 0.26, 0.44, 0.46],
                         [0.65, 0.25, 0.85, 0.45]])
    scores = jnp.asarray([0.9, 0.8, 0.7, 0.6])
    kps = jnp.zeros((4, 6, 2))
    b, s, kp, ok = mpf._weighted_nms(boxes, scores, kps, k_faces=2)
    assert bool(ok[0]) and bool(ok[1])
    # slot 0 = score-weighted blend of the cluster
    w = np.asarray([0.9, 0.8, 0.7])
    expect = (np.asarray(boxes[:3]) * w[:, None]).sum(0) / w.sum()
    np.testing.assert_allclose(np.asarray(b[0]), expect, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b[1]), np.asarray(boxes[3]),
                               atol=1e-6)
    # low-score-only input -> nothing valid
    _, _, _, ok2 = mpf._weighted_nms(boxes, scores * 0.1, kps, k_faces=2)
    assert not bool(ok2.any())


def test_crop_rotated_identity():
    # an axis-aligned rect crop of a gradient reproduces the gradient
    H, W = 64, 64
    img = (np.arange(W, dtype=np.uint8)[None, :, None]
           * np.ones((H, 1, 3), np.uint8))
    rect = mpf._Rect(cx=jnp.float32(32.0), cy=jnp.float32(32.0),
                     side=jnp.float32(32.0), rot=jnp.float32(0.0))
    crop = mpf._crop_rotated(jnp.asarray(img), rect, 32)
    # BGR->RGB flip doesn't matter (all channels equal); x spans 16..48
    got = np.asarray(crop[16, :, 0]) * 255.0
    expect = 16.0 + np.arange(32)
    np.testing.assert_allclose(got, expect, atol=1.0)


def test_crop_rotated_packed_bitexact_vs_ref():
    """The packed-tap fast crop (one (1,1,12) gather per output pixel) must
    be BIT-exact vs the direct 4-gather formulation, including rects that
    spill over every frame edge and hit the x1/y1 clamp columns."""
    rng = np.random.default_rng(7)
    H, W = 97, 133
    img = jnp.asarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    cases = [
        (60.0, 50.0, 40.0, 0.0),        # interior, axis-aligned
        (60.0, 50.0, 40.0, 0.37),       # interior, rotated
        (60.0, 50.0, 40.0, -1.2),       # big negative rotation
        (2.0, 3.0, 50.0, 0.5),          # spills top-left
        (131.0, 95.0, 60.0, -0.4),      # spills bottom-right
        (66.0, 48.0, 400.0, 0.25),      # rect far larger than the frame
        (-20.0, -10.0, 30.0, 0.1),      # fully outside (all taps clamped)
    ]
    for cx, cy, side, rot in cases:
        rect = mpf._Rect(cx=jnp.float32(cx), cy=jnp.float32(cy),
                         side=jnp.float32(side), rot=jnp.float32(rot))
        fast = np.asarray(mpf._crop_rotated(img, rect, 48))
        ref = np.asarray(mpf._crop_rotated_ref(img, rect, 48))
        np.testing.assert_array_equal(fast, ref, err_msg=str((cx, cy, side,
                                                              rot)))


def test_crop_faces_blocked_matches_direct():
    """_crop_faces with T > _CROP_BLOCK (padded lax.map path) must equal
    the per-frame direct path."""
    rng = np.random.default_rng(3)
    T, H, W, K = mpf._CROP_BLOCK + 5, 40, 52, 2
    frames = jnp.asarray(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    rect = mpf._Rect(
        cx=jnp.asarray(rng.uniform(5, W - 5, (T, K)), jnp.float32),
        cy=jnp.asarray(rng.uniform(5, H - 5, (T, K)), jnp.float32),
        side=jnp.asarray(rng.uniform(10, 40, (T, K)), jnp.float32),
        rot=jnp.asarray(rng.uniform(-0.6, 0.6, (T, K)), jnp.float32))
    blocked = np.asarray(mpf._crop_faces(frames, rect, 16))
    direct = np.asarray(jax.vmap(lambda f, rk: jax.vmap(
        lambda r: mpf._crop_rotated(f, r, 16))(rk))(frames, rect))
    # Tolerance covers FMA-contraction jitter between the lax.map and
    # plain-vmap compile contexts (ULP-level in the sample-grid floats,
    # amplified through the tap weights); an indexing/ordering bug would
    # show O(0.1) errors.
    np.testing.assert_allclose(blocked, direct, atol=1e-5, rtol=0)


def test_crop_axis_mxu_matches_ref_rot0():
    """The separable matmul crop must reproduce the direct bilinear reference
    at rot=0 within ~1 u8 LSB (bf16-rounded interp weights), including
    edge-spilling rects that exercise the clamp columns."""
    rng = np.random.default_rng(11)
    H, W = 97, 133
    img = jnp.asarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    cases = [
        (60.0, 50.0, 40.0),             # interior
        (2.0, 3.0, 50.0),               # spills top-left
        (131.0, 95.0, 60.0),            # spills bottom-right
        (66.0, 48.0, 400.0),            # rect far larger than the frame
        (-20.0, -10.0, 30.0),           # fully outside (all taps clamped)
    ]
    for cx, cy, side in cases:
        rect = mpf._Rect(cx=jnp.float32(cx), cy=jnp.float32(cy),
                         side=jnp.float32(side), rot=jnp.float32(0.0))
        fast = np.asarray(mpf._crop_axis_mxu(img, rect, 48))
        ref = np.asarray(mpf._crop_rotated_ref(img, rect, 48))
        np.testing.assert_allclose(fast, ref, atol=2.0 / 255.0, rtol=0,
                                   err_msg=str((cx, cy, side)))


def test_crop_faces_axis_blocked_matches_direct():
    """_crop_faces(mode="axis") with T > _CROP_BLOCK must equal the
    per-frame direct matmul crop."""
    rng = np.random.default_rng(5)
    T, H, W, K = mpf._CROP_BLOCK + 3, 40, 52, 2
    frames = jnp.asarray(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    rect = mpf._Rect(
        cx=jnp.asarray(rng.uniform(5, W - 5, (T, K)), jnp.float32),
        cy=jnp.asarray(rng.uniform(5, H - 5, (T, K)), jnp.float32),
        side=jnp.asarray(rng.uniform(10, 40, (T, K)), jnp.float32),
        rot=jnp.zeros((T, K), jnp.float32))
    blocked = np.asarray(mpf._crop_faces(frames, rect, 16, mode="axis"))
    direct = np.asarray(jax.vmap(lambda f, rk: jax.vmap(
        lambda r: mpf._crop_axis_mxu(f, r, 16))(rk))(frames, rect))
    np.testing.assert_allclose(blocked, direct, atol=1e-5, rtol=0)


# --- behavior with the production weights ----------------------------------

def test_bf16_compute_mode_agrees_with_f32():
    """compute_dtype=bf16 (the bf16 matmul mode) must reproduce the f32 result:
    same detection box, landmarks within 1 px RMS, score within 1e-2."""
    img = draw_face()
    fr = jnp.asarray(img[None])
    out = {}
    for name, cd in (("f32", None), ("bf16", jnp.bfloat16)):
        params, da, la = mpf.load_face_models(TASK, compute_dtype=cd)
        rects, scores, ok = mpf.detect_faces_mp(params, da, fr, k_faces=1)
        lm, presence = mpf.face_landmarks(params, la, fr, rects)
        assert bool(np.asarray(ok)[0, 0]), name
        out[name] = (np.asarray(lm)[0, 0], float(np.asarray(scores)[0, 0]),
                     float(np.asarray(presence)[0, 0]))
    lm_rms = float(np.sqrt(np.mean(
        (out["f32"][0] - out["bf16"][0]) ** 2)))
    assert lm_rms < 1.0, lm_rms
    assert abs(out["f32"][1] - out["bf16"][1]) < 1e-2
    assert abs(out["f32"][2] - out["bf16"][2]) < 5e-2


def test_detects_drawn_face():
    det = mpf.make_mediapipe_detector(TASK)
    img = draw_face()
    boxes, valid = jax.jit(lambda f: det(f))(jnp.asarray(img[None]))
    assert bool(valid[0])
    x1, y1, x2, y2 = np.asarray(boxes[0])
    # landmark min/max box sits on the drawn face (ellipse spans
    # x 105..215, y 55..205)
    assert 90 <= x1 <= 130 and 190 <= x2 <= 230
    assert 50 <= y1 <= 100 and 180 <= y2 <= 230
    # pure noise -> no detection
    noise = np.random.default_rng(0).integers(0, 255, img.shape, np.uint8)
    _, v2 = jax.jit(lambda f: det(f))(jnp.asarray(noise[None]))
    assert not bool(v2[0])


@pytest.mark.slow
def test_tracks_rotated_face():
    import cv2
    img = draw_face()
    M = cv2.getRotationMatrix2D((160, 128), 25, 1.0)
    rot = cv2.warpAffine(img, M, (320, 256), borderValue=(60, 70, 80))
    params, det_apply, lm_apply = mpf.load_face_models(TASK)
    frames = jnp.asarray(np.stack([img, rot]))
    rects, scores, ok = mpf.detect_faces_mp(params, det_apply, frames, 1)
    assert bool(ok[0, 0]) and bool(ok[1, 0])
    # the in-plane rotation shows up in the eye-keypoint angle
    d_deg = np.degrees(float(rects.rot[1, 0]) - float(rects.rot[0, 0]))
    assert -35.0 <= d_deg <= -15.0
    _, presence = mpf.face_landmarks(params, lm_apply, frames, rects)
    assert float(presence[1, 0]) > 0.9


@pytest.mark.slow
def test_mediapipe_detector_drives_pipeline():
    """extract_signals(detector=mediapipe) recovers the injected pulse."""
    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.pipeline import offline

    fps, T = 30.0, 48
    img = draw_face(H=192, W=224, cx=112, cy=96, rx=45, ry=62)
    pulse = 3.0 * np.sin(2 * np.pi * 1.25 * np.arange(T) / fps)
    frames = np.repeat(img[None], T, axis=0).astype(np.float32)
    ys, xs = np.mgrid[0:192, 0:224]
    skin = ((xs - 112) / 45.0) ** 2 + ((ys - 96) / 62.0) ** 2 <= 1.0
    frames[:, skin, 1] += pulse[:, None]
    frames = np.clip(frames, 0, 255).astype(np.uint8)

    det = mpf.make_mediapipe_detector(TASK)
    trace = offline.extract_signals(jnp.asarray(frames), detector=det)
    valid = np.asarray(trace.valid)
    assert valid.mean() > 0.9
    green = np.asarray(trace.bgr[:, 1])[valid]
    # cheek-ROI green mean carries the injected 1.25 Hz pulse
    assert green.std() > 0.3
    centred = green - green.mean()
    ref = pulse[valid] - pulse[valid].mean()
    corr = np.dot(centred, ref) / (np.linalg.norm(centred)
                                   * np.linalg.norm(ref) + 1e-9)
    assert corr > 0.9


def test_bf16_activation_mode_agrees_with_f32():
    """activation_dtype=bf16 stores every feature map in bf16 — halving
    the activation memory traffic that dominates these nets.  Landmarks
    must stay within ~1 px RMS of f32; the face must still be found with
    confident presence."""
    img = draw_face()
    fr = jnp.asarray(img[None])
    out = {}
    for name, kw in (("f32", {}),
                     ("bf16a", {"activation_dtype": jnp.bfloat16})):
        params, da, la = mpf.load_face_models(TASK, **kw)
        rects, scores, ok = mpf.detect_faces_mp(params, da, fr, k_faces=1)
        lm, presence = mpf.face_landmarks(params, la, fr, rects)
        assert bool(np.asarray(ok)[0, 0]), name
        out[name] = (np.asarray(lm)[0, 0], float(np.asarray(presence)[0, 0]))
    lm_rms = float(np.sqrt(np.mean((out["f32"][0] - out["bf16a"][0]) ** 2)))
    assert lm_rms < 1.5, lm_rms
    assert out["bf16a"][1] > 0.5


def test_letterbox_matmul_matches_jax_image_resize():
    """The separable interp-matrix letterbox (matmul form) must reproduce
    jax.image.resize('bilinear') — including its antialiasing triangle
    kernel on downscale — to matmul-reassociation tolerance."""
    rng = np.random.default_rng(3)
    frames = jnp.asarray(rng.integers(0, 256, (2, 90, 160, 3), np.uint8))
    size = 128
    T, H, W, _ = frames.shape
    scale, h2, w2, px, py = mpf._letterbox_geometry(H, W, size)
    rgb = frames[..., ::-1].astype(jnp.float32)
    small = jax.image.resize(rgb, (T, h2, w2, 3), "bilinear")
    canvas = jnp.zeros((T, size, size, 3), jnp.float32)
    canvas = jax.lax.dynamic_update_slice(canvas, small, (0, py, px, 0))
    ref = canvas * (2.0 / 255.0) - 1.0
    got = mpf._letterbox(frames, size, -1.0, 1.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)

