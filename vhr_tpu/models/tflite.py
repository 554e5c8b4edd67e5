"""First-party TFLite flatbuffer reader — no TensorFlow, no generated code.

The reference ships its face models as MediaPipe's ``face_landmarker.task``
(a zip of ``.tflite`` graphs, consumed via the mediapipe runtime at
``/root/reference/analysis/utils/roi.py:70-90`` and
``/root/reference/rppg_VIDEO.py:25-46``).  This module reads the
flatbuffer *directly* with ``struct`` — a few lines of vtable navigation
(the FlatBuffers binary format: little-endian tables that point at a
vtable of 16-bit field offsets) — and the TFLite schema's stable field ids
transcribed from the public ``tensorflow/lite/schema/schema.fbs``.  No
TensorFlow, MediaPipe or ``flatbuffers`` package is needed.

Output is a plain :class:`TFLiteModel` graph description (tensors with
shapes/dtypes/constant data, operators with resolved builtin names and
options) that :mod:`vhr_tpu.models.tflite_exec` turns into a jittable JAX
function and a numpy oracle.
"""

from __future__ import annotations

import dataclasses
import struct
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["TFLiteModel", "Subgraph", "Tensor", "Operator",
           "parse_tflite", "load_task_models", "BUILTIN_NAMES"]


# --- schema enums (tensorflow/lite/schema/schema.fbs, stable since 2019) ---

TENSOR_DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    5: object, 6: np.bool_, 7: np.int16, 8: np.complex64, 9: np.int8,
}

# BuiltinOperator enum — the subset plus neighbours we might meet; unknown
# codes surface as "OP_<code>" so a new model fails loudly, not wrongly.
BUILTIN_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 5: "DEPTH_TO_SPACE", 6: "DEQUANTIZE",
    9: "FULLY_CONNECTED", 14: "LOGISTIC", 17: "MAX_POOL_2D", 18: "MUL",
    19: "RELU", 21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR",
    25: "SOFTMAX", 28: "TANH", 32: "CUSTOM", 34: "PAD", 36: "GATHER",
    39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV", 43: "SQUEEZE",
    45: "STRIDED_SLICE", 47: "EXP", 49: "SPLIT", 53: "CAST", 54: "PRELU",
    55: "MAXIMUM", 57: "MINIMUM", 59: "NEG", 65: "SLICE", 67: "TRANSPOSE_CONV",
    70: "EXPAND_DIMS", 73: "LOG", 74: "SUM", 75: "SQRT", 76: "RSQRT",
    77: "SHAPE", 78: "POW", 83: "PACK", 88: "UNPACK", 92: "SQUARE",
    97: "RESIZE_NEAREST_NEIGHBOR", 98: "LEAKY_RELU",
    99: "SQUARED_DIFFERENCE", 101: "ABS", 102: "SPLIT_V", 106: "ADD_N",
    114: "QUANTIZE", 117: "HARD_SWISH", 126: "BATCH_MATMUL",
}

ACT_NAMES = {0: None, 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6", 4: "TANH"}
PAD_NAMES = {0: "SAME", 1: "VALID"}


# --- tiny vtable navigation layer -----------------------------------------

def _u32(buf: bytes, pos: int) -> int:
    return struct.unpack_from("<I", buf, pos)[0]


class _T:
    """One flatbuffer table; field ids resolve via the vtable.

    A table starts with a signed 32-bit offset back to its vtable; the
    vtable holds its own byte size, the table's size, then one u16 offset
    per field (0 = field absent).  Offsets to sub-tables, vectors and
    strings are u32, relative to where they are stored.
    """

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vtable)[0]

    def _off(self, field_id: int) -> int:
        """Byte offset of the field inside the table, 0 when absent."""
        slot = 4 + 2 * field_id
        if slot >= self.vt_size:
            return 0
        return struct.unpack_from("<H", self.buf, self.vtable + slot)[0]

    def scalar(self, field_id: int, fmt: str, default=0):
        o = self._off(field_id)
        if o == 0:
            return default
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0]

    def i32(self, fid, default=0):
        return int(self.scalar(fid, "i", default))

    def u32(self, fid, default=0):
        return int(self.scalar(fid, "I", default))

    def i8(self, fid, default=0):
        return int(self.scalar(fid, "b", default))

    def u8(self, fid, default=0):
        return int(self.scalar(fid, "B", default))

    def f32(self, fid, default=0.0):
        return float(self.scalar(fid, "f", default))

    def boolean(self, fid, default=False):
        return bool(self.scalar(fid, "B", default))

    def _indirect(self, field_id: int) -> int:
        """Absolute position the (offset-typed) field points at, or 0."""
        o = self._off(field_id)
        if o == 0:
            return 0
        at = self.pos + o
        return at + _u32(self.buf, at)

    def string(self, fid) -> Optional[str]:
        at = self._indirect(fid)
        if at == 0:
            return None
        n = _u32(self.buf, at)
        return bytes(self.buf[at + 4:at + 4 + n]).decode("utf-8")

    def table(self, fid) -> Optional["_T"]:
        at = self._indirect(fid)
        return None if at == 0 else _T(self.buf, at)

    def union_table(self, fid) -> Optional["_T"]:
        """Union value field: stored like a table field."""
        return self.table(fid)

    def vec_len(self, fid) -> int:
        at = self._indirect(fid)
        return 0 if at == 0 else _u32(self.buf, at)

    def vec_numeric(self, fid, dtype) -> np.ndarray:
        at = self._indirect(fid)
        if at == 0:
            return np.zeros((0,), dtype)
        return np.frombuffer(self.buf, dtype, count=_u32(self.buf, at),
                             offset=at + 4).copy()

    def vec_bytes(self, fid) -> bytes:
        at = self._indirect(fid)
        if at == 0:
            return b""
        return bytes(self.buf[at + 4:at + 4 + _u32(self.buf, at)])

    def vec_table(self, fid, i: int) -> "_T":
        elem = self._indirect(fid) + 4 + i * 4
        return _T(self.buf, elem + _u32(self.buf, elem))


# --- graph description ------------------------------------------------------

@dataclasses.dataclass
class Tensor:
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    data: Optional[np.ndarray]        # constant weights, else None
    quant_scale: Optional[np.ndarray] = None
    quant_zero: Optional[np.ndarray] = None


@dataclasses.dataclass
class Operator:
    op: str                           # builtin name, e.g. "CONV_2D"
    inputs: List[int]                 # tensor indices (-1 = absent optional)
    outputs: List[int]
    options: Dict[str, Any]


@dataclasses.dataclass
class Subgraph:
    name: Optional[str]
    tensors: List[Tensor]
    inputs: List[int]
    outputs: List[int]
    operators: List[Operator]


@dataclasses.dataclass
class TFLiteModel:
    description: Optional[str]
    subgraphs: List[Subgraph]

    @property
    def graph(self) -> Subgraph:
        return self.subgraphs[0]


# --- builtin-options decoding (schema union BuiltinOptions) ---------------

def _conv2d_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1), "dilation": (1, 1),
                "activation": None}
    return {
        "padding": PAD_NAMES[t.i8(0, 0)],
        "stride": (t.i32(2, 1), t.i32(1, 1)),          # (h, w)
        "activation": ACT_NAMES.get(t.i8(3, 0)),
        "dilation": (t.i32(5, 1), t.i32(4, 1)),
    }


def _dwconv2d_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1), "dilation": (1, 1),
                "depth_multiplier": 1, "activation": None}
    return {
        "padding": PAD_NAMES[t.i8(0, 0)],
        "stride": (t.i32(2, 1), t.i32(1, 1)),
        "depth_multiplier": t.i32(3, 1),
        "activation": ACT_NAMES.get(t.i8(4, 0)),
        "dilation": (t.i32(6, 1), t.i32(5, 1)),
    }


def _pool_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1), "filter": (1, 1),
                "activation": None}
    return {
        "padding": PAD_NAMES[t.i8(0, 0)],
        "stride": (t.i32(2, 1), t.i32(1, 1)),
        "filter": (t.i32(4, 1), t.i32(3, 1)),
        "activation": ACT_NAMES.get(t.i8(5, 0)),
    }


def _act_only(field_id: int):
    def go(t: Optional[_T]) -> Dict[str, Any]:
        if t is None:
            return {"activation": None}
        return {"activation": ACT_NAMES.get(t.i8(field_id, 0))}
    return go


def _reshape_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"new_shape": None}
    v = t.vec_numeric(0, np.int32)
    return {"new_shape": tuple(int(x) for x in v) if v.size else None}


def _concat_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"axis": 0, "activation": None}
    return {"axis": t.i32(0, 0), "activation": ACT_NAMES.get(t.i8(1, 0))}


def _strided_slice_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {k: 0 for k in ("begin_mask", "end_mask", "ellipsis_mask",
                               "new_axis_mask", "shrink_axis_mask")}
    return {
        "begin_mask": t.i32(0, 0), "end_mask": t.i32(1, 0),
        "ellipsis_mask": t.i32(2, 0), "new_axis_mask": t.i32(3, 0),
        "shrink_axis_mask": t.i32(4, 0),
    }


def _transpose_conv_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1)}
    return {"padding": PAD_NAMES[t.i8(0, 0)],
            "stride": (t.i32(2, 1), t.i32(1, 1))}


def _resize_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"align_corners": False, "half_pixel_centers": False}
    return {"align_corners": t.boolean(2, False),
            "half_pixel_centers": t.boolean(3, False)}


def _softmax_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"beta": 1.0}
    return {"beta": t.f32(0, 1.0)}


def _fully_connected_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"activation": None, "keep_num_dims": False}
    return {"activation": ACT_NAMES.get(t.i8(0, 0)),
            "keep_num_dims": t.boolean(2, False)}


def _gather_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"axis": 0}
    return {"axis": t.i32(0, 0)}


def _split_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"num_splits": 0}
    return {"num_splits": t.i32(0, 0)}


def _leaky_relu_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"alpha": 0.0}
    return {"alpha": t.f32(0, 0.0)}


def _mean_opts(t: Optional[_T]) -> Dict[str, Any]:   # ReducerOptions
    if t is None:
        return {"keep_dims": False}
    return {"keep_dims": t.boolean(0, False)}


def _pack_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"values_count": 0, "axis": 0}
    return {"values_count": t.i32(0, 0), "axis": t.i32(1, 0)}


# BuiltinOptions union type code -> decoder (schema.fbs union order).
_OPTION_DECODERS = {
    1: _conv2d_opts,            # Conv2DOptions
    2: _dwconv2d_opts,          # DepthwiseConv2DOptions
    5: _pool_opts,              # Pool2DOptions
    8: _fully_connected_opts,   # FullyConnectedOptions
    9: _softmax_opts,           # SoftmaxOptions
    10: _concat_opts,           # ConcatenationOptions
    11: _act_only(0),           # AddOptions
    21: _act_only(0),           # MulOptions
    13: _reshape_opts,          # ReshapeOptions
    23: _resize_opts,           # ResizeBilinearOptions
    25: _mean_opts,             # ReducerOptions (MEAN/SUM/...)
    27: _gather_opts,           # GatherOptions
    28: _strided_slice_opts,    # StridedSliceOptions
    30: _act_only(0),           # SubOptions
    31: _act_only(0),           # DivOptions
    35: _split_opts,            # SplitOptions
    44: _leaky_relu_opts,       # LeakyReluOptions
    54: _pack_opts,             # PackOptions
    66: _transpose_conv_opts,   # TransposeConvOptions
}


# --- parsing ----------------------------------------------------------------

def _parse_tensor(t: _T, buffers: List[bytes]) -> Tensor:
    shape = tuple(int(x) for x in t.vec_numeric(0, np.int32))
    dtype = TENSOR_DTYPES[t.i8(1, 0)]
    buf_idx = t.u32(2, 0)
    name = t.string(3) or ""
    raw = buffers[buf_idx] if buf_idx < len(buffers) else b""
    data = None
    if raw:
        data = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    qscale = qzero = None
    q = t.table(4)
    if q is not None:
        s = q.vec_numeric(2, np.float32)
        z = q.vec_numeric(3, np.int64)
        if s.size:
            qscale, qzero = s, z
    return Tensor(name=name, shape=shape, dtype=dtype, data=data,
                  quant_scale=qscale, quant_zero=qzero)


def _parse_operator(t: _T, opcodes: List[str]) -> Operator:
    op = opcodes[t.u32(0, 0)]
    inputs = [int(x) for x in t.vec_numeric(1, np.int32)]
    outputs = [int(x) for x in t.vec_numeric(2, np.int32)]
    opt_type = t.u8(3, 0)
    decoder = _OPTION_DECODERS.get(opt_type)
    options = decoder(t.union_table(4)) if decoder else {}
    return Operator(op=op, inputs=inputs, outputs=outputs, options=options)


def parse_tflite(data: bytes) -> TFLiteModel:
    """Parse a ``.tflite`` flatbuffer into a plain graph description."""
    if data[4:8] != b"TFL3":
        raise ValueError(f"not a TFLite v3 flatbuffer (magic {data[4:8]!r})")
    model = _T(data, _u32(data, 0))

    n_codes = model.vec_len(1)
    opcodes = []
    for i in range(n_codes):
        oc = model.vec_table(1, i)
        code = oc.i32(3, 0)                     # builtin_code (new field)
        if code == 0:
            code = oc.i8(0, 0)                  # deprecated_builtin_code
        if code == 32:
            opcodes.append(f"CUSTOM:{oc.string(1)}")
        else:
            opcodes.append(BUILTIN_NAMES.get(code, f"OP_{code}"))

    n_buffers = model.vec_len(4)
    buffers = [model.vec_table(4, i).vec_bytes(0) for i in range(n_buffers)]

    subgraphs = []
    for i in range(model.vec_len(2)):
        sg = model.vec_table(2, i)
        tensors = [_parse_tensor(sg.vec_table(0, j), buffers)
                   for j in range(sg.vec_len(0))]
        operators = [_parse_operator(sg.vec_table(3, j), opcodes)
                     for j in range(sg.vec_len(3))]
        subgraphs.append(Subgraph(
            name=sg.string(4), tensors=tensors,
            inputs=[int(x) for x in sg.vec_numeric(1, np.int32)],
            outputs=[int(x) for x in sg.vec_numeric(2, np.int32)],
            operators=operators))

    return TFLiteModel(description=model.string(3), subgraphs=subgraphs)


def load_task_models(task_path: str) -> Dict[str, TFLiteModel]:
    """Parse every ``.tflite`` inside a MediaPipe ``.task`` zip."""
    out = {}
    with zipfile.ZipFile(task_path) as z:
        for info in z.infolist():
            if info.filename.endswith(".tflite"):
                out[info.filename] = parse_tflite(z.read(info.filename))
    return out
