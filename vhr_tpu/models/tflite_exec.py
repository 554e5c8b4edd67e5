"""Execute parsed TFLite graphs: a jittable JAX builder + a numpy oracle.

The MediaPipe face graphs (``vhr_tpu.models.tflite``) use a 10-op subset:
CONV_2D, DEPTHWISE_CONV_2D, ADD, RELU, PRELU, PAD, MAX_POOL_2D, RESHAPE,
CONCATENATION, LOGISTIC (+ fp16-constant DEQUANTIZE, folded at load).

Two independent executors of the same graph description:

* :func:`build_jax` — the product path: weights as a pytree, a pure
  ``apply(params, x)`` traced once under ``jit``; convs lower to
  ``lax.conv_general_dilated`` (NHWC/HWIO), everything else fuses.  Batch over frames by vmapping/batching the leading axis.
* :class:`NumpyInterpreter` — the validation oracle: an im2col conv
  interpreter written against numpy only, sharing *no* execution code with
  the JAX path (TF is not in this image, so op-level validation is
  two-independent-implementations agreement, checked in
  ``tests/test_tflite.py``).

Reference consumer of these graphs: mediapipe runtime at
``/root/reference/analysis/utils/roi.py:70-90``, ``rppg_VIDEO.py:25-46``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .tflite import Operator, Subgraph

__all__ = ["fold_dequantize", "build_jax", "NumpyInterpreter",
           "SUPPORTED_OPS"]

SUPPORTED_OPS = frozenset({
    "CONV_2D", "DEPTHWISE_CONV_2D", "ADD", "RELU", "PRELU", "PAD",
    "MAX_POOL_2D", "RESHAPE", "CONCATENATION", "LOGISTIC",
})


def fold_dequantize(graph: Subgraph) -> Subgraph:
    """Fold ``DEQUANTIZE(const fp16) -> fp32`` into fp32 constant tensors.

    Both face graphs store weights as fp16 constants dequantized at graph
    entry; after folding, the op stream contains only :data:`SUPPORTED_OPS`.
    """
    ops: List[Operator] = []
    for op in graph.operators:
        if op.op == "DEQUANTIZE":
            src = graph.tensors[op.inputs[0]]
            if src.data is None:
                raise NotImplementedError(
                    "runtime DEQUANTIZE (non-constant input) unsupported")
            dst = graph.tensors[op.outputs[0]]
            dst.data = src.data.astype(np.float32)
            continue
        if op.op not in SUPPORTED_OPS:
            raise NotImplementedError(f"op {op.op} not in supported subset")
        ops.append(op)
    return Subgraph(name=graph.name, tensors=graph.tensors,
                    inputs=graph.inputs, outputs=graph.outputs,
                    operators=ops)


def _activation(name):
    import jax.numpy as jnp
    if name is None:
        return lambda x: x
    if name == "RELU":
        return lambda x: jnp.maximum(x, 0.0)
    if name == "RELU6":
        return lambda x: jnp.clip(x, 0.0, 6.0)
    raise NotImplementedError(f"fused activation {name}")


def build_jax(graph: Subgraph, compute_dtype=None,
              activation_dtype=None):
    """Compile the graph description to ``(params, apply)``.

    ``params`` maps tensor-index strings to constant arrays (a flat pytree —
    weights stay jit *arguments*, never baked XLA literals); ``apply(params,
    x)`` returns the tuple of graph outputs.  Shapes are static, control
    flow is straight-line: one fused XLA program per input shape.

    Precision of each mode (convolutions go to cuDNN on a GPU):

    * default (both ``None``): f32 storage; the convolutions run at XLA's
      default precision, which on an NVIDIA GPU may use TF32 tensor cores
      (about 11 significant bits per product, f32 accumulation).
    * ``compute_dtype=jnp.bfloat16``: conv inputs/filters in bf16 with f32
      accumulation (``preferred_element_type``) — the weights ship as fp16
      constants in the flatbuffer, so bf16's 8-bit mantissa costs only ~2
      bits of stored precision.  Biases, PRELU and LOGISTIC stay f32;
      activations between ops stay f32.
    * ``activation_dtype=jnp.bfloat16`` (the product mode): every feature
      map is also STORED in bf16 (convs emit bf16; elementwise ops run in
      bf16), halving activation memory traffic, which dominates these
      nets.  Accumulation inside each conv is still f32; only inter-op
      storage rounds.  LOGISTIC and the graph outputs are computed and
      returned in f32.  Landmark RMS vs the f32 path on the real face
      graphs is pinned in tests/test_mediapipe_face.py.
    """
    import jax.numpy as jnp
    from jax import lax

    graph = fold_dequantize(graph)
    ad = activation_dtype
    cd = compute_dtype if ad is None else ad
    acc = (dict(preferred_element_type=jnp.float32)
           if (cd is not None and ad is None) else {})

    def _cd(t):
        return t.astype(cd) if cd is not None else t

    def _ad(t):
        return t.astype(ad) if ad is not None else t

    # Constants that ops actually read become params; PAD paddings and
    # RESHAPE shapes stay Python-side (they must be static).
    const_idx = set()
    for op in graph.operators:
        for i in op.inputs:
            if i >= 0 and graph.tensors[i].data is not None:
                if op.op in ("PAD", "RESHAPE") and i == op.inputs[-1]:
                    continue        # static geometry operand
                const_idx.add(i)
    params = {str(i): jnp.asarray(graph.tensors[i].data)
              for i in sorted(const_idx)}

    in_idx = graph.inputs[0]
    out_idx = tuple(graph.outputs)
    ops = graph.operators
    tensors = graph.tensors

    def apply(params, x):
        env: Dict[int, jnp.ndarray] = {in_idx: _ad(x)}

        def get(i):
            if i in env:
                return env[i]
            return params[str(i)]

        for op in ops:
            o = op.outputs[0]
            if op.op == "CONV_2D":
                inp, filt, bias = (get(i) for i in op.inputs)
                # TFLite filter is OHWI -> lax wants HWIO.
                y = lax.conv_general_dilated(
                    _cd(inp), _cd(jnp.transpose(filt, (1, 2, 3, 0))),
                    window_strides=op.options["stride"],
                    padding=op.options["padding"],
                    rhs_dilation=op.options["dilation"],
                    dimension_numbers=("NHWC", "HWIO", "NHWC"), **acc)
                y = _activation(op.options["activation"])(y + _ad(bias))
            elif op.op == "DEPTHWISE_CONV_2D":
                inp, filt, bias = (get(i) for i in op.inputs)
                ch_in = inp.shape[-1]
                # TFLite DW filter is (1, kh, kw, ch_in*mult) -> lax rhs
                # (kh, kw, 1, ch_out) with feature_group_count=ch_in; both
                # order output channels input-channel-major, so the reshape
                # lines up exactly.
                y = lax.conv_general_dilated(
                    _cd(inp), _cd(jnp.transpose(filt, (1, 2, 0, 3))),
                    window_strides=op.options["stride"],
                    padding=op.options["padding"],
                    rhs_dilation=op.options["dilation"],
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    feature_group_count=ch_in, **acc)
                y = _activation(op.options["activation"])(y + _ad(bias))
            elif op.op == "ADD":
                y = _activation(op.options.get("activation"))(
                    get(op.inputs[0]) + _ad(get(op.inputs[1])))
            elif op.op == "RELU":
                y = jnp.maximum(get(op.inputs[0]), 0.0)
            elif op.op == "PRELU":
                xin = get(op.inputs[0])
                alpha = _ad(get(op.inputs[1]))
                y = jnp.where(xin >= 0, xin, xin * alpha)
            elif op.op == "PAD":
                pads = tensors[op.inputs[1]].data
                y = jnp.pad(get(op.inputs[0]),
                            [tuple(p) for p in np.asarray(pads)])
            elif op.op == "MAX_POOL_2D":
                xin = get(op.inputs[0])
                y = lax.reduce_window(
                    xin, jnp.asarray(-jnp.inf, xin.dtype), lax.max,
                    (1,) + tuple(op.options["filter"]) + (1,),
                    (1,) + tuple(op.options["stride"]) + (1,),
                    op.options["padding"])
                y = _activation(op.options["activation"])(y)
            elif op.op == "RESHAPE":
                shape = op.options.get("new_shape")
                if shape is None and len(op.inputs) > 1:
                    shape = tuple(int(s)
                                  for s in tensors[op.inputs[1]].data)
                if shape is None:
                    shape = tensors[o].shape     # static output shape
                xin = get(op.inputs[0])
                shape = tuple(int(s) for s in shape)
                if any(s < 0 for s in shape):
                    # Wildcard target (e.g. the mesh net's (-1, 1)
                    # presence reshape): resolve it against the baked
                    # batch-1 static output shape, then batch-scale below
                    # like any literal target — a raw jnp.reshape of a
                    # batched input against a (1, -1)-style target would
                    # fold the batch into the wrong axis.
                    shape = tuple(int(s) for s in tensors[o].shape)
                if int(np.prod(shape)) != xin.size:
                    # Batch-agnostic reshape: the flatbuffer bakes batch-1
                    # target shapes; scale the leading dim so apply() also
                    # accepts a flat (B, ...) batch without vmap.  Only a
                    # unit leading dim is provably batch-scalable; anything
                    # else would silently mis-fold the batch — refuse
                    # loudly instead.
                    if shape[0] != 1:
                        raise ValueError(
                            f"RESHAPE target {shape} is not batch-agnostic "
                            f"for input size {xin.size} (need a unit "
                            f"leading dim)")
                    rest = int(np.prod(shape[1:]))
                    if rest <= 0 or xin.size % rest != 0:
                        raise ValueError(
                            f"RESHAPE: input size {xin.size} not divisible "
                            f"by per-sample size {rest} (target {shape})")
                    shape = (xin.size // rest,) + shape[1:]
                y = jnp.reshape(xin, shape)
            elif op.op == "CONCATENATION":
                y = jnp.concatenate([get(i) for i in op.inputs],
                                    axis=op.options["axis"])
                y = _activation(op.options["activation"])(y)
            elif op.op == "LOGISTIC":
                x32 = get(op.inputs[0]).astype(jnp.float32)
                y = 1.0 / (1.0 + jnp.exp(-x32))
            else:                      # unreachable post-fold
                raise NotImplementedError(op.op)
            env[o] = y
        return tuple(env[i].astype(jnp.float32) for i in out_idx)

    return params, apply


# --- independent numpy oracle ----------------------------------------------

def _np_pad_amount(size: int, k: int, s: int, mode: str) -> Tuple[int, int]:
    if mode == "VALID":
        return (0, 0)
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return (total // 2, total - total // 2)


def _np_conv(x: np.ndarray, filt: np.ndarray, bias, stride, padding,
             groups: int = 1) -> np.ndarray:
    """im2col NHWC conv; ``filt`` is OHWI (TFLite layout)."""
    n, h, w, cin = x.shape
    co, kh, kw, ci_g = filt.shape
    sh, sw = stride
    ph = _np_pad_amount(h, kh, sh, padding)
    pw = _np_pad_amount(w, kw, sw, padding)
    xp = np.pad(x, ((0, 0), ph, pw, (0, 0)))
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    # window view: (n, oh, ow, kh, kw, cin)
    sN, sH, sW, sC = xp.strides
    win = np.lib.stride_tricks.as_strided(
        xp, (n, oh, ow, kh, kw, cin),
        (sN, sH * sh, sW * sw, sH, sW, sC), writeable=False)
    if groups == 1:
        cols = win.reshape(n * oh * ow, kh * kw * cin)
        wmat = filt.transpose(1, 2, 3, 0).reshape(kh * kw * ci_g, co)
        y = (cols @ wmat).reshape(n, oh, ow, co)
    else:
        # depthwise: groups == cin, ci_g == 1 after the caller reshapes;
        # filt arrives as TFLite DW layout (1, kh, kw, cin*mult).
        mult = filt.shape[-1] // cin
        f = filt.reshape(kh, kw, cin, mult)
        y = np.einsum("nhwklc,klcm->nhwcm", win, f, optimize=True)
        y = y.reshape(n, oh, ow, cin * mult)
    return y + bias


class NumpyInterpreter:
    """Tensor-by-tensor numpy evaluation of a (folded) subgraph."""

    def __init__(self, graph: Subgraph):
        self.graph = fold_dequantize(graph)

    def __call__(self, x: np.ndarray) -> Tuple[np.ndarray, ...]:
        g = self.graph
        env: Dict[int, np.ndarray] = {g.inputs[0]: np.asarray(x, np.float32)}

        def get(i):
            if i in env:
                return env[i]
            return g.tensors[i].data

        def act(name, y):
            if name == "RELU":
                return np.maximum(y, 0.0)
            if name == "RELU6":
                return np.clip(y, 0.0, 6.0)
            return y

        for op in g.operators:
            if op.op == "CONV_2D":
                y = _np_conv(get(op.inputs[0]), get(op.inputs[1]),
                             get(op.inputs[2]), op.options["stride"],
                             op.options["padding"])
                y = act(op.options["activation"], y)
            elif op.op == "DEPTHWISE_CONV_2D":
                xin = get(op.inputs[0])
                y = _np_conv(xin, get(op.inputs[1]), get(op.inputs[2]),
                             op.options["stride"], op.options["padding"],
                             groups=xin.shape[-1])
                y = act(op.options["activation"], y)
            elif op.op == "ADD":
                y = act(op.options.get("activation"),
                        get(op.inputs[0]) + get(op.inputs[1]))
            elif op.op == "RELU":
                y = np.maximum(get(op.inputs[0]), 0.0)
            elif op.op == "PRELU":
                xin = get(op.inputs[0])
                alpha = get(op.inputs[1])
                y = np.where(xin >= 0, xin, xin * alpha)
            elif op.op == "PAD":
                pads = np.asarray(get(op.inputs[1]))
                y = np.pad(get(op.inputs[0]), [tuple(p) for p in pads])
            elif op.op == "MAX_POOL_2D":
                xin = get(op.inputs[0])
                kh, kw = op.options["filter"]
                sh, sw = op.options["stride"]
                n, h, w, c = xin.shape
                ph = _np_pad_amount(h, kh, sh, op.options["padding"])
                pw = _np_pad_amount(w, kw, sw, op.options["padding"])
                xp = np.pad(xin, ((0, 0), ph, pw, (0, 0)),
                            constant_values=-np.inf)
                oh = (xp.shape[1] - kh) // sh + 1
                ow = (xp.shape[2] - kw) // sw + 1
                sN, sH, sW, sC = xp.strides
                win = np.lib.stride_tricks.as_strided(
                    xp, (n, oh, ow, kh, kw, c),
                    (sN, sH * sh, sW * sw, sH, sW, sC), writeable=False)
                y = act(op.options["activation"], win.max(axis=(3, 4)))
            elif op.op == "RESHAPE":
                shape = op.options.get("new_shape")
                if shape is None and len(op.inputs) > 1:
                    shape = tuple(int(s)
                                  for s in g.tensors[op.inputs[1]].data)
                if shape is None:
                    shape = g.tensors[op.outputs[0]].shape
                y = np.reshape(get(op.inputs[0]), shape)
            elif op.op == "CONCATENATION":
                y = act(op.options["activation"],
                        np.concatenate([get(i) for i in op.inputs],
                                       axis=op.options["axis"]))
            elif op.op == "LOGISTIC":
                y = 1.0 / (1.0 + np.exp(-get(op.inputs[0])))
            else:
                raise NotImplementedError(op.op)
            env[op.outputs[0]] = y.astype(np.float32)
        return tuple(env[i] for i in g.outputs)
