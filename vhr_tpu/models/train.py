"""Landmark-model training: synthetic supervision, mesh-sharded train step.

The reference ships frozen MediaPipe weights (``face_landmarker.task``) and
has no training capability at all.  Here the landmark model trains end to end
on the synthetic face generator (``vhr_tpu.utils.synth``) with a mesh-sharded
``train_step``:

* **dp** — batch sharded over the ``data`` mesh axis; gradients reduced by
  XLA collectives inserted from the shardings (no hand-written psum);
* **tp** — dense-layer kernels sharded over the ``model`` axis (the trunk
  and head matmuls are the FLOPs).

The same step runs on one chip (trivial mesh) or a pod slice; the driver's
``dryrun_multichip`` exercises it on a virtual 8-device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import facegen
from .landmarker import FaceLandmarker, LandmarkerConfig

__all__ = ["TrainConfig", "init_state", "make_train_step", "synth_batch",
           "param_shardings", "train", "evaluate_iou"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: LandmarkerConfig = LandmarkerConfig()
    # The HARD generator (full tone range, colored light, skin backgrounds,
    # pose/occlusion/texture) — see models/facegen.py; round 1 trained on
    # plain ellipses, which the weight-free chroma detector also solves.
    gen: facegen.FaceGenConfig = facegen.FaceGenConfig()
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 64
    presence_weight: float = 0.2
    # Extra weight on the landmark cloud's min/max box — the ONLY quantity
    # the rPPG pipeline consumes (rppg_VIDEO.py:93-98), so its extremes
    # deserve more gradient than the average landmark.
    bbox_weight: float = 2.0
    total_steps: int = 4000              # cosine decay horizon


def init_state(cfg: TrainConfig, rng: jax.Array):
    model = FaceLandmarker(cfg.model)
    s = cfg.model.input_size
    params = model.init(rng, jnp.zeros((1, s, s, 3)))["params"]
    sched = optax.cosine_decay_schedule(cfg.learning_rate, cfg.total_steps,
                                        alpha=0.05)
    tx = optax.adamw(sched, weight_decay=cfg.weight_decay)
    opt_state = tx.init(params)
    return model, params, tx, opt_state


def param_shardings(params, mesh: Mesh):
    """Tensor-parallel layout: shard every >=2-D kernel's output features
    over the ``model`` axis when divisible; replicate the rest."""
    model_size = mesh.shape["model"]

    def spec_for(path, x):
        if x.ndim >= 2 and x.shape[-1] % model_size == 0:
            return NamedSharding(mesh, P(*([None] * (x.ndim - 1) + ["model"])))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)


def _loss_fn(model, params, batch, presence_weight, bbox_weight=0.0):
    img = batch["image"]
    if img.dtype == jnp.uint8:    # facegen ships u8; normalize on device
        img = img.astype(jnp.float32) / 255.0
    lm, presence = model.apply({"params": params}, img)
    lm_err = jnp.sum((lm - batch["landmarks"]) ** 2, axis=-1)   # (B, L)
    has = batch["has_face"]
    lm_loss = jnp.mean(jnp.where(has[:, None], lm_err, 0.0))
    bce = optax.sigmoid_binary_cross_entropy(
        presence, has.astype(jnp.float32))
    loss = lm_loss + presence_weight * jnp.mean(bce)
    if bbox_weight:
        pb = jnp.concatenate([jnp.min(lm, axis=1), jnp.max(lm, axis=1)], -1)
        tb = jnp.concatenate([jnp.min(batch["landmarks"], axis=1),
                              jnp.max(batch["landmarks"], axis=1)], -1)
        bbox_err = jnp.sum(jnp.abs(pb - tb), axis=-1)           # (B,)
        loss = loss + bbox_weight * jnp.mean(jnp.where(has, bbox_err, 0.0))
    return loss, (lm_loss, jnp.mean(bce))


def make_train_step(model, tx, cfg: TrainConfig, mesh: Mesh = None,
                    params_example=None):
    """Build the jitted, mesh-sharded train step.

    With a mesh: params/opt-state follow :func:`param_shardings`, the batch
    shards over ``data``; XLA derives the all-reduce for the data-parallel
    gradient and the collectives for the model-sharded matmuls.
    """
    def step(params, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: _loss_fn(model, p, batch, cfg.presence_weight,
                               cfg.bbox_weight),
            has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, aux

    if mesh is None:
        return jax.jit(step)

    p_shard = param_shardings(params_example, mesh)
    batch_spec = {
        "image": NamedSharding(mesh, P("data")),
        "landmarks": NamedSharding(mesh, P("data")),
        "has_face": NamedSharding(mesh, P("data")),
    }
    # adamw's mu/nu mirror the param tree -> same tensor-parallel layout;
    # scalar counts replicate.  `None` lets jit propagate from the params.
    return jax.jit(
        step,
        in_shardings=(p_shard, None, batch_spec),
        out_shardings=(p_shard, None, NamedSharding(mesh, P()),
                       (NamedSharding(mesh, P()), NamedSharding(mesh, P()))),
    )


def synth_batch(cfg: TrainConfig, rng: np.random.Generator
                ) -> Dict[str, np.ndarray]:
    """A batch from the hard face generator (``models/facegen.py``)."""
    gen = dataclasses.replace(cfg.gen, size=cfg.model.input_size)
    return facegen.sample_batch(gen, rng, cfg.batch_size,
                                cfg.model.num_landmarks)


def train(cfg: TrainConfig, steps: int, seed: int = 0, mesh: Mesh = None,
          log_every: int = 0, init_params=None, batch_fn=None):
    """Train the landmarker on synthetic faces; returns (model, params, losses).

    ``init_params`` warm-starts from an existing checkpoint (fine-tuning:
    pair with a lower ``cfg.learning_rate`` / shorter ``cfg.total_steps``
    cosine horizon); the optimizer state starts fresh.  ``batch_fn``
    overrides the data source (default :func:`synth_batch`; e.g.
    ``realgen.make_mixed_batch_fn`` for real-photo distillation).
    """
    if batch_fn is None:
        batch_fn = synth_batch
    rng = np.random.default_rng(seed)
    model, params, tx, opt_state = init_state(cfg, jax.random.PRNGKey(seed))
    if init_params is not None:
        params = init_params
        opt_state = tx.init(params)
    step = make_train_step(model, tx, cfg, mesh=mesh, params_example=params)
    if mesh is not None:
        params = jax.tree.map(jax.device_put, params,
                              param_shardings(params, mesh))
    losses_dev = []
    for i in range(steps):
        batch = jax.tree.map(jnp.asarray, batch_fn(cfg, rng))
        params, opt_state, loss, aux = step(params, opt_state, batch)
        # No per-step host sync: batch generation for step i+1 overlaps
        # device execution of step i.  A forced sync every 2 steps keeps
        # the async queue (and the device memory it holds) bounded.
        losses_dev.append(loss)
        if (i + 1) % 2 == 0:
            jax.block_until_ready(loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps}: loss={float(loss):.4f} "
                  f"(lm={float(aux[0]):.4f} bce={float(aux[1]):.4f})",
                  flush=True)
    losses = (np.asarray(jnp.stack(losses_dev)).tolist()
              if losses_dev else [])
    return model, params, losses


def evaluate_iou(params, cfg: TrainConfig, n_clips: int = 8,
                 frames_per_clip: int = 8, held_out: bool = True,
                 seed: int = 1234, threshold: float = 0.0) -> float:
    """Mean box IoU of the learned detector on generator clips.

    ``held_out=True`` (the honest bar) draws from the DISJOINT evaluation
    family of ``facegen`` — interpolated tones, shifted scale/aspect/angle
    ranges, elliptical occluders — never the training family.
    """
    from .landmarker import make_detector

    gen = dataclasses.replace(cfg.gen, size=cfg.model.input_size,
                              held_out=held_out, face_prob=1.0)
    det = make_detector(params, cfg.model, threshold)
    rng = np.random.default_rng(seed)
    ious = []
    for c in range(n_clips):
        hw = [(96, 96), (96, 120), (120, 160)][c % 3]
        frames, truth = facegen.render_clip(gen, rng, frames_per_clip, *hw)
        boxes, valid = det(jnp.asarray(frames))
        b = np.asarray(boxes)
        for i in range(frames_per_clip):
            ix = max(0, min(b[i, 2], truth[i, 2]) - max(b[i, 0], truth[i, 0]))
            iy = max(0, min(b[i, 3], truth[i, 3]) - max(b[i, 1], truth[i, 1]))
            inter = ix * iy
            union = ((b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
                     + (truth[i, 2] - truth[i, 0])
                     * (truth[i, 3] - truth[i, 1]) - inter)
            ious.append(inter / max(union, 1))
    return float(np.mean(ious))


def main(argv=None):
    """CLI: train + evaluate + checkpoint the landmarker.

    ``python -m vhr_tpu.models.train --steps 4000 --out checkpoints/landmarker``
    """
    import argparse

    from . import checkpoint as ckpt

    ap = argparse.ArgumentParser(description=train.__doc__)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="checkpoint dir")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to warm-start (fine-tune) from")
    ap.add_argument("--eval-clips", type=int, default=12)
    ap.add_argument("--real-frac", type=float, default=0.0,
                    help="fraction of each batch drawn from the real-photo "
                         "distillation generator (models/realgen.py)")
    args = ap.parse_args(argv)

    cfg = TrainConfig(batch_size=args.batch_size, learning_rate=args.lr,
                      total_steps=args.steps)
    init_params = ckpt.load_params(args.resume) if args.resume else None
    batch_fn = None
    if args.real_frac > 0.0:
        from .realgen import make_mixed_batch_fn
        batch_fn = make_mixed_batch_fn(real_frac=args.real_frac)
    model, params, losses = train(cfg, args.steps, seed=args.seed,
                                  log_every=max(1, args.steps // 20),
                                  init_params=init_params,
                                  batch_fn=batch_fn)
    iou_ho = evaluate_iou(params, cfg, n_clips=args.eval_clips,
                          held_out=True)
    iou_tr = evaluate_iou(params, cfg, n_clips=args.eval_clips,
                          held_out=False)
    print(f"final loss {losses[-1]:.4f}; IoU train-family {iou_tr:.3f}, "
          f"HELD-OUT {iou_ho:.3f}")
    if args.out:
        ckpt.save_params(args.out, params)
        print(f"saved {args.out}")


if __name__ == "__main__":
    main()
