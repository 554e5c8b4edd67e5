"""EVM color-magnification app: make the pulse visible in a video.

The working version of the reference's planned-but-dead EVM feature
(``rppg_VIDEO.py:120-124`` stub; README mention).  Streams a video through
``vhr_tpu.pipeline.evm.magnify`` in chunks and writes the amplified result.

Usage::

    python -m vhr_tpu.apps.evm_magnify in.mp4 out.mp4 \
        [--alpha 50] [--low-hz 0.83] [--high-hz 1.0] [--levels 4]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    import jax.numpy as jnp

    from ..config import EVMConfig, HRBand
    from ..io import video as vio
    from ..pipeline import evm

    p = argparse.ArgumentParser(description="Eulerian color magnification")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--alpha", type=float, default=50.0)
    p.add_argument("--low-hz", type=float, default=0.83)
    p.add_argument("--high-hz", type=float, default=1.0)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--chunk-seconds", type=float, default=20.0,
                   help="temporal chunk length (FFT bandpass is per chunk)")
    args = p.parse_args(argv)

    cfg = EVMConfig(pyramid_levels=args.levels, amplification=args.alpha,
                    band=HRBand(args.low_hz, args.high_hz))

    import cv2
    writer = None
    total = 0
    for chunk, fps, _ in vio.iter_video_chunks(
            args.input, chunk_frames=max(16, int(args.chunk_seconds * 30))):
        out = np.asarray(evm.magnify(jnp.asarray(chunk), float(fps), cfg))
        if writer is None:
            h, w = out.shape[1:3]
            writer = cv2.VideoWriter(args.output,
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
        for f in out:
            writer.write(np.ascontiguousarray(f))
        total += out.shape[0]
        print(f"magnified {total} frames", flush=True)
    if writer is not None:
        writer.release()
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    from vhr_tpu.backend import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())
