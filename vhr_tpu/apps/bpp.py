"""Video statistics tool — the ``bpp.py`` equivalent.

Bits-per-pixel, per-frame entropy, noise variance and noise-to-signal ratio
of a video (``bpp.py:5-176``), with the per-frame statistics computed as one
batched JAX program per chunk (``vhr_tpu.ops.reduce.video_stats``) instead
of a per-frame OpenCV loop.

Usage::

    python -m vhr_tpu.apps.bpp VIDEO [--json]
    python -m vhr_tpu.apps.bpp --videos-dir video-footage   # stdin picker
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def compute_stats(video_path: str, chunk_frames: int = 256) -> dict:
    import jax.numpy as jnp

    from ..io import video as vio
    from ..ops.reduce import video_stats

    width, height, fps, _, bitrate = vio.video_metadata(video_path)
    pixels_per_second = width * height * fps
    bpp = bitrate / pixels_per_second if pixels_per_second else float("nan")

    ent, noise, nsr, n = [], [], [], 0
    for chunk, _, _ in vio.iter_video_chunks(video_path, chunk_frames):
        s = video_stats(jnp.asarray(chunk))
        ent.append(np.asarray(s.entropy))
        noise.append(np.asarray(s.noise_variance))
        nsr.append(np.asarray(s.nsr))
        n += chunk.shape[0]

    return {
        "width": width, "height": height, "fps": fps,
        "bitrate_kbps": bitrate / 1000.0,
        "bpp": bpp,
        "frames": n,
        "avg_entropy": float(np.concatenate(ent).mean()) if n else None,
        "avg_noise_variance": float(np.concatenate(noise).mean()) if n else None,
        "avg_nsr": float(np.concatenate(nsr).mean()) if n else None,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Video statistics")
    p.add_argument("video", nargs="?")
    p.add_argument("--videos-dir", default="video-footage")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    path = args.video
    if path is None:
        files = sorted(os.listdir(args.videos_dir))
        print("Select input video file:")
        for i, f in enumerate(files):
            print(f"[{i + 1}] {f}")
        choice = int(input().strip()) - 1
        if not 0 <= choice < len(files):
            print("Invalid choice, exiting...")
            return 1
        path = os.path.join(args.videos_dir, files[choice])

    s = compute_stats(path)
    if args.json:
        print(json.dumps(s))
    else:
        print(f"Height: {s['height']}px")
        print(f"Width: {s['width']}px")
        print(f"Framerate: {s['fps']}/s")
        print(f"Bitrate: {s['bitrate_kbps']}kb/s")
        print(f"BPP: {s['bpp']:.4f}b/p")
        print(f"Average Entropy of the Video: {s['avg_entropy']:.4f}")
        print(f"Average Noise (Variance) of the Video: "
              f"{s['avg_noise_variance']:.4f}")
        print(f"Average NSR of the Video: {s['avg_nsr']:.4f}")
    return 0


if __name__ == "__main__":
    from vhr_tpu.backend import enable_compile_cache
    enable_compile_cache()
    raise SystemExit(main())
