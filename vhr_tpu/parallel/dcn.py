"""Multi-host stream farms over DCN: `jax.distributed` scaffolding.

SURVEY §2C/§5 build decision: batched monitoring scales past one host by
data-parallel sharding of the *stream* axis, where steady state needs no
collectives at all — each host's chips own whole subjects, DCN carries
only input distribution and result gathers.  That makes DCN (slow,
host-level) the right tier for the stream axis while the intra-host
device links stay reserved for tensor/time sharding (`parallel/streams.py`,
`parallel/time_shard.py`).

This module is the thin, host-count-agnostic layer the rest of the code
was already written against:

* :func:`init_cluster` — one-call `jax.distributed.initialize` wrapper
  (coordinator/process_id plumbing, CPU-test friendly).
* :func:`cluster_stream_mesh` — a global 1-axis ``stream`` mesh over every
  device in the cluster.
* :func:`distribute_streams` — per-process local frames -> one global
  sharded array (each process contributes its own subjects).
* :func:`gather_streams` — fetch a global result to every host.

Tested for real (not mocked) in ``tests/test_dcn.py``: two localhost
processes x 4 virtual CPU devices run ``multistream_green_bpm`` over the
2x4=8-device cluster mesh and match the single-process reference
bit-for-bit.  The same code path scales to N accelerator hosts by
changing only ``coordinator`` / ``num_processes`` / ``process_id``.

Reference contrast: the reference has no multi-machine story at all (one
Python process per video, ``analysis/main.py`` loops serially).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_cluster", "cluster_stream_mesh", "distribute_streams",
           "gather_streams"]


def init_cluster(coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None) -> None:
    """Join (or form) the cluster. Call once, before any backend use.

    Pass ``coordinator="host:port"``, ``num_processes`` and
    ``process_id`` (the localhost CPU test rig does; on a cluster manager
    JAX supports, passing nothing lets it autodetect them).
    Idempotent: a second call on an initialized runtime is a no-op.
    """
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    kwargs = {}
    if coordinator is not None:
        kwargs.update(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def cluster_stream_mesh() -> Mesh:
    """One ``stream`` axis over every device of every process.

    ``jax.devices()`` post-init enumerates the whole cluster (local devices
    first for this process's slice); `shard_map` over this mesh gives each
    process's chips their own subjects — no cross-host collective in the
    steady state, so the DCN hop costs nothing per frame.
    """
    return Mesh(np.asarray(jax.devices()), ("stream",))


def distribute_streams(local_frames, mesh: Mesh):
    """Per-process local ``(S_local, ...)`` frames -> global sharded array.

    Every process contributes its own subjects; the result is a global
    ``(S_total, ...)`` array sharded ``P("stream")`` that drops straight
    into ``multistream_green_bpm(frames, fps, mesh)``.
    """
    sharding = NamedSharding(mesh, P("stream"))
    return jax.make_array_from_process_local_data(sharding, local_frames)


def gather_streams(global_array) -> np.ndarray:
    """Fetch a stream-sharded result to every host (DCN allgather)."""
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(global_array, tiled=True))
