"""Process-level JAX runtime setup: multi-host initialization."""

from __future__ import annotations

import os


def maybe_init_distributed() -> bool:
    """Multi-host SPMD initialization (jax.distributed).

    Called by every CLI entry point BEFORE the first device query.  Three
    modes, chosen by environment (config cannot drive this: the coordinator
    handshake must happen before the backend initializes, i.e. before any
    jax call the config system's consumers might make):

      * ``W2VSEG_COORDINATOR`` set -> explicit rendezvous:
        ``W2VSEG_COORDINATOR=host:port W2VSEG_NUM_PROCESSES=N
        W2VSEG_PROCESS_ID=i`` (works on CPU fleets too — how the
        multi-host tests run).
      * ``W2VSEG_DISTRIBUTED=auto`` -> ``jax.distributed.initialize()``
        with no arguments, for cluster managers JAX detects itself (SLURM,
        Open MPI); nothing else tells JAX of a cluster.
      * neither -> single-host, no-op.

    After init, ``jax.devices()`` is the GLOBAL device list, so the mesh
    helpers (parallel/mesh.resolve_mesh) and the jitted train step work
    unchanged: every process feeds the same global batch (the loaders are
    seed-deterministic), ``jax.device_put`` transfers only each host's
    addressable shards, and GSPMD inserts the cross-host collectives.

    Returns True if running multi-process after the call.
    """
    import jax

    coord = os.environ.get("W2VSEG_COORDINATOR")
    auto = os.environ.get("W2VSEG_DISTRIBUTED", "").lower() == "auto"
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["W2VSEG_NUM_PROCESSES"]),
            process_id=int(os.environ["W2VSEG_PROCESS_ID"]),
        )
    elif auto:
        jax.distributed.initialize()
    return jax.process_count() > 1
