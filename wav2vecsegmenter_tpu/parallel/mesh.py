"""Device mesh and sharding helpers.

The reference scales with single-host ``nn.DataParallel``
(train.py:312-315); the JAX equivalent is a ``jax.sharding.Mesh`` over
devices with XLA-inserted collectives (NCCL on the GPU):

* **data axis** — batches sharded, gradients all-reduced (psum) inside the
  jitted train step.  This is the production configuration for the 300 M
  param segmenter models.
* **model axis** (optional, ``runtime.mesh.model``) — Megatron-style tensor
  parallelism over the transformer's heads/FFN dims: q/k/v and ffn.w1
  weights are sharded on their OUTPUT dim, o and ffn.w2 on their INPUT dim,
  so each device computes a head/FFN slice and XLA inserts one
  reduce-scatter/all-reduce per block boundary.  Optimizer moments inherit
  the param shardings (see ``state_shardings``), cutting per-device
  optimizer memory by the model-axis size.  Every op on the path is plain
  XLA or cuDNN fused attention, which GSPMD partitions like any other op:
  no op needs a mesh context of its own.

The helpers here also back the multi-chip dry-run path
(__graft_entry__.dryrun_multichip) and CPU tests with
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int = -1, n_model: int = 1, devices=None) -> Mesh:
    """(data, model) mesh; n_data=-1 uses all devices left after n_model."""
    if devices is None:
        devices = jax.devices()
    n_model = max(1, int(n_model or 1))
    if n_data in (-1, None):
        n_data = len(devices) // n_model
    use = np.array(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(use, axis_names=("data", "model"))


def resolve_mesh(mesh_conf, devices=None):
    """Validate a ``runtime.mesh`` config block and build the mesh.

    Returns ``(mesh_or_None, n_data, n_model)``.  A requested axis that
    cannot be satisfied by the available devices is an error, never a
    silent fallback to replicated execution: a model that only fits
    sharded would otherwise OOM with no hint why."""
    if devices is None:
        devices = jax.devices()
    conf = mesh_conf or {}
    raw_data, raw_model = conf.get("data", -1), conf.get("model", 1)
    n_data = -1 if raw_data is None else int(raw_data)
    n_model = 1 if raw_model is None else int(raw_model)
    if n_model < 1 or n_data < -1 or n_data == 0:
        raise ValueError(
            f"runtime.mesh: invalid axis sizes data={n_data} model={n_model}")
    if n_model > len(devices):
        raise ValueError(
            f"runtime.mesh.model={n_model} exceeds the {len(devices)} "
            f"available device(s)")
    if n_data == -1:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"runtime.mesh: data={n_data} x model={n_model} = "
            f"{n_data * n_model} devices requested but only "
            f"{len(devices)} available")
    mesh = make_mesh(n_data, n_model, devices) if n_data * n_model > 1 else None
    return mesh, n_data, n_model


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _path_keys(path) -> tuple:
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "name"):
            out.append(str(p.name))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
        else:
            out.append(str(p))
    return tuple(out)


def _tp_spec(keys: tuple, ndim: int) -> P:
    """Tensor-parallel PartitionSpec for one param leaf (path → rule).

    Column-parallel (shard OUTPUT dim): attn q/k/v, ffn.w1, adapter.down —
    weights AND biases.  Row-parallel (shard INPUT dim, bias replicated):
    attn.o, ffn.w2, adapter.up.  Everything else replicated.  Leaves may
    carry a leading stacked-layer [L] dim (ndim 3 vs 2 / 2 vs 1)."""
    if len(keys) < 2:
        return P()
    mod, leaf = keys[-2], keys[-1]
    col = mod in ("q", "k", "v", "w1", "down")
    row = mod in ("o", "w2", "up")
    if not (col or row) or leaf not in ("w", "b"):
        return P()
    if leaf == "w" and ndim >= 2:
        ax = ndim - 1 if col else ndim - 2
        spec = [None] * ndim
        spec[ax] = "model"
        return P(*spec)
    if leaf == "b" and col and ndim >= 1:
        spec = [None] * (ndim - 1) + ["model"]
        return P(*spec)
    return P()


# FSDP: leaves smaller than this stay replicated — an all-gather launch
# costs more than the bytes saved (LN scales, biases, conv taps)
_FSDP_MIN_ELEMS = 2 ** 15


def _add_fsdp_axis(spec: P, shape, n_data: int) -> P:
    """ZeRO-3 via GSPMD: put 'data' on the largest still-free dim divisible
    by the data-axis size.  Params and optimizer moments then live sharded
    in HBM; XLA inserts the all-gather at each use and the matching
    reduce-scatter on the gradients."""
    if n_data <= 1 or int(np.prod(shape)) < _FSDP_MIN_ELEMS:
        return spec
    names = list(spec) + [None] * (len(shape) - len(spec))
    free = [ax for ax in range(len(shape))
            if names[ax] is None and shape[ax] % n_data == 0]
    if not free:
        return spec
    ax = max(free, key=lambda a: shape[a])
    names[ax] = "data"
    return P(*names)


def param_shardings(mesh: Mesh, params, fsdp: bool = False):
    """NamedSharding tree for a model param tree: tensor-parallel specs on
    the transformer block weights when the mesh has a model axis, replicated
    otherwise.  Dims not divisible by the model-axis size fall back to
    replicated (GSPMD would pad; not worth it for odd heads).  With
    ``fsdp=True`` every large leaf additionally shards one free dim over
    'data' (ZeRO-3; composes with tensor parallelism)."""
    n_model = mesh.shape.get("model", 1)
    n_data = mesh.shape.get("data", 1)

    def one(path, leaf):
        spec = P()
        if n_model > 1:
            spec = _tp_spec(_path_keys(path), getattr(leaf, "ndim", 0))
            for ax, name in enumerate(spec):
                if name == "model" and leaf.shape[ax] % n_model != 0:
                    spec = P()
                    break
        if fsdp:
            spec = _add_fsdp_axis(spec, getattr(leaf, "shape", ()), n_data)
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(one, params)


def state_shardings(mesh: Mesh, state, params=None, fsdp: bool = False):
    """Sharding tree for a TrainState (or any pytree embedding the param
    tree): param leaves get ``param_shardings``; optimizer-state leaves
    whose path SUFFIX and shape match a param leaf (adam mu/nu, MultiSteps
    accumulators mirror the param tree) inherit that param's sharding;
    everything else (counts, schedules) is replicated."""
    if params is None:
        params = state.params
    p_sh = param_shardings(mesh, params, fsdp=fsdp)
    flat_p = {
        _path_keys(path): (leaf.shape, sh)
        for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(p_sh)[0])
    }
    max_len = max((len(k) for k in flat_p), default=0)
    rep = replicated(mesh)

    def one(path, leaf):
        keys = _path_keys(path)
        shape = getattr(leaf, "shape", ())
        for n in range(min(len(keys), max_len), 0, -1):
            hit = flat_p.get(keys[-n:])
            if hit is not None:
                return hit[1] if hit[0] == shape else rep
        return rep

    return jax.tree_util.tree_map_with_path(one, state)


def shard_batch_arrays(mesh: Mesh, *arrays):
    """Place host arrays onto the mesh sharded along their leading axis.
    Leading dims must be divisible by the mesh size (loaders pad batches to
    the static batch size, so pick batch_size % n_devices == 0)."""
    sh = batch_sharding(mesh)
    return tuple(jax.device_put(a, sh) for a in arrays)


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Round a batch size up to a device multiple."""
    return ((batch_size + n_devices - 1) // n_devices) * n_devices
