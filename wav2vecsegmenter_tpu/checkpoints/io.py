"""Checkpoint I/O: a numpy directory format for native training state,
torch .pt ingestion for reference checkpoints, and HF-dir loading for
pretrained wav2vec2 weights.

Layouts follow the reference contract (train.py:596-613):
  * ``finetune_wav2vec=True``  -> full model state;
  * otherwise                  -> seg-head-only state; the wav2vec2 weights
    are re-materialized from the pretrained source at load time
    (inference.py:51-54, segment.py:48-51).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ..models.wav2vec2 import Wav2Vec2Config
from .torch_convert import (
    convert_reference_checkpoint,
    is_full_layout,
    load_hf_pretrained_dir,
    load_torch_state_dict,
)

logger = logging.getLogger(__name__)


def _hf_local_snapshot(model_name: str) -> Path | None:
    """Locate a locally cached/downloaded HF model dir (no network)."""
    candidates = []
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    repo_dir = Path(hf_home) / "hub" / ("models--" + model_name.replace("/", "--"))
    if repo_dir.exists():
        snaps = sorted((repo_dir / "snapshots").glob("*"))
        candidates += snaps
    candidates.append(Path(model_name))  # explicit local dir
    for c in candidates:
        if c.is_dir() and (
            (c / "pytorch_model.bin").exists() or (c / "model.safetensors").exists()
        ):
            return c
    return None


def load_wav2vec2_pretrained(model_name: str, cfg: Wav2Vec2Config,
                             allow_random: bool = False,
                             rng_seed: int = 0) -> dict:
    snap = _hf_local_snapshot(model_name)
    if snap is not None:
        logger.info("Loading wav2vec2 weights from %s", snap)
        return load_hf_pretrained_dir(snap, cfg)
    if allow_random:
        logger.warning(
            "No local weights for %s — using RANDOM wav2vec2 init "
            "(allow_random=True).", model_name)
        from ..models.wav2vec2 import init_wav2vec2_params

        return init_wav2vec2_params(jax.random.PRNGKey(rng_seed), cfg)
    raise FileNotFoundError(
        f"No local HF weights found for '{model_name}'. Place the model under "
        f"$HF_HOME/hub or pass a local directory path."
    )


def load_model_checkpoint(model, ckpt_path: str | Path,
                          allow_random_wav2vec: bool = False) -> dict:
    """Load params for ``model`` (a SHAS-family spec) from either a torch .pt
    (reference format, both layouts) or a checkpoint directory.

    Both sources come in two layouts (reference train.py:596-613): the FULL
    model state when the backbone was fine-tuned, or the seg head only when
    it was frozen — our train loop mirrors that for its epoch ckpts
    (train/loop.py save_ckpt), so the head-only completion (backbone weights
    re-loaded from the pretrained source) applies to both formats."""
    ckpt_path = Path(ckpt_path)
    if ckpt_path.is_dir():
        template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        on_disk = set(_orbax_top_keys(ckpt_path))
        if on_disk >= set(template.keys()):
            return restore_orbax(ckpt_path, template=template)
        sub = {k: v for k, v in template.items() if k in on_disk}
        params = restore_orbax(ckpt_path, template=sub)
        return _complete_headonly_params(params, model, allow_random_wav2vec)

    sd = load_torch_state_dict(ckpt_path)
    if is_full_layout(sd):
        return convert_reference_checkpoint(sd, model)
    params = convert_reference_checkpoint(sd, model)  # {'seg': ...}
    return _complete_headonly_params(params, model, allow_random_wav2vec)


def _complete_headonly_params(params: dict, model,
                              allow_random_wav2vec: bool) -> dict:
    """Fill a head-only checkpoint ({'seg': ...}) up to the full param tree
    from the pretrained wav2vec2 source (reference inference.py loads the
    backbone from HF when the ckpt only carries the classifier)."""
    is_ssl = hasattr(model, "ctc_vocab_size")
    snap = _hf_local_snapshot(model.wav2vec_model_name)
    if is_ssl and snap is not None:
        # SSL variant: the ForCTC pretrained dir also provides the final
        # encoder LN and the lm_head (reference lib/models.py:488-507).
        # setdefault per key: subtrees the checkpoint DID carry (e.g. a
        # fine-tuned backbone restored by the partial-Orbax path) must not
        # be overwritten by pretrained weights.
        from .torch_convert import convert_hf_for_ctc

        sd_hf = _load_hf_state_dict(snap)
        for k, v in convert_hf_for_ctc(sd_hf, model.w2v_cfg).items():
            params.setdefault(k, v)
    else:
        if "wav2vec" not in params:
            params["wav2vec"] = load_wav2vec2_pretrained(
                model.wav2vec_model_name, model.w2v_cfg,
                allow_random=allow_random_wav2vec,
            )
        if is_ssl:
            # no pretrained source: random final_ln/lm_head to complete the
            # tree (allow_random path)
            init = model.init(jax.random.PRNGKey(0))
            params.setdefault("final_ln", init["final_ln"])
            params.setdefault("lm_head", init["lm_head"])
    return params


def _load_hf_state_dict(model_dir: Path) -> dict:
    st_path = model_dir / "model.safetensors"
    bin_path = model_dir / "pytorch_model.bin"
    if st_path.exists():
        from safetensors.numpy import load_file

        return load_file(str(st_path))
    return load_torch_state_dict(bin_path)


# ---------------------------------------------------------------------------
# Checkpoint directories: the flattened pytree as one .npz of leaves plus a
# JSON manifest of their key paths and dtypes.  Directories written by Orbax
# (earlier versions of this code) are still read where orbax is installed.
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _key_part(k) -> list:
    if isinstance(k, jax.tree_util.DictKey):
        return ["d", str(k.key)]
    if isinstance(k, jax.tree_util.SequenceKey):
        return ["i", int(k.idx)]
    if isinstance(k, jax.tree_util.GetAttrKey):
        return ["a", k.name]
    if isinstance(k, jax.tree_util.FlattenedIndexKey):
        return ["i", int(k.key)]
    raise TypeError(f"unsupported pytree key {k!r}")


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils

        leaf = multihost_utils.process_allgather(leaf, tiled=True)
    return np.asarray(jax.device_get(leaf))


def save_orbax(path: str | Path, tree,
               files: dict[str, str] | None = None) -> None:
    """Write ``tree``, and ``files`` (name -> text, e.g. resume
    bookkeeping), to the directory ``path``, replacing it.

    Every process calls this: sharded leaves are gathered collectively and
    process 0 writes.  The new directory is built under a hidden sibling
    name, manifest last, then renamed into place, so a crash leaves the old
    checkpoint or the new one (between the two renames: the old one under
    ``.<name>.old``), never a directory without its manifest.  No process
    returns before the rename is done."""
    path = Path(path).absolute()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    arrays, entries = {}, []
    for i, (kpath, leaf) in enumerate(flat):
        a = _to_host(leaf)
        dtype = str(a.dtype)
        if a.dtype.itemsize == 2 and a.dtype.kind == "V":  # bfloat16 & co
            a = a.view(np.uint16)
        arrays[f"a{i}"] = a
        entries.append({"path": [_key_part(k) for k in kpath],
                        "dtype": dtype})
    if jax.process_index() == 0:
        tmp = path.with_name(f".{path.name}.tmp")
        old = path.with_name(f".{path.name}.old")
        for d in (tmp, old):
            if d.exists():
                shutil.rmtree(d)
        tmp.mkdir(parents=True)
        np.savez(tmp / _ARRAYS, **arrays)
        for name, text in (files or {}).items():
            (tmp / name).write_text(text)
        (tmp / _MANIFEST).write_text(json.dumps({"leaves": entries}))
        if path.exists():
            path.rename(old)
        tmp.rename(path)
        shutil.rmtree(old, ignore_errors=True)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(f"save_orbax {path.name}")


def _read_leaves(path: Path) -> list[tuple[tuple, np.ndarray]]:
    entries = json.loads((path / _MANIFEST).read_text())["leaves"]
    out = []
    with np.load(path / _ARRAYS) as z:
        for i, e in enumerate(entries):
            a = z[f"a{i}"]
            dt = jnp.dtype(e["dtype"])
            out.append((tuple(tuple(p) for p in e["path"]),
                        a.view(dt) if a.dtype != dt else a))
    return out


def _nest(leaves) -> dict:
    """Nested dicts (lists for sequence keys) from (path, array) pairs."""
    root: dict = {}
    for kpath, a in leaves:
        node = root
        for _, k in kpath[:-1]:
            node = node.setdefault(k, {})
        node[kpath[-1][1]] = a

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in sorted(node)]
        return node

    return listify(root)


def _orbax_top_keys(path: Path) -> list:
    """Top-level keys of the pytree stored in a checkpoint directory."""
    path = Path(path)
    if not (path / _MANIFEST).exists():
        return _legacy_orbax(path, lambda c, p: list(
            c.metadata(p).item_metadata.tree.keys()))
    entries = json.loads((path / _MANIFEST).read_text())["leaves"]
    return list(dict.fromkeys(e["path"][0][1] for e in entries))


def _legacy_orbax(path: Path, fn):
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise RuntimeError(
            f"{path} is an Orbax checkpoint and orbax is not installed") from e
    with ocp.StandardCheckpointer() as ckptr:
        return fn(ckptr, path.absolute())


def restore_orbax(path: str | Path, model=None, template=None):
    """Restore a pytree.  With a ``template`` (or a ``model`` to derive one
    from) the result has the template's structure, and its leaves are
    uncommitted arrays on this process's default device, as freshly
    initialized ones are (a multi-process jit may then place them on its
    mesh); without one it comes back as nested dicts of numpy arrays."""
    path = Path(path).absolute()
    if template is None and model is not None:
        template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    if not (path / _MANIFEST).exists():
        return _restore_legacy_orbax(path, template)
    leaves = _read_leaves(path)
    if template is None:
        return _nest(leaves)
    by_path = dict(leaves)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for kpath, spec in flat:
        key = tuple(tuple(_key_part(k)) for k in kpath)
        if key not in by_path:
            raise KeyError(f"{path}: no leaf at {jax.tree_util.keystr(kpath)}")
        a = by_path[key]
        if a.shape != tuple(spec.shape):
            raise ValueError(f"{path}: leaf {jax.tree_util.keystr(kpath)} has "
                             f"shape {a.shape}, expected {tuple(spec.shape)}")
        out.append(jnp.asarray(a.astype(spec.dtype)))
    return jax.tree_util.tree_unflatten(treedef, out)


def _restore_legacy_orbax(path: Path, template):
    """The template carries concrete single-device shardings (orbax cannot
    reconstruct shardings saved by a process on another backend)."""
    def restore(ckptr, p):
        if template is None:
            return ckptr.restore(p)
        sharding = jax.sharding.SingleDeviceSharding(jax.local_devices()[0])
        tmpl = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sharding),
            template)
        return ckptr.restore(p, tmpl)

    return _legacy_orbax(path, restore)
