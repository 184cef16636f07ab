"""Checkpoint directories: the flattened pytree as arrays.npz + a JSON
manifest (checkpoints/io.py), and the Orbax directories written by earlier
versions, which stay readable where orbax is installed."""

from typing import NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wav2vecsegmenter_tpu.checkpoints.io import (
    _orbax_top_keys, restore_orbax, save_orbax)


class _State(NamedTuple):
    params: dict
    step: jax.Array


def _tree():
    rng = np.random.RandomState(0)
    return {
        "convs": [{"w": jnp.asarray(rng.randn(3, 2), jnp.float32)},
                  {"w": jnp.asarray(rng.randn(2, 2), jnp.bfloat16)}],
        "head": {"b": jnp.asarray(rng.randn(4), jnp.float32),
                 "flag": jnp.zeros((), jnp.int32)},
    }


def test_roundtrip_with_template_keeps_structure_and_dtypes(tmp_path):
    tree = _State(_tree(), jnp.asarray(7, jnp.int32))
    save_orbax(tmp_path / "ck", tree)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "arrays.npz", "manifest.json"]
    got = restore_orbax(tmp_path / "ck",
                        template=jax.eval_shape(lambda: tree))
    assert isinstance(got, _State)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_restore_without_template_nests_dicts_and_lists(tmp_path):
    tree = _tree()
    save_orbax(tmp_path / "ck", tree)
    got = restore_orbax(tmp_path / "ck")
    assert set(got) == {"convs", "head"}
    assert isinstance(got["convs"], list) and len(got["convs"]) == 2
    assert got["convs"][1]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(got["head"]["b"], np.asarray(tree["head"]["b"]))
    assert _orbax_top_keys(tmp_path / "ck") == ["convs", "head"]


def test_save_replaces_and_restore_checks_shapes(tmp_path):
    save_orbax(tmp_path / "ck", {"a": jnp.ones(3)})
    save_orbax(tmp_path / "ck", {"a": jnp.zeros(3)})  # overwrite in place
    np.testing.assert_array_equal(restore_orbax(tmp_path / "ck")["a"],
                                  np.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        restore_orbax(tmp_path / "ck",
                      template={"a": jax.ShapeDtypeStruct((4,), jnp.float32)})
    with pytest.raises(KeyError, match="no leaf"):
        restore_orbax(tmp_path / "ck",
                      template={"b": jax.ShapeDtypeStruct((3,), jnp.float32)})


def test_files_are_saved_inside_the_checkpoint(tmp_path):
    save_orbax(tmp_path / "ck", {"a": jnp.ones(2)},
               files={"meta.yaml": "epoch: 3\n"})
    assert (tmp_path / "ck" / "meta.yaml").read_text() == "epoch: 3\n"
    # no build or swap directory is left beside the checkpoint
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]


def test_failed_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    import wav2vecsegmenter_tpu.checkpoints.io as io

    save_orbax(tmp_path / "ck", {"a": jnp.ones(3)}, files={"meta.yaml": "1"})

    def crash(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(io.np, "savez", crash)
    with pytest.raises(OSError, match="disk full"):
        save_orbax(tmp_path / "ck", {"a": jnp.zeros(3)},
                   files={"meta.yaml": "2"})
    # the old checkpoint is whole: manifest, arrays and its own files
    np.testing.assert_array_equal(restore_orbax(tmp_path / "ck")["a"],
                                  np.ones(3))
    assert (tmp_path / "ck" / "meta.yaml").read_text() == "1"
    monkeypatch.undo()
    # the next save clears the half-built directory and goes through
    save_orbax(tmp_path / "ck", {"a": jnp.zeros(3)}, files={"meta.yaml": "2"})
    np.testing.assert_array_equal(restore_orbax(tmp_path / "ck")["a"],
                                  np.zeros(3))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]


def test_orbax_directories_stay_readable(tmp_path):
    ocp = pytest.importorskip("orbax.checkpoint")
    tree = {"seg": {"w": jnp.arange(6.0).reshape(2, 3)}}
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((tmp_path / "old").absolute(), tree)
    assert _orbax_top_keys(tmp_path / "old") == ["seg"]
    got = restore_orbax(tmp_path / "old", template=jax.eval_shape(lambda: tree))
    np.testing.assert_array_equal(np.asarray(got["seg"]["w"]),
                                  np.arange(6.0).reshape(2, 3))


def test_pt_converters_name_torch_when_it_is_missing(monkeypatch, tmp_path):
    import sys

    from wav2vecsegmenter_tpu.checkpoints.torch_convert import (
        load_torch_state_dict)

    monkeypatch.setitem(sys.modules, "torch", None)  # import torch fails
    with pytest.raises(ImportError, match="needs torch"):
        load_torch_state_dict(tmp_path / "model.pt")
