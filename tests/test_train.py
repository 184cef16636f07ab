"""Training subsystem tests: losses vs torch, LNA masking, train step on a
tiny model, and data-parallel sharding on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wav2vecsegmenter_tpu.train.loss import (
    BCEWithLogitsLoss,
    CrossEntropyLoss,
    FocalLoss,
    build_loss,
    moving_average_jax,
)
from wav2vecsegmenter_tpu.train.step import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

from .helpers import tiny_shas


def test_bce_matches_torch(rng):
    torch = pytest.importorskip("torch")
    x = rng.randn(4, 50).astype(np.float32)
    z = (rng.rand(4, 50) > 0.7).astype(np.float32)
    for pw in [None, 0.93]:
        ours = np.asarray(BCEWithLogitsLoss(pw)(jnp.asarray(x), jnp.asarray(z)))
        tl = torch.nn.BCEWithLogitsLoss(
            reduction="none",
            pos_weight=None if pw is None else torch.tensor(pw),
        )(torch.from_numpy(x), torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(ours, tl, rtol=1e-5, atol=1e-6)


def test_focal_matches_reference_formula(rng):
    torch = pytest.importorskip("torch")
    import sys

    sys.path.insert(0, "/root/reference/lib")
    from loss import FocalLoss as RefFocal

    x = rng.randn(4, 50).astype(np.float32)
    z = (rng.rand(4, 50) > 0.7).astype(np.float32)
    ours = np.asarray(FocalLoss(0.9, 2.0)(jnp.asarray(x), jnp.asarray(z)))
    ref = RefFocal(pos_weight=0.9, gamma=2.0)(
        torch.from_numpy(x), torch.from_numpy(z)
    ).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_ce_matches_torch(rng):
    torch = pytest.importorskip("torch")
    x = rng.randn(20, 7).astype(np.float32)
    t = rng.randint(0, 7, 20)
    t[3] = 2
    ours = np.asarray(
        CrossEntropyLoss(ignore_index=2)(jnp.asarray(x), jnp.asarray(t))
    )
    tl = torch.nn.CrossEntropyLoss(reduction="none", ignore_index=2)(
        torch.from_numpy(x), torch.from_numpy(t)
    ).numpy()
    np.testing.assert_allclose(ours, tl, rtol=1e-5, atol=1e-6)


def test_moving_average_jax_matches_numpy(rng):
    from wav2vecsegmenter_tpu.algorithms import moving_average

    x = rng.rand(3, 100).astype(np.float32)
    got = np.asarray(moving_average_jax(jnp.asarray(x), 5))
    for i in range(3):
        np.testing.assert_allclose(got[i], moving_average(x[i], 5), rtol=1e-5)


def test_build_loss_pos_weight_auto():
    conf = {"_target_": "torch.nn.BCEWithLogitsLoss", "tag": "bce",
            "pos_weight": None, "ma_window": None, "reduction": "none"}
    loss_fn, tag, ma = build_loss(conf, pos_class_percentage=0.8)
    assert tag == "bce" and ma == 0.0
    assert abs(loss_fn.pos_weight - 0.2) < 1e-9


def _make_batch(rng, b=4, L=32000, t_out=100):
    audio = rng.randn(b, L).astype(np.float32)
    lengths = np.full(b, L, np.int32)
    # learnable structure: speech in the first half, boundary in the second
    target = np.zeros((b, t_out), np.float32)
    target[:, : t_out // 2] = 1.0
    out_mask = np.ones((b, t_out), bool)
    return {
        "audio": jnp.asarray(audio),
        "in_lengths": jnp.asarray(lengths),
        "target": jnp.asarray(target),
        "out_mask": jnp.asarray(out_mask),
    }


def test_train_step_decreases_loss(rng):
    import dataclasses

    from .helpers import TINY_W2V

    model = tiny_shas()
    # this test checks optimizer mechanics; the HF-exact SpecAugment
    # (min_masks=2 -> ~40% of a 49-frame toy window masked per step) makes
    # an 8-step loss decrease too noisy to assert, so disable it here
    model.w2v_cfg = dataclasses.replace(TINY_W2V, apply_spec_augment=False)
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 1, mask)
    state = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    loss_fn = BCEWithLogitsLoss(None)
    step = make_train_step(model, loss_fn, "bce", 0, opt)

    batch = _make_batch(rng)
    losses = []
    key = jax.random.PRNGKey(2)
    for i in range(8):
        key, sub = jax.random.split(key)
        state, metrics = step(state, batch, sub)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_frozen_backbone_does_not_move(rng):
    model = tiny_shas(finetune_wav2vec=False)
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-2, 100, 1, mask)
    state = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)

    w2v_before = jax.tree.map(lambda x: np.asarray(x).copy(),
                              state.params["wav2vec"])
    seg_before = np.asarray(state.params["seg"]["out"]["w"]).copy()
    batch = _make_batch(rng)
    state, _ = step(state, batch, jax.random.PRNGKey(3))

    for a, b in zip(jax.tree.leaves(w2v_before),
                    jax.tree.leaves(state.params["wav2vec"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.allclose(seg_before, np.asarray(state.params["seg"]["out"]["w"]))


def test_partial_finetune_layer_masking():
    model = tiny_shas(finetune_wav2vec=True, wav2vec_ft_layers=1,
                      finetune_w2v_feat_enc=False, finetune_w2v_ffn=False)
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    # 2 kept layers, 1 ft layer: layer 0 frozen, layer 1 trainable
    attn_q_mask = np.asarray(mask["wav2vec"]["layers"]["attn"]["q"]["w"])
    assert attn_q_mask[0].max() == 0.0
    assert attn_q_mask[1].min() == 1.0
    # FFN frozen in all layers (finetune_w2v_ffn=False)
    ffn_mask = np.asarray(mask["wav2vec"]["layers"]["ffn"]["w1"]["w"])
    assert ffn_mask.max() == 0.0
    # feature extractor frozen
    fe_mask = np.asarray(mask["wav2vec"]["feature_extractor"]["convs"][0]["w"])
    assert fe_mask.max() == 0.0
    # pos_conv trainable (reference leaves it unfrozen)
    assert np.asarray(mask["wav2vec"]["pos_conv"]["w_v"]).min() == 1.0


def test_data_parallel_train_step_on_mesh(rng):
    """Train step over the 8-device CPU mesh matches the single-device step."""
    from wav2vecsegmenter_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    mesh = make_mesh(8)

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 1, mask)

    batch = _make_batch(rng, b=8, L=16000, t_out=50)

    params2 = jax.tree.map(jnp.copy, params)  # step fns donate their state
    state1 = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step1 = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    state1, m1 = step1(state1, batch, jax.random.PRNGKey(9))

    state2 = init_train_state(model, opt, jax.random.PRNGKey(1), params2)
    step8 = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt,
                            mesh=mesh)
    state2, m8 = step8(state2, batch, jax.random.PRNGKey(9))

    np.testing.assert_allclose(float(m1["loss"]), float(m8["loss"]), rtol=1e-5)
    # Adam's first-step update is ~sign(g): tiny cross-shard reduction-order
    # differences get amplified, so params match only loosely after a step.
    for a, b in zip(jax.tree.leaves(state1.params),
                    jax.tree.leaves(state2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=1e-3)


def test_tensor_parallel_train_step_on_mesh(rng):
    """Train step on a 2-D (data=4, model=2) mesh with Megatron-style
    tensor-parallel param/optimizer shardings matches single-device.

    q/k/v and ffn.w1 shard their output dim over 'model', o and ffn.w2
    their input dim (parallel/mesh.param_shardings); adam moments inherit
    the param shardings via path-suffix matching (state_shardings)."""
    from wav2vecsegmenter_tpu.parallel.mesh import (
        make_mesh, param_shardings, state_shardings)

    mesh = make_mesh(4, 2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 1, mask)
    batch = _make_batch(rng, b=8, L=16000, t_out=50)

    # sharding rules hit the transformer block leaves
    p_sh = param_shardings(mesh, params)
    assert "model" in str(p_sh["wav2vec"]["layers"]["attn"]["q"]["w"].spec)
    assert "model" in str(p_sh["wav2vec"]["layers"]["ffn"]["w2"]["w"].spec)
    assert str(p_sh["wav2vec"]["layers"]["ln1"]["scale"].spec) == \
        "PartitionSpec()"

    params2 = jax.tree.map(jnp.copy, params)
    state1 = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step1 = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    state1, m1 = step1(state1, batch, jax.random.PRNGKey(9))

    state2 = init_train_state(model, opt, jax.random.PRNGKey(1), params2)
    st_sh = state_shardings(mesh, state2)
    state2 = jax.device_put(state2, st_sh)
    # optimizer moments really are distributed (mu mirrors the param tree)
    qw = state2.params["wav2vec"]["layers"]["attn"]["q"]["w"]
    assert len(qw.sharding.device_set) == 8  # data-replicated, model-sharded
    assert qw.addressable_shards[0].data.shape[-1] == qw.shape[-1] // 2
    step_tp = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt,
                              mesh=mesh, state_shardings=st_sh)
    state2, mtp = step_tp(state2, batch, jax.random.PRNGKey(9))

    np.testing.assert_allclose(float(m1["loss"]), float(mtp["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree.leaves(state1.params),
                    jax.tree.leaves(state2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=1e-3)


def test_multistep_on_mesh(rng):
    """K steps/call via lax.scan on the 8-device mesh (the
    steps_per_call > 1 path) runs and matches sequential single steps.

    Regression test for the round-1 out_shardings crash: multi_fn returns
    {"loss", "logits"} but the mesh path only constrained {"loss"}."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wav2vecsegmenter_tpu.parallel.mesh import make_mesh
    from wav2vecsegmenter_tpu.train.step import make_train_multistep

    mesh = make_mesh(8)
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 1, mask)
    K = 2

    b1 = _make_batch(rng, b=8, L=16000, t_out=50)
    b2 = _make_batch(rng, b=8, L=16000, t_out=50)

    # sequential single steps (no mesh) as the oracle
    params2 = jax.tree.map(jnp.copy, params)
    state1 = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step1 = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    keys = jax.random.split(jax.random.PRNGKey(9), K)
    ref_losses = []
    for b, k in zip((b1, b2), keys):
        state1, m = step1(state1, b, k)
        ref_losses.append(float(m["loss"]))

    # K-step scan on the mesh
    state2 = init_train_state(model, opt, jax.random.PRNGKey(1), params2)
    multi = make_train_multistep(model, BCEWithLogitsLoss(None), "bce", 0,
                                 opt, n_steps=K, mesh=mesh)
    stk = NamedSharding(mesh, P(None, "data"))
    stacked = {
        k: jax.device_put(np.stack([np.asarray(b1[k]), np.asarray(b2[k])]),
                          stk)
        for k in b1
    }
    state2, m = multi(state2, stacked, jax.random.PRNGKey(9))
    losses = np.asarray(m["loss"])
    logits = np.asarray(m["logits"])
    assert losses.shape == (K,) and np.isfinite(losses).all()
    assert logits.shape[:2] == (K, 8)
    # same data, same keys (both paths split PRNGKey(9) into K subkeys):
    # losses match the sequential oracle up to cross-shard reduction order
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(state1.params),
                    jax.tree.leaves(state2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=5e-3)


def test_multistep_tensor_parallel_on_mesh(rng):
    """K-step lax.scan with tensor-parallel state shardings on a
    (data=4, model=2) mesh: the scan carry keeps the Megatron shardings and
    losses match the sequential single-step oracle."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wav2vecsegmenter_tpu.parallel.mesh import make_mesh, state_shardings
    from wav2vecsegmenter_tpu.train.step import make_train_multistep

    mesh = make_mesh(4, 2)
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 1, mask)
    K = 2

    b1 = _make_batch(rng, b=8, L=16000, t_out=50)
    b2 = _make_batch(rng, b=8, L=16000, t_out=50)

    params2 = jax.tree.map(jnp.copy, params)
    state1 = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step1 = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    keys = jax.random.split(jax.random.PRNGKey(9), K)
    ref_losses = []
    for b, k in zip((b1, b2), keys):
        state1, m = step1(state1, b, k)
        ref_losses.append(float(m["loss"]))

    state2 = init_train_state(model, opt, jax.random.PRNGKey(1), params2)
    st_sh = state_shardings(mesh, state2)
    state2 = jax.device_put(state2, st_sh)
    multi = make_train_multistep(model, BCEWithLogitsLoss(None), "bce", 0,
                                 opt, n_steps=K, mesh=mesh,
                                 state_shardings=st_sh)
    stk = NamedSharding(mesh, P(None, "data"))
    stacked = {
        k: jax.device_put(np.stack([np.asarray(b1[k]), np.asarray(b2[k])]),
                          stk)
        for k in b1
    }
    state2, m = multi(state2, stacked, jax.random.PRNGKey(9))
    losses = np.asarray(m["loss"])
    assert losses.shape == (K,) and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    # params stay model-sharded after the scan
    qw = state2.params["wav2vec"]["layers"]["attn"]["q"]["w"]
    assert qw.addressable_shards[0].data.shape[-1] == qw.shape[-1] // 2
    for a, b in zip(jax.tree.leaves(state1.params),
                    jax.tree.leaves(state2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=5e-3)


def test_gradient_accumulation_multisteps(rng):
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 4, mask)
    state = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    batch = _make_batch(rng, b=2, L=16000, t_out=50)
    p0 = np.asarray(state.params["seg"]["out"]["w"]).copy()
    for i in range(3):  # fewer than update_freq: no update yet
        state, _ = step(state, batch, jax.random.PRNGKey(i))
    np.testing.assert_array_equal(p0, np.asarray(state.params["seg"]["out"]["w"]))
    state, _ = step(state, batch, jax.random.PRNGKey(99))  # 4th: update fires
    assert not np.allclose(p0, np.asarray(state.params["seg"]["out"]["w"]))


def test_train_step_device_normalize_matches_host(rng):
    """int16 upload + on-device normalization in the train step produces the
    same loss as pre-normalized float batches."""
    from wav2vecsegmenter_tpu.data.collate import collate

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)

    examples = []
    for i in range(2):
        wav = (rng.randint(-4000, 4000, 16000).astype(np.float32) / 32768.0)
        tgt = np.zeros(50, np.float32)
        tgt[:25] = 1.0
        examples.append((wav, tgt, i * 50, (i + 1) * 50))

    def run(device_normalize):
        params2 = jax.tree.map(jnp.copy, params)
        opt = make_optimizer(1e-3, 100, 1, mask)
        state = init_train_state(model, opt, jax.random.PRNGKey(1), params2)
        step = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt,
                               device_normalize=device_normalize)
        b = collate(examples, 2, 16000, 50,
                    device_normalize=device_normalize)
        batch = {
            "audio": jnp.asarray(b.audio),
            "in_lengths": jnp.asarray(b.in_lengths),
            "target": jnp.asarray(b.target),
            "out_mask": jnp.asarray(b.out_mask),
        }
        if device_normalize:
            batch["included"] = jnp.asarray(b.included)
            batch["norm_length"] = jnp.asarray(b.norm_length, jnp.int32)
        _, metrics = step(state, batch, jax.random.PRNGKey(2))
        return float(metrics["loss"])

    l_host = run(False)
    l_dev = run(True)
    assert l_dev == pytest.approx(l_host, rel=1e-5)


def test_resolve_mesh_validates_axis_sizes():
    """An unsatisfiable runtime.mesh must error, never silently fall back
    to replicated execution (the TP memory savings would vanish and the
    run would OOM with no hint why)."""
    from wav2vecsegmenter_tpu.parallel.mesh import resolve_mesh

    n = len(jax.devices())

    mesh, n_data, n_model = resolve_mesh(None)
    assert n_data == n and n_model == 1
    assert (mesh is None) == (n == 1)

    mesh, n_data, n_model = resolve_mesh({"data": 1, "model": 1})
    assert mesh is None and n_data == 1

    with pytest.raises(ValueError, match="exceeds"):
        resolve_mesh({"model": n + 1})
    with pytest.raises(ValueError, match="available"):
        resolve_mesh({"data": n, "model": 2})
    with pytest.raises(ValueError, match="invalid"):
        resolve_mesh({"data": 0})

    if n >= 2:
        mesh, n_data, n_model = resolve_mesh({"data": -1, "model": 2})
        assert n_data == n // 2 and n_model == 2
        assert dict(mesh.shape) == {"data": n // 2, "model": 2}


def test_autoreg_step_with_dynamic_pos_weight_on_mesh(rng):
    """The train loop injects batch['pos_weight'] for ANY bce-tag loss,
    including on an autoregression task; the mesh in_shardings dict must
    keep the key after the autoregression overwrite (ordering trap)."""
    from wav2vecsegmenter_tpu.data.collate import collate_autoreg
    from wav2vecsegmenter_tpu.data.vocab import BaseVocabulary
    from wav2vecsegmenter_tpu.parallel.mesh import make_mesh
    from wav2vecsegmenter_tpu.train.loss import CrossEntropyLoss
    from wav2vecsegmenter_tpu.train.step import init_train_state

    from .test_autoreg import tiny_autoreg

    vocab = BaseVocabulary()
    model = tiny_autoreg()
    params = model.init(jax.random.PRNGKey(0))
    opt = make_optimizer(1e-3, 50, 1, model.trainable_mask(params))
    state = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    loss_fn = CrossEntropyLoss(ignore_index=vocab.pad_token_id)
    mesh = make_mesh(8)
    step = make_train_step(model, loss_fn, "ce", 0, opt, vocab=vocab,
                           autoregression=True, mesh=mesh,
                           dynamic_pos_weight=True)

    examples = []
    for i in range(8):
        wav = rng.randn(16000).astype(np.float32) * 0.1
        tgt = np.zeros(48, np.float32)
        tgt[:24] = 1.0
        examples.append((wav, tgt, i * 50, i * 50 + 48))
    b = collate_autoreg(examples, 8, 16000, 50,
                        vocab.pad_token_id, vocab.sep_token_id)
    batch = {
        "audio": jnp.asarray(b.audio),
        "in_lengths": jnp.asarray(b.in_lengths),
        "in_target": jnp.asarray(b.in_target),
        "out_target": jnp.asarray(b.out_target),
        "src_mask": jnp.asarray(b.src_mask),
        "tgt_mask": jnp.asarray(b.tgt_mask),
        "pos_weight": jnp.asarray(0.8, jnp.float32),
    }
    state, metrics = step(state, batch, jax.random.PRNGKey(2))
    assert np.isfinite(float(metrics["loss"]))


def test_fsdp_train_step_on_mesh(rng, monkeypatch):
    """ZeRO-3 via GSPMD (runtime.mesh.fsdp): params + adam moments shard
    one free dim over 'data' (parallel/mesh._add_fsdp_axis); the train
    step matches the single-device step (XLA all-gathers at use,
    reduce-scatters grads)."""
    import wav2vecsegmenter_tpu.parallel.mesh as mesh_mod
    from wav2vecsegmenter_tpu.parallel.mesh import (
        make_mesh, param_shardings, state_shardings)

    # the tiny model's leaves are all below the production size floor
    monkeypatch.setattr(mesh_mod, "_FSDP_MIN_ELEMS", 1024)

    mesh = make_mesh(8, 1)
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 1, mask)
    batch = _make_batch(rng, b=8, L=16000, t_out=50)

    p_sh = param_shardings(mesh, params, fsdp=True)
    assert "data" in str(p_sh["wav2vec"]["layers"]["ffn"]["w1"]["w"].spec)
    # tiny leaves stay replicated even under the lowered floor
    assert str(p_sh["seg"]["out"]["b"].spec) == "PartitionSpec()"

    params2 = jax.tree.map(jnp.copy, params)
    state1 = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step1 = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    state1, m1 = step1(state1, batch, jax.random.PRNGKey(9))

    state2 = init_train_state(model, opt, jax.random.PRNGKey(1), params2)
    st_sh = state_shardings(mesh, state2, fsdp=True)
    state2 = jax.device_put(state2, st_sh)
    w1 = state2.params["wav2vec"]["layers"]["ffn"]["w1"]["w"]
    # genuinely distributed: each device holds 1/8 of the leaf
    assert w1.addressable_shards[0].data.size == w1.size // 8
    step_f = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt,
                             mesh=mesh, state_shardings=st_sh)
    state2, mf = step_f(state2, batch, jax.random.PRNGKey(9))

    np.testing.assert_allclose(float(m1["loss"]), float(mf["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree.leaves(state1.params),
                    jax.tree.leaves(state2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=1e-3)


def test_epoch_end_accum_flush(rng):
    """Reference train.py:474-480 steps the optimizer at epoch end even on
    a partial accumulation (scaled sum/update_freq) and restarts
    accumulation; make_accum_flush replicates that against MultiSteps."""
    import optax

    from wav2vecsegmenter_tpu.train.step import make_accum_flush

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-3, 100, 4, mask)  # update_freq=4
    state = init_train_state(model, opt, jax.random.PRNGKey(1), params)
    step = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt)
    flush = make_accum_flush(opt)
    assert flush is not None
    assert make_accum_flush(make_optimizer(1e-3, 100, 1, mask)) is None

    p0 = jax.tree.map(np.asarray, state.params)
    for i in range(2):  # 2 of 4 micro-steps: no update applied yet
        batch = _make_batch(rng, b=2, L=16000, t_out=50)
        state, _ = step(state, batch, jax.random.PRNGKey(2 + i))
    assert int(state.opt_state.mini_step) == 2
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # oracle: the reference applies inner_update(sum(grads)/update_freq)
    ms = state.opt_state
    grads = jax.tree.map(lambda g: g * (2.0 / 4.0), ms.acc_grads)
    updates, _ = opt._w2vseg_inner.update(grads, ms.inner_opt_state,
                                          state.params)
    want = optax.apply_updates(state.params, updates)

    state = flush(state)
    assert int(state.opt_state.mini_step) == 0
    assert int(state.opt_state.gradient_step) == 1
    changed = any(
        np.abs(np.asarray(a) - np.asarray(b)).max() > 0
        for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(state.params)))
    assert changed
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)

    # empty accumulator: flush is a no-op
    p1 = jax.tree.map(np.asarray, state.params)
    state = flush(state)
    assert int(state.opt_state.gradient_step) == 1
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
