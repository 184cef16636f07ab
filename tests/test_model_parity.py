"""Numerical parity: JAX wav2vec2 + SFC vs HuggingFace/torch on random
small-config weights (float32, CPU).  This is the BASELINE 'frame probs within
fp tolerance' contract, exercised without downloading any pretrained weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax
import jax.numpy as jnp

from wav2vecsegmenter_tpu.checkpoints.torch_convert import (
    convert_hf_wav2vec2,
    convert_torch_sfc,
)
from wav2vecsegmenter_tpu.models.sfc import sfc_forward
from wav2vecsegmenter_tpu.models.wav2vec2 import Wav2Vec2Config, wav2vec2_forward

SMALL = dict(
    hidden_size=64,
    num_hidden_layers=3,
    num_attention_heads=4,
    intermediate_size=128,
    conv_dim=(32, 32),
    conv_kernel=(10, 3),
    conv_stride=(5, 2),
    num_feat_extract_layers=2,
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
    hidden_dropout=0.0,
    activation_dropout=0.0,
    attention_dropout=0.0,
    feat_proj_dropout=0.0,
    layerdrop=0.0,
    apply_spec_augment=False,
)


def make_hf_model(stable=True, real_geometry=False):
    """Tiny random HF model; real_geometry uses the true 7-layer 320x conv
    stack (tiny channels) so the 49.95 Hz frame math holds end to end."""
    kwargs = dict(SMALL)
    if real_geometry:
        kwargs.update(
            conv_dim=(32,) * 7,
            conv_kernel=(10, 3, 3, 3, 3, 2, 2),
            conv_stride=(5, 2, 2, 2, 2, 2, 2),
            num_feat_extract_layers=7,
        )
    cfg = transformers.Wav2Vec2Config(
        **kwargs,
        do_stable_layer_norm=stable,
        feat_extract_norm="layer" if stable else "group",
        conv_bias=stable,
    )
    torch.manual_seed(0)
    model = transformers.Wav2Vec2Model(cfg)
    model.eval()
    return model, cfg


def our_cfg(stable=True):
    return Wav2Vec2Config(
        hidden_size=64,
        num_layers=3,
        num_heads=4,
        ffn_dim=128,
        conv_dim=(32, 32),
        conv_kernel=(10, 3),
        conv_stride=(5, 2),
        conv_bias=stable,
        feat_extract_norm="layer" if stable else "group",
        do_stable_layer_norm=stable,
        num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
        hidden_dropout=0.0,
        attention_dropout=0.0,
        activation_dropout=0.0,
        feat_proj_dropout=0.0,
    )


@pytest.mark.parametrize("stable", [True, False])
def test_wav2vec2_matches_hf(stable):
    model, _ = make_hf_model(stable)
    # reference replaces encoder.layer_norm with Identity for EVERY variant
    # (lib/models.py:340-349): the final LN on stable models, the pre-layers
    # LN on base/group-norm models — emulate for comparison
    model.encoder.layer_norm = torch.nn.Identity()

    cfg = our_cfg(stable)
    params = convert_hf_wav2vec2(model.state_dict(), cfg)

    rng = np.random.RandomState(0)
    b, L = 3, 2000
    audio = rng.randn(b, L).astype(np.float32)
    lengths = np.array([2000, 1500, 800], np.int32)
    in_mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int64)

    with torch.no_grad():
        hf_out = model(
            torch.from_numpy(audio), attention_mask=torch.from_numpy(in_mask)
        ).last_hidden_state.numpy()

    ours, frame_mask = wav2vec2_forward(
        params, jnp.asarray(audio), jnp.asarray(lengths), cfg
    )
    ours = np.asarray(ours)
    fm = np.asarray(frame_mask)

    # compare only at valid frames (padded positions are unspecified)
    diff = np.abs(ours - hf_out)[fm]
    assert diff.max() < 2e-4, f"max abs diff {diff.max()}"


def test_sfc_head_matches_torch():
    d_model, n_heads, n_layers = 64, 4, 1
    torch.manual_seed(1)
    enc_layer = torch.nn.TransformerEncoderLayer(
        d_model, nhead=n_heads, activation="gelu", batch_first=True,
        norm_first=True,
    )
    head = torch.nn.ModuleDict({
        "transformer": torch.nn.TransformerEncoder(enc_layer, num_layers=n_layers),
        "layer_norm": torch.nn.LayerNorm(d_model),
        "output_layer": torch.nn.Linear(d_model, 1),
    })
    head.eval()

    params = convert_torch_sfc(head.state_dict(), n_layers)

    rng = np.random.RandomState(2)
    b, t = 2, 37
    x = rng.randn(b, t, d_model).astype(np.float32)
    out_lens = np.array([37, 20])
    out_mask = np.arange(t)[None, :] < out_lens[:, None]

    with torch.no_grad():
        h = head["transformer"](
            torch.from_numpy(x),
            src_key_padding_mask=torch.from_numpy(~out_mask),
        )
        torch_logits = head["output_layer"](head["layer_norm"](h)).squeeze(-1).numpy()

    ours = np.asarray(
        sfc_forward(params, jnp.asarray(x), jnp.asarray(out_mask), n_heads)
    )
    diff = np.abs(ours - torch_logits)[out_mask]
    assert diff.max() < 2e-4, f"max abs diff {diff.max()}"


def test_full_shas_pipeline_parity():
    """wav2vec2 -> +-1-frame fix -> SFC, as the reference composes them
    (lib/models.py:214-235), against the torch pipeline."""
    model, _ = make_hf_model(True)
    model.encoder.layer_norm = torch.nn.Identity()
    d_model = 64

    torch.manual_seed(3)
    enc_layer = torch.nn.TransformerEncoderLayer(
        d_model, nhead=4, activation="gelu", batch_first=True, norm_first=True
    )
    head = torch.nn.ModuleDict({
        "transformer": torch.nn.TransformerEncoder(enc_layer, num_layers=1),
        "layer_norm": torch.nn.LayerNorm(d_model),
        "output_layer": torch.nn.Linear(d_model, 1),
    })
    head.eval()

    from wav2vecsegmenter_tpu.models.shas import SHAS

    shas = SHAS(
        wav2vec_model_name="facebook/wav2vec2-xls-r-300m",
        wav2vec_keep_layers=3,
        n_transformer_enc_layers=1,
        n_transformer_enc_heads=4,
    )
    shas.w2v_cfg = our_cfg(True)
    shas.d_model = d_model

    params = {
        "wav2vec": convert_hf_wav2vec2(model.state_dict(), shas.w2v_cfg),
        "seg": convert_torch_sfc(head.state_dict(), 1),
    }

    rng = np.random.RandomState(4)
    b, L = 2, 1990
    audio = rng.randn(b, L).astype(np.float32)
    lengths = np.array([1990, 1200], np.int32)
    in_mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int64)
    t_out = 198  # an out_mask length != conv length, exercising the fix
    out_lens = np.array([198, 119])
    out_mask = np.arange(t_out)[None, :] < out_lens[:, None]

    with torch.no_grad():
        h = model(
            torch.from_numpy(audio), attention_mask=torch.from_numpy(in_mask)
        ).last_hidden_state
        if h.shape[1] > t_out:
            h = h[:, :t_out]
        hh = head["transformer"](
            h, src_key_padding_mask=torch.from_numpy(~out_mask)
        )
        torch_logits = (
            head["output_layer"](head["layer_norm"](hh)).squeeze(-1).numpy()
        )

    ours = np.asarray(
        shas.apply(params, jnp.asarray(audio), jnp.asarray(lengths),
                   jnp.asarray(out_mask))
    )
    diff = np.abs(ours - torch_logits)[out_mask]
    assert diff.max() < 2e-4, f"max abs diff {diff.max()}"


def test_bf16_compute_dtype_compiles_all_variants():
    """bf16 compute path (the GPU default) must trace for every variant —
    guards dtype leaks that f32-only CPU tests cannot catch."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from .helpers import TINY_W2V, tiny_shas

    variants = [
        tiny_shas(),
        tiny_shas(finetune_wav2vec=True, wav2vec_ft_layers=1,
                  finetune_w2v_feat_enc=False, finetune_w2v_ffn=False),
    ]
    adapter = tiny_shas(finetune_wav2vec=True, wav2vec_ft_layers=1,
                        ffn_adapter=True)
    adapter.w2v_cfg = dataclasses.replace(TINY_W2V, ffn_adapter=True,
                                          adapter_dim=16)
    variants.append(adapter)

    audio = jax.ShapeDtypeStruct((2, 16000), jnp.float32)
    lens = jax.ShapeDtypeStruct((2,), jnp.int32)
    om = jax.ShapeDtypeStruct((2, 50), jnp.bool_)
    for m in variants:
        params = m.init(jax.random.PRNGKey(0))
        out = jax.eval_shape(
            lambda p, a, l, o: m.apply(p, a, l, o,
                                       compute_dtype=jnp.bfloat16),
            params, audio, lens, om)
        assert out.shape == (2, 50)
        # gradient path traces too (fine-tuning)
        gshape = jax.eval_shape(
            lambda p, a, l, o: jax.grad(
                lambda pp: m.apply(pp, a, l, o,
                                   compute_dtype=jnp.bfloat16).sum())(p),
            params, audio, lens, om)
        assert jax.tree.structure(gshape) == jax.tree.structure(params)


def test_attention_prob_dropout_flag():
    """cfg.apply_attention_prob_dropout: inert at eval, active in train mode
    (the explicit-softmax measurement path for the fused kernel's omitted
    prob dropout — scripts/measure_attn_dropout.py)."""
    import dataclasses

    model, _ = make_hf_model(True)
    cfg_off = our_cfg(True)
    cfg_off = dataclasses.replace(cfg_off, attention_dropout=0.1)
    cfg_on = dataclasses.replace(cfg_off, apply_attention_prob_dropout=True)
    params = convert_hf_wav2vec2(model.state_dict(), cfg_off)

    rng = np.random.RandomState(0)
    audio = rng.randn(2, 2000).astype(np.float32)
    lengths = np.array([2000, 2000], np.int32)
    a, l = jnp.asarray(audio), jnp.asarray(lengths)

    # eval path: flag has no effect
    h_off, _ = wav2vec2_forward(params, a, l, cfg_off)
    h_on, _ = wav2vec2_forward(params, a, l, cfg_on)
    np.testing.assert_array_equal(np.asarray(h_off), np.asarray(h_on))

    # train path: flag changes activations (same rng)
    key = jax.random.PRNGKey(7)
    t_off, _ = wav2vec2_forward(params, a, l, cfg_off,
                                deterministic=False, rng=key)
    t_on, _ = wav2vec2_forward(params, a, l, cfg_on,
                               deterministic=False, rng=key)
    assert np.abs(np.asarray(t_off) - np.asarray(t_on)).max() > 1e-6
    # and gradients flow through the prob-dropout path
    g = jax.grad(
        lambda p: wav2vec2_forward(p, a, l, cfg_on, deterministic=False,
                                   rng=key)[0].sum()
    )(params)
    assert np.isfinite(np.asarray(g["layers"]["attn"]["q"]["w"])).all()
