"""PyTorch checkpoint -> JAX pytree conversion.

Supports the three checkpoint families the reference ecosystem produces:
  1. HF ``Wav2Vec2Model`` pretrained weights (wav2vec2-xls-r-300m etc.),
     loaded from a local HF directory (pytorch_model.bin / model.safetensors);
  2. reference SFC checkpoints, *full* layout (``wav2vec_model.model.*`` +
     ``seg_model.*`` keys, saved when finetune_wav2vec=True,
     reference train.py:596-604);
  3. reference SFC checkpoints, *seg-only* layout (classifier state dict
     only, train.py:605-613; the wav2vec2 weights come from the HF dir).

Weight layout convention here: linear weights are [in, out] (right-multiply),
i.e. the transpose of torch's [out, in]; conv weights are [k, in, out]
('HIO') vs torch's [out, in, k].
"""

from __future__ import annotations

import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..models.wav2vec2 import Wav2Vec2Config

logger = logging.getLogger(__name__)


def _np(t) -> np.ndarray:
    """torch tensor (or ndarray) -> float32 ndarray without importing torch
    at module scope."""
    if isinstance(t, np.ndarray):
        return t.astype(np.float32)
    return t.detach().cpu().numpy().astype(np.float32)


def _lin(sd: dict, prefix: str) -> dict:
    return {
        "w": jnp.asarray(_np(sd[f"{prefix}.weight"]).T),
        "b": jnp.asarray(_np(sd[f"{prefix}.bias"])),
    }


def _lnorm(sd: dict, prefix: str) -> dict:
    return {
        "scale": jnp.asarray(_np(sd[f"{prefix}.weight"])),
        "bias": jnp.asarray(_np(sd[f"{prefix}.bias"])),
    }


def _stack(dicts: list[dict]) -> dict:
    import jax

    return jax.tree.map(lambda *xs: jnp.stack(xs), *dicts)


# --------------------------------------------------------------------------
# HF Wav2Vec2Model
# --------------------------------------------------------------------------

def convert_hf_wav2vec2(sd: dict, cfg: Wav2Vec2Config,
                        prefix: str = "") -> dict:
    """HF Wav2Vec2Model state_dict -> our wav2vec params subtree.

    ``cfg.num_layers`` controls truncation: only the first N encoder layers
    are converted (reference layer-truncation, lib/models.py:340-346).
    """
    p = prefix
    params: dict = {}

    convs = []
    for i in range(len(cfg.conv_dim)):
        base = f"{p}feature_extractor.conv_layers.{i}"
        layer = {"w": jnp.asarray(
            np.transpose(_np(sd[f"{base}.conv.weight"]), (2, 1, 0)))}
        if f"{base}.conv.bias" in sd:
            layer["b"] = jnp.asarray(_np(sd[f"{base}.conv.bias"]))
        if cfg.feat_extract_norm == "layer":
            layer["ln"] = _lnorm(sd, f"{base}.layer_norm")
        elif i == 0:
            layer["gn"] = _lnorm(sd, f"{base}.layer_norm")
        convs.append(layer)
    params["feature_extractor"] = {"convs": convs}

    params["feature_projection"] = {
        "ln": _lnorm(sd, f"{p}feature_projection.layer_norm"),
        "proj": _lin(sd, f"{p}feature_projection.projection"),
    }

    # positional conv: plain weight_norm names or parametrize API names
    pc = f"{p}encoder.pos_conv_embed.conv"
    if f"{pc}.weight_g" in sd:
        wg, wv = sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"]
    else:
        wg = sd[f"{pc}.parametrizations.weight.original0"]
        wv = sd[f"{pc}.parametrizations.weight.original1"]
    params["pos_conv"] = {
        "w_g": jnp.asarray(_np(wg)),
        "w_v": jnp.asarray(_np(wv)),
        "b": jnp.asarray(_np(sd[f"{pc}.bias"])),
    }

    if not cfg.do_stable_layer_norm and f"{p}encoder.layer_norm.weight" in sd:
        params["encoder_pre_ln"] = _lnorm(sd, f"{p}encoder.layer_norm")

    if f"{p}masked_spec_embed" in sd:
        params["masked_spec_embed"] = jnp.asarray(_np(sd[f"{p}masked_spec_embed"]))

    layers = []
    for i in range(cfg.num_layers):
        base = f"{p}encoder.layers.{i}"
        layer = {
            "ln1": _lnorm(sd, f"{base}.layer_norm"),
            "attn": {
                "q": _lin(sd, f"{base}.attention.q_proj"),
                "k": _lin(sd, f"{base}.attention.k_proj"),
                "v": _lin(sd, f"{base}.attention.v_proj"),
                "o": _lin(sd, f"{base}.attention.out_proj"),
            },
            "ln2": _lnorm(sd, f"{base}.final_layer_norm"),
            "ffn": {
                "w1": _lin(sd, f"{base}.feed_forward.intermediate_dense"),
                "w2": _lin(sd, f"{base}.feed_forward.output_dense"),
            },
        }
        if cfg.ffn_adapter:
            if f"{base}.ffn_adapter.down_proj.weight" in sd:
                layer["adapter"] = {
                    "down": _lin(sd, f"{base}.ffn_adapter.down_proj"),
                    "up": _lin(sd, f"{base}.ffn_adapter.up_proj"),
                    "flag": jnp.ones((), jnp.float32),
                }
            else:
                h, a = cfg.hidden_size, cfg.adapter_dim
                layer["adapter"] = {
                    "down": {"w": jnp.zeros((h, a)), "b": jnp.zeros((a,))},
                    "up": {"w": jnp.zeros((a, h)), "b": jnp.zeros((h,))},
                    "flag": jnp.zeros((), jnp.float32),
                }
        layers.append(layer)
    params["layers"] = _stack(layers)
    return params


# --------------------------------------------------------------------------
# torch SFC head (nn.TransformerEncoder based)
# --------------------------------------------------------------------------

def convert_torch_sfc(sd: dict, n_layers: int, prefix: str = "") -> dict:
    """torch SegmentationFrameClassifier state_dict -> seg params subtree.

    torch MHA packs q/k/v into in_proj_weight [3E, E]; split into our
    separate projections."""
    p = prefix
    params: dict = {}
    layers = []
    for i in range(n_layers):
        base = f"{p}transformer.layers.{i}"
        in_w = _np(sd[f"{base}.self_attn.in_proj_weight"])
        in_b = _np(sd[f"{base}.self_attn.in_proj_bias"])
        e = in_w.shape[1]
        qw, kw, vw = in_w[:e], in_w[e : 2 * e], in_w[2 * e :]
        qb, kb, vb = in_b[:e], in_b[e : 2 * e], in_b[2 * e :]
        layers.append({
            "ln1": _lnorm(sd, f"{base}.norm1"),
            "attn": {
                "q": {"w": jnp.asarray(qw.T), "b": jnp.asarray(qb)},
                "k": {"w": jnp.asarray(kw.T), "b": jnp.asarray(kb)},
                "v": {"w": jnp.asarray(vw.T), "b": jnp.asarray(vb)},
                "o": _lin(sd, f"{base}.self_attn.out_proj"),
            },
            "ln2": _lnorm(sd, f"{base}.norm2"),
            "ffn": {
                "w1": _lin(sd, f"{base}.linear1"),
                "w2": _lin(sd, f"{base}.linear2"),
            },
        })
    if layers:
        params["layers"] = _stack(layers)
    params["final_ln"] = _lnorm(sd, f"{p}layer_norm")
    params["out"] = _lin(sd, f"{p}output_layer")
    return params


# --------------------------------------------------------------------------
# reference .pt checkpoints
# --------------------------------------------------------------------------

def convert_hf_for_ctc(sd: dict, cfg: Wav2Vec2Config,
                       prefix: str = "") -> dict:
    """HF Wav2Vec2ForCTC state dict -> {wav2vec, final_ln, lm_head} for
    SHASWithSSL (reference HFWav2Vec2ForCTC wrapper, lib/models.py:488-507:
    the backbone keeps its final encoder LayerNorm; CTC logits come from
    lm_head on the post-LN hidden states)."""
    p = prefix
    out = {
        "wav2vec": convert_hf_wav2vec2(sd, cfg, prefix=f"{p}wav2vec2."),
        "final_ln": _lnorm(sd, f"{p}wav2vec2.encoder.layer_norm"),
        "lm_head": _lin(sd, f"{p}lm_head"),
    }
    return out


def import_torch():
    """torch, imported on first use: only the .pt converters need it."""
    try:
        import torch
    except ImportError as e:
        raise ImportError(
            "reading or writing PyTorch .pt checkpoints needs torch, which "
            "is not installed; native checkpoint directories need no "
            "torch") from e
    return torch


def load_torch_state_dict(path: str | Path) -> dict:
    torch = import_torch()
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def is_full_layout(sd: dict) -> bool:
    """True if the checkpoint carries wav2vec weights (full layout)."""
    return any(k.startswith("wav2vec_model.") for k in sd)


def convert_reference_checkpoint(sd: dict, model) -> dict:
    """Reference SHAS .pt state dict -> full params pytree for ``model``
    (a models.shas spec).  Handles both layouts (train.py:596-613) and the
    SSL variant's ForCTC nesting."""
    if is_full_layout(sd):
        if any(k.startswith("wav2vec_model.model.wav2vec2.") for k in sd):
            # SHASWithSSL full layout (ForCTC backbone)
            out = convert_hf_for_ctc(sd, model.w2v_cfg,
                                     prefix="wav2vec_model.model.")
            out["seg"] = convert_torch_sfc(sd, model.n_enc_layers,
                                           prefix="seg_model.")
            return out
        w2v = convert_hf_wav2vec2(sd, model.w2v_cfg, prefix="wav2vec_model.model.")
        seg = convert_torch_sfc(sd, model.n_enc_layers, prefix="seg_model.")
        return {"wav2vec": w2v, "seg": seg}
    # seg-only layout: caller must supply wav2vec weights separately
    return {"seg": convert_torch_sfc(sd, model.n_enc_layers)}


def load_hf_pretrained_dir(model_dir: str | Path, cfg: Wav2Vec2Config) -> dict:
    """Load wav2vec2 weights from a local HF model directory."""
    model_dir = Path(model_dir)
    st_path = model_dir / "model.safetensors"
    bin_path = model_dir / "pytorch_model.bin"
    if st_path.exists():
        from safetensors.numpy import load_file

        sd = load_file(str(st_path))
    elif bin_path.exists():
        sd = load_torch_state_dict(bin_path)
    else:
        raise FileNotFoundError(f"No weights found under {model_dir}")
    # ForCTC checkpoints prefix the backbone with 'wav2vec2.'
    prefix = "wav2vec2." if any(k.startswith("wav2vec2.") for k in sd) else ""
    return convert_hf_wav2vec2(sd, cfg, prefix=prefix)
