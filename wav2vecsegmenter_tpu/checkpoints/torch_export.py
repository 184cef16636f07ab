"""JAX params -> reference-format PyTorch checkpoint export.

Writes a ``{"state_dict": ...}`` .pt that the reference codebase loads
unmodified (both layouts, train.py:596-613): full layout with
``wav2vec_model.model.*`` + ``seg_model.*`` keys, or seg-head-only.  This is
the inverse of torch_convert.py, so checkpoints can round-trip between the
frameworks.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .torch_convert import import_torch


def _t(arr) -> "object":
    return import_torch().from_numpy(np.asarray(arr).copy())


def _unstack(stacked: dict, i: int) -> dict:
    import jax

    return jax.tree.map(lambda x: x[i], stacked)


def _export_wav2vec2(params: dict, cfg, prefix: str) -> dict:
    sd: dict = {}
    for i, layer in enumerate(params["feature_extractor"]["convs"]):
        base = f"{prefix}feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = _t(np.transpose(np.asarray(layer["w"]),
                                                    (2, 1, 0)))
        if "b" in layer:
            sd[f"{base}.conv.bias"] = _t(layer["b"])
        norm = layer.get("ln") or layer.get("gn")
        if norm is not None:
            sd[f"{base}.layer_norm.weight"] = _t(norm["scale"])
            sd[f"{base}.layer_norm.bias"] = _t(norm["bias"])

    fp = params["feature_projection"]
    sd[f"{prefix}feature_projection.layer_norm.weight"] = _t(fp["ln"]["scale"])
    sd[f"{prefix}feature_projection.layer_norm.bias"] = _t(fp["ln"]["bias"])
    sd[f"{prefix}feature_projection.projection.weight"] = _t(
        np.asarray(fp["proj"]["w"]).T)
    sd[f"{prefix}feature_projection.projection.bias"] = _t(fp["proj"]["b"])

    pc = params["pos_conv"]
    sd[f"{prefix}encoder.pos_conv_embed.conv.weight_g"] = _t(pc["w_g"])
    sd[f"{prefix}encoder.pos_conv_embed.conv.weight_v"] = _t(pc["w_v"])
    sd[f"{prefix}encoder.pos_conv_embed.conv.bias"] = _t(pc["b"])

    if "encoder_pre_ln" in params:
        sd[f"{prefix}encoder.layer_norm.weight"] = _t(
            params["encoder_pre_ln"]["scale"])
        sd[f"{prefix}encoder.layer_norm.bias"] = _t(
            params["encoder_pre_ln"]["bias"])
    if "masked_spec_embed" in params:
        sd[f"{prefix}masked_spec_embed"] = _t(params["masked_spec_embed"])

    n_layers = np.asarray(params["layers"]["ln1"]["scale"]).shape[0]
    for i in range(n_layers):
        layer = _unstack(params["layers"], i)
        base = f"{prefix}encoder.layers.{i}"
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                          ("out_proj", "o")):
            sd[f"{base}.attention.{name}.weight"] = _t(
                np.asarray(layer["attn"][key]["w"]).T)
            sd[f"{base}.attention.{name}.bias"] = _t(layer["attn"][key]["b"])
        sd[f"{base}.layer_norm.weight"] = _t(layer["ln1"]["scale"])
        sd[f"{base}.layer_norm.bias"] = _t(layer["ln1"]["bias"])
        sd[f"{base}.final_layer_norm.weight"] = _t(layer["ln2"]["scale"])
        sd[f"{base}.final_layer_norm.bias"] = _t(layer["ln2"]["bias"])
        sd[f"{base}.feed_forward.intermediate_dense.weight"] = _t(
            np.asarray(layer["ffn"]["w1"]["w"]).T)
        sd[f"{base}.feed_forward.intermediate_dense.bias"] = _t(
            layer["ffn"]["w1"]["b"])
        sd[f"{base}.feed_forward.output_dense.weight"] = _t(
            np.asarray(layer["ffn"]["w2"]["w"]).T)
        sd[f"{base}.feed_forward.output_dense.bias"] = _t(
            layer["ffn"]["w2"]["b"])
        if "adapter" in layer and float(layer["adapter"]["flag"]) > 0:
            sd[f"{base}.ffn_adapter.down_proj.weight"] = _t(
                np.asarray(layer["adapter"]["down"]["w"]).T)
            sd[f"{base}.ffn_adapter.down_proj.bias"] = _t(
                layer["adapter"]["down"]["b"])
            sd[f"{base}.ffn_adapter.up_proj.weight"] = _t(
                np.asarray(layer["adapter"]["up"]["w"]).T)
            sd[f"{base}.ffn_adapter.up_proj.bias"] = _t(
                layer["adapter"]["up"]["b"])
    return sd


def _export_sfc(params: dict, prefix: str) -> dict:
    torch = import_torch()
    sd: dict = {}
    if "layers" in params:
        n_layers = np.asarray(params["layers"]["ln1"]["scale"]).shape[0]
        for i in range(n_layers):
            layer = _unstack(params["layers"], i)
            base = f"{prefix}transformer.layers.{i}"
            qw = np.asarray(layer["attn"]["q"]["w"]).T
            kw = np.asarray(layer["attn"]["k"]["w"]).T
            vw = np.asarray(layer["attn"]["v"]["w"]).T
            sd[f"{base}.self_attn.in_proj_weight"] = _t(
                np.concatenate([qw, kw, vw], axis=0))
            sd[f"{base}.self_attn.in_proj_bias"] = _t(np.concatenate([
                np.asarray(layer["attn"]["q"]["b"]),
                np.asarray(layer["attn"]["k"]["b"]),
                np.asarray(layer["attn"]["v"]["b"]),
            ]))
            sd[f"{base}.self_attn.out_proj.weight"] = _t(
                np.asarray(layer["attn"]["o"]["w"]).T)
            sd[f"{base}.self_attn.out_proj.bias"] = _t(layer["attn"]["o"]["b"])
            sd[f"{base}.norm1.weight"] = _t(layer["ln1"]["scale"])
            sd[f"{base}.norm1.bias"] = _t(layer["ln1"]["bias"])
            sd[f"{base}.norm2.weight"] = _t(layer["ln2"]["scale"])
            sd[f"{base}.norm2.bias"] = _t(layer["ln2"]["bias"])
            sd[f"{base}.linear1.weight"] = _t(np.asarray(layer["ffn"]["w1"]["w"]).T)
            sd[f"{base}.linear1.bias"] = _t(layer["ffn"]["w1"]["b"])
            sd[f"{base}.linear2.weight"] = _t(np.asarray(layer["ffn"]["w2"]["w"]).T)
            sd[f"{base}.linear2.bias"] = _t(layer["ffn"]["w2"]["b"])
    sd[f"{prefix}layer_norm.weight"] = _t(params["final_ln"]["scale"])
    sd[f"{prefix}layer_norm.bias"] = _t(params["final_ln"]["bias"])
    sd[f"{prefix}output_layer.weight"] = _t(np.asarray(params["out"]["w"]).T)
    sd[f"{prefix}output_layer.bias"] = _t(params["out"]["b"])
    return sd


def export_torch_checkpoint(params: dict, model, path: str | Path) -> Path:
    """Write a reference-compatible .pt; layout follows
    ``model.save_full_state`` (full vs seg-only)."""
    import jax

    torch = import_torch()
    # materialize the whole tree as host numpy ONCE: the per-leaf slicing
    # below (_unstack's x[i]) would otherwise dispatch hundreds of eager jax
    # ops — measured >10 min for 323.8M params on the 1-core bench host
    params = jax.device_get(params)
    path = Path(path)
    if model.save_full_state:
        sd = _export_wav2vec2(params["wav2vec"], model.w2v_cfg,
                              "wav2vec_model.model.")
        sd.update(_export_sfc(params["seg"], "seg_model."))
    else:
        sd = _export_sfc(params["seg"], "")
    torch.save({"state_dict": sd}, str(path))
    return path
