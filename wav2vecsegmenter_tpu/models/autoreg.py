"""Autoregressive segmenter: wav2vec2 encoder + transformer decoder over a
4-token vocabulary.

Equivalent of reference ``AutoRegSegmenter``/``TransformerEncoderDecoder``
(lib/models.py:11-140): 1 pre-LN encoder layer + 4 pre-LN decoder layers,
scaled token embedding (lib/models.py:162-169); positional encoding is
intentionally absent, matching the reference's ``[TODO] PE``
(lib/models.py:127-128).  The decoder LayerNorm after the encoder and before
the output projection is the *same* module (lib/models.py:101,123,138) —
replicated via a shared parameter group.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..ops.attention import NEG_INF, attention, prefix_lengths
from ..ops.layernorm import layer_norm
from .sfc import _linear, _ln
from .shas import _mask_like
from .wav2vec2 import (_dropout, config_for, init_wav2vec2_params,
                       wav2vec2_forward)

_EPS = 1e-5

# torch TransformerEncoderLayer/DecoderLayer default — the reference builds
# its seg encoder/decoder without overriding it (lib/models.py:75-96)
_LAYER_DROPOUT = 0.1


def _attn_block(p, x_q, x_kv, n_heads, key_mask=None, causal=False,
                compute_dtype=jnp.float32):
    """Multi-head attention in [B, T, N, D] layout.  ``key_mask`` [B, Tk]
    is a prefix mask of valid keys (frame mask) or, with ``causal``, the
    decoder's target padding mask."""
    b, tq, d = x_q.shape
    dh = d // n_heads

    def proj(pp, xx):
        return xx @ pp["w"].astype(compute_dtype) + pp["b"].astype(compute_dtype)

    q = proj(p["q"], x_q).reshape(b, tq, n_heads, dh)
    k = proj(p["k"], x_kv).reshape(b, -1, n_heads, dh)
    v = proj(p["v"], x_kv).reshape(b, -1, n_heads, dh)
    if causal:
        # causal decoder self-attention keeps the explicit softmax: its
        # target mask is not a prefix of valid keys per query.  Scores +
        # softmax in f32 regardless of compute dtype (bf16 exp/denominator
        # accumulation is ~1% noisy)
        scores = jnp.einsum("bqnd,bknd->bnqk", q * dh ** -0.5, k,
                            preferred_element_type=jnp.float32)
        tk = scores.shape[-1]
        cmask = jnp.tril(jnp.ones((tq, tk), bool))
        scores = jnp.where(cmask[None, None], scores, NEG_INF)
        if key_mask is not None:
            scores = jnp.where(key_mask[:, None, None, :], scores, NEG_INF)
        probs = jax.nn.softmax(scores, -1).astype(compute_dtype)
        out = jnp.einsum("bnqk,bknd->bqnd", probs, v)
    else:
        kv_lengths = None if key_mask is None else prefix_lengths(key_mask)
        out = attention(q, k, v, kv_lengths, scale=dh ** -0.5)
    return proj(p["o"], out.reshape(b, tq, d))


def _ffn_block(p, x, compute_dtype=jnp.float32, *, deterministic=True,
               rng=None):
    f = x @ p["w1"]["w"].astype(compute_dtype) + p["w1"]["b"].astype(compute_dtype)
    f = jax.nn.gelu(f, approximate=False)
    if rng is not None:
        f = _dropout(f, _LAYER_DROPOUT, deterministic, rng)
    return f @ p["w2"]["w"].astype(compute_dtype) + p["w2"]["b"].astype(compute_dtype)


class AutoRegSegmenterImpl:
    def __init__(
        self,
        wav2vec_model_name: str = "facebook/wav2vec2-xls-r-300m",
        wav2vec_keep_layers: int = 15,
        finetune_wav2vec: bool = False,
        wav2vec_ft_layers: int | None = None,
        finetune_w2v_feat_enc: bool = False,
        n_transformer_enc_layers: int = 1,
        n_transformer_enc_heads: int = 8,
        n_transformer_dec_layers: int = 4,
        n_transformer_dec_heads: int = 8,
        init_dropout: float = 0.1,
        vocab_size: int = 4,
    ) -> None:
        self.w2v_cfg = config_for(wav2vec_model_name, wav2vec_keep_layers)
        self.finetune_wav2vec = bool(finetune_wav2vec)
        self.n_enc_layers = n_transformer_enc_layers
        self.n_enc_heads = n_transformer_enc_heads
        self.n_dec_layers = n_transformer_dec_layers
        self.n_dec_heads = n_transformer_dec_heads
        self.init_dropout = init_dropout
        self.vocab_size = vocab_size
        self.d_model = self.w2v_cfg.hidden_size

    def init(self, rng: jax.Array) -> dict:
        keys = jax.random.split(rng, 6)
        d, f = self.d_model, 2048

        def enc_layer(i):
            ks = jax.random.split(jax.random.fold_in(keys[1], i), 6)
            return {
                "ln1": _ln(d),
                "attn": {"q": _linear(ks[0], d, d), "k": _linear(ks[1], d, d),
                         "v": _linear(ks[2], d, d), "o": _linear(ks[3], d, d)},
                "ln2": _ln(d),
                "ffn": {"w1": _linear(ks[4], d, f), "w2": _linear(ks[5], f, d)},
            }

        def dec_layer(i):
            ks = jax.random.split(jax.random.fold_in(keys[2], i), 10)
            return {
                "ln1": _ln(d),
                "self_attn": {"q": _linear(ks[0], d, d), "k": _linear(ks[1], d, d),
                              "v": _linear(ks[2], d, d), "o": _linear(ks[3], d, d)},
                "ln2": _ln(d),
                "cross_attn": {"q": _linear(ks[4], d, d), "k": _linear(ks[5], d, d),
                               "v": _linear(ks[6], d, d), "o": _linear(ks[7], d, d)},
                "ln3": _ln(d),
                "ffn": {"w1": _linear(ks[8], d, f), "w2": _linear(ks[9], f, d)},
            }

        enc = [enc_layer(i) for i in range(self.n_enc_layers)]
        dec = [dec_layer(i) for i in range(self.n_dec_layers)]
        return {
            "wav2vec": init_wav2vec2_params(keys[0], self.w2v_cfg),
            "seg": {
                "encoder": jax.tree.map(lambda *xs: jnp.stack(xs), *enc),
                "decoder": jax.tree.map(lambda *xs: jnp.stack(xs), *dec),
                "tok_emb": jax.random.normal(
                    keys[3], (self.vocab_size, d), jnp.float32),
                "shared_ln": _ln(d),
                "out": _linear(keys[4], d, self.vocab_size),
            },
        }

    def apply(self, params, audio, in_lengths, target_in, src_mask, tgt_mask,
              *, deterministic=True, rng=None, compute_dtype=jnp.float32):
        """target_in [B, T_tgt] token ids; returns logits [B, T_tgt, V]."""
        if rng is not None:
            rng, enc_rng, dec_rng = jax.random.split(rng, 3)
        else:
            enc_rng = dec_rng = None
        memory, frame_mask = self._encode(
            params, audio, in_lengths, compute_dtype,
            deterministic=deterministic, rng=enc_rng,
        )
        seg = params["seg"]

        emb = seg["tok_emb"][target_in] * math.sqrt(self.d_model)
        y = emb.astype(compute_dtype)
        # no dropout on tgt_emb: the reference's PE (which carried it) is
        # commented out (lib/models.py:127-128)

        def dec_body(carry, xs):
            yy, i = carry
            layer = xs
            lrng = None if dec_rng is None else jax.random.fold_in(dec_rng, i)
            rngs = jax.random.split(lrng, 4) if lrng is not None else [None] * 4
            yn = layer_norm(yy, layer["ln1"]["scale"], layer["ln1"]["bias"], _EPS)
            a = _attn_block(layer["self_attn"], yn, yn, self.n_dec_heads,
                            tgt_mask, causal=True,
                            compute_dtype=compute_dtype)
            yy = yy + _dropout(a, _LAYER_DROPOUT, deterministic, rngs[0])
            yn = layer_norm(yy, layer["ln2"]["scale"], layer["ln2"]["bias"], _EPS)
            a = _attn_block(layer["cross_attn"], yn, memory,
                            self.n_dec_heads, frame_mask,
                            compute_dtype=compute_dtype)
            yy = yy + _dropout(a, _LAYER_DROPOUT, deterministic, rngs[1])
            yn = layer_norm(yy, layer["ln3"]["scale"], layer["ln3"]["bias"], _EPS)
            f = _ffn_block(layer["ffn"], yn, compute_dtype,
                           deterministic=deterministic, rng=rngs[2])
            yy = yy + _dropout(f, _LAYER_DROPOUT, deterministic, rngs[3])
            return (yy, i + 1), None

        (y, _), _ = jax.lax.scan(dec_body, (y, 0), seg["decoder"])
        y = layer_norm(y, seg["shared_ln"]["scale"], seg["shared_ln"]["bias"],
                       _EPS)
        logits = y @ seg["out"]["w"].astype(compute_dtype) + \
            seg["out"]["b"].astype(compute_dtype)
        return logits.astype(jnp.float32)

    def _encode(self, params, audio, in_lengths, compute_dtype, *,
                deterministic=True, rng=None):
        """Shared encoder path: wav2vec2 -> init_dropout(src) -> 1-layer
        transformer -> shared LN (the memory the decoder cross-attends to).

        Dropout placement matches the reference TransformerEncoderDecoder
        (lib/models.py:100-123): ``self.dropout(src)`` with init_dropout
        before the encoder, plus the torch encoder-layer defaults (0.1
        after self-attn, inside the FFN, after the FFN)."""
        if rng is not None:
            rng, w2v_rng, src_rng, layer_rng = jax.random.split(rng, 4)
        else:
            w2v_rng = src_rng = layer_rng = None
        h, frame_mask = wav2vec2_forward(
            params["wav2vec"], audio, in_lengths, self.w2v_cfg,
            deterministic=deterministic, rng=w2v_rng,
            compute_dtype=compute_dtype,
        )
        if not self.finetune_wav2vec:
            h = jax.lax.stop_gradient(h)
        seg = params["seg"]
        x = _dropout(h.astype(compute_dtype), self.init_dropout,
                     deterministic, src_rng)

        def enc_body(carry, layer):
            hh, i = carry
            lrng = (None if layer_rng is None
                    else jax.random.fold_in(layer_rng, i))
            rngs = jax.random.split(lrng, 3) if lrng is not None else [None] * 3
            hn = layer_norm(hh, layer["ln1"]["scale"], layer["ln1"]["bias"], _EPS)
            a = _attn_block(layer["attn"], hn, hn, self.n_enc_heads,
                            frame_mask, compute_dtype=compute_dtype)
            hh = hh + _dropout(a, _LAYER_DROPOUT, deterministic, rngs[0])
            hn = layer_norm(hh, layer["ln2"]["scale"], layer["ln2"]["bias"], _EPS)
            f = _ffn_block(layer["ffn"], hn, compute_dtype,
                           deterministic=deterministic, rng=rngs[1])
            hh = hh + _dropout(f, _LAYER_DROPOUT, deterministic, rngs[2])
            return (hh, i + 1), None

        (x, _), _ = jax.lax.scan(enc_body, (x, 0), seg["encoder"])
        memory = layer_norm(x, seg["shared_ln"]["scale"],
                            seg["shared_ln"]["bias"], _EPS)
        return memory, frame_mask

    def greedy_decode(self, params, audio, in_lengths, t_out: int, *,
                      compute_dtype=jnp.float32,
                      boundary_id: int = 0, nonboundary_id: int = 1,
                      sep_id: int = 3):
        """Greedy frame-token decode — the inference path the reference
        leaves as ``NotImplementedError`` (lib/evaluate.py:50).

        One token per output frame, teacher-forcing layout from training
        (SEP-led input, data/collate.py:collate_autoreg): step i feeds the
        token decoded at i-1 (SEP at i=0) and predicts frame i.  Decoding is
        KV-cached — the encoder memory and each decoder layer's cross K/V
        are computed once; a lax.scan over frame positions carries per-layer
        self-attention caches, so the cost is O(T) single-token decoder
        steps, not O(T^2) full re-runs.  Tokens are constrained to the
        frame alphabet {<B>, <NB>} (argmax over those two logits).

        Returns (probs [B, t_out], logits [B, t_out, V], tokens [B, t_out]):
        ``probs`` is p(<NB>)/(p(<B>)+p(<NB>)) — the probability the frame is
        inside a speech segment, matching the BCE path's prob semantics so
        pdac/pthr/strm consume it unchanged (the collate maps frame target
        1 -> <NB>, 0 -> <B>)."""
        memory, frame_mask = self._encode(params, audio, in_lengths,
                                          compute_dtype)
        seg = params["seg"]
        b = memory.shape[0]
        d, h = self.d_model, self.n_dec_heads
        dh = d // h

        def proj(pp, xx):
            return xx @ pp["w"].astype(compute_dtype) + \
                pp["b"].astype(compute_dtype)

        # cross-attention K/V once per layer: [L, B, H, T_mem, dh]
        def cross_kv(layer):
            k = proj(layer["cross_attn"]["k"], memory)
            v = proj(layer["cross_attn"]["v"], memory)
            rs = lambda z: z.reshape(b, -1, h, dh).transpose(0, 2, 1, 3)
            return rs(k), rs(v)

        k_cross, v_cross = jax.vmap(cross_kv, in_axes=(0,))(seg["decoder"])

        n_layers = self.n_dec_layers
        k_cache = jnp.zeros((n_layers, b, h, t_out, dh), compute_dtype)
        v_cache = jnp.zeros_like(k_cache)
        tok0 = jnp.full((b,), sep_id, jnp.int32)

        def step(carry, i):
            tok, kc, vc = carry
            y = (seg["tok_emb"][tok] * math.sqrt(d)).astype(compute_dtype)

            def layer_body(yy, xs):
                layer, kx, vx, kc_l, vc_l = xs
                yn = layer_norm(yy, layer["ln1"]["scale"],
                                layer["ln1"]["bias"], _EPS)
                q = proj(layer["self_attn"]["q"], yn).reshape(b, h, dh)
                kk = proj(layer["self_attn"]["k"], yn).reshape(b, h, dh)
                vv = proj(layer["self_attn"]["v"], yn).reshape(b, h, dh)
                kc_l = jax.lax.dynamic_update_index_in_dim(kc_l, kk, i, 2)
                vc_l = jax.lax.dynamic_update_index_in_dim(vc_l, vv, i, 2)
                scores = jnp.einsum("bhd,bhkd->bhk", q * dh ** -0.5, kc_l)
                pos_ok = jnp.arange(t_out)[None, None, :] <= i
                scores = jnp.where(pos_ok, scores, -1e30)
                att = jnp.einsum(
                    "bhk,bhkd->bhd", jax.nn.softmax(scores, -1), vc_l)
                yy = yy + proj(layer["self_attn"]["o"],
                               att.reshape(b, d))
                yn = layer_norm(yy, layer["ln2"]["scale"],
                                layer["ln2"]["bias"], _EPS)
                q = proj(layer["cross_attn"]["q"], yn).reshape(b, h, dh)
                cs = jnp.einsum("bhd,bhkd->bhk", q * dh ** -0.5, kx)
                cs = jnp.where(frame_mask[:, None, :], cs, -1e30)
                catt = jnp.einsum("bhk,bhkd->bhd", jax.nn.softmax(cs, -1), vx)
                yy = yy + proj(layer["cross_attn"]["o"], catt.reshape(b, d))
                yn = layer_norm(yy, layer["ln3"]["scale"],
                                layer["ln3"]["bias"], _EPS)
                yy = yy + _ffn_block(layer["ffn"], yn, compute_dtype)
                return yy, (kc_l, vc_l)

            y, (kc, vc) = jax.lax.scan(
                layer_body, y, (seg["decoder"], k_cross, v_cross, kc, vc))
            y = layer_norm(y, seg["shared_ln"]["scale"],
                           seg["shared_ln"]["bias"], _EPS)
            logits = (y @ seg["out"]["w"].astype(compute_dtype) +
                      seg["out"]["b"].astype(compute_dtype)).astype(jnp.float32)
            frame_pair = jnp.stack(
                [logits[:, boundary_id], logits[:, nonboundary_id]], -1)
            next_tok = jnp.where(
                jnp.argmax(frame_pair, -1) == 1, nonboundary_id, boundary_id
            ).astype(jnp.int32)
            p = jax.nn.softmax(frame_pair, axis=-1)[:, 1]
            return (next_tok, kc, vc), (p, logits, next_tok)

        _, (probs, logits, tokens) = jax.lax.scan(
            step, (tok0, k_cache, v_cache), jnp.arange(t_out))
        # scan stacks along axis 0 (time) -> [B, T, ...]
        return (probs.transpose(1, 0), logits.transpose(1, 0, 2),
                tokens.transpose(1, 0))

    def trainable_mask(self, params):
        # scalar broadcastable leaves (shas._mask_like): a full-shaped mask
        # tree would double param HBM residency at 300M params
        return {
            "wav2vec": _mask_like(
                params["wav2vec"], 1.0 if self.finetune_wav2vec else 0.0),
            "seg": _mask_like(params["seg"], 1.0),
        }

    @property
    def save_full_state(self) -> bool:
        return self.finetune_wav2vec
