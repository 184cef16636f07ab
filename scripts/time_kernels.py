#!/usr/bin/env python
"""Time the attention candidates where they run: inside the 24-layer
forward (batch 10, 20 s windows, T=999) and the fine-tune train step
(lna_l24_ft24, batch 4) of SHAS on the wav2vec2-xls-r-300m architecture in
bf16, on one GPU.

    python scripts/time_kernels.py [--reps 5] [--rounds 3]

Attention arms:
  * cudnn   — the product path (ops/attention.py): cuDNN fused attention
  * xla     — the plain einsum left to XLA: bf16 operands, float32 scores
              and softmax, [B, N, T, T] scores in device memory
  * pallas  — JAX's own Pallas-Triton flash attention kernel
              (jax.experimental.pallas.ops.gpu.attention.mha, a library
              kernel, not one this repository wrote), T padded to its block
              size, key padding as segment ids

Arms run in turns, ``--rounds`` times, so that clock and power drift hit
every arm alike; each prints its median and best.  Then one profiler
trace of LayerNorm at [10, 999, 1024] lists the kernels it launches.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def attention_arms():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.gpu import attention as pallas_attention

    from wav2vecsegmenter_tpu.ops.attention import NEG_INF, attention

    def cudnn(q, k, v, kv_lengths=None, scale=None):
        return attention(q, k, v, kv_lengths, scale, impl="cudnn")

    def xla(q, k, v, kv_lengths=None, scale=None):
        s = jnp.einsum("bqnd,bknd->bnqk", q, k,
                       preferred_element_type=jnp.float32) * scale
        if kv_lengths is not None:
            valid = jnp.arange(k.shape[1])[None, :] < kv_lengths[:, None]
            s = jnp.where(valid[:, None, None, :], s, NEG_INF)
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        return jnp.einsum("bnqk,bknd->bqnd", p, v)

    def pallas(q, k, v, kv_lengths=None, scale=None):
        # self-attention only (one segment-id array covers q and k)
        b, t, n, d = q.shape
        tp = -(-t // 64) * 64
        pad = ((0, 0), (0, tp - t), (0, 0), (0, 0))
        lengths = jnp.full((b,), t) if kv_lengths is None else kv_lengths
        seg = (jnp.arange(tp)[None, :] < jnp.maximum(lengths, 1)[:, None])
        out = pallas_attention.mha(
            jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad),
            seg.astype(jnp.int32), sm_scale=scale,
            block_sizes=pallas_attention.BlockSizes(
                block_q=64, block_k=64, block_q_dkv=32, block_kv_dkv=32,
                block_q_dq=32, block_kv_dq=32))
        return out[:, :t]

    return {"cudnn": cudnn, "xla": xla, "pallas": pallas}


def build(arm_fn, seed=0):
    """(forward fn + args, train step fn + state + batch), traced and
    compiled with the model's attention calls routed through ``arm_fn``."""
    import jax
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.models import sfc, wav2vec2
    from wav2vecsegmenter_tpu.models.shas import SHAS
    from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss
    from wav2vecsegmenter_tpu.train.step import (
        init_train_state, make_optimizer, make_train_step)

    model = SHAS(wav2vec_model_name="facebook/wav2vec2-xls-r-300m",
                 wav2vec_keep_layers=24, finetune_wav2vec=True,
                 wav2vec_ft_layers=24, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=8, init_dropout=0.1)
    params = model.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    L, t_out = 320000, 999
    lens = np.full(10, L, np.int32)
    lens[-3:] = [250000, 160000, 48000]  # ragged tail windows
    fwd_args = (params, jnp.asarray(rng.randn(10, L).astype(np.float32)),
                jnp.asarray(lens), jnp.ones((10, t_out), bool))

    def fwd(p, a, l, m):
        return model.apply(p, a, l, m, deterministic=True,
                           compute_dtype=jnp.bfloat16)

    opt = make_optimizer(2.5e-4, 10_000, 1, model.trainable_mask(params))
    step = make_train_step(model, BCEWithLogitsLoss(None), "bce", 0, opt,
                           compute_dtype=jnp.bfloat16)
    state = init_train_state(model, opt, jax.random.PRNGKey(1),
                             jax.tree.map(jnp.copy, params))
    batch = {
        "audio": jnp.asarray(rng.randn(4, L).astype(np.float32)),
        "in_lengths": jnp.full((4,), L, jnp.int32),
        "target": jnp.asarray((rng.rand(4, t_out) > 0.3).astype(np.float32)),
        "out_mask": jnp.ones((4, t_out), bool),
    }
    with mock.patch.object(wav2vec2, "attention", arm_fn), \
            mock.patch.object(sfc, "attention", arm_fn):
        fwd_c = jax.jit(fwd).lower(*fwd_args).compile()
        state, _ = step(state, batch, jax.random.PRNGKey(2))  # compiles
    return (fwd_c, fwd_args), (step, state, batch)


def time_arm(built, reps):
    import jax

    (fwd_c, fwd_args), (step, state, batch) = built
    jax.block_until_ready(fwd_c(*fwd_args))
    fwd_t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fwd_c(*fwd_args))
        fwd_t.append(time.perf_counter() - t0)
    step_t = []
    key = jax.random.PRNGKey(3)
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        state, m = step(state, batch, key)
        jax.block_until_ready((state, m))
        step_t.append(time.perf_counter() - t0)
    built[1] = (step, state, batch)
    return fwd_t, step_t[1:]


def layer_norm_kernels() -> list[str]:
    import jax
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.ops.layernorm import layer_norm

    x = jnp.ones((10, 999, 1024), jnp.bfloat16)
    s = jnp.ones((1024,), jnp.float32)
    f = jax.jit(layer_norm)
    jax.block_until_ready(f(x, s, s))
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            jax.block_until_ready(f(x, s, s))
        pb = sorted(Path(td).rglob("*.xplane.pb"))[-1]
        data = jax.profiler.ProfileData.from_file(str(pb))
        names = []
        for plane in data.planes:
            if "GPU" not in plane.name and "gpu" not in plane.name:
                continue
            for line in plane.lines:
                names += [f"{plane.name} | {line.name} | {e.name}"
                          for e in line.events]
        return names


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax

    from wav2vecsegmenter_tpu.core import platform

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; jax {jax.__version__}", flush=True)
    platform.require_gpu()
    platform.setup_compilation_cache()

    built = {}
    for name, fn in attention_arms().items():
        t0 = time.perf_counter()
        try:
            built[name] = list(build(fn))
        except Exception as e:  # an arm the GPU compiler refuses is a result
            print(f"{name}: FAILED to build: {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)
            continue
        print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s",
              flush=True)
    times = {n: ([], []) for n in built}
    for r in range(args.rounds):
        for name in built:
            f, s = time_arm(built[name], args.reps)
            times[name][0].extend(f)
            times[name][1].extend(s)
    print(f"# 24-layer forward [10, 20 s] and train step [4, 20 s], bf16, "
          f"{args.rounds} rounds x {args.reps} reps, on {card}")
    for name, (f, s) in times.items():
        print(f"{name:8s} forward median {np.median(f) * 1e3:8.2f} ms "
              f"best {min(f) * 1e3:8.2f} ms | train step median "
              f"{np.median(s) * 1e3:8.2f} ms best {min(s) * 1e3:8.2f} ms",
              flush=True)
    names = layer_norm_kernels()
    print(f"# LayerNorm [10, 999, 1024] bf16: {len(names)} device events")
    for n in names:
        print(f"  {n}")


if __name__ == "__main__":
    main()
