#!/usr/bin/env python
"""Prove that the segmenter runs on the GPU, through its normal entry points.

    python chip_smoke.py [--seed N]      # one card: phases 1-5
    python chip_smoke.py --four-cards    # four cards: the multi-card path only

One card, in order (any failure exits non-zero):

1. device   JAX must see GPU devices; there is no CPU fallback.
2. ops      At real widths, against float32 references under highest matmul
            precision, forward and gradient: attention at the encoder
            (B=10, H=16, T=999, D=64, ragged key lengths), SFC-head
            (H=8, D=128) and autoreg cross-attention (tq != tk) shapes;
            LayerNorm and bias+LN+GELU at [10, 999, 1024]; one
            512-channel conv layer with its epilogue.
3. train    The train CLI fine-tunes SHAS on the wav2vec2-xls-r-300m
            architecture (h=1024, 24/24 layers, LNA with all 24 layers
            trainable, batch 4, bf16) on a synthetic MuST-C-style corpus,
            once with K=8 and once with K=1 train steps per jit call:
            finite losses, s/step for each K, a checkpoint saved through
            the normal save path, and the training objective on a fixed
            batch well below its value at the initial parameters.
4. segment  The segment CLI on that checkpoint over a synthetic 600 s talk
            (pDAC, batch 10) writes several segments to
            custom_segments.yaml; bf16 against f32 probabilities and pDAC
            boundaries on the first 60 s, with pDAC's threshold at the
            median probability; xRT.
5. serve    The serving daemon on a unix socket, two client threads of 60 s
            each; every commit equals a single-stream OnlineSegmenter run.
            Then one batch through an int8 engine against bf16.

``--four-cards`` runs only the multi-card path and what it is compared with:
the train CLI with runtime.mesh.data=4 against the same global batch on one
card, sharded inference against one card, and one tensor-parallel (2x2)
and one FSDP train step against the data-parallel step.

Weights are random from --seed and the audio is synthetic from --seed.
Work files go to <repo>/.smoke_work, which is removed at exit.  The last
line of stdout is the JSON result; times are on the card named on the
first line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SR = 16000

# production geometry; cpu rehearsals shrink it (depth and audio only)
FULL = {
    "keep_layers": 24,
    "train_talks": 4,
    "train_talk_secs": 210.0,   # 4 x 210 s / 20 s windows / batch 4 ~ 10 steps
    "dev_talk_secs": 40.0,
    "segment_talk_secs": 600.0,
    "clip_secs": 60.0,
    "stream_secs": 60.0,
    "attn": [  # (name, b, tq, tk, heads, d)
        ("encoder", 10, 999, 999, 16, 64),
        ("sfc_head", 10, 999, 999, 8, 128),
        ("autoreg_cross", 4, 333, 999, 8, 128),
    ],
    "rows": (10, 999, 1024),
    "conv": (10, 63999, 512),   # layer-1 input of a 20 s window
    "step_batch": 8,            # --four-cards step comparisons, 20 s windows
}

# bf16 operands with float32 accumulation against a float32 reference
# (highest precision): bf16 keeps 8 mantissa bits, so one rounding is
# 2^-9 ~ 2e-3 relative; errors are judged relative to the reference's
# largest magnitude (PARITY.md, "GPU tolerances")
TOL_FWD = 2e-2
TOL_GRAD = 3e-2

# train phase: a random-weight 24-layer model at batch 4 with no warm-up
# (the reference recipe is 2.5e-4 at an effective batch of 280); the
# objective on a fixed batch must end at most LOSS_DROP of where it began
LR = 5e-5
FIXED_WINDOWS = 10
LOSS_DROP = 0.9

# segment phase: bf16 against f32 frame probabilities, and the share of
# pDAC boundaries that agree within one frame (PARITY.md)
TOL_DPROB = 2e-2
MIN_AGREE = 0.8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# synthetic audio
# ---------------------------------------------------------------------------

def speechlike_pcm(rng, secs: float, period: int = 56000,
                   on: int = 48000) -> np.ndarray:
    """int16 noise bursts: `on` samples of speech-like noise every
    `period` samples (3 s on, 0.5 s pause at the defaults)."""
    n = int(secs * SR)
    x = rng.randn(n).astype(np.float32) * 0.1 * ((np.arange(n) % period) < on)
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype("<i2")


def write_pcm_wav(path: Path, pcm: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())


def make_corpus(work: Path, rng, size: dict) -> dict:
    """MuST-C-style talks (wav + segment yaml) -> talks/segments TSVs
    through data.prep, for a train split and a dev split."""
    import yaml

    from wav2vecsegmenter_tpu.data.prep import (
        prepare_dataset_for_segmentation)

    wav_dir = work / "corpus" / "wav"
    wav_dir.mkdir(parents=True)
    out = {}
    for split, n, secs in (("train", size["train_talks"],
                            size["train_talk_secs"]),
                           ("dev", 1, size["dev_talk_secs"])):
        rows = []
        for i in range(n):
            name = f"{split}_talk{i}.wav"
            pcm = speechlike_pcm(rng, secs)
            write_pcm_wav(wav_dir / name, pcm)
            if split == "train" and i == 0:
                out["train_talk0"] = pcm
            t = 0.0
            while t + 3.0 <= secs:  # the speech bursts are the segments
                rows.append({"duration": 3.0, "offset": round(t, 3),
                             "speaker_id": "spk", "wav": name})
                t += 3.5
        ypath = work / "corpus" / f"{split}.yaml"
        ypath.write_text(yaml.safe_dump(rows))
        out[split] = prepare_dataset_for_segmentation(
            ypath, wav_dir, work / "corpus", split=split)
    return out


# ---------------------------------------------------------------------------
# phase 2: ops against float32 references
# ---------------------------------------------------------------------------

def compare(name: str, got, want, tol: float) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want))) or 1.0
    rel = err / scale
    ok = rel <= tol
    log(f"  {name}: max_abs_err={err:.4e} rel_err={rel:.4e} tol={tol:g} "
        f"(bf16 operands, f32 accumulation vs f32 highest) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: rel_err {rel:.4e} > {tol:g}")


def check_fwd_grad(name, fn, ref, args, seed) -> None:
    """fn on bf16 args vs ref on float32 args (highest precision): forward
    and the gradient of <out, cotangent> w.r.t. every arg, each side one
    jitted program."""
    import jax
    import jax.numpy as jnp

    lo = [a.astype(jnp.bfloat16) for a in args]
    out_shape = jax.eval_shape(fn, *lo).shape
    # the cotangent is an argument, not a closure constant: a captured
    # array would be baked into the executable
    cot = jax.random.normal(jax.random.PRNGKey(seed), out_shape, jnp.float32)

    @jax.jit
    def fwd_and_grads(cot, *xs):
        f = fn if xs[0].dtype == jnp.bfloat16 else ref
        out, vjp = jax.vjp(lambda *a: f(*a).astype(jnp.float32), *xs)
        return out, vjp(cot)

    out, grads = fwd_and_grads(cot, *lo)
    with jax.default_matmul_precision("highest"):
        want, want_g = fwd_and_grads(cot, *args)
    compare(f"{name} forward", out, want, TOL_FWD)
    for i, (g, w) in enumerate(zip(grads, want_g)):
        compare(f"{name} grad[arg{i}]", g, w, TOL_GRAD)


def phase_ops(size: dict, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.core import platform
    from wav2vecsegmenter_tpu.models.wav2vec2 import _strided_conv1d_as_matmul
    from wav2vecsegmenter_tpu.ops.attention import (
        attention, attention_reference)
    from wav2vecsegmenter_tpu.ops.layernorm import (
        bias_layer_norm_gelu, layer_norm)

    impl = platform.attention_impl(jnp.bfloat16)
    log(f"phase 2: ops at real widths (attention implementation: {impl})")
    key = jax.random.PRNGKey(seed)
    for i, (name, b, tq, tk, h, d) in enumerate(size["attn"]):
        ks = jax.random.split(jax.random.fold_in(key, i), 3)
        q = jax.random.normal(ks[0], (b, tq, h, d), jnp.float32)
        k = jax.random.normal(ks[1], (b, tk, h, d), jnp.float32)
        v = jax.random.normal(ks[2], (b, tk, h, d), jnp.float32)
        lens = jnp.asarray(np.linspace(tk, tk // 3, b).astype(np.int32))
        scale = d ** -0.5
        # padded query rows are garbage by contract: compare valid rows
        qmask = ((jnp.arange(tq)[None, :] < lens[:, None]) if tq == tk
                 else jnp.ones((b, tq), bool))[:, :, None, None]

        def fn(q, k, v, lens=lens, qmask=qmask, scale=scale):
            return jnp.where(qmask, attention(q, k, v, lens, scale), 0)

        def ref(q, k, v, lens=lens, qmask=qmask, scale=scale):
            return jnp.where(
                qmask, attention_reference(q, k, v, lens, scale), 0)

        check_fwd_grad(f"attention {name} B={b} tq={tq} tk={tk} H={h} "
                       f"D={d}", fn, ref, (q, k, v), seed + i)

    rows = size["rows"]
    ks = jax.random.split(jax.random.fold_in(key, 100), 5)
    x = jax.random.normal(ks[0], rows, jnp.float32) * 2 + 0.5
    hdim = rows[-1]
    sc = 1 + 0.1 * jax.random.normal(ks[1], (hdim,), jnp.float32)
    bi = 0.1 * jax.random.normal(ks[2], (hdim,), jnp.float32)
    cb = 0.1 * jax.random.normal(ks[3], (hdim,), jnp.float32)

    def ln_fn(x, sc, bi):
        return layer_norm(x, sc.astype(jnp.float32), bi.astype(jnp.float32))

    check_fwd_grad(f"layer_norm {list(rows)}", ln_fn, ln_fn, (x, sc, bi),
                   seed + 100)

    def bln_fn(x, cb, sc, bi):
        return bias_layer_norm_gelu(x, cb, sc.astype(jnp.float32),
                                    bi.astype(jnp.float32))

    check_fwd_grad(f"bias_layer_norm_gelu {list(rows)}", bln_fn, bln_fn,
                   (x, cb, sc, bi), seed + 101)

    b, t, c = size["conv"]
    ks = jax.random.split(jax.random.fold_in(key, 200), 5)
    xc = jax.random.normal(ks[0], (b, t, c), jnp.float32)
    w = jax.random.normal(ks[1], (3, c, c), jnp.float32) / np.sqrt(3 * c)
    cb = 0.1 * jax.random.normal(ks[2], (c,), jnp.float32)
    sc = 1 + 0.1 * jax.random.normal(ks[3], (c,), jnp.float32)
    bi = 0.1 * jax.random.normal(ks[4], (c,), jnp.float32)

    def conv_fn(x, w, cb, sc, bi):
        y = _strided_conv1d_as_matmul(x, w, 2, x.dtype)
        return bias_layer_norm_gelu(y, cb, sc.astype(jnp.float32),
                                    bi.astype(jnp.float32))

    def conv_ref(x, w, cb, sc, bi):
        y = jax.lax.conv_general_dilated(
            x, w, window_strides=(2,), padding="VALID",
            dimension_numbers=("NHC", "HIO", "NHC"))
        return bias_layer_norm_gelu(y, cb, sc, bi)

    check_fwd_grad(f"conv layer k=3 s=2 {c}->{c} + bias/LN/GELU, "
                   f"input [{b}, {t}, {c}]", conv_fn, conv_ref,
                   (xc, w, cb, sc, bi), seed + 200)


# ---------------------------------------------------------------------------
# phase 3: train CLI
# ---------------------------------------------------------------------------

class StepLog(logging.Handler):
    """Collects the train loop's per-step log lines."""

    STEP = re.compile(r"Step (\d+)/(\d+) loss=(\S+) .*\((\S+) steps/s\)")

    def __init__(self):
        super().__init__()
        self.epoch = -1
        self.steps: list[tuple[int, int, float, float]] = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Starting epoch"):
            self.epoch += 1
        m = self.STEP.search(msg)
        if m:
            self.steps.append((self.epoch, int(m.group(1)),
                               float(m.group(3)), float(m.group(4))))


def run_train(work: Path, corpus: dict, size: dict, seed: int, k: int,
              save: bool, extra: tuple = ()) -> tuple[StepLog, float]:
    from wav2vecsegmenter_tpu.cli.train import main as train_main

    (tr_talks, tr_segs), (dev_talks, dev_segs) = corpus["train"], corpus["dev"]
    layers = size["keep_layers"]
    overrides = [
        f"exp_name=smoke_k{k}", "batch_size=4", "segment_length=20",
        "max_epochs=2", "update_freq=1", "print_every_steps=1",
        "save_every_steps=999999", f"save_ckpts={str(save).lower()}",
        "keep_last_ckpts=1", "keep_best_ckpt=false", f"learning_rate={LR}",
        f"task.model.wav2vec_keep_layers={layers}",
        "task.model.finetune_wav2vec=true",
        f"task.model.wav2vec_ft_layers={layers}",
        f"data.train.talk_list={tr_talks}",
        f"data.train.segments_list={tr_segs}",
        f"data.eval.talk_list={dev_talks}",
        f"data.eval.segments_list={dev_segs}",
        f"+data.train.seed={seed}", f"runtime.seed={seed}",
        f"runtime.steps_per_call={k}", *extra,
    ]
    handler = StepLog()
    lg = logging.getLogger("wav2vecsegmenter_tpu")
    lg.addHandler(handler)
    cwd = os.getcwd()
    os.chdir(work)
    t0 = time.perf_counter()
    try:
        train_main(overrides)
    finally:
        os.chdir(cwd)
        lg.removeHandler(handler)
    return handler, time.perf_counter() - t0


def epoch_s_per_step(steps, epoch: int) -> tuple[float, int]:
    """s/step over a whole epoch from its last step line (the loop's
    steps/s counts from the epoch start: data, dispatch and compute)."""
    last = [s for s in steps if s[0] == epoch][-1]
    return 1.0 / last[3], last[1]


def envelope_batch(pcm: np.ndarray, n: int, period: int = 56000,
                   on: int = 48000):
    """n 20 s windows of a speechlike_pcm talk as one collated batch, with
    per-frame targets from its on/off envelope (frame j of a window covers
    samples j*320 .. j*320+400)."""
    from wav2vecsegmenter_tpu.data.collate import collate

    win, t_out = 20 * SR, 999
    audio = pcm.astype(np.float32) / 32768.0
    rows = [(audio[i * win:(i + 1) * win], None, 0, t_out) for i in range(n)]
    batch = collate(rows, batch_size=n, audio_len=win, out_len=t_out,
                    device_normalize=True)
    centre = np.arange(n)[:, None] * win + np.arange(t_out)[None, :] * 320 + 200
    return batch, ((centre % period) < on).astype(np.float64)


def bce_loss(logits, target) -> float:
    """The train step's BCE objective (train/step.compute_bce_loss): per
    frame BCE with logits, pos_weight = 1 - share of speech frames, summed
    over frames, averaged over windows."""
    x = np.asarray(logits, np.float64).reshape(target.shape)
    pw = 1.0 - target.mean()
    per = pw * target * np.logaddexp(0, -x) + (1 - target) * np.logaddexp(0, x)
    return float(per.sum(axis=1).mean())


def phase_train(work: Path, corpus: dict, size: dict, seed: int) -> dict:
    import jax

    from wav2vecsegmenter_tpu.cli.common import build_model, load_params
    from wav2vecsegmenter_tpu.config import load_config
    from wav2vecsegmenter_tpu.core import platform
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference

    log(f"phase 3: train CLI, SHAS xls-r-300m architecture, "
        f"{size['keep_layers']}/24 layers, LNA fine-tuning of all layers, "
        f"batch 4, lr {LR:g}, bf16")
    res = {}
    for k in (8, 1):
        steps, wall = run_train(work, corpus, size, seed, k, True)
        losses = [s[2] for s in steps.steps]
        if not losses or not np.isfinite(losses).all():
            raise RuntimeError(f"K={k}: non-finite or missing losses {losses}")
        s_step, n = epoch_s_per_step(steps.steps, 1)
        res[k] = {"s_per_step": s_step, "steps": n, "wall": wall}
        log(f"  K={k}: {n} steps/epoch, epoch-2 s/step={s_step:.4f} "
            f"(data+dispatch+compute), CLI wall {wall:.1f} s")
        log(f"  K={k}: set-up (compile, eval, checkpoint I/O) "
            f"~{wall - 2 * n * s_step:.1f} s")
        log(f"  K={k} losses per step: {[round(x, 4) for x in losses]}")
    log(f"  s/step on {jax.devices()[0].device_kind}: "
        f"K=1 {res[1]['s_per_step']:.4f}, K=8 {res[8]['s_per_step']:.4f}")

    # the training objective on one fixed batch, from the CLI's own initial
    # parameters (train/loop: model.init(PRNGKey(runtime.seed))) and from
    # each run's last checkpoint: only the optimizer's updates move it
    cfg = load_config(work / "smoke_k1" / ".hydra" / "config.yaml")
    model, _ = build_model(cfg)
    batch, target = envelope_batch(corpus["train_talk0"], FIXED_WINDOWS)
    engine = WindowInference(model, model.init(jax.random.PRNGKey(seed)),
                             compute_dtype=platform.compute_dtype())
    before = bce_loss(engine.run_batch(batch)[1], target)
    log(f"  fixed batch ({FIXED_WINDOWS} x 20 s of train talk 0): "
        f"loss {before:.4f} at the initial parameters")
    ckpts = {}
    for k in (8, 1):
        found = sorted((work / f"smoke_k{k}" / "ckpts").glob("epoch-*"))
        if not found:
            raise RuntimeError(f"K={k}: no checkpoint saved")
        ckpts[k] = found[-1]
        engine.params = load_params(cfg, model, found[-1])
        after = bce_loss(engine.run_batch(batch)[1], target)
        log(f"  K={k}: fixed-batch loss {after:.4f} after training "
            f"({found[-1].name}), {after / before:.3f} of the initial; "
            f"limit {LOSS_DROP:g}")
        if not np.isfinite(after) or after > LOSS_DROP * before:
            raise RuntimeError(f"K={k}: training did not lower the loss on "
                               f"the fixed batch")
    log(f"  checkpoint saved through the train loop: {ckpts[1]}")
    return {"ckpt": ckpts[1],
            "config": work / "smoke_k1" / ".hydra" / "config.yaml"}


# ---------------------------------------------------------------------------
# phase 4: segment CLI
# ---------------------------------------------------------------------------

def segment_overrides(ckpt, config, wav_dir, seg_yaml, out_dir):
    return [f"ckpt_path={ckpt}", f"config_path={config}",
            f"infer_data.wav_dir={wav_dir}",
            f"infer_data.orig_seg_yaml={seg_yaml}",
            f"output_dir={out_dir}", f"+results_path={out_dir}",
            "algorithm=dac", "batch_size=10"]


def composed(app: str, overrides: list[str]):
    """The app config as the CLI builds it: CLI config over the training
    run's saved config."""
    from wav2vecsegmenter_tpu.cli.common import compose_app
    from wav2vecsegmenter_tpu.config import load_config, merge

    cfg, _ = compose_app(app, overrides, False)
    return merge(load_config(cfg.config_path), cfg)


def talk_probs(engine, wav: Path) -> np.ndarray:
    from wav2vecsegmenter_tpu.data.datasets import (
        FixedSegmentationDatasetNoTarget)
    from wav2vecsegmenter_tpu.data.loader import BatchIterator
    from wav2vecsegmenter_tpu.infer.pipeline import infer_talk

    ds = FixedSegmentationDatasetNoTarget(wav, 20, 1)
    ds.fixed_length_segmentation(0)
    batches = BatchIterator(ds, 10, 20.0, shuffle=False,
                            device_normalize=True)
    probs, _, _ = infer_talk(engine, batches, ds.duration_outframes,
                             need_logits=False)
    return probs


def boundary_agreement(a, b, tol_frames: int = 1) -> float:
    """Share of segment boundaries (starts and ends, in frames) of either
    segmentation that the other has within tol_frames."""
    ba = sorted({s.start for s in a} | {s.end for s in a})
    bb = sorted({s.start for s in b} | {s.end for s in b})
    if not ba and not bb:
        return 1.0

    def hits(x, y):
        y = np.asarray(y)
        return sum(bool(len(y)) and np.min(np.abs(y - v)) <= tol_frames
                   for v in x)

    return (hits(ba, bb) + hits(bb, ba)) / (len(ba) + len(bb))


def phase_segment(work: Path, trained: dict, size: dict, rng) -> dict:
    import jax
    import yaml

    from wav2vecsegmenter_tpu.cli.common import (
        apply_runtime, build_model, load_params, run_algorithm, segment_wavs)
    from wav2vecsegmenter_tpu.cli.segment import main as segment_main
    from wav2vecsegmenter_tpu.config import to_plain
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference

    secs = size["segment_talk_secs"]
    log(f"phase 4: segment CLI, {secs:g} s talk, pDAC, batch 10")
    wav_dir = work / "segment" / "wav"
    wav_dir.mkdir(parents=True)
    pcm = speechlike_pcm(rng, secs)
    write_pcm_wav(wav_dir / "talk.wav", pcm)
    clip_dir = work / "segment" / "clip"
    clip_dir.mkdir()
    write_pcm_wav(clip_dir / "clip.wav", pcm[: int(size["clip_secs"] * SR)])
    seg_yaml = work / "segment" / "talks.yaml"
    seg_yaml.write_text(yaml.safe_dump(
        [{"wav": "talk.wav", "offset": 0.0, "duration": secs,
          "speaker_id": "spk"}]))
    out = work / "segment" / "out"
    ov = segment_overrides(trained["ckpt"], trained["config"], wav_dir,
                           seg_yaml, out)

    # the engine as the CLI builds it; bf16 against f32
    # (runtime.precision=f32 under highest precision) on the first clip_secs
    cfg = composed("segment", ov)
    dtype = apply_runtime(cfg)
    model, vocab = build_model(cfg)
    params = load_params(cfg, model, cfg.ckpt_path)
    engine = WindowInference(model, params, loss_tag=cfg.task.loss.tag,
                             compute_dtype=dtype, vocab=vocab)
    p16 = talk_probs(engine, clip_dir / "clip.wav")
    f32 = WindowInference(model, params, loss_tag=cfg.task.loss.tag,
                          compute_dtype=dtype, vocab=vocab, precision="f32")
    with jax.default_matmul_precision("highest"):
        p32 = talk_probs(f32, clip_dir / "clip.wav")
    if not (np.isfinite(p16).all() and np.isfinite(p32).all()):
        raise RuntimeError("non-finite frame probabilities")
    # a briefly trained random-weight model need not straddle pDAC's 0.5:
    # split and trim at the median probability, so that pDAC's search and
    # trimming run and the boundaries have something to agree on
    thr = round(float(np.median(p32)), 6)
    log(f"  frame probabilities, first {size['clip_secs']:g} s: p10="
        f"{np.percentile(p32, 10):.4f} p50={thr:.6f} "
        f"p90={np.percentile(p32, 90):.4f}; pDAC threshold set to the median")
    d = np.abs(p16 - p32)
    algo = to_plain(cfg.algorithm)
    tag = algo.pop("tag")
    algo["threshold"] = thr
    s16 = run_algorithm(tag, algo, p16, np.zeros_like(p16), vocab)
    s32 = run_algorithm(tag, algo, p32, np.zeros_like(p32), vocab)
    agree = boundary_agreement(s16, s32)
    log(f"  bf16 vs f32, first {size['clip_secs']:g} s ({len(d)} frames): "
        f"|dprob| mean={d.mean():.3e} p99={np.percentile(d, 99):.3e} "
        f"max={d.max():.3e} (limit {TOL_DPROB:g}); pDAC boundaries agreeing "
        f"within 1 frame: {agree:.3f} (limit {MIN_AGREE:g}; {len(s16)} vs "
        f"{len(s32)} segments)")
    if d.max() > TOL_DPROB:
        raise RuntimeError(f"bf16 probabilities differ from f32 by "
                           f"{d.max():.3e} > {TOL_DPROB:g}")
    if min(len(s16), len(s32)) < 2 or agree < MIN_AGREE:
        raise RuntimeError("bf16 and f32 pDAC segmentations disagree")

    ov.append(f"algorithm.threshold={thr}")
    t0 = time.perf_counter()
    rows = segment_main(ov)
    cli_wall = time.perf_counter() - t0
    written = yaml.safe_load((out / "custom_segments.yaml").read_text())
    if not written or len(written) != len(rows) or len(written) < 2:
        raise RuntimeError(f"custom_segments.yaml holds "
                           f"{len(written or [])} segments, expected several")
    if not all({"wav", "offset", "duration"} <= set(r) for r in written):
        raise RuntimeError("custom_segments.yaml rows lack wav/offset/"
                           "duration")
    log(f"  custom_segments.yaml: {len(written)} segments; CLI wall "
        f"{cli_wall:.1f} s (set-up: checkpoint load + compile)")

    # warm xRT through the same product loop
    cfg = composed("segment", ov)
    segment_wavs(cfg, model, params, vocab, [wav_dir / "talk.wav"], dtype,
                 engine=engine)
    t0 = time.perf_counter()
    segment_wavs(cfg, model, params, vocab, [wav_dir / "talk.wav"], dtype,
                 engine=engine)
    wall = time.perf_counter() - t0
    xrt = secs / wall
    log(f"  xRT (warm, {secs:g} s talk, batch 10, dac, bf16): {xrt:.1f} "
        f"({wall:.3f} s) on {jax.devices()[0].device_kind}")
    return {"engine": engine, "model": model, "params": params,
            "vocab": vocab, "dtype": dtype, "clip": clip_dir / "clip.wav"}


# ---------------------------------------------------------------------------
# phase 5: serving daemon
# ---------------------------------------------------------------------------

def phase_serve(work: Path, trained: dict, seg: dict, size: dict,
                rng) -> None:
    import jax

    from wav2vecsegmenter_tpu.cli.common import hop_conf
    from wav2vecsegmenter_tpu.cli.serve import build_server
    from wav2vecsegmenter_tpu.config import to_plain
    from wav2vecsegmenter_tpu.data.collate import collate
    from wav2vecsegmenter_tpu.infer.online import OnlineSegmenter
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu.infer.server import segment_stream_client

    sock = work / "serve.sock"
    log(f"phase 5: serving daemon on a unix socket, 2 streams x "
        f"{size['stream_secs']:g} s")
    cfg = composed("serve", [f"ckpt_path={trained['ckpt']}",
                             f"config_path={trained['config']}",
                             f"unix_path={sock}", "stats_every_s=0"])
    server = build_server(cfg)
    loop = threading.Thread(target=server.serve_forever,
                            kwargs={"poll_s": 0.01}, daemon=True)
    loop.start()
    try:
        streams = {f"s{i}": speechlike_pcm(rng, size["stream_secs"],
                                           period=48000 + 4000 * i,
                                           on=40000)
                   for i in range(2)}
        results: dict = {}
        errors: list = []

        def client(name):
            try:
                results[name] = segment_stream_client(
                    server.address, streams[name].tobytes(), name=name,
                    chunk_bytes=2 * SR, pace_s=0.01)
            except Exception as e:  # reported by the main thread below
                errors.append((name, e))

        threads = [threading.Thread(target=client, args=(n,))
                   for n in streams]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"serve clients failed: {errors}")
    finally:
        server.shutdown()
        loop.join(timeout=120)
    if loop.is_alive():
        raise RuntimeError("server loop did not stop")

    algo = to_plain(cfg.algorithm)
    tag = algo.pop("tag")
    kw = dict(segment_length=float(cfg.segment_length), algorithm=tag,
              **hop_conf(cfg), **algo)
    for name, pcm in streams.items():
        lines = results.get(name) or []
        if not lines or lines[-1].get("type") != "end":
            raise RuntimeError(f"{name}: no end line ({lines[-1:]})")
        segs = [(ln["offset"], ln["duration"]) for ln in lines[:-1]
                if ln["type"] == "segment"]
        if lines[-1]["n_segments"] != len(segs) or not segs:
            raise RuntimeError(f"{name}: {len(segs)} segment lines, end "
                               f"line says {lines[-1]['n_segments']}")
        single = OnlineSegmenter(server.mux.engine, **kw)
        single.feed(pcm.astype(np.float32) / 32768.0)
        single.finish()
        want = [(s.offset, s.duration) for s in single.segments]
        log(f"  {name}: {len(segs)} segments + end line; single-stream "
            f"OnlineSegmenter: {len(want)}; equal: {segs == want}")
        if segs != want:
            raise RuntimeError(f"{name}: served commits differ from the "
                               f"single-stream run")
    log(f"  served {2 * size['stream_secs']:g} s of audio in {wall:.1f} s "
        f"(client-paced)")

    # int8 engine against bf16 on one batch of windows, in the segment
    # engine's own batch shape (10 x 20 s, raw int16 upload)
    clip = streams["s0"].astype(np.float32) / 32768.0
    win = 20 * SR
    rows = [(clip[i * win // 2: i * win // 2 + win], None, 0, 999)
            for i in range(5)]
    batch = collate(rows, batch_size=10, audio_len=win, out_len=999,
                    device_normalize=True)
    q = WindowInference(seg["model"], seg["params"], loss_tag="bce",
                        compute_dtype=seg["dtype"], quantize="int8")
    pq, _ = q.run_batch(batch)
    pb, _ = seg["engine"].run_batch(batch)
    dq = np.abs(np.asarray(pq) - np.asarray(pb))[:len(rows)]
    if not np.isfinite(dq).all():
        raise RuntimeError("int8 engine produced non-finite probabilities")
    log(f"  int8 (w8a8) engine vs bf16, one batch of {len(rows)} x 20 s: "
        f"max |dprob|={dq.max():.4e} mean={dq.mean():.4e} on "
        f"{jax.devices()[0].device_kind}")


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def phase_four_cards(work: Path, corpus: dict, size: dict, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.core import platform
    from wav2vecsegmenter_tpu.data.collate import collate
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu.models.shas import SHAS
    from wav2vecsegmenter_tpu.parallel.mesh import (
        batch_sharding, make_mesh, state_shardings)
    from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss
    from wav2vecsegmenter_tpu.train.step import (
        init_train_state, make_optimizer, make_train_step)

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    layers = size["keep_layers"]

    # 1. train CLI: data parallel over 4 cards vs the same global batch on 1
    log("four cards 1: train CLI, runtime.mesh.data=4 (batch 4 per card) "
        "vs one card (batch 16), same seed and data")
    dp, _ = run_train(work, corpus, size, seed, 1, False, extra=(
        "runtime.mesh.data=4", "max_epochs=1", "exp_name=dp4"))
    one, _ = run_train(work, corpus, size, seed, 1, False, extra=(
        "runtime.mesh.data=1", "batch_size=16", "max_epochs=1",
        "exp_name=dp1"))
    l4 = [s[2] for s in dp.steps]
    l1 = [s[2] for s in one.steps]
    if len(l4) != len(l1) or not l4:
        raise RuntimeError(f"step counts differ: {len(l4)} vs {len(l1)}")
    rel = [abs(a - b) / max(abs(b), 1e-6) for a, b in zip(l4, l1)]
    tol = 2e-2
    log(f"  losses mesh.data=4: {[round(x, 5) for x in l4]}")
    log(f"  losses one card   : {[round(x, 5) for x in l1]}")
    log(f"  max relative loss difference {max(rel):.3e} (tol {tol:g}: bf16 "
        f"compute, all-reduce order)")
    if max(rel) > tol:
        raise RuntimeError("data-parallel losses differ from one card")

    # model + one global batch for the step-level comparisons
    model = SHAS(wav2vec_model_name="facebook/wav2vec2-xls-r-300m",
                 wav2vec_keep_layers=layers, finetune_wav2vec=True,
                 wav2vec_ft_layers=layers, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=8, init_dropout=0.1)
    dtype = platform.compute_dtype()
    params = model.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    L, t_out, b = 20 * SR, 999, size["step_batch"]
    pcm = speechlike_pcm(rng, b * 20.0)
    audio = pcm.astype(np.float32).reshape(b, L) / 32768.0
    audio = (audio - audio.mean(1, keepdims=True)) / audio.std(1, keepdims=True)
    host_batch = {
        "audio": audio.astype(np.float32),
        "in_lengths": np.full(b, L, np.int32),
        "target": (rng.rand(b, t_out) > 0.3).astype(np.float32),
        "out_mask": np.ones((b, t_out), bool),
    }

    # 2. sharded inference vs one card
    log("four cards 2: WindowInference over a 4-way data mesh vs one card")
    rows = [(audio[i], None, 0, t_out) for i in range(b)]
    ib = collate(rows, batch_size=b, audio_len=L, out_len=t_out)
    mesh4 = make_mesh(4, 1)
    p4, _ = WindowInference(model, params, compute_dtype=dtype,
                            mesh=mesh4).run_batch(ib)
    p1, _ = WindowInference(model, params, compute_dtype=dtype).run_batch(ib)
    shard_devs = {s.device for s in p4.addressable_shards}
    d = float(np.max(np.abs(np.asarray(p4) - np.asarray(p1))))
    log(f"  output shards on {len(shard_devs)} devices; max |dprob| vs one "
        f"card {d:.3e} (tol 2e-2)")
    if len(shard_devs) != 4 or d > 2e-2:
        raise RuntimeError("sharded inference differs from one card")

    # 3. TP (2x2) and FSDP steps vs the data-parallel step
    log("four cards 3: one train step data-parallel (4), tensor-parallel "
        "(2x2) and FSDP (4)")
    mask = model.trainable_mask(params)
    opt = make_optimizer(2.5e-4, 100, 1, mask)
    loss_fn = BCEWithLogitsLoss(None)

    def one_step(mesh, shard_fn):
        state = init_train_state(model, opt, jax.random.PRNGKey(1),
                                 jax.tree.map(jnp.copy, params))
        st_sh = None if shard_fn is None else shard_fn(mesh, state)
        if st_sh is not None:
            state = jax.device_put(state, st_sh)
        step = make_train_step(model, loss_fn, "bce", 0, opt,
                               compute_dtype=dtype, mesh=mesh,
                               state_shardings=st_sh)
        batch = jax.device_put(host_batch, batch_sharding(mesh))
        state, m = step(state, batch, jax.random.PRNGKey(2))
        loss = float(m["loss"])
        # train-state bytes held by each card, from the arrays' own shards
        held = {dv: 0 for dv in devs[:4]}
        for leaf in jax.tree.leaves(state):
            for sh in leaf.addressable_shards:
                held[sh.device] += sh.data.nbytes
        return loss, [held[dv] for dv in devs[:4]]

    dp_loss, used_dp = one_step(make_mesh(4, 1), None)
    log(f"  data-parallel loss {dp_loss:.5f}; train state per card "
        f"{[u >> 20 for u in used_dp]} MiB (replicated)")
    tp_loss, used_tp = one_step(make_mesh(2, 2), state_shardings)
    fs_loss, used_fs = one_step(
        make_mesh(4, 1), lambda m, s: state_shardings(m, s, fsdp=True))
    for name, loss, used in (("tensor-parallel 2x2", tp_loss, used_tp),
                             ("FSDP 4", fs_loss, used_fs)):
        rel = abs(loss - dp_loss) / max(abs(dp_loss), 1e-6)
        log(f"  {name} loss {loss:.5f} (rel diff {rel:.3e} vs data-parallel, "
            f"tol 2e-2); train state per card {[u >> 20 for u in used]} MiB")
        if not np.isfinite(loss) or rel > 2e-2:
            raise RuntimeError(f"{name} loss differs from data-parallel")
        if min(used) < 0.5 * max(used) or max(used) >= 0.9 * max(used_dp):
            raise RuntimeError(f"{name}: the train state is not spread "
                               f"over the cards")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from wav2vecsegmenter_tpu.core import platform

    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', '')!r}")
    devices = platform.require_gpu()
    platform.setup_compilation_cache()
    log(f"phase 1: {len(devices)} x {devices[0].device_kind} "
        f"({devices[0].platform})")

    work = REPO / ".smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    rng = np.random.RandomState(args.seed)
    t_all = time.perf_counter()
    try:
        if args.four_cards:
            corpus = make_corpus(work, rng, FULL)
            phase_four_cards(work, corpus, FULL, args.seed)
        else:
            t0 = time.perf_counter()
            phase_ops(FULL, args.seed)
            log(f"  phase 2 wall {time.perf_counter() - t0:.1f} s")
            corpus = make_corpus(work, rng, FULL)
            t0 = time.perf_counter()
            trained = phase_train(work, corpus, FULL, args.seed)
            log(f"  phase 3 wall {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            seg = phase_segment(work, trained, FULL, rng)
            log(f"  phase 4 wall {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_serve(work, trained, seg, FULL, rng)
            log(f"  phase 5 wall {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
