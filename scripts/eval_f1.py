#!/usr/bin/env python
"""Standalone frame-F1 evaluation of a checkpoint against segmentation TSVs.

The reference computes dev frame-F1 only inside its training loop
(lib/evaluate.py:130-214 via train.py:543-662); this script exposes the same
metric as a one-command runbook stage so trained-weights parity (frame-F1
against the reference checkpoints) can be checked on any host with the
checkpoints and a prepared MuST-C dev split:

    python scripts/eval_f1.py \
        --ckpt /path/epoch-15_best_eval_f1.pt \
        --config /path/training_run/.hydra/config.yaml \
        --talk-list $DATA/dev_talks.tsv --segments-list $DATA/dev_segments.tsv

Prints one JSON line: {"eval_f1", "eval_accuracy", "eval_precision",
"eval_recall" [, "eval_loss"]}.  Metric semantics identical to the in-train
eval (eval/metrics.py): probs averaged over --inference-times shifted window
grids, thresholded at 0.5.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--config", required=True,
                    help="training config.yaml (the run's saved hydra "
                         "config; task.model drives architecture)")
    ap.add_argument("--talk-list", required=True)
    ap.add_argument("--segments-list", required=True)
    ap.add_argument("--segment-length", type=float, default=20.0)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--inference-times", type=int, default=1)
    ap.add_argument("--allow-random-wav2vec", action="store_true",
                    help="head-only ckpt without a local HF snapshot "
                         "(random backbone — smoke/dry runs only)")
    return ap.parse_args(argv)


def evaluate_checkpoint(args) -> dict:
    """The metrics dict for parsed ``args``; runs in the calling process
    (one JAX process per card)."""
    from wav2vecsegmenter_tpu.core import platform

    platform.setup_compilation_cache()
    from wav2vecsegmenter_tpu.checkpoints.io import load_model_checkpoint
    from wav2vecsegmenter_tpu.cli.common import build_model
    from wav2vecsegmenter_tpu.config import load_config
    from wav2vecsegmenter_tpu.data.loader import FixedDataloaderGenerator
    from wav2vecsegmenter_tpu.eval.metrics import evaluate
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu.train.loss import build_loss

    config = load_config(args.config)
    model, vocab = build_model(config)
    params = load_model_checkpoint(
        model, args.ckpt, allow_random_wav2vec=args.allow_random_wav2vec)

    loss_tag = config.task.loss.tag
    loss_fn = (build_loss(dict(config.task.loss))[0]
               if loss_tag == "bce" else None)
    engine = WindowInference(
        model, params, loss_tag=loss_tag,
        compute_dtype=platform.compute_dtype(),
        vocab=vocab, loss_fn=loss_fn)
    gen = FixedDataloaderGenerator(
        talk_list=args.talk_list, segments_list=args.segments_list,
        segment_length=args.segment_length, batch_size=args.batch_size,
        inference_times=args.inference_times, vocab=vocab,
        device_normalize=True, remainder_ladder=True)
    return evaluate(gen, engine, loss_tag=loss_tag, vocab=vocab)


def main(argv=None):
    print(json.dumps(evaluate_checkpoint(parse_args(argv))))


if __name__ == "__main__":
    main()
