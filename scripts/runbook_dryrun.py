#!/usr/bin/env python
"""Real-weights runbook dry run (runs/real_weights_runbook.sh dryrun).

Exercises, at FULL production geometry, every runbook stage this
download-blocked environment permits — so a weights-capable host can run
the remaining stages unmodified:

  1. synthesize a reference-layout FULL .pt (324M params; the layout of a
     finetune_wav2vec=True reference checkpoint, train.py:596-613) from
     random init and load it back through the CLI ingest;
  2. synthesize a HEAD-ONLY .pt (seg_model.* keys — the frozen-backbone
     layout) and load it with allow_random_wav2vec=true (the flag a host
     without an HF snapshot needs);
  3. run the segment CLI end-to-end on a synthetic talk with the full .pt
     (config_path merge + ckpt load + windows + pDAC + yaml out);
  4. run scripts/eval_f1.py's evaluation, in this process, against the
     head-only ckpt on a tiny synthetic dev split (the F1 stage's plumbing;
     the NUMBER is meaningless with random weights — only trained weights
     make it the parity metric).

Run: timeout 1800 python scripts/runbook_dryrun.py  (GPU or CPU; CPU uses
a reduced talk but the same full-geometry model).  Stages 1-2 need torch
for the .pt files.
"""

from __future__ import annotations

import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[dryrun] {msg}", flush=True)


def main():
    from wav2vecsegmenter_tpu.core import platform

    platform.setup_compilation_cache()
    import jax

    from wav2vecsegmenter_tpu.checkpoints.io import load_model_checkpoint
    from wav2vecsegmenter_tpu.checkpoints.torch_export import (
        export_torch_checkpoint)
    from wav2vecsegmenter_tpu.data.audio import write_wav
    from wav2vecsegmenter_tpu.models.shas import SHAS

    model = SHAS(wav2vec_model_name="facebook/wav2vec2-xls-r-300m",
                 wav2vec_keep_layers=24, n_transformer_enc_layers=1,
                 n_transformer_enc_heads=8, init_dropout=0.1)
    with jax.default_device(jax.devices("cpu")[0]):
        params = model.init(jax.random.PRNGKey(0))

    td = Path(tempfile.mkdtemp(prefix="w2vseg_runbook_"))
    log(f"workdir {td}")

    # stage 1: full reference layout round trip
    full_pt = td / "full.pt"
    saved = model.finetune_wav2vec
    model.finetune_wav2vec = True
    try:
        export_torch_checkpoint(params, model, str(full_pt))
    finally:
        model.finetune_wav2vec = saved
    log(f"exported full layout: {full_pt.stat().st_size / 1e6:.0f} MB")
    p2 = load_model_checkpoint(model, str(full_pt))
    ref = np.asarray(params["seg"]["out"]["w"])
    np.testing.assert_allclose(np.asarray(p2["seg"]["out"]["w"]), ref,
                               atol=1e-6)
    log("full layout ingest OK")

    # stage 2: head-only layout (frozen backbone) + allow_random_wav2vec
    head_pt = td / "head.pt"
    export_torch_checkpoint(params, model, str(head_pt))  # finetune=False
    log(f"exported head-only layout: {head_pt.stat().st_size / 1e6:.0f} MB")
    p3 = load_model_checkpoint(model, str(head_pt),
                               allow_random_wav2vec=True)
    np.testing.assert_allclose(np.asarray(p3["seg"]["out"]["w"]), ref,
                               atol=1e-6)
    log("head-only ingest (allow_random_wav2vec) OK")
    del p2, p3

    # stage 3: segment CLI end-to-end with the full .pt
    from wav2vecsegmenter_tpu.config import compose, save_config

    wav_dir = td / "wav"
    wav_dir.mkdir()
    secs = 120.0 if platform.on_gpu() else 30.0
    rng = np.random.RandomState(0)
    n = int(secs * 16000)
    write_wav(wav_dir / "talk.wav",
              (rng.randn(n).astype(np.float32) * 0.1
               * ((np.arange(n) % 56000) < 48000)))
    cfg = compose(REPO / "conf", "train")
    save_config(cfg, td / "config.yaml")
    out_dir = td / "segout"
    from wav2vecsegmenter_tpu.cli.segment import main as segment_main

    overrides = [
        f"ckpt_path={full_pt}", f"config_path={td / 'config.yaml'}",
        f"infer_data.wav_dir={wav_dir}", f"output_dir={out_dir}",
        "task.model.wav2vec_keep_layers=24", "batch_size=10",
        f"+results_path={out_dir}",
    ]
    rows = segment_main(overrides)
    assert rows and (out_dir / "custom_segments.yaml").exists()
    log(f"segment CLI OK: {len(rows)} segments from {secs:.0f}s talk")

    # stage 4: eval_f1 plumbing with the head-only ckpt on a synthetic split
    import yaml as _yaml

    from wav2vecsegmenter_tpu.data.prep import (
        prepare_dataset_for_segmentation)

    seg_rows, t = [], 0.2
    while t + 3.0 < secs:
        seg_rows.append({"duration": 2.8, "offset": round(t, 2),
                         "speaker_id": "NA", "wav": "talk.wav"})
        t += 6.5
    with open(td / "dev.yaml", "w") as f:
        _yaml.dump(seg_rows, f)
    talks_tsv, segs_tsv = prepare_dataset_for_segmentation(
        td / "dev.yaml", wav_dir, td, split="dev")
    # in this process: a child JAX process would open the card a second time
    spec = importlib.util.spec_from_file_location(
        "eval_f1", REPO / "scripts" / "eval_f1.py")
    eval_f1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_f1)
    metrics = eval_f1.evaluate_checkpoint(eval_f1.parse_args([
        "--ckpt", str(head_pt), "--config", str(td / "config.yaml"),
        "--talk-list", str(talks_tsv), "--segments-list", str(segs_tsv),
        "--allow-random-wav2vec"]))
    log(f"eval_f1 stage OK (random-weights metrics, plumbing only): "
        f"{metrics}")
    print("RUNBOOK_DRYRUN_OK", flush=True)


if __name__ == "__main__":
    main()
