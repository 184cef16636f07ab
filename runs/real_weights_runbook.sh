#!/usr/bin/env bash
# Real-weights parity runbook: download -> convert -> parity -> F1 -> segment.
#
# This environment blocks HF downloads, so trained-weights evidence (the
# BASELINE "frame-F1 within 0.1 pt of the reference checkpoints" claim,
# reference README.md:62-93) must be produced on a weights-capable host by
# running THIS script unmodified.  Every stage that does not need the real
# weights is dry-run in-repo (see `dryrun` below + tests/test_runbook.py),
# so only the downloads themselves are untested here.
#
# Usage:
#   bash runs/real_weights_runbook.sh weights            # stage 1: download
#   bash runs/real_weights_runbook.sh parity  CKPT.pt    # stage 2: tests
#   bash runs/real_weights_runbook.sh f1      CKPT.pt CONFIG.yaml DATA_DIR
#   bash runs/real_weights_runbook.sh segment CKPT.pt CONFIG.yaml WAV_DIR OUT
#   bash runs/real_weights_runbook.sh all     CKPT.pt CONFIG.yaml DATA_DIR WAV_DIR OUT
#   bash runs/real_weights_runbook.sh dryrun            # env-permitted subset
#
# CKPT.pt    = a published reference checkpoint (e.g. epoch-15_best_eval_f1.pt
#              from the reference README's model table; both layouts work —
#              full state_dict and seg_model-only).
# CONFIG.yaml= the training run's saved hydra config (reference
#              outputs/<run>/.hydra/config.yaml) or conf/train.yaml defaults.
# DATA_DIR   = SHAS-prepared split: dev_talks.tsv + dev_segments.tsv
#              (runs/prep_mustc.sh emits these from MuST-C).
set -euo pipefail
cd "$(dirname "$0")/.."

stage="${1:-all}"

weights() {
  # xls-r-300m backbone (the SFC checkpoints' backbone; ~1.3 GB)
  python -c "import huggingface_hub as h; h.snapshot_download('facebook/wav2vec2-xls-r-300m')"
}

parity() {  # $1 = reference .pt
  # backbone vs HF torch + full-pipeline frame probs vs the reference's own
  # PyTorch implementation (tests/test_real_weights.py; <=1e-3 prob delta
  # implies identical thresholded predictions, hence F1 inside the 0.1 pt
  # budget)
  W2VSEG_REFERENCE_CKPT="$1" \
    python -m pytest tests/test_real_weights.py -m requires_weights -v
}

f1() {  # $1 = ckpt, $2 = config, $3 = data dir with dev_{talks,segments}.tsv
  python scripts/eval_f1.py --ckpt "$1" --config "$2" \
    --talk-list "$3/dev_talks.tsv" --segments-list "$3/dev_segments.tsv"
}

segment() {  # $1 = ckpt, $2 = config, $3 = wav dir, $4 = out dir
  python segment.py "ckpt_path=$1" "config_path=$2" \
    "infer_data.wav_dir=$3" "output_dir=$4" "+results_path=$4"
}

dryrun() {
  # Everything this (download-blocked) env permits, at FULL geometry:
  # synthetic reference-layout .pt export -> both-layout ingest -> segment
  # CLI load -> a talk segmented end-to-end.
  python scripts/runbook_dryrun.py
}

case "$stage" in
  weights) weights ;;
  parity)  parity "$2" ;;
  f1)      f1 "$2" "$3" "$4" ;;
  segment) segment "$2" "$3" "$4" "$5" ;;
  dryrun)  dryrun ;;
  all)
    weights
    parity "$2"
    f1 "$2" "$3" "$4"
    segment "$2" "$3" "$5" "$6"
    ;;
  *) echo "unknown stage '$stage'" >&2; exit 2 ;;
esac
