"""Worker process for tests/test_multihost.py.

Run as: python -m tests.multihost_worker <work_dir> <talks_tsv> <segments_tsv>
        <out_json> [overrides...]

The W2VSEG_COORDINATOR / W2VSEG_NUM_PROCESSES / W2VSEG_PROCESS_ID env vars
(read by core.runtime.maybe_init_distributed, called from train()) decide
whether this is one rank of a multi-process SPMD job or a plain single-host
run.  XLA_FLAGS picks the per-process virtual CPU device count.
"""

import json
import sys
from pathlib import Path

import jax

# pin CPU before ANY device query: the worker is a CPU test process
jax.config.update("jax_platforms", "cpu")

CONF = Path(__file__).resolve().parents[1] / "conf"


def build_tiny(**kwargs):
    from tests.helpers import tiny_shas

    return tiny_shas()


def main() -> None:
    work_dir, talks_tsv, segments_tsv, out_json = sys.argv[1:5]
    extra = sys.argv[5:]

    from wav2vecsegmenter_tpu.config import compose, registry

    registry.register("lib.models.SHAS", "tests.multihost_worker:build_tiny")
    cfg = compose(CONF, "train", overrides=[
        "exp_name=mh",
        "batch_size=8",
        "segment_length=4",
        "max_epochs=1",
        "update_freq=1",
        "print_every_steps=2",
        "save_every_steps=999999",
        "save_ckpts=false",
        "learning_rate=1e-4",
        f"data.train.talk_list={talks_tsv}",
        f"data.train.segments_list={segments_tsv}",
        f"data.eval.talk_list={talks_tsv}",
        f"data.eval.segments_list={segments_tsv}",
        "runtime.compute_dtype=float32",
        "runtime.mesh.data=8",
        *extra,
    ])
    from wav2vecsegmenter_tpu.train.loop import train

    results = train(cfg, work_dir=work_dir)
    payload = {k: float(v) for k, v in results.items()}
    payload["process_index"] = jax.process_index()
    payload["process_count"] = jax.process_count()
    payload["n_global_devices"] = len(jax.devices())
    Path(out_json).write_text(json.dumps(payload))


if __name__ == "__main__":
    main()
