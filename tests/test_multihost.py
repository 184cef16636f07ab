"""Multi-host SPMD training (SURVEY §2.3/§5.8 beyond single-host):
two processes x 4 virtual CPU devices form one global 8-device data mesh
via jax.distributed; the full train() loop runs on both ranks and agrees
with a single-process 8-device run of the same job.

This is the CPU stand-in for a multi-host cluster: same code path
(core.runtime.maybe_init_distributed -> global mesh -> GSPMD collectives,
here over gloo instead of ICI).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from wav2vecsegmenter_tpu.data.prep import prepare_dataset_for_segmentation

from .helpers import make_speechlike_wav

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ws = tmp_path_factory.mktemp("mhcorpus")
    wav_dir = ws / "wav"
    wav_dir.mkdir()
    make_speechlike_wav(wav_dir / "talkA.wav", duration_secs=30, seed=0)
    make_speechlike_wav(wav_dir / "talkB.wav", duration_secs=25, seed=1)
    rows = []
    for wav, dur in (("talkA.wav", 30), ("talkB.wav", 25)):
        t = 0.2
        while t + 3.0 < dur:
            rows.append({"duration": 2.8, "offset": round(t, 2),
                         "speaker_id": "NA", "wav": wav})
            t += 3.5
    with open(ws / "train.yaml", "w") as f:
        yaml.dump(rows, f)
    return prepare_dataset_for_segmentation(
        ws / "train.yaml", wav_dir, ws, split="train")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_cmd(work, corpus, out_json):
    talks_tsv, segments_tsv = corpus
    return [sys.executable, "-m", "tests.multihost_worker",
            str(work), str(talks_tsv), str(segments_tsv), str(out_json),
            # same random resegmentation everywhere: multi-host injects
            # runtime.seed when unset, the single-host reference must be
            # pinned explicitly to the same stream
            "+task.train_generator.seed=0"]


def _env(n_local_devices, coord=None, num=None, pid=None):
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_local_devices}")
    env["PYTHONPATH"] = str(REPO)
    env.pop("W2VSEG_COORDINATOR", None)
    env.pop("W2VSEG_DISTRIBUTED", None)
    if coord:
        env["W2VSEG_COORDINATOR"] = coord
        env["W2VSEG_NUM_PROCESSES"] = str(num)
        env["W2VSEG_PROCESS_ID"] = str(pid)
    return env


def _run_two_ranks(work_of, out_of, corpus, extra=()):
    """Two ranks x 4 local devices -> one 8-device global data mesh."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            _worker_cmd(work_of(pid), corpus, out_of(pid)) + list(extra),
            env=_env(4, coord, 2, pid), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(e[-3000:] for e in errs)
    return [json.loads(Path(out_of(pid)).read_text()) for pid in range(2)]


def test_two_process_train_matches_single_host(corpus, tmp_path):
    # single-host reference: one process, 8 local devices, same global mesh
    ref_json = tmp_path / "ref.json"
    ref = subprocess.run(
        _worker_cmd(tmp_path / "ref", corpus, ref_json),
        env=_env(8), cwd=REPO, capture_output=True, text=True, timeout=540)
    assert ref.returncode == 0, ref.stderr[-3000:]

    r0, r1 = _run_two_ranks(lambda pid: tmp_path / f"rank{pid}",
                            lambda pid: tmp_path / f"rank{pid}.json", corpus)
    ref_res = json.loads(ref_json.read_text())

    assert ref_res["process_count"] == 1
    assert ref_res["n_global_devices"] == 8
    for r in (r0, r1):
        assert r["process_count"] == 2
        assert r["n_global_devices"] == 8

    # both ranks ran the same SPMD program: identical results
    for k in ("eval_loss", "eval_f1", "eval_precision", "eval_recall"):
        assert r0[k] == pytest.approx(r1[k], rel=1e-6), k

    # and the 2-process run reproduces the single-process 8-device run
    # (same global batches, same mesh; collectives ride gloo instead of
    # intra-process transfers — tiny numerical slack)
    assert r0["eval_f1"] == pytest.approx(ref_res["eval_f1"], abs=1e-3)
    assert r0["eval_loss"] == pytest.approx(ref_res["eval_loss"], rel=1e-3)


def test_two_process_checkpoints_save_and_resume(corpus, tmp_path):
    """Both ranks share one work dir, as on shared storage, with
    checkpoints on: process 0 writes each checkpoint and the resume state
    with its bookkeeping, and no rank returns from a save before it is in
    place; a second run resumes from it on both ranks."""
    shared = tmp_path / "shared"
    run = shared / "mh"

    def ranks(tag, extra):
        return _run_two_ranks(lambda pid: shared,
                              lambda pid: tmp_path / f"{tag}{pid}.json",
                              corpus, extra=extra)

    r0, r1 = ranks("first", ["save_ckpts=true"])
    meta = yaml.safe_load((run / "last_state" / "meta.yaml").read_text())
    assert meta["epoch"] == 1 and meta["ckpt_list"] == ["epoch-0"]
    assert (run / "last_state" / "manifest.json").exists()
    assert (run / "ckpts" / "epoch-0" / "manifest.json").exists()
    # no half-built or swapped-out directory is left behind
    assert not [p for p in run.rglob(".*") if p.name.endswith((".tmp", ".old"))]

    r0, r1 = ranks("resumed", ["save_ckpts=true", "+resume=true",
                               "max_epochs=2"])
    meta = yaml.safe_load((run / "last_state" / "meta.yaml").read_text())
    assert meta["epoch"] == 2
    assert meta["ckpt_list"] == ["epoch-0", "epoch-1"]
    for k in ("eval_loss", "eval_f1"):
        assert r0[k] == pytest.approx(r1[k], rel=1e-6), k
