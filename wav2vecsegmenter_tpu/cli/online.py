"""Online (streaming) segmentation CLI — commit segments while audio arrives.

A serving surface beyond the reference (whose pSTRM only *simulates* a
stream over a precomputed talk, lib/segment.py:454-505): wavs are replayed
in ``chunk_secs`` chunks through :class:`~..infer.online.OnlineSegmenter`,
and every segment prints as a JSON line the moment it commits — the line's
``lag_s`` records how far the stream had advanced past the segment's end
when it finalized (the real serving latency of the bounded-lookahead
algorithms).  The full run also lands in ``custom_segments.yaml``, the same
output contract as the offline CLIs (algorithms/yaml_out.py), so downstream
ST evaluation works unchanged.

    python -m wav2vecsegmenter_tpu.cli.online ckpt_path=... config_path=... \
        output_dir=... algorithm=pthr [wav_path=/path/talk.wav] [chunk_secs=0.5]

Only the causal algorithms serve online: ``strm`` and ``pthr`` (+moving
average).  pDAC needs the whole talk and stays offline-only.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import yaml

from ..algorithms import update_yaml_content
from ..config import load_config, merge, to_plain
from ..constants import INPUT_SAMPLE_RATE
from ..data.audio import read_wav_window, wav_info
from ..infer.online import OnlineSegmenter
from ..infer.pipeline import WindowInference
from .common import (
    apply_runtime,
    build_model,
    compose_app,
    expand_sweeps,
    hop_conf,
    init_logging,
    load_params,
    logger,
    parse_cli,
    wavs_from_yaml,
)


def main(argv: list[str] | None = None):
    """Single run returns the yaml rows; ``-m`` multirun returns one list
    per sweep job (same hydra CLI surface as the offline entry points)."""
    multirun, overrides = parse_cli(argv)
    if not multirun:
        return _run_job(overrides, multirun=False)
    return [_run_job(job, multirun=True) for job in expand_sweeps(overrides)]


def _run_job(overrides: list[str], multirun: bool) -> list[dict]:
    config, run_dir = compose_app("online", overrides, multirun)

    if config.get("config_path"):
        prev = load_config(config.config_path)
        config = merge(prev, config)

    output_dir = Path(config.get("results_path") or run_dir
                      or config.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    init_logging(config, str(output_dir / "log"))
    logger.info("Output directory : [%s]", output_dir)

    compute_dtype = apply_runtime(config)
    model, vocab = build_model(config)
    params = load_params(config, model, config.ckpt_path)
    engine = WindowInference(
        model, params, loss_tag=config.task.loss.tag,
        compute_dtype=compute_dtype, vocab=vocab,
        quantize=(config.get("runtime") or {}).get("quantize"),
        precision=(config.get("runtime") or {}).get("precision"),
    )

    algo_conf = to_plain(config.algorithm)
    tag = algo_conf.pop("tag")
    if tag not in ("strm", "pthr"):
        raise NotImplementedError(
            f"online serving needs a causal algorithm (strm/pthr), got "
            f"'{tag}' — pDAC needs the whole talk; use the offline CLIs")

    emit_jsonl = bool(config.get("emit_jsonl", True))
    chunk_samples = max(1, int(float(config.chunk_secs) * INPUT_SAMPLE_RATE))

    if config.get("wav_path") == "-":
        # live source: raw s16le mono 16 kHz PCM on stdin, e.g.
        #   arecord -f S16_LE -r 16000 -c 1 | w2vseg-online wav_path=- ...
        name = str(config.get("stream_name", "stdin"))
        segments = _stream_stdin(engine, config, tag, algo_conf,
                                 chunk_samples, emit_jsonl, name)
        yaml_content = update_yaml_content([], segments, name)
        logger.info("Number of segments: %d", len(yaml_content))
        cust_seg_yaml = output_dir / config.cust_seg_yaml
        with open(cust_seg_yaml, "w") as f:
            yaml.dump(yaml_content, f, default_flow_style=True)
        logger.info("Saved to [%s].", cust_seg_yaml)
        return yaml_content

    if config.get("wav_path"):
        wav_paths = [Path(config.wav_path)]
    else:
        wav_paths = wavs_from_yaml(config)

    n_concurrent = int(config.get("concurrent_streams", 0) or 0)
    yaml_content = []
    if n_concurrent > 1 and len(wav_paths) > 1:
        by_wav = _stream_concurrent(
            engine, config, tag, algo_conf, wav_paths, chunk_samples,
            emit_jsonl, n_concurrent,
        )
        for wav_path in wav_paths:
            yaml_content = update_yaml_content(
                yaml_content, by_wav[Path(wav_path).name],
                Path(wav_path).name)
    else:
        for wav_path in wav_paths:
            segments = _stream_wav(
                engine, config, tag, algo_conf, wav_path, chunk_samples,
                emit_jsonl,
            )
            yaml_content = update_yaml_content(yaml_content, segments,
                                               Path(wav_path).name)

    logger.info("Number of segments: %d", len(yaml_content))
    cust_seg_yaml = output_dir / config.cust_seg_yaml
    with open(cust_seg_yaml, "w") as f:
        yaml.dump(yaml_content, f, default_flow_style=True)
    logger.info("Saved to [%s].", cust_seg_yaml)
    return yaml_content


def _emitter(name: str, emit_jsonl: bool):
    """JSON-line printer for committed segments of one stream."""
    def emit(segs, stream_samples):
        if not emit_jsonl:
            return
        pos_s = stream_samples / INPUT_SAMPLE_RATE
        for s in segs:
            print(json.dumps({
                "wav": name,
                "offset": s.offset,
                "duration": s.duration,
                "stream_pos_s": round(pos_s, 3),
                "lag_s": round(pos_s - (s.offset + s.duration), 3),
            }), flush=True)
    return emit


def _stream_stdin(engine, config, tag, algo_conf, chunk_samples: int,
                  emit_jsonl: bool, name: str):
    """Serve a LIVE source: raw s16le mono 16 kHz PCM read from stdin until
    EOF.  Same commit semantics as the wav replay paths; the stream clock is
    the byte count, so lag_s is the true serving latency behind the source."""
    import sys

    import numpy as np

    online = OnlineSegmenter(
        engine,
        segment_length=float(config.segment_length),
        algorithm=tag,
        **hop_conf(config),
        **algo_conf,
    )
    emit = _emitter(name, emit_jsonl)
    stdin = sys.stdin.buffer
    carry = b""
    pos = 0
    eof = False
    t0 = time.perf_counter()
    while not eof:
        buf = stdin.read(chunk_samples * 2)
        eof = not buf
        data = carry + buf
        n2 = len(data) // 2 * 2  # torn sample at a read boundary carries
        data, carry = data[:n2], data[n2:]
        if data:
            chunk = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            pos += len(chunk)
            emit(online.feed(chunk), pos)
    emit(online.finish(), pos)
    dt = time.perf_counter() - t0
    talk_secs = pos / INPUT_SAMPLE_RATE
    logger.info("%s: %.1fs live audio served in %.2fs (%.0fx RT), "
                "%d segments", name, talk_secs, dt,
                talk_secs / dt if dt > 0 else 0.0, len(online.segments))
    return online.segments


def _stream_wav(engine, config, tag, algo_conf, wav_path: Path,
                chunk_samples: int, emit_jsonl: bool):
    """Replay one wav through an OnlineSegmenter; returns its segments."""
    total, sr, _ = wav_info(wav_path)
    if sr != INPUT_SAMPLE_RATE:
        raise ValueError(
            f"{wav_path}: sample rate {sr} != {INPUT_SAMPLE_RATE} "
            "(resample offline; the reference pipeline is 16 kHz-only)")

    online = OnlineSegmenter(
        engine,
        segment_length=float(config.segment_length),
        algorithm=tag,
        **hop_conf(config),
        **algo_conf,
    )
    emit = _emitter(Path(wav_path).name, emit_jsonl)

    t0 = time.perf_counter()
    pos = 0
    while pos < total:
        chunk = read_wav_window(wav_path, pos, chunk_samples)
        if not len(chunk):
            break
        pos += len(chunk)
        emit(online.feed(chunk), pos)
    emit(online.finish(), pos)
    dt = time.perf_counter() - t0
    talk_secs = pos / INPUT_SAMPLE_RATE
    logger.info("%s: %.1fs audio streamed in %.2fs (%.0fx RT), %d segments",
                Path(wav_path).name, talk_secs, dt,
                talk_secs / dt if dt > 0 else 0.0, len(online.segments))
    return online.segments


def _stream_concurrent(engine, config, tag, algo_conf, wav_paths,
                       chunk_samples: int, emit_jsonl: bool,
                       n_concurrent: int) -> dict:
    """Serve wavs as concurrent streams through ONE batched encoder.

    Up to ``n_concurrent`` wavs replay simultaneously; each tick feeds one
    chunk per active stream and all filled windows across streams run in
    batched forwards (infer/online.MultiStreamSegmenter — the serving
    configuration: batch-1 forwards leave the device mostly idle).  When a
    stream's wav ends, the next wav is admitted in its place, so the pool
    stays full.  Commits are identical to the sequential path per stream
    (tested); returns {wav name: [Segment]}."""
    from ..infer.online import MultiStreamSegmenter

    mux = MultiStreamSegmenter(
        engine, max_batch=int(config.get("max_batch", 8)),
        segment_length=float(config.segment_length), algorithm=tag,
        **hop_conf(config), **algo_conf)

    queue = list(wav_paths)
    active: dict = {}  # sid -> [wav_path, pos, total]

    def admit():
        while len(active) < n_concurrent and queue:
            wav_path = queue.pop(0)
            total, sr, _ = wav_info(wav_path)
            if sr != INPUT_SAMPLE_RATE:
                raise ValueError(
                    f"{wav_path}: sample rate {sr} != {INPUT_SAMPLE_RATE} "
                    "(resample offline; the reference pipeline is "
                    "16 kHz-only)")
            sid = Path(wav_path).name
            mux.add_stream(sid)
            active[sid] = [wav_path, 0, total]

    def emit(sid, segs):
        if not emit_jsonl or not segs:
            return
        pos_s = active[sid][1] / INPUT_SAMPLE_RATE
        for s in segs:
            print(json.dumps({
                "wav": sid,
                "offset": s.offset,
                "duration": s.duration,
                "stream_pos_s": round(pos_s, 3),
                "lag_s": round(pos_s - (s.offset + s.duration), 3),
            }), flush=True)

    by_wav: dict = {}
    total_secs = 0.0
    t0 = time.perf_counter()
    admit()
    while active:
        chunks = {}
        for sid, st in active.items():
            chunk = read_wav_window(st[0], st[1], chunk_samples)
            if len(chunk):
                st[1] += len(chunk)
                chunks[sid] = chunk
        committed = mux.feed(chunks) if chunks else {}
        for sid, segs in committed.items():
            emit(sid, segs)
        done = [sid for sid, st in active.items()
                if st[1] >= st[2] or (sid not in chunks)]
        for sid in done:
            emit(sid, mux.finish(sid))
            by_wav[sid] = mux.segments(sid)
            total_secs += active[sid][1] / INPUT_SAMPLE_RATE
            del active[sid]
        admit()
    dt = time.perf_counter() - t0
    logger.info(
        "%d wavs served as %d-way concurrent streams: %.1fs audio in "
        "%.2fs (%.0fx RT aggregate)", len(wav_paths), n_concurrent,
        total_secs, dt, total_secs / dt if dt > 0 else 0.0)
    return by_wav


def console() -> None:
    """setuptools console entry point."""
    main()


if __name__ == "__main__":
    main()
