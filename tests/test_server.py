"""Live segmentation server: concurrent PCM connections -> JSON commits.

Wire protocol + batching semantics in infer/server.py.  The serving
correctness claim is the same as MultiStreamSegmenter's (per-connection
commits == a single OnlineSegmenter over the same audio), checked here
through real sockets and the daemon event loop.
"""

import json
import socket
import threading

import numpy as np
import pytest

import jax

from .helpers import tiny_shas


def _pcm(wav: np.ndarray) -> bytes:
    return (np.clip(np.rint(wav * 32768.0), -32768, 32767)
            .astype("<i2").tobytes())


def _wav(seed: int, secs: float) -> np.ndarray:
    rng = np.random.RandomState(seed)
    n = int(secs * 16000)
    raw = (rng.randn(n).astype(np.float32) * 0.1
           * ((np.arange(n) % 20000) < 15000))
    # round-trip through int16 so the ground-truth path sees the exact
    # floats the server decodes from the wire
    return np.frombuffer(_pcm(raw), "<i2").astype(np.float32) / 32768.0


@pytest.fixture(scope="module")
def engine():
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference

    model = tiny_shas()
    return WindowInference(model, model.init(jax.random.PRNGKey(0)))


ALGO = dict(segment_length=4.0, algorithm="strm", max_segment_length=3,
            min_segment_length=0.2, min_pause_length=0.2, threshold=0.5)


def _ground_truth(engine, wav):
    from wav2vecsegmenter_tpu.infer.online import OnlineSegmenter

    o = OnlineSegmenter(engine, **ALGO)
    o.feed(wav)
    o.finish()
    return [(s.offset, s.duration) for s in o.segments]


@pytest.fixture()
def server(engine):
    from wav2vecsegmenter_tpu.infer.server import SegmentationServer

    srv = SegmentationServer(engine, port=0, max_batch=4, **ALGO)
    t = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.01},
                         daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    t.join(timeout=10)


def test_server_concurrent_connections_match_single_stream(engine, server):
    from wav2vecsegmenter_tpu.infer.server import segment_stream_client

    wavs = {"a": _wav(41, 17.3), "b": _wav(42, 11.1)}
    want = {k: _ground_truth(engine, w) for k, w in wavs.items()}

    results: dict = {}

    def client(name):
        results[name] = segment_stream_client(
            server.address, _pcm(wavs[name]), name=name,
            chunk_bytes=2 * 16000, pace_s=0.01)

    threads = [threading.Thread(target=client, args=(k,)) for k in wavs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)

    for name, w in wavs.items():
        lines = results[name]
        assert lines, f"{name}: no lines received"
        end = lines[-1]
        assert end["type"] == "end" and end["name"] == name
        assert end["audio_secs"] == pytest.approx(len(w) / 16000, abs=1e-3)
        segs = [ln for ln in lines[:-1] if ln["type"] == "segment"]
        assert end["n_segments"] == len(segs)
        got = [(ln["offset"], ln["duration"]) for ln in segs]
        assert got == want[name], f"{name} diverged from single-stream"
        assert len(got) > 0
        for ln in segs:
            assert ln["name"] == name
            # commit lag bounded by window buffering + algorithm lookahead
            assert -0.1 <= ln["lag_s"] <= 4.0 + 3.0 + 1.0
        # segments committed DURING the stream, not all at EOF
        assert segs[0]["stream_pos_s"] < len(w) / 16000


def test_server_bad_header_gets_error_line(server):
    sock = socket.create_connection(tuple(server.address))
    sock.sendall(b"this is not json\n")
    sock.shutdown(socket.SHUT_WR)
    buf = b""
    while True:
        data = sock.recv(65536)
        if not data:
            break
        buf += data
    sock.close()
    lines = [json.loads(ln) for ln in buf.splitlines() if ln.strip()]
    assert lines and lines[0]["type"] == "error"


def test_server_unix_socket(engine, tmp_path):
    from wav2vecsegmenter_tpu.infer.server import (
        SegmentationServer,
        segment_stream_client,
    )

    path = str(tmp_path / "seg.sock")
    srv = SegmentationServer(engine, unix_path=path, max_batch=4, **ALGO)
    t = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.01},
                         daemon=True)
    t.start()
    try:
        wav = _wav(47, 9.2)
        lines = segment_stream_client(path, _pcm(wav), name="u")
        assert lines[-1]["type"] == "end"
        got = [(ln["offset"], ln["duration"]) for ln in lines
               if ln["type"] == "segment"]
        assert got == _ground_truth(engine, wav) and len(got) > 0
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_server_max_conns_cap(engine):
    """Above max_conns new clients get an error line + close; existing
    connections keep serving."""
    import time

    from wav2vecsegmenter_tpu.infer.server import (
        SegmentationServer,
        segment_stream_client,
    )

    srv = SegmentationServer(engine, port=0, max_batch=4, max_conns=1,
                             **ALGO)
    t = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.01},
                         daemon=True)
    t.start()
    try:
        first = socket.create_connection(tuple(srv.address))
        first.sendall(b"\n")  # empty header: occupies the one slot
        time.sleep(0.3)

        second = socket.create_connection(tuple(srv.address))
        buf = b""
        while b"\n" not in buf:
            data = second.recv(65536)
            if not data:
                break
            buf += data
        second.close()
        msg = json.loads(buf.splitlines()[0])
        assert msg["type"] == "error" and "capacity" in msg["error"]

        # the occupant still serves end to end
        wav = _wav(50, 8.1)
        first.sendall(_pcm(wav))
        first.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            data = first.recv(65536)
            if not data:
                break
            buf += data
        first.close()
        lines = [json.loads(ln) for ln in buf.splitlines() if ln.strip()]
        assert lines[-1]["type"] == "end"
        assert lines[-1]["audio_secs"] == pytest.approx(len(wav) / 16000,
                                                        abs=1e-3)
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_server_stats_line(engine, caplog):
    """stats_every_s emits the periodic ops line with totals."""
    import logging

    from wav2vecsegmenter_tpu.infer.server import (
        SegmentationServer,
        segment_stream_client,
    )

    srv = SegmentationServer(engine, port=0, max_batch=4,
                             stats_every_s=0.05, **ALGO)
    t = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.01},
                         daemon=True)
    t.start()
    try:
        with caplog.at_level(logging.INFO, logger="wav2vecsegmenter_tpu"):
            wav = _wav(49, 8.3)
            lines = segment_stream_client(srv.address, _pcm(wav), name="s")
            assert lines[-1]["type"] == "end"
            stats = [r for r in caplog.records
                     if "serve stats" in r.getMessage()]
            assert stats, "no stats line emitted"
        assert srv.total_conns >= 1
        assert srv.total_samples >= len(wav)
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_server_shutdown_drains_active_streams(engine):
    """A shutting-down server flushes each open connection's tail window
    and sends its end line instead of dropping the socket mid-stream."""
    import time

    from wav2vecsegmenter_tpu.infer.online import OnlineSegmenter
    from wav2vecsegmenter_tpu.infer.server import SegmentationServer

    srv = SegmentationServer(engine, port=0, max_batch=4, **ALGO)
    t = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.01},
                         daemon=True)
    t.start()

    wav = _wav(48, 9.7)  # no FIN: the stream is live when shutdown arrives
    want_open = OnlineSegmenter(engine, **ALGO)
    want_open.feed(wav)
    want_open.finish()
    want = [(s.offset, s.duration) for s in want_open.segments]

    sock = socket.create_connection(tuple(srv.address))
    sock.sendall(b'{"name": "live"}\n' + _pcm(wav))
    time.sleep(1.0)  # let the event loop ingest + run the filled windows

    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()

    buf = b""
    while True:
        data = sock.recv(65536)
        if not data:
            break
        buf += data
    sock.close()
    lines = [json.loads(ln) for ln in buf.splitlines() if ln.strip()]
    assert lines and lines[-1]["type"] == "end"
    assert lines[-1]["audio_secs"] == pytest.approx(len(wav) / 16000,
                                                    abs=1e-3)
    got = [(ln["offset"], ln["duration"]) for ln in lines
           if ln["type"] == "segment"]
    assert got == want and len(got) > 0


def test_server_unix_socket_stale_and_in_use(engine, tmp_path):
    """A dead server's socket file is replaced; a live one is refused; the
    file is unlinked on close."""
    import os

    from wav2vecsegmenter_tpu.infer.server import SegmentationServer

    path = str(tmp_path / "seg.sock")
    # stale file: bind, close WITHOUT the unlink (simulate a crash)
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(path)
    stale.close()
    assert os.path.exists(path)

    srv = SegmentationServer(engine, unix_path=path, max_batch=4, **ALGO)
    try:
        with pytest.raises(OSError, match="listening"):
            SegmentationServer(engine, unix_path=path, max_batch=4, **ALGO)
    finally:
        srv.close()
    assert not os.path.exists(path)


def test_serve_cli_build_server(tmp_path):
    """build_server composes the daemon from the hydra surface (tiny model
    via the registry patch used by the other CLI tests)."""
    from wav2vecsegmenter_tpu.checkpoints.io import save_orbax
    from wav2vecsegmenter_tpu.config import compose, registry, save_config

    import tests.helpers as helpers
    from pathlib import Path

    orig = registry._ALIASES["lib.models.SHAS"]
    helpers._tiny_serve_builder = lambda **kw: tiny_shas()
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_serve_builder")
    try:
        model = tiny_shas()
        save_orbax(tmp_path / "ckpt", model.init(jax.random.PRNGKey(0)))
        save_config(compose(Path(__file__).parents[1] / "conf", "train"),
                    tmp_path / "train_config.yaml")

        from wav2vecsegmenter_tpu.cli.common import compose_app
        from wav2vecsegmenter_tpu.cli.serve import build_server
        from wav2vecsegmenter_tpu.config import load_config, merge

        config, _ = compose_app("serve", [
            f"ckpt_path={tmp_path}/ckpt",
            "segment_length=4",
            "algorithm=strm", "algorithm.max_segment_length=3",
            "runtime.compute_dtype=float32",
        ])
        config = merge(load_config(tmp_path / "train_config.yaml"), config)
        srv = build_server(config)
        try:
            assert srv.address[1] > 0  # ephemeral port bound
            from wav2vecsegmenter_tpu.infer.server import (
                segment_stream_client,
            )

            t = threading.Thread(target=srv.serve_forever,
                                 kwargs={"poll_s": 0.01}, daemon=True)
            t.start()
            wav = _wav(53, 8.6)
            lines = segment_stream_client(srv.address, _pcm(wav))
            assert lines[-1]["type"] == "end"
            assert lines[-1]["n_segments"] > 0
            srv.shutdown()
            t.join(timeout=10)
        finally:
            srv.close()
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig


def test_server_per_connection_algorithm_override(engine, server):
    """A connection's header can pick its own algorithm/thresholds; the
    encoder batches mixed-algorithm connections together and each matches
    its own single-stream ground truth."""
    from wav2vecsegmenter_tpu.infer.online import OnlineSegmenter
    from wav2vecsegmenter_tpu.infer.server import segment_stream_client

    wav = _wav(41, 17.3)
    pthr_over = dict(algorithm="pthr", max_segment_length=2.5,
                     threshold=0.5, moving_average_window=0.1)

    truth = OnlineSegmenter(engine, segment_length=4.0, min_segment_length=0.2,
                            min_pause_length=0.2, **pthr_over)
    truth.feed(wav)
    truth.finish()
    want_pthr = [(s.offset, s.duration) for s in truth.segments]
    want_strm = _ground_truth(engine, wav)
    assert want_pthr != want_strm  # the override matters

    results: dict = {}

    def client(name, header):
        results[name] = segment_stream_client(
            server.address, _pcm(wav), name=name, header=header,
            chunk_bytes=2 * 16000, pace_s=0.01)

    threads = [
        threading.Thread(target=client, args=("s", None)),
        threading.Thread(target=client, args=("p", pthr_over)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)

    for name, want in (("s", want_strm), ("p", want_pthr)):
        segs = [(ln["offset"], ln["duration"]) for ln in results[name]
                if ln["type"] == "segment"]
        assert segs == want and len(segs) > 0, f"{name} diverged"


def test_server_rejects_unknown_header_key(server):
    from wav2vecsegmenter_tpu.infer.server import segment_stream_client

    lines = segment_stream_client(
        server.address, b"\x00\x00" * 100, header={"segment_length": 8})
    assert lines and lines[0]["type"] == "error"
    assert "segment_length" in lines[0]["error"]
