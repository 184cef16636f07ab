"""Opt-in cross-talk window packing (``runtime.pack_across_talks``).

In the default sweep, every (talk, pass) unit pads its final partial batch up
to the static batch size — ~10% of inference rows are dead padding on a
multi-talk sweep (counted from the window grid).  The packer fills those rows with the
NEXT unit's windows instead: windows stream into per-bucket (std/tail
static shape) buffers shared across talks, and a batch is launched whenever a
buffer fills.  Stitching scatters each row back to its own talk.

PARITY NOTE (why this is opt-in): the reference normalizes each window with
mean/std computed over the batch-max padded row length
(lib/datautils.py:120-125).  Packing changes which windows share a batch, so
a talk's tail window can normalize over a different padded length than in
the per-talk sweep — the same class of deviation as changing ``batch_size``,
bounded accordingly (see PARITY.md "Cross-talk packing", measured in
tests/test_packing.py).

Pipelining contract: ``drain_unit`` force-flushes any partial batch still
holding that unit's rows, so the one-talk-lookahead loop in
cli/common.segment_wavs (drain N after dispatch N+1) never deadlocks; by
then talk N's std-bucket remainder has normally been completed by talk
N+1's windows and only the rare tail-bucket remainder pads.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data.collate import collate, out_len_for
from ..data.loader import audio_bucket_lengths
from .pipeline import (alloc_talk_arrays, download_batches,
                       finalize_talk_arrays, stitch_row)


class _Unit:
    """One (talk, pass) stitching target."""

    __slots__ = ("records", "n_windows")

    def __init__(self):
        self.records: list[dict] = []
        self.n_windows = 0


class PackedSweep:
    def __init__(self, engine, batch_size: int, segment_length_secs: float,
                 need_logits: bool = False, num_threads: int = 4):
        self.engine = engine
        self.batch_size = batch_size
        self.std_len, self.tail_len = audio_bucket_lengths(segment_length_secs)
        self.need_logits = need_logits
        self._buffers: dict[int, list] = {self.std_len: [], self.tail_len: []}
        self._pool = ThreadPoolExecutor(num_threads)
        # collate + device dispatch run on ONE background thread so the
        # main thread's drains (device_get) overlap with the next batches'
        # host work — mirrors BatchIterator's producer-thread overlap in
        # the unpacked sweep
        self._dispatch = ThreadPoolExecutor(1)

    def new_unit(self) -> _Unit:
        return _Unit()

    def add_dataset_pass(self, unit: _Unit, dataset) -> None:
        """Decode all windows of one (talk, pass) grid and buffer them."""
        for example in self._pool.map(dataset.__getitem__,
                                      range(len(dataset))):
            self._add_window(unit, example)

    def _add_window(self, unit: _Unit, example) -> None:
        wav = example[0]
        audio_len = self.std_len if len(wav) <= self.std_len else self.tail_len
        buf = self._buffers[audio_len]
        buf.append((unit, example))
        unit.n_windows += 1
        if len(buf) == self.batch_size:
            self._flush(audio_len)

    def _flush(self, audio_len: int) -> None:
        buf = self._buffers[audio_len]
        if not buf:
            return
        self._buffers[audio_len] = []
        units = [u for u, _ in buf]
        examples = [ex for _, ex in buf]

        def work():
            batch = collate(examples, self.batch_size, audio_len,
                            out_len_for(audio_len), device_normalize=True)
            probs_d, logits_d = self.engine.run_batch(batch)
            return batch, probs_d, logits_d

        record = {
            "future": self._dispatch.submit(work),
            "batch": None,
            "rows": [(u, i) for i, u in enumerate(units)],
            "probs": None,
            "logits": None,
        }
        for u in set(units):
            u.records.append(record)

    def _materialize_all(self, records: list) -> None:
        """Download every unresolved record in one overlapped round-trip
        (pipeline.download_batches)."""
        resolved = []
        for record in records:
            if record["probs"] is not None:
                continue
            batch, probs_d, logits_d = record["future"].result()
            record["batch"] = batch
            resolved.append((record, probs_d, logits_d))
        all_probs, all_logits = download_batches(
            [p for _, p, _ in resolved], [l for _, _, l in resolved],
            self.need_logits)
        for (record, _, _), probs, logits in zip(resolved, all_probs,
                                                 all_logits):
            record["probs"] = probs
            record["logits"] = logits

    def drain_unit(self, unit: _Unit, duration_outframes: int):
        """Flush anything still buffering this unit's windows, then stitch
        its rows (reference lib/evaluate.py:100-125 semantics, incl. the
        .5-outframe end clamp and NaN-gap fill)."""
        for audio_len, buf in list(self._buffers.items()):
            if any(u is unit for u, _ in buf):
                self._flush(audio_len)

        vocab_size = getattr(self.engine.model, "vocab_size", 1)
        talk_probs, talk_logits = alloc_talk_arrays(
            vocab_size, duration_outframes)

        self._materialize_all(unit.records)
        n_scattered = 0
        for record in unit.records:
            batch = record["batch"]
            for u, i in record["rows"]:
                if u is not unit:
                    continue
                n_scattered += 1
                stitch_row(talk_probs, talk_logits, batch, i,
                           record["probs"], record["logits"],
                           duration_outframes)
        assert n_scattered == unit.n_windows, (n_scattered, unit.n_windows)
        unit.records = []

        return finalize_talk_arrays(
            talk_probs, talk_logits, duration_outframes, self.need_logits)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._dispatch.shutdown(wait=False)
