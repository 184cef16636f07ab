"""CTC task end-to-end: transcript loading, encoding, loss, tiny train run.

The reference DECLARES this task (conf/task/shas_ctc.yaml) but cannot run
it: lib.models.SHASWithCTC does not exist and the data layer never loads
transcripts (lib/dataset.py:45 "[TODO] load self.tgt_text").  This suite
covers the working path built here: segments.tsv tgt_text column ->
window_transcript -> UppercasedCharVocabulary.encode_transcript -> collate
tokens -> train/step.py ctc branch (torch-matching CTC loss).
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

from wav2vecsegmenter_tpu.config import compose
from wav2vecsegmenter_tpu.data.datasets import SegmentationCorpus
from wav2vecsegmenter_tpu.data.prep import prepare_dataset_for_segmentation
from wav2vecsegmenter_tpu.data.vocab import UppercasedCharVocabulary

from .helpers import TINY_W2V, make_speechlike_wav

CONF = Path(__file__).resolve().parents[1] / "conf"


# ---------------------------------------------------------------------------
# transcript encoding
# ---------------------------------------------------------------------------

def test_encode_transcript():
    v = UppercasedCharVocabulary()
    ids = v.encode_transcript("Hey you!")
    # uppercased, space -> '|', unknown ('!') -> <unk>; all offset by 4
    want = [v.word2id[c] for c in "HEY"] + [v.word_delimiter_id] + \
        [v.word2id[c] for c in "YOU"] + [v.unk_token_id]
    assert ids == want
    assert all(i >= v.n_special_tokens for i in ids)
    # whitespace runs collapse; empty encodes empty
    assert v.encode_transcript("  a \n b ") == \
        v.encode_transcript("a b")
    assert v.encode_transcript("") == []


# ---------------------------------------------------------------------------
# corpus fixture with transcripts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctc_corpus(tmp_path_factory):
    ws = tmp_path_factory.mktemp("ctccorpus")
    wav_dir = ws / "wav"
    wav_dir.mkdir()
    make_speechlike_wav(wav_dir / "talkA.wav", duration_secs=30, seed=0)
    make_speechlike_wav(wav_dir / "talkB.wav", duration_secs=25, seed=1)
    rows, texts = [], []
    k = 0
    for wav, dur in (("talkA.wav", 30), ("talkB.wav", 25)):
        t = 0.2
        while t + 3.0 < dur:
            rows.append({"duration": 2.8, "offset": round(t, 2),
                         "speaker_id": "NA", "wav": wav})
            texts.append(f"segment {k} says hello")
            t += 3.5
            k += 1
    with open(ws / "train.yaml", "w") as f:
        yaml.dump(rows, f)
    (ws / "train.en").write_text("\n".join(texts) + "\n")
    talks_tsv, segments_tsv = prepare_dataset_for_segmentation(
        ws / "train.yaml", wav_dir, ws, split="train",
        txt_path=ws / "train.en",
    )
    return ws, talks_tsv, segments_tsv


def test_prep_writes_tgt_text(ctc_corpus):
    import pandas as pd

    _, _, segments_tsv = ctc_corpus
    segs = pd.read_csv(segments_tsv, sep="\t", index_col=0)
    assert "tgt_text" in segs.columns
    assert segs.tgt_text.str.contains("says hello").all()


def test_window_transcript_fully_contained(ctc_corpus):
    """Only segments fully inside [start, end) contribute their text, in
    start order."""
    _, talks_tsv, segments_tsv = ctc_corpus
    corpus = SegmentationCorpus(talks_tsv, segments_tsv)
    assert corpus.has_text
    segs = corpus.segments_df[corpus.segments_df.talk_id == "talkA"]
    s0, s1 = segs.iloc[0], segs.iloc[1]
    # window covering exactly the first two segments
    text = corpus.window_transcript("talkA", int(s0.start), int(s1.end))
    assert text == f"{s0.tgt_text} {s1.tgt_text}"
    # window cutting into segment 1: segment 1 excluded
    text = corpus.window_transcript("talkA", int(s0.start), int(s1.end) - 1)
    assert text == s0.tgt_text
    # window with no fully-contained segment
    assert corpus.window_transcript("talkA", int(s0.start) + 1,
                                    int(s0.end) - 1) == ""


def test_loader_collates_ctc_tokens(ctc_corpus):
    from wav2vecsegmenter_tpu.data.loader import RandomDataloaderGenerator

    _, talks_tsv, segments_tsv = ctc_corpus
    vocab = UppercasedCharVocabulary()
    gen = RandomDataloaderGenerator(
        talks_tsv, segments_tsv, segment_length=4, batch_size=2,
        num_workers=2, vocab=vocab, seed=0, ctc=True,
    )
    saw_labels = False
    for batch in gen.generate():
        assert batch.tokens is not None
        assert batch.tokens.shape[0] == batch.audio.shape[0]
        assert batch.tokens.dtype == np.int32
        real = batch.tokens[batch.tokens != vocab.pad_token_id]
        if real.size:
            saw_labels = True
            assert (real >= vocab.n_special_tokens).all()
    assert saw_labels, "no window produced any CTC labels"


# ---------------------------------------------------------------------------
# loss numerics vs torch
# ---------------------------------------------------------------------------

def test_ctc_loss_matches_torch(rng):
    import torch

    from wav2vecsegmenter_tpu.train.loss import CTCLoss

    B, T, V, U = 3, 24, 8, 6
    logits = rng.randn(B, T, V).astype(np.float32)
    labels = rng.randint(1, V, size=(B, U)).astype(np.int32)
    label_lens = np.array([6, 4, 1])
    logit_lens = np.array([24, 20, 17])

    # torch: log_probs [T, B, V], flattened targets
    lp = torch.log_softmax(torch.tensor(logits), dim=-1).transpose(0, 1)
    tgt = torch.tensor(
        np.concatenate([labels[i, :label_lens[i]] for i in range(B)]),
        dtype=torch.long)
    want = torch.nn.CTCLoss(blank=0, reduction="mean")(
        lp, tgt, torch.tensor(logit_lens), torch.tensor(label_lens))

    label_pad = (np.arange(U)[None] >= label_lens[:, None]).astype(np.float32)
    logit_pad = (np.arange(T)[None] >= logit_lens[:, None]).astype(np.float32)
    got = CTCLoss(blank=0, reduction="mean")(
        logits, labels, logit_pad, label_pad)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    # example_mask: masked row's loss excluded, denominator shrinks
    mask = np.array([True, True, False])
    got_m = CTCLoss(blank=0, reduction="mean")(
        logits, labels, logit_pad, label_pad, example_mask=mask)
    want_m = torch.nn.CTCLoss(blank=0, reduction="mean")(
        lp[:, :2], tgt[: label_lens[:2].sum()],
        torch.tensor(logit_lens[:2]), torch.tensor(label_lens[:2]))
    np.testing.assert_allclose(float(got_m), float(want_m), rtol=1e-5)


# ---------------------------------------------------------------------------
# end-to-end tiny training run on task=shas_ctc
# ---------------------------------------------------------------------------

def test_ctc_train_loop_end_to_end(ctc_corpus, tmp_path, monkeypatch):
    ws, talks_tsv, segments_tsv = ctc_corpus
    monkeypatch.chdir(tmp_path)

    from wav2vecsegmenter_tpu.config import registry
    from wav2vecsegmenter_tpu.models.shas import SHASWithSSL

    import tests.helpers as helpers

    def build_tiny_ssl(**kwargs):
        m = SHASWithSSL(
            n_transformer_enc_layers=1, n_transformer_enc_heads=4,
            init_dropout=0.0, vocab_size=36, ctc_vocab_size=32,
            finetune_wav2vec=True,
        )
        m.w2v_cfg = TINY_W2V
        m.d_model = TINY_W2V.hidden_size
        return m

    helpers._tiny_builder_ctc = build_tiny_ssl
    orig = registry._ALIASES["lib.models.SHASWithCTC"]
    registry.register("lib.models.SHASWithCTC",
                      "tests.helpers:_tiny_builder_ctc")
    try:
        cfg = compose(CONF, "train", overrides=[
            "task=shas_ctc",
            "exp_name=ctcsmoke",
            "batch_size=2",
            "segment_length=4",
            "max_epochs=1",
            "update_freq=1",
            "print_every_steps=5",
            "save_every_steps=999999",
            "learning_rate=1e-4",
            f"data.train.talk_list={talks_tsv}",
            f"data.train.segments_list={segments_tsv}",
            f"data.eval.talk_list={talks_tsv}",
            f"data.eval.segments_list={segments_tsv}",
            "runtime.compute_dtype=float32",
        ])
        from wav2vecsegmenter_tpu.train.loop import train

        results = train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHASWithCTC"] = orig

    # eval ran (frame metrics over the multi-class head) and a full-state
    # checkpoint was written (finetune_wav2vec=True -> save_full_state)
    assert set(results) >= {"eval_accuracy", "eval_f1"}
    ckpts = sorted((tmp_path / "ctcsmoke" / "ckpts").glob("epoch-*"))
    assert ckpts, "no checkpoints saved"
    from wav2vecsegmenter_tpu.checkpoints.io import restore_orbax

    tree = restore_orbax(ckpts[0])
    assert {"wav2vec", "lm_head", "final_ln", "seg"} <= set(tree)


def test_collate_truncates_ctc_labels_to_row_logit_length():
    """A short row in a long bucket must cap its labels at ITS OWN logit
    length (conv frames of its real audio), not the bucket-wide out_len —
    U > T is an infeasible CTC sequence whose ~|log_epsilon| loss would
    poison the batch mean silently."""
    from wav2vecsegmenter_tpu.core.frames import conv_output_length
    from wav2vecsegmenter_tpu.data.collate import collate

    vocab = UppercasedCharVocabulary()
    L_bucket, L_short = 16000 * 20, 16000 * 4
    out_len = 999  # 20 s bucket
    flen_short = int(conv_output_length(L_short))  # 199
    assert flen_short < out_len

    wav = np.zeros(L_short, np.float32)
    text = "A" * (out_len - 1)  # would fit the bucket cap, not the row
    batch = collate(
        [(wav, None, 0, flen_short)], batch_size=2, audio_len=L_bucket,
        out_len=out_len, transcripts=[text], ctc_vocab=vocab,
    )
    n_labels = int((batch.tokens[0] != vocab.pad_token_id).sum())
    assert n_labels == flen_short
    # padding row stays all-pad
    assert (batch.tokens[1] == vocab.pad_token_id).all()
