"""Beam search and the n-gram LM in the port vs the JAX package, on the CPU.

- ``NGramLM``: the tables built from token corpora (orders 1–3, add-k and
  interpolation), from a text corpus through the char tokenizers, and from
  an ARPA file within 1e-6 of JAX's; ``score``, ``beam_score_fn`` and
  ``sequence_logprob`` equal JAX's on random contexts; the cases of JAX's
  ``tests/test_lm.py``.
- ``ctc_beam_search_decode`` at W 1, 4 and 8, without an LM and with a
  bigram and a trigram LM, on random and on peaked logits (where scores
  tie: the dead hypotheses at −1e30, and the one-hot frames): tokens and
  lengths equal JAX's exactly; the cases of JAX's ``tests/test_decoding.py``.
- ``transducer_beam_search_decode`` on JAX's toy step function (beam
  against greedy on peaked frames, chunks against the whole), and through
  ``recognize`` on a tiny Conformer-T: tokens equal JAX's, and a streaming
  Conformer-T's chunk loop (3 chunks) under beam search equals JAX's chunk by chunk
  (tokens, the winner's next token and decoder states, the KV memories).
- CTC ``recognize`` with beam search and the LM, ``evaluate_dataset`` with
  a beam column under the LM, and ``utils.app_util.evaluate_hypotheses``
  of a prediction TSV, equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.lm import NGramLM as JNGramLM
from tensorflowasr_tpu.models.ctc import base as jctc
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.ops import ctc_decode as jctc_decode
from tensorflowasr_tpu.ops import transducer_decode as jtd
from tensorflowasr_tpu.training import evaluation as jevaluation
from tensorflowasr_tpu.utils import app_util as japp_util
from tensorflowasr_tpu_torch import schemas
from tensorflowasr_tpu_torch.lm import NGramLM
from tensorflowasr_tpu_torch.models.ctc import base as tctc
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops import ctc_decode, transducer_decode
from tensorflowasr_tpu_torch.training import callbacks
from tensorflowasr_tpu_torch.training.evaluation import evaluate_dataset
from tensorflowasr_tpu_torch.utils import app_util
from tests.test_torch_metrics_eval import TEXTS, _datasets, _models, manifest  # noqa: F401  (the fixture)
from tests.test_torch_slice import TINY_CFG
from tests.test_torch_streaming import STREAM, _chunks, _stream_both, _tiny_pair
from tests.test_torch_transducer_transformer import family_pair

# ---------------------------------- LM ------------------------------------ #


def _corpus(seed: int, vocab: int, n: int = 40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(1, 12))).tolist() for _ in range(n)]


@pytest.mark.parametrize("order, add_k, interpolation", [(1, 0.5, 0.3), (2, 0.5, 0.3), (2, 0.01, 0.0), (3, 0.5, 0.3), (3, 0.1, 0.6)])
def test_token_corpus_tables_equal_jax(order, add_k, interpolation):
    seqs = _corpus(order, 9)
    ours = NGramLM.from_token_corpus(seqs, 9, order=order, add_k=add_k, interpolation=interpolation)
    theirs = JNGramLM.from_token_corpus(seqs, 9, order=order, add_k=add_k, interpolation=interpolation)
    assert ours.order == theirs.order and ours.vocab_size == theirs.vocab_size == 9 and ours.table.dtype == torch.float32
    np.testing.assert_allclose(ours.table.numpy(), np.asarray(theirs.table), rtol=0, atol=1e-6)


def test_text_corpus_table_equals_jax():
    from tensorflowasr_tpu.configs import DecoderConfig as JDecoderConfig
    from tensorflowasr_tpu.tokenizers.char import CharTokenizer as JCharTokenizer
    from tensorflowasr_tpu_torch.configs import DecoderConfig
    from tensorflowasr_tpu_torch.tokenizers.char import CharTokenizer

    tok, jtok = CharTokenizer(DecoderConfig({"type": "characters"})), JCharTokenizer(JDecoderConfig({"type": "characters"}))
    tok.make()
    jtok.make()
    ours, theirs = NGramLM.from_text_corpus(TEXTS * 3, tok, order=2), JNGramLM.from_text_corpus(TEXTS * 3, jtok, order=2)
    assert ours.vocab_size == tok.num_classes
    np.testing.assert_allclose(ours.table.numpy(), np.asarray(theirs.table), rtol=0, atol=1e-6)


ARPA = ("\\data\\\nngram 1=3\nngram 2=2\nngram 3=1\n\n\\1-grams:\n-0.5\ta\t-0.3\n-0.7\tb\t-0.2\n-1.0\tc\t0.0\n\n"
        "\\2-grams:\n-0.1\ta b\t-0.05\n-0.4\tb c\n\n\\3-grams:\n-0.2\ta b c\n\n\\end\\\n")


@pytest.mark.parametrize("order", [1, 2, 3])
def test_arpa_tables_equal_jax(tmp_path, order):
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA)
    ids = {"a": 0, "b": 1, "c": 2, "d": 3}  # "d" is in no n-gram: unk_log10
    ours, theirs = NGramLM.from_arpa(str(path), ids, order=order), JNGramLM.from_arpa(str(path), ids, order=order)
    assert ours.table.shape == (4,) * order
    np.testing.assert_allclose(ours.table.numpy(), np.asarray(theirs.table), rtol=0, atol=1e-6)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_score_beam_score_fn_and_sequence_logprob_equal_jax(order):
    v = 7
    seqs = _corpus(10 + order, v)
    ours, theirs = NGramLM.from_token_corpus(seqs, v, order=order), JNGramLM.from_token_corpus(seqs, v, order=order)
    rng = np.random.default_rng(order)
    ctx, cands = rng.integers(0, v, (3, 5, 2)), rng.integers(0, v, (3, 5, 4))
    np.testing.assert_array_equal(ours.score(torch.tensor(ctx), torch.tensor(cands)).numpy(), np.asarray(theirs.score(jnp.asarray(ctx), jnp.asarray(cands))))
    tokens, lengths, ids = rng.integers(0, v, (2, 3, 6)), rng.integers(0, 7, (2, 3)), rng.integers(0, v, (2, 4))
    got = ours.beam_score_fn()(torch.tensor(tokens), torch.tensor(lengths), torch.tensor(ids))
    ref = theirs.beam_score_fn()(jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths, jnp.int32), jnp.asarray(ids, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for seq in seqs[:5] + [[], [3, 3, 3, 3]]:
        assert ours.sequence_logprob(seq) == pytest.approx(theirs.sequence_logprob(seq), rel=1e-6, abs=1e-6)


# the cases of JAX's tests/test_lm.py


def test_bigram_from_corpus_probabilities():
    lm = NGramLM.from_token_corpus([[1, 2, 1, 2, 1, 2], [1, 2, 1, 2]], vocab_size=4, order=2, add_k=0.01, interpolation=0.0)
    probs = np.exp(lm.table.numpy())
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, atol=1e-5)
    assert probs[1, 2] > 0.9 and probs[1, 3] < 0.05


def test_trigram_score_shapes():
    lm = NGramLM.from_token_corpus([[1, 2, 3, 1, 2, 3]], vocab_size=5, order=3)
    s = lm.score(torch.tensor([[1, 2]]), torch.tensor([[0, 1, 2, 3, 4]]))
    assert s.shape == (1, 5) and float(s[0, 3]) > float(s[0, 4])


def test_beam_score_fn_shapes():
    fn = NGramLM.from_token_corpus([[1, 2, 1, 2]], vocab_size=4, order=2).beam_score_fn()
    out = fn(torch.zeros((2, 3, 10), dtype=torch.int64), torch.tensor([[0, 1, 2], [3, 0, 1]]), torch.tensor([[1, 2], [2, 3]]))
    assert out.shape == (2, 3, 2)


def test_beam_with_lm_changes_ranking():
    logp = np.full((1, 2, 4), -8.0, np.float32)
    logp[0, 0, 1], logp[0, 1, 2], logp[0, 1, 3] = -0.05, -0.6, -0.8  # acoustics: 1 then 2 slightly over 3
    lm = NGramLM.from_token_corpus([[1, 3] * 50], vocab_size=4, order=2, interpolation=0.0)
    t_no, _ = ctc_decode.ctc_beam_search_decode(torch.tensor(logp), torch.tensor([2]), beam_width=4)
    t_lm, _ = ctc_decode.ctc_beam_search_decode(torch.tensor(logp), torch.tensor([2]), beam_width=4, lm_score_fn=lm.beam_score_fn(), lm_weight=1.0)
    assert int(t_no[0, 1]) == 2 and int(t_lm[0, 1]) == 3  # the LM flips the second token


def test_arpa_roundtrip(tmp_path):
    path = tmp_path / "lm.arpa"
    path.write_text("\\data\\\nngram 1=3\nngram 2=2\n\n\\1-grams:\n-0.5\ta\t-0.3\n-0.7\tb\t-0.2\n-1.0\tc\t0.0\n\n"
                    "\\2-grams:\n-0.1\ta b\n-0.4\tb c\n\n\\end\\\n")
    lm = NGramLM.from_arpa(str(path), {"a": 0, "b": 1, "c": 2}, order=2)
    np.testing.assert_allclose(float(lm.score(torch.tensor([0]), torch.tensor([1]))[0]), -0.1 * np.log(10), atol=1e-5)
    np.testing.assert_allclose(float(lm.score(torch.tensor([0]), torch.tensor([2]))[0]), (-0.3 - 1.0) * np.log(10), atol=1e-5)  # backoff


def test_sequence_logprob():
    lm = NGramLM.from_token_corpus([[1, 2, 1, 2]], vocab_size=4, order=2)
    assert lm.sequence_logprob([1, 2, 1, 2]) > lm.sequence_logprob([3, 3, 3, 3])


# ------------------------------- CTC beam --------------------------------- #


def _logits(kind: str, seed: int, b: int = 3, t: int = 14, v: int = 9):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.standard_normal((b, t, v)) * 2.0).astype(np.float32)
    out = np.zeros((b, t, v), np.float32)  # one-hot frames: ties everywhere below the peak
    out[np.arange(b)[:, None], np.arange(t)[None, :], rng.integers(0, v, (b, t))] = 20.0
    return out


@pytest.mark.parametrize("lm_order", [0, 2, 3])
@pytest.mark.parametrize("beam_width", [1, 4, 8])
@pytest.mark.parametrize("kind", ["random", "peaked"])
def test_ctc_beam_equals_jax(kind, beam_width, lm_order):
    logits, lengths = _logits(kind, beam_width + lm_order), np.array([14, 9, 0], np.int32)
    kw = {}
    if lm_order:
        seqs = _corpus(lm_order, 9, n=30)
        ours, theirs = NGramLM.from_token_corpus(seqs, 9, order=lm_order), JNGramLM.from_token_corpus(seqs, 9, order=lm_order)
        kw = dict(lm_weight=0.7)
    ref_t, ref_l = jctc_decode.ctc_beam_search_decode(jnp.asarray(logits), jnp.asarray(lengths), beam_width=beam_width, prune_vocab=5,
                                                      lm_score_fn=theirs.beam_score_fn() if lm_order else None, **kw)
    got_t, got_l = ctc_decode.ctc_beam_search_decode(torch.tensor(logits), torch.tensor(lengths), beam_width=beam_width, prune_vocab=5,
                                                     lm_score_fn=ours.beam_score_fn() if lm_order else None, **kw)
    assert got_t.dtype == torch.int64 and got_t.shape == (3, 14)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    assert int(got_l[2]) == 0


def test_top_k_puts_the_lower_index_first_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0, -1e30]])
    values, idx = ctc_decode.top_k(x, 5)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_v))


def test_ctc_beam_matches_greedy_on_peaked_logits():
    ids = [0, 1, 1, 0, 2, 0, 3, 3]
    logits = np.zeros((1, len(ids), 5), np.float32)
    logits[0, np.arange(len(ids)), ids] = 20.0
    gt, gl = ctc_decode.ctc_greedy_decode(torch.tensor(logits), torch.tensor([len(ids)]))
    bt, bl = ctc_decode.ctc_beam_search_decode(torch.tensor(logits), torch.tensor([len(ids)]), beam_width=4)
    assert int(bl[0]) == int(gl[0]) and torch.equal(bt[0, : int(bl[0])], gt[0, : int(gl[0])])


def test_ctc_beam_sums_alignments():
    """p("a") = 0.64 over its three alignments beats the best path "" (0.36)."""
    p = np.log(np.asarray([[[0.6, 0.4], [0.6, 0.4]]], np.float32))
    tokens, lengths = ctc_decode.ctc_beam_search_decode(torch.tensor(p), torch.tensor([2]), beam_width=4, prune_vocab=1)
    assert int(lengths[0]) == 1 and int(tokens[0, 0]) == 1


# ---------------------------- transducer beam ----------------------------- #


def _toy_step_fn(vocab=4, suppress=25.0):
    """JAX's toy: emits the frame's favoured token once, then blank; states count the calls."""

    def step_fn(enc_frame, prev_tokens, states):
        nonblank = (prev_tokens != 0).to(enc_frame.dtype)[:, None]
        logits = enc_frame - suppress * torch.nn.functional.one_hot(prev_tokens, vocab).to(enc_frame.dtype) * nonblank
        return logits, tuple(x + 1 for x in states)

    return step_fn


def _frames(tokens, vocab=4):
    enc = np.zeros((1, len(tokens), vocab), np.float32)
    enc[0, np.arange(len(tokens)), tokens] = 10.0
    return enc


def test_transducer_beam_matches_greedy_on_peaked():
    enc, states = torch.tensor(_frames([1, 0, 2, 3])), (torch.zeros((1, 2)),)
    gt, gl, _, _ = transducer_decode.transducer_greedy_decode(enc, torch.tensor([4]), _toy_step_fn(), torch.zeros(1, dtype=torch.int64), states)
    bt, bl, bnt, bns = transducer_decode.transducer_beam_search_decode(enc, torch.tensor([4]), _toy_step_fn(), torch.zeros(1, dtype=torch.int64),
                                                                       states, beam_width=2)
    assert int(bl[0]) == int(gl[0]) == 3 and torch.equal(bt[0, :3], gt[0, :3])
    assert int(bnt[0]) == int(gt[0, 2]) and bns[0].shape == states[0].shape


def test_transducer_beam_streaming_chunks_equal_full():
    enc, states, step_fn = torch.tensor(_frames([1, 0, 2, 3, 0, 1])), (torch.zeros((1, 2)),), _toy_step_fn()
    ft, fl, _, _ = transducer_decode.transducer_beam_search_decode(enc, torch.tensor([6]), step_fn, torch.zeros(1, dtype=torch.int64), states, 2)
    prev, st, got = torch.zeros(1, dtype=torch.int64), states, []
    for lo in (0, 3):
        ct, cl, prev, st = transducer_decode.transducer_beam_search_decode(enc[:, lo: lo + 3], torch.tensor([3]), step_fn, prev, st, 2)
        got.extend(ct[0, : int(cl[0])].tolist())
    assert got == ft[0, : int(fl[0])].tolist()


@pytest.mark.parametrize("beam_width", [1, 4])
def test_transducer_beam_on_the_toy_equals_jax(beam_width):
    rng = np.random.default_rng(beam_width)
    enc, lengths = (rng.standard_normal((3, 7, 4)) * 3).astype(np.float32), np.array([7, 4, 0], np.int32)
    init = np.array([0, 2, 1], np.int32)

    def jstep(enc_frame, prev_tokens, states):
        nonblank = (prev_tokens != 0).astype(enc_frame.dtype)[:, None]
        return enc_frame - 25.0 * jax.nn.one_hot(prev_tokens, 4) * nonblank, jax.tree_util.tree_map(lambda x: x + 1, states)

    ref = jtd.transducer_beam_search_decode(jnp.asarray(enc), jnp.asarray(lengths), jstep, jnp.asarray(init), (jnp.zeros((3, 2)),), beam_width=beam_width)
    got = transducer_decode.transducer_beam_search_decode(torch.tensor(enc), torch.tensor(lengths), _toy_step_fn(), torch.tensor(init).long(),
                                                          (torch.zeros((3, 2)),), beam_width=beam_width)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(ref[3][0]))


@pytest.mark.parametrize("beam_width", [4])
def test_conformer_transducer_beam_through_recognize_equals_jax(beam_width):
    jm, v, tm, arrs = family_pair(JConformer, Conformer, TINY_CFG)
    tm.eval()
    sig, lens = arrs[0], arrs[1]
    ref = jax.jit(lambda v_, p_: jbase.recognize(jm, v_, p_, beam_width=beam_width))(v, jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens),
                                                                                                                None, None, None))
    got = tbase.recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)), beam_width=beam_width)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.next_tokens.numpy(), np.asarray(ref.next_tokens))
    for g, r in zip(jax.tree_util.tree_leaves(got.next_decoder_states), jax.tree_util.tree_leaves(ref.next_decoder_states)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5)
    assert (got.tokens != 0).any()


def test_streaming_conformer_transducer_beam_chunks_equal_jax():
    """Three 16-frame chunks of a tiny streaming Conformer-T (KV memory 8)
    through both ``recognize``s at beam 2, carrying the winner's token and
    decoder states and the memories (``test_torch_streaming._stream_both``)."""
    cfg = {**TINY_CFG, **STREAM, "encoder_mhsam_causal": True}
    jm, v, tm = _tiny_pair(JConformer, Conformer, cfg, seed=4, sharpen_joint=True)
    _stream_both(jm, v, tm, lambda m, v_, p_: jbase.recognize(m, v_, p_, beam_width=2), lambda m, p_: tbase.recognize(m, p_, beam_width=2),
                 _chunks(cfg["speech_config"], 3, seed=5), decoder=True)


# --------------------------- entry points, eval --------------------------- #


@pytest.fixture(scope="module")
def ctc_pair(manifest):  # noqa: F811  (the imported fixture)
    ours, theirs = _datasets(manifest)
    jm, v, tm = _models("conformer_ctc", theirs)
    lm = NGramLM.from_text_corpus(TEXTS, manifest[1], order=2)
    jlm = JNGramLM.from_text_corpus(TEXTS, manifest[2], order=2)
    return ours, theirs, jm, v, tm, lm, jlm


def test_ctc_recognize_with_beam_and_lm_equals_jax(ctc_pair):
    _, theirs, jm, v, tm, lm, jlm = ctc_pair
    batch = next(theirs.create(4, num_workers=0, prefetch=0))
    sig, lens = np.asarray(batch.inputs.inputs), np.asarray(batch.inputs.inputs_length)
    for kw, jkw in (({}, {}), ({"lm": lm}, {"lm": jlm}), ({"lm": lm, "lm_weight": 2.0}, {"lm": jlm, "lm_weight": 2.0})):
        ref = jax.jit(lambda v_, p_: jctc.recognize(jm, v_, p_, beam_width=4, **jkw))(v, jschemas.PredictInput(jnp.asarray(sig), jnp.asarray(lens),
                                                                                                                 None, None, None))
        got = tctc.recognize(tm, schemas.PredictInput(torch.tensor(sig), torch.tensor(lens)), beam_width=4, **kw)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


def test_evaluate_dataset_beam_with_lm_and_evaluate_hypotheses_equal_jax(ctc_pair, manifest, tmp_path):  # noqa: F811
    ours, theirs, jm, v, tm, lm, jlm = ctc_pair
    ref = jevaluation.evaluate_dataset(jm, v, theirs, manifest[2], batch_size=3, beam_width=4, lm=jlm, collect_rows=True)
    path = tmp_path / "predictions.tsv"
    got = evaluate_dataset(tm, ours, manifest[1], batch_size=3, beam_width=4, lm=lm, collect_rows=True, num_workers=2,
                           predict_logger=callbacks.PredictLogger(output=str(path)))
    assert got["rows"] == ref["rows"] and got["greedy"] == ref["greedy"] and got["beam"] == ref["beam"]
    assert app_util.evaluate_hypotheses(str(path)) == japp_util.evaluate_hypotheses(str(path))
    rows = path.read_text().splitlines()
    rows[1] = "\t".join(rows[1].split("\t")[:3])  # a row without its beam column
    path.write_text("\n".join(rows + ["short"]) + "\n")
    report = app_util.evaluate_hypotheses(str(path))
    assert report == japp_util.evaluate_hypotheses(str(path)) and set(report) == {"greedy", "beam"}
