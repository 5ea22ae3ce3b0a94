"""Streaming in the port vs the JAX package, on the CPU, at f32: the
frontend's chunk math, attention with KV memory, the streaming Conformer
encoder, and ``recognize`` chunk by chunk with carried tokens, decoder and
encoder states (counterparts of ``tests/test_streaming.py``).

Tolerances: attention and encoder outputs to 1e-5 absolute (f32
summation order on unit-scale outputs; 2e-5 through two blocks), the KV
memories (raw LayerNorm'd block inputs) likewise; tokens equal; decoder
states to 2e-5 (the test_torch_slice tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.ctc import base as jctc
from tensorflowasr_tpu.models.ctc.conformer import ConformerCtc as JConformerCtc
from tensorflowasr_tpu.models.ctc.transformer import TransformerCtc as JTransformerCtc
from tensorflowasr_tpu.models.encoders.conformer import ConformerEncoder as JConformerEncoder
from tensorflowasr_tpu.models.layers import attention as jatt
from tensorflowasr_tpu.models.layers import positional as jpos
from tensorflowasr_tpu.models.transducer import base as jbase
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.ops import frontend as jfrontend
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.models.ctc import base as tctc
from tensorflowasr_tpu_torch.models.ctc.conformer import ConformerCtc
from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc
from tensorflowasr_tpu_torch.models.encoders.conformer import ConformerEncoder
from tensorflowasr_tpu_torch.models.layers import positional as tpos
from tensorflowasr_tpu_torch.models.layers.attention import MemoryState, MultiHeadAttention, MultiHeadRelativeAttention
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer, conformer_small_config, conformer_small_streaming_config
from tensorflowasr_tpu_torch.ops import frontend
from tests.test_torch_ctc_slice import CONFORMER_CFG, TRANSFORMER_CFG
from tests.test_torch_slice import TINY_CFG

TOL = dict(rtol=0, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params(v, rng, scale=0.1):
    """JAX variables as numpy, params moved off their init values (non-zero biases)."""
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"] = jax.tree_util.tree_map(lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), v["params"])
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
    return v


def _assert_memories(got, ref, tol=TOL):
    assert (got is None) == (ref is None)
    for g, r in zip(got or [], ref or []):
        np.testing.assert_allclose(_np(g["k"]), np.asarray(r["k"]), **tol)
        np.testing.assert_allclose(_np(g["v"]), np.asarray(r["v"]), **tol)
        np.testing.assert_array_equal(_np(g["mask"]), np.asarray(r["mask"]))


def test_frontend_chunk_equivalence():
    """STFT frames of chunks cut by ``get_signal_chunk_size_and_step`` equal
    the full signal's (JAX test_streaming.py:19), and the chunk math is JAX's."""
    cfg = frontend.FrontendConfig(pad_end=False)
    for nframes in (1, 8, 16):
        assert cfg.get_signal_chunk_size_and_step(nframes) == jfrontend.FrontendConfig(pad_end=False).get_signal_chunk_size_and_step(nframes)
    sig = torch.tensor(np.random.default_rng(0).standard_normal((1, 16000)).astype(np.float32))
    full = frontend.stft_magnitude_squared(sig, cfg)
    size, step = cfg.get_signal_chunk_size_and_step(16)
    chunks = [frontend.stft_magnitude_squared(sig[:, i * step: i * step + size], cfg) for i in range((sig.shape[1] - size) // step + 1)]
    stitched = torch.cat(chunks, dim=1)
    np.testing.assert_allclose(stitched.numpy(), full[:, : stitched.shape[1]].numpy(), rtol=1e-4, atol=1e-4)


def _mha_pair(memory_chunk_mask: bool, seed: int):
    """JAX test_streaming.py:147/171: the full pass under the chunk mask
    (no memory) and chunk-by-chunk passes with a memory of MEM frames, on
    both sides; returns the port's and JAX's stitched outputs and the
    port's full pass."""
    t, d, ch, mem = 16, 16, 4, 8
    x = np.random.default_rng(seed).standard_normal((1, t, d)).astype(np.float32)
    ones = np.ones((1, t), bool)
    full_kw = dict(use_causal_mask=True) if not memory_chunk_mask else {}
    jm = jatt.MultiHeadAttention(num_heads=2, key_dim=8, output_dim=d, chunk_size=ch, history_size=mem)
    v = _params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x), query_mask=jnp.asarray(ones), kv_mask=jnp.asarray(ones), **full_kw),
                np.random.default_rng(seed))
    chunk_kw = dict(chunk_size=ch, history_size=mem) if memory_chunk_mask else {}
    jm2 = jatt.MultiHeadAttention(num_heads=2, key_dim=8, output_dim=d, memory_length=mem, **chunk_kw)
    tfull = MultiHeadAttention(d, 2, 8, output_dim=d, chunk_size=ch, history_size=mem)
    tm2 = MultiHeadAttention(d, 2, 8, output_dim=d, memory_length=mem, **chunk_kw)
    for m in (tfull, tm2):
        m.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        full, _ = tfull(torch.tensor(x), torch.tensor(x), query_mask=torch.tensor(ones), kv_mask=torch.tensor(ones), **full_kw)
    jmem, tmem = jm2.init_memory(1, d), tm2.init_memory(1, d)
    jouts, touts = [], []
    cm = np.ones((1, ch), bool)
    for i in range(t // ch):
        chunk = x[:, i * ch: (i + 1) * ch]
        jo, jmem = jm2.apply({"params": v["params"]}, jnp.asarray(chunk), jnp.asarray(chunk), query_mask=jnp.asarray(cm), kv_mask=jnp.asarray(cm),
                             memory_state=jmem, use_causal_mask=not memory_chunk_mask)
        with torch.no_grad():
            to, tmem = tm2(torch.tensor(chunk), torch.tensor(chunk), query_mask=torch.tensor(cm), kv_mask=torch.tensor(cm), memory_state=tmem,
                           use_causal_mask=not memory_chunk_mask)
        _assert_memories([tmem], [jmem])
        jouts.append(np.asarray(jo))
        touts.append(to)
    return torch.cat(touts, dim=1), np.concatenate(jouts, axis=1), full


def test_attention_memory_exactly_equals_chunked_mask():
    got, ref, full = _mha_pair(memory_chunk_mask=False, seed=0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_attention_memory_plus_chunk_mask_equals_chunked_full_pass():
    """The memory columns sit at negative frame coordinates of the chunk
    mask (JAX's regression test for the memory/chunk-mask coordinate bug)."""
    got, ref, full = _mha_pair(memory_chunk_mask=True, seed=1)
    assert float(got[:, :4].abs().max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_relative_positional_encoding_with_memory(causal):
    """R = 2T+M−1 (T+M causal) with the per-row roll, as JAX's."""
    x, lens = np.random.default_rng(2).standard_normal((3, 7, 12)).astype(np.float32), np.array([7, 4, 1], np.int32)
    _, ref = jpos.RelativeSinusoidalPositionalEncoding(interleave=True, memory_length=5, causal=causal).apply({}, jnp.asarray(x), jnp.asarray(lens))
    _, got = tpos.RelativeSinusoidalPositionalEncoding(interleave=True, memory_length=5, causal=causal)(torch.tensor(x), torch.tensor(lens))
    assert got.shape[1] == (7 + 5 if causal else 2 * 7 + 5 - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_relative_attention_memory_matches_jax(causal):
    """Kernel B with S = M + T keys, the memory mask as its key bias, chunk
    by chunk under the chunk mask: outputs and memories equal JAX's."""
    t, d, ch, mem, n, h = 12, 16, 4, 8, 2, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    pe = jpos.RelativeSinusoidalPositionalEncoding(interleave=True, memory_length=mem, causal=causal)
    kw = dict(num_heads=n, key_dim=h, output_dim=d, memory_length=mem, chunk_size=ch, history_size=mem, causal=causal)
    jm = jatt.MultiHeadRelativeAttention(use_attention_bias=True, **kw)
    cm = np.array([[True] * ch, [True] * (ch - 1) + [False]])
    _, relpe0 = pe.apply({}, jnp.asarray(x[:, :ch]), jnp.asarray(cm.sum(1)))
    v = _params(jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:, :ch]), jnp.asarray(x[:, :ch]), relpe=relpe0, query_mask=jnp.asarray(cm),
                        memory_state=jatt.MemoryState.init(2, mem, d)), rng)
    tm = MultiHeadRelativeAttention(d, n, h, d, causal=causal, chunk_size=ch, history_size=mem, use_attention_bias=True, memory_length=mem)
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    jmem, tmem = jatt.MemoryState.init(2, mem, d), MemoryState.init(2, mem, d)
    for i in range(t // ch):
        chunk = x[:, i * ch: (i + 1) * ch]
        _, relpe = pe.apply({}, jnp.asarray(chunk), jnp.asarray(cm.sum(1)))
        jo, jmem = jm.apply(v, jnp.asarray(chunk), jnp.asarray(chunk), relpe=relpe, query_mask=jnp.asarray(cm), memory_state=jmem)
        with torch.no_grad():
            to, tmem = tm(torch.tensor(chunk), torch.tensor(chunk), relpe=torch.tensor(np.asarray(relpe)), query_mask=torch.tensor(cm),
                          memory_state=tmem)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _assert_memories([tmem], [jmem])


def _encoders(kernel_size, strides, causal, use_causal_mask, seed=0):
    sub = {"class_name": "Conv2dSubsampling",
           "config": {"filters": [8] * len(strides), "kernels": [kernel_size if kernel_size == 1 else 3] * len(strides), "strides": strides,
                      "paddings": ["causal"] * len(strides), "norms": ["none"] * len(strides), "activations": ["swish"] * len(strides)}}
    kw = dict(dmodel=16, num_blocks=2, head_size=4, num_heads=2, kernel_size=kernel_size, memory_length=8, chunk_size=4, history_size=8,
              mhsam_causal=causal, use_attention_causal_mask=use_causal_mask, dropout=0.0)
    jenc = JConformerEncoder(subsampling=sub, **kw)
    feats = np.random.default_rng(seed).standard_normal((1, 64, 20)).astype(np.float32)
    v = _params(jenc.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(feats), jnp.asarray([64]), initial_state=jenc.init_state(1), train=False),
                np.random.default_rng(seed), scale=0.05)
    tenc = ConformerEncoder(sub, 20, **kw)
    tenc.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jenc, v, tenc.eval(), feats


def test_streaming_conformer_first_chunk_exact():
    """JAX test_streaming.py:203 on the port, and held to JAX: a zero memory
    equals no memory on the full pass, and the first chunk equals the
    no-memory full pass under the chunk mask."""
    jenc, v, tenc, feats = _encoders(kernel_size=3, strides=[2, 2], causal=True, use_causal_mask=True)
    with torch.no_grad():
        full_nomem, _, none_state = tenc(torch.tensor(feats), torch.tensor([64]))
        full_mem, _, _ = tenc(torch.tensor(feats), torch.tensor([64]), initial_state=tenc.init_state(1))
        chunk0, _, state0 = tenc(torch.tensor(feats[:, :16]), torch.tensor([16]), initial_state=tenc.init_state(1))
    assert none_state is None and len(state0) == 2
    np.testing.assert_allclose(full_mem.numpy(), full_nomem.numpy(), **TOL)
    assert float(chunk0.abs().max()) > 1e-3
    np.testing.assert_allclose(chunk0.numpy(), full_nomem[:, :4].numpy(), **TOL)
    ref0, _, ref_state0 = jenc.apply(v, jnp.asarray(feats[:, :16]), jnp.asarray([16]), initial_state=jenc.init_state(1), train=False)
    np.testing.assert_allclose(chunk0.numpy(), np.asarray(ref0), **TOL)
    _assert_memories(state0, ref_state0)


def test_streaming_conformer_memory_carries_across_chunks():
    """JAX test_streaming.py:234 on the port (pointwise conv: no cross-chunk
    conv context): with the carried memory every chunk equals the no-memory
    full pass under the chunk mask, and each chunk's output and memories equal JAX's."""
    jenc, v, tenc, feats = _encoders(kernel_size=1, strides=[4], causal=False, use_causal_mask=False)
    with torch.no_grad():
        full_nomem, _, _ = tenc(torch.tensor(feats), torch.tensor([64]))
    outs, state, jstate = [], tenc.init_state(1), jenc.init_state(1)
    for i in range(4):
        chunk = feats[:, i * 16: (i + 1) * 16]
        with torch.no_grad():
            out, _, state = tenc(torch.tensor(chunk), torch.tensor([16]), initial_state=state)
        ref, _, jstate = jenc.apply(v, jnp.asarray(chunk), jnp.asarray([16]), initial_state=jstate, train=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
        _assert_memories(state, jstate, dict(rtol=0, atol=2e-5))
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full_nomem.numpy(), rtol=0, atol=2e-5)


def _chunks(speech_config, n_chunks, seed, nframes=16):
    cfg = frontend.FrontendConfig(**speech_config)
    size, step = cfg.get_signal_chunk_size_and_step(nframes)
    sig = (np.random.default_rng(seed).standard_normal((1, (n_chunks - 1) * step + size)) * 0.5).astype(np.float32)
    return [sig[:, i * step: i * step + size] for i in range(n_chunks)]


def _stream_both(jm, v, tm, jrecognize, trecognize, chunks, decoder: bool):
    """Chunk loops through both ``recognize``s, carrying every state; each
    chunk's tokens, next tokens and carried states compared. The first
    chunk starts from explicit initial states (blank token, zero decoder
    states) on both sides, so that one jitted JAX chunk serves every chunk."""
    jtok = jnp.zeros((1,), jnp.int32)
    jdec = jm.init_decoder_states(1) if decoder else None
    ttok = tdec = None
    jenc, tenc = jm.init_encoder_states(1), tm.init_encoder_states(1)
    jchunk = jax.jit(lambda v_, p_: jrecognize(jm, v_, p_))
    emitted = 0
    for chunk in chunks:
        n = np.array([chunk.shape[1]], np.int32)
        ref = jchunk(v, jschemas.PredictInput(jnp.asarray(chunk), jnp.asarray(n), jtok, jenc, jdec))
        got = trecognize(tm, schemas.PredictInput(torch.tensor(chunk), torch.tensor(n), ttok, tenc, tdec))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.next_tokens.numpy(), np.asarray(ref.next_tokens))
        _assert_memories(got.next_encoder_states, ref.next_encoder_states, dict(rtol=0, atol=2e-5))
        if decoder:
            for g, r in zip(jax.tree_util.tree_leaves(got.next_decoder_states), jax.tree_util.tree_leaves(ref.next_decoder_states)):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-5)
        emitted += int((got.tokens != 0).sum())
        jtok, jenc, jdec = ref.next_tokens, ref.next_encoder_states, ref.next_decoder_states
        ttok, tenc, tdec = got.next_tokens, got.next_encoder_states, got.next_decoder_states
    assert emitted > 0


def _tiny_pair(jcls, tcls, cfg, seed, sharpen_joint=False):
    rng = np.random.default_rng(seed)
    jm = jcls.from_config(cfg)
    sig = jnp.asarray(rng.standard_normal((1, 2800)).astype(np.float32))
    if jcls is JConformer:
        ti = jschemas.TrainInput(sig, jnp.asarray([2800]), jnp.zeros((1, 3), jnp.int32), jnp.full((1,), 3, jnp.int32))
        v = jm.init({"params": jax.random.PRNGKey(seed)}, ti, train=False)
    else:
        v = jm.init({"params": jax.random.PRNGKey(seed)}, sig, jnp.asarray([2800]), method=jm.encode)
    v = _params(v, rng, scale=0.02)
    if sharpen_joint:
        v["params"]["joint"]["vocab"]["kernel"] = v["params"]["joint"]["vocab"]["kernel"] * 4.0
    tm = tcls.from_config(cfg, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm.eval()


STREAM = {"encoder_memory_length": 8, "encoder_chunk_size": 4, "encoder_history_size": 8}


def test_conformer_transducer_streams_through_recognize_as_jax():
    """A tiny streaming Conformer-T (causal rel-MHSA, chunk 4, history 8,
    memory 8): four 16-frame chunks through ``recognize`` (the fused
    decode's plain version) vs JAX's chunk loop (the XLA WIND loop)."""
    cfg = {**TINY_CFG, **STREAM, "encoder_mhsam_causal": True}
    jm, v, tm = _tiny_pair(JConformer, Conformer, cfg, seed=4, sharpen_joint=True)
    assert tm.decode_params() is not None
    _stream_both(jm, v, tm, jbase.recognize, tbase.recognize, _chunks(cfg["speech_config"], 4, seed=5), decoder=True)


@pytest.mark.parametrize("name", ["conformer", "transformer"])
def test_ctc_models_stream_through_recognize_as_jax(name):
    """Tiny Conformer-CTC (kernel B) and Transformer-CTC (kernel A, S = M + T)
    with KV memory: four chunks through ``recognize`` vs JAX's chunk loop."""
    jcls, tcls, base = {"conformer": (JConformerCtc, ConformerCtc, CONFORMER_CFG), "transformer": (JTransformerCtc, TransformerCtc, TRANSFORMER_CFG)}[name]
    cfg = {**base, **STREAM}
    jm, v, tm = _tiny_pair(jcls, tcls, cfg, seed=6)
    _stream_both(jm, v, tm, jctc.recognize, tctc.recognize, _chunks(cfg["speech_config"], 4, seed=7), decoder=False)


def test_streaming_config_is_the_example_model():
    """``conformer_small_streaming_config`` builds the small-streaming example
    at its widths, with the memory as asked and the flagship's other keys."""
    cfg = conformer_small_streaming_config(memory_length=64)
    assert {k: cfg[k] for k in ("encoder_mhsam_causal", "encoder_chunk_size", "encoder_history_size", "encoder_memory_length", "vocab_size")} == {
        "encoder_mhsam_causal": True, "encoder_chunk_size": 16, "encoder_history_size": 64, "encoder_memory_length": 64, "vocab_size": 1000}
    flagship = conformer_small_config()
    assert {k: v for k, v in cfg.items() if k in flagship and k != "vocab_size" and k != "speech_config"} == {
        k: v for k, v in flagship.items() if k != "vocab_size" and k != "speech_config"}
    assert "encoder_memory_length" not in conformer_small_streaming_config()
    model = Conformer.from_config(conformer_small_streaming_config(num_blocks=2, memory_length=64), device="cpu")
    states = model.init_encoder_states(1)
    assert len(states) == 2 and tuple(states[0]["k"].shape) == (1, 64, 144) and not states[0]["mask"].any()
