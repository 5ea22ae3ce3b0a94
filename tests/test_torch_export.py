"""The port's exported inference program (``export.py``, ``torch.export``)
vs JAX's ``make_inference_fn``, and the custom operators it holds
(``ops/cuda/library.py``), on the CPU at f32.

- Programs: tiny DeepSpeech2 (the CLI test's config; the LSTM through its
  kernel route, ``rnn_impl="pallas"``), a 2-block Conformer-Transducer
  (the fused decode), a 2-block Transformer-CTC (kernel A) and the
  Conformer-Transducer with a mul joint (the eager WIND loop, which under
  export runs to its iteration cap), greedy, and the first two at beam 2,
  each exported, saved as ``.pt2``, loaded and
  run in a fresh process, against JAX's ``make_inference_fn`` on the
  JAX-initialised weights the port loaded through ``bridge``, on the same
  seeded audio: tokens, next tokens and codepoints equal exactly.
- A streaming Conformer-Transducer program (the carried states in its
  signature) over 3 chunks, each chunk's outputs fed back, against JAX's
  chunk loop: tokens and codepoints equal, the carried states within 2e-5.
- The graphs hold the port's custom operator for every kernel on each
  model's path and no other; each operator passes ``torch.library.opcheck``
  and its CPU implementation equals the kernel's plain version exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu import export as jexport
from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.configs import DecoderConfig as JDecoderConfig
from tensorflowasr_tpu.models.ctc.deepspeech2 import DeepSpeech2 as JDeepSpeech2
from tensorflowasr_tpu.models.ctc.transformer import TransformerCtc as JTransformerCtc
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.tokenizers.char import CharTokenizer as JCharTokenizer
from tensorflowasr_tpu_torch import bridge, export
from tensorflowasr_tpu_torch.configs import DecoderConfig
from tensorflowasr_tpu_torch.models.ctc.deepspeech2 import DeepSpeech2
from tensorflowasr_tpu_torch.models.ctc.transformer import TransformerCtc
from tensorflowasr_tpu_torch.models.transducer.conformer import Conformer
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel, conv_kernel, decode_kernel, ff_kernel, frontend_kernel, library, lstm_kernel
from tensorflowasr_tpu_torch.ops.frontend import FrontendConfig
from tensorflowasr_tpu_torch.tokenizers.char import CharTokenizer
from tests.test_torch_ctc_slice import TRANSFORMER_CFG
from tests.test_torch_streaming import STREAM, _chunks, _params
from tests.test_torch_slice import TINY_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 29  # the English character tokenizer's classes

def _nsamples(name: str, width: int) -> int:
    """The case's audio: short where the trace unrolls a loop (the beam's rounds, the eager WIND loop's iterations)."""
    return 2000 if width or name == "conformer_t_mul" else 8000


DS2_TINY = {"speech_config": {"sample_rate": 16000, "frame_ms": 25, "stride_ms": 10, "num_feature_bins": 40, "nfft": 512,
                              "feature_type": "log_mel_spectrogram"},
            "conv_type": "conv2d", "conv_kernels": [[3, 5]], "conv_strides": [[2, 2]], "conv_filters": [4], "rnn_nlayers": 1, "rnn_type": "lstm",
            "rnn_units": 16, "rnn_bidirectional": True, "fc_nlayers": 0, "blank": 0, "vocab_size": V}
# name: (JAX class, port class, config, port keyword arguments, the custom operators on its path)
MODELS = {
    "ds2": (JDeepSpeech2, DeepSpeech2, DS2_TINY, {"rnn_impl": "pallas"}, {"log_mel_spectrogram", "lstm"}),
    "conformer_t": (JConformer, Conformer, {**TINY_CFG, "vocab_size": V}, {},
                    {"log_mel_spectrogram", "fused_ff", "fused_rel_attention", "conv_front", "conv_back", "fused_greedy_decode"}),
    "transformer_ctc": (JTransformerCtc, TransformerCtc, {**TRANSFORMER_CFG, "vocab_size": V}, {}, {"log_mel_spectrogram", "fused_attention"}),
    # a mul joint, which the fused decode does not take: the eager WIND loop, run to its iteration cap under export
    "conformer_t_mul": (JConformer, Conformer, {**TINY_CFG, "vocab_size": V, "joint_mode": "mul"}, {},
                        {"log_mel_spectrogram", "fused_ff", "fused_rel_attention", "conv_front", "conv_back"}),
}
CASES = [("ds2", 0), ("ds2", 2), ("conformer_t", 0), ("conformer_t", 2), ("transformer_ctc", 0), ("conformer_t_mul", 0)]
STREAM_CFG = {**TINY_CFG, **STREAM, "encoder_mhsam_causal": True, "vocab_size": V}

RUNNER = """
import sys, numpy as np, torch
from tensorflowasr_tpu_torch import bridge, export
io = dict(np.load(sys.argv[1]))
out = {}
for name in io["names"]:
    fn = export.load_program(f"{sys.argv[2]}/{name}.pt2")
    res = fn(torch.tensor(io[f"{name}/sig"]), torch.tensor(io[f"{name}/len"]))
    out[f"{name}/tokens"], out[f"{name}/next_tokens"], out[f"{name}/transcript"] = res.tokens.numpy(), res.next_tokens.numpy(), res.transcript.numpy()
fn = export.load_program(f"{sys.argv[2]}/stream.pt2")
chunks = [io[f"chunk{i}"] for i in range(int(io["nchunks"]))]
enc = [{k: torch.tensor(io[f"enc0/{j}/{k}"]) for k in ("k", "v", "mask")} for j in range(int(io["nblocks"]))]
dec = tuple((torch.tensor(io[f"dec0/{j}/c"]), torch.tensor(io[f"dec0/{j}/h"])) for j in range(int(io["nlayers"])))
carry = (torch.zeros((1,), dtype=torch.int64), enc, dec)
for i, chunk in enumerate(chunks):
    res = fn(torch.tensor(chunk), torch.tensor([chunk.shape[1]], dtype=torch.int32), *carry)
    out[f"stream{i}/tokens"], out[f"stream{i}/transcript"] = res.tokens.numpy(), res.transcript.numpy()
    out[f"stream{i}/next_tokens"] = res.next_tokens.numpy()
    carry = (res.next_tokens, res.next_encoder_states, res.next_decoder_states)
    for j, (c, h) in enumerate(res.next_decoder_states):
        out[f"stream{i}/dec/{j}/c"], out[f"stream{i}/dec/{j}/h"] = c.numpy(), h.numpy()
    for j, m in enumerate(res.next_encoder_states):
        out[f"stream{i}/enc/{j}/k"], out[f"stream{i}/enc/{j}/v"] = m["k"].numpy(), m["v"].numpy()
np.savez(sys.argv[3], **out)
"""


def _tokenizers():
    tok, jtok = CharTokenizer(DecoderConfig({"type": "characters"})), JCharTokenizer(JDecoderConfig({"type": "characters"}))
    tok.make()
    jtok.make()
    assert tok.num_classes == jtok.num_classes == V
    return tok, jtok


def _pair(jcls, tcls, cfg, seed, sharpen_joint=False, v=None, **kwargs):
    """JAX model and variables (jitted init, moved off their init values as
    ``test_torch_streaming._tiny_pair`` does; or ``v``, another config's of
    the same parameter tree) and the port's model with them."""
    jm = jcls.from_config(cfg)
    if v is None:
        sig, lens = jnp.zeros((1, 2800)), jnp.asarray([2800])
        if jcls is JConformer:
            ti = jschemas.TrainInput(sig, lens, jnp.zeros((1, 3), jnp.int32), jnp.full((1,), 3, jnp.int32))
            init = jax.jit(lambda key: jm.init({"params": key}, ti, train=False))
        else:
            init = jax.jit(lambda key: jm.init({"params": key}, sig, lens, method=jm.encode))
        v = _params(init(jax.random.PRNGKey(seed)), np.random.default_rng(seed), scale=0.02)
        if sharpen_joint:
            v["params"]["joint"]["vocab"]["kernel"] = v["params"]["joint"]["vocab"]["kernel"] * 4.0
    tm = tcls.from_config(cfg, device="cpu", **kwargs)
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """Every case exported to ``<dir>/<case>.pt2`` and the streaming program
    to ``stream.pt2``, then all run in one fresh process; JAX's outputs
    beside them."""
    root = tmp_path_factory.mktemp("export")
    tok, jtok = _tokenizers()
    rng = np.random.default_rng(0)
    io, ref, graphs = {"names": np.array([f"{n}_beam{w}" for n, w in CASES])}, {}, {}
    pairs = {}
    for name, (jcls, tcls, cfg, kwargs, _) in MODELS.items():  # the mul-joint Conformer-T takes conformer_t's variables
        pairs[name] = _pair(jcls, tcls, cfg, 2, sharpen_joint=jcls is JConformer, v=pairs["conformer_t"][1] if name == "conformer_t_mul" else None, **kwargs)
    for name, width in CASES:
        jm, v, tm = pairs[name]
        case = f"{name}_beam{width}"
        sig = (rng.standard_normal((1, _nsamples(name, width))) * 0.5).astype(np.float32)
        lens = np.array([sig.shape[1]], np.int32)
        io[f"{case}/sig"], io[f"{case}/len"] = sig, lens
        program = export.export_program(export.make_inference_fn(tm, tok, beam_width=width), (torch.tensor(sig), torch.tensor(lens)),
                                        str(root / f"{case}.pt2"))
        graphs[case] = program.graph
        out = jax.jit(jexport.make_inference_fn(jm, v, tokenizer=jtok, beam_width=width))(jnp.asarray(sig), jnp.asarray(lens))
        ref[case] = {k: np.asarray(getattr(out, k)) for k in ("tokens", "next_tokens", "transcript")}

    jm, v, tm = _pair(JConformer, Conformer, STREAM_CFG, 4, v=pairs["conformer_t"][1])  # the KV memory adds no parameter
    chunks = _chunks(STREAM_CFG["speech_config"], 3, seed=5)
    enc0, dec0 = tm.init_encoder_states(1), tm.init_decoder_states(1)
    n0 = torch.tensor([chunks[0].shape[1]], dtype=torch.int32)
    program = export.export_program(export.make_inference_fn(tm, tok), (torch.tensor(chunks[0]), n0, torch.zeros((1,), dtype=torch.int64), enc0, dec0),
                                    str(root / "stream.pt2"))
    graphs["stream"] = program.graph
    io.update({f"chunk{i}": c for i, c in enumerate(chunks)}, nchunks=np.array(len(chunks)), nblocks=np.array(len(enc0)), nlayers=np.array(len(dec0)))
    io.update({f"enc0/{j}/{k}": m[k].numpy() for j, m in enumerate(enc0) for k in ("k", "v", "mask")})
    io.update({f"dec0/{j}/{n}": t.numpy() for j, (c, h) in enumerate(dec0) for n, t in (("c", c), ("h", h))})
    jfn = jax.jit(jexport.make_inference_fn(jm, v, tokenizer=jtok))
    jtokens, jenc, jdec = jnp.zeros((1,), jnp.int32), jm.init_encoder_states(1), jm.init_decoder_states(1)
    for i, chunk in enumerate(chunks):
        out = jfn(jnp.asarray(chunk), jnp.asarray([chunk.shape[1]], jnp.int32), jtokens, jenc, jdec)
        ref[f"stream{i}"] = {"tokens": np.asarray(out.tokens), "next_tokens": np.asarray(out.next_tokens), "transcript": np.asarray(out.transcript),
                             "dec": [(np.asarray(c), np.asarray(h)) for c, h in out.next_decoder_states],
                             "enc": [(np.asarray(m["k"]), np.asarray(m["v"])) for m in out.next_encoder_states]}
        jtokens, jenc, jdec = out.next_tokens, out.next_encoder_states, out.next_decoder_states

    np.savez(root / "io.npz", **io)
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(root / "io.npz"), str(root), str(root / "out.npz")], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"got": dict(np.load(root / "out.npz")), "ref": ref, "graphs": graphs, "nchunks": len(chunks)}


def _custom_ops(graph) -> set:
    return {str(n.target).split(".")[1] for n in graph.nodes if n.op == "call_function" and str(n.target).startswith(f"{library.NAMESPACE}.")}


@pytest.mark.parametrize("name, width", CASES)
def test_loaded_program_equals_jax_inference_fn(programs, name, width):
    case = f"{name}_beam{width}"
    got, ref = programs["got"], programs["ref"][case]
    assert (ref["tokens"] != 0).any(), "an empty decode has no power"
    for key in ("tokens", "next_tokens", "transcript"):
        np.testing.assert_array_equal(got[f"{case}/{key}"], ref[key], err_msg=f"{case} {key}")
    assert _custom_ops(programs["graphs"][case]) == MODELS[name][4] - ({"fused_greedy_decode"} if width else set())


def test_streamed_program_equals_jax_chunk_loop(programs):
    got = programs["got"]
    emitted = 0
    for i in range(programs["nchunks"]):
        ref = programs["ref"][f"stream{i}"]
        for key in ("tokens", "next_tokens", "transcript"):
            np.testing.assert_array_equal(got[f"stream{i}/{key}"], ref[key], err_msg=f"chunk {i} {key}")
        for j, (c, h) in enumerate(ref["dec"]):
            np.testing.assert_allclose(got[f"stream{i}/dec/{j}/c"], c, rtol=0, atol=2e-5)
            np.testing.assert_allclose(got[f"stream{i}/dec/{j}/h"], h, rtol=0, atol=2e-5)
        for j, (k, v) in enumerate(ref["enc"]):
            np.testing.assert_allclose(got[f"stream{i}/enc/{j}/k"], k, rtol=0, atol=2e-5)
            np.testing.assert_allclose(got[f"stream{i}/enc/{j}/v"], v, rtol=0, atol=2e-5)
        emitted += int((ref["tokens"] != 0).sum())
    assert emitted > 0
    assert _custom_ops(programs["graphs"]["stream"]) == MODELS["conformer_t"][4]


# ------------------------------ the operators ------------------------------ #


def _r(g, *shape, scale=0.5):
    return torch.randn(*shape, generator=g) * scale


def _op_cases():
    """name → (operator arguments, the plain version's result on them)."""
    g = torch.Generator().manual_seed(0)
    cfg = FrontendConfig(num_feature_bins=16, nfft=512)
    sig = _r(g, 2, 1200)
    bh, t, s, d = 4, 5, 7, 8
    qc, qp, k, v, pos = _r(g, bh, t, d), _r(g, bh, t, d), _r(g, bh, s, d), _r(g, bh, s, d), _r(g, bh, s + t - 1, d)
    q_len = torch.tensor([5, 3], dtype=torch.int32)
    bias = _r(g, 1, t, s)
    n, dm, f = 6, 8, 16
    x = _r(g, n, dm)
    ln = (1.0 + _r(g, dm, scale=0.1), _r(g, dm, scale=0.1))
    ff = (_r(g, dm, f), _r(g, f), _r(g, f, dm), _r(g, dm))
    x3, y3 = _r(g, 2, 3, dm), _r(g, 2, 3, dm)
    conv = (_r(g, dm, dm), _r(g, dm), _r(g, dm, dm), _r(g, dm))
    stats = (_r(g, dm, scale=0.1), 1.0 + _r(g, dm, scale=0.1).abs())
    xg, wh, h0, c0 = _r(g, 2, 4, 4 * dm), _r(g, dm, 4 * dm), _r(g, 2, dm), _r(g, 2, dm)
    tm = Conformer.from_config({**TINY_CFG, "vocab_size": V}, device="cpu")
    tm.reset_parameters(torch.Generator().manual_seed(1))
    params = tm.decode_params()
    enc, enc_len, tok0 = _r(g, 2, 6, 16), torch.tensor([6, 4]), torch.tensor([0, 3])
    states = tm.init_decoder_states(2)
    plain_decode = decode_kernel.fused_greedy_decode_plain(enc, enc_len, params, tok0, states)
    layers = params.layers
    return {
        "log_mel_spectrogram": ((sig, cfg.sample_rate, float(cfg.frame_ms), float(cfg.stride_ms), cfg.nfft, cfg.num_feature_bins,
                                 cfg.lower_edge_hertz, cfg.upper_edge_hertz, cfg.epsilon), frontend_kernel.log_mel_spectrogram_plain(sig, cfg)),
        "fused_rel_attention": ((qc, qp, k, v, pos, None, q_len, 0, 0.0, False, None, None, False),
                                attention_kernel.fused_rel_attention_plain(qc, qp, k, v, pos, None, q_len)),
        "fused_attention": ((qc, qp, k[:, :t], bias[:, :, :t], 0, 0.0), attention_kernel.fused_attention_plain(qc, qp, k[:, :t], bias[:, :, :t])),
        "fused_ff": ((x, *ln, *ff, 0, 0.0, 0.5, 1e-3), ff_kernel.fused_ff_plain(x, *ln, *ff)),
        "conv_front": ((x3, *ln, *conv, 1e-3), conv_kernel.conv_front_plain(x3, *ln, *conv)),
        "conv_back": ((x3, y3, *stats, *ln, *conv[:2], 0, 0.0, 1.0, 1e-3), conv_kernel.conv_back_plain(x3, y3, *stats, *ln, *conv[:2])),
        "lstm": ((xg, wh, h0, c0), lstm_kernel.lstm_fwd_plain(xg, wh, h0, c0)[:2]),
        "fused_greedy_decode": ((enc, enc_len, tok0, decode_kernel.stack_states(states), params.embed, [l.w_ih for l in layers],
                                 [l.w_hh for l in layers], [l.b for l in layers], [l.ln for l in layers], [None for _ in layers],
                                 [None for _ in layers], params.wp, params.bp, params.wv, params.bv, params.w_enc, params.b_enc, params.hidden,
                                 params.ln_eps, 0, 16, 2),
                                (*plain_decode[:3], decode_kernel.stack_states(plain_decode[3]))),
    }


OP_CASES = _op_cases()


def test_every_operator_is_covered():
    assert set(OP_CASES) == set(library.OPS)


@pytest.mark.parametrize("name", library.OPS)
def test_operator_opcheck_and_plain_version(name):
    args, plain = OP_CASES[name]
    op = getattr(torch.ops.tfasr, name).default
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    got = op(*args)
    got, plain = (got, plain) if isinstance(got, (tuple, list)) else ((got,), (plain,))
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), name
