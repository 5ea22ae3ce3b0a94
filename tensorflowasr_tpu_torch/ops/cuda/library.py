"""The serving kernels as PyTorch custom operators (namespace ``tfasr``), so
that ``torch.export`` can hold them in a graph (``export.py``).

A kernel's wrapper is a ``ctypes`` call, which ``torch.export`` cannot
trace. Each wrapper on the serving path therefore takes its operator here
when ``torch.compiler.is_exporting()`` is true, and only then: the eager
serve, train and eval paths call the kernels as before. Each operator has

- a CUDA implementation: the wrapper's kernel launch (its ``_check``, its
  plan, occupancy and row choices, the ``nvcc`` build at first use), which
  adds one to the wrapper's count in ``utils/tracing.launches``;
- a CPU implementation: the kernel's plain version;
- a fake implementation, the output shapes from the input shapes alone,
  which is all that runs while ``torch.export`` traces.

Only forwards are registered: the exported program serves. The operators:

========================== ================================================
``log_mel_spectrogram``    ``frontend_kernel.log_mel_spectrogram_pallas``
``fused_rel_attention``    ``attention_kernel.fused_rel_attention`` (kernel B)
``fused_attention``        ``attention_kernel.fused_attention`` (kernel A)
``fused_ff``               ``ff_kernel.fused_ff``
``conv_front``             ``conv_kernel.conv_front``
``conv_back``              ``conv_kernel.conv_back``
``lstm``                   ``lstm_kernel.lstm_core`` (so ``lstm_layer_fused``)
``fused_greedy_decode``    ``decode_kernel.fused_greedy_decode``
========================== ================================================

Importing this module registers them (it builds nothing); a loaded
``.pt2`` names them, so ``export.load_program`` imports it first.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor
from torch.library import custom_op

from tensorflowasr_tpu_torch.ops import frontend
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel, conv_kernel, decode_kernel, ff_kernel, frontend_kernel, lstm_kernel

NAMESPACE = "tfasr"
OPS = ("log_mel_spectrogram", "fused_rel_attention", "fused_attention", "fused_ff", "conv_front", "conv_back", "lstm", "fused_greedy_decode")


def _op(name: str):
    return custom_op(f"{NAMESPACE}::{name}", mutates_args=(), device_types="cpu")


# ------------------------------- frontend ------------------------------- #


def _frontend_config(sample_rate, frame_ms, stride_ms, nfft, num_feature_bins, lower_edge_hertz, upper_edge_hertz, epsilon):
    return frontend.FrontendConfig(sample_rate=sample_rate, frame_ms=frame_ms, stride_ms=stride_ms, nfft=nfft, num_feature_bins=num_feature_bins,
                                   lower_edge_hertz=lower_edge_hertz, upper_edge_hertz=upper_edge_hertz, epsilon=epsilon)


@_op("log_mel_spectrogram")
def log_mel_spectrogram(signal: Tensor, sample_rate: int, frame_ms: float, stride_ms: float, nfft: Optional[int], num_feature_bins: int,
                        lower_edge_hertz: float, upper_edge_hertz: float, epsilon: float) -> Tensor:
    cfg = _frontend_config(sample_rate, frame_ms, stride_ms, nfft, num_feature_bins, lower_edge_hertz, upper_edge_hertz, epsilon)
    return frontend_kernel.log_mel_spectrogram_plain(signal, cfg)


@log_mel_spectrogram.register_kernel("cuda")
def _(signal, sample_rate, frame_ms, stride_ms, nfft, num_feature_bins, lower_edge_hertz, upper_edge_hertz, epsilon):
    cfg = _frontend_config(sample_rate, frame_ms, stride_ms, nfft, num_feature_bins, lower_edge_hertz, upper_edge_hertz, epsilon)
    return frontend_kernel.log_mel_spectrogram_kernel(signal, cfg)


@log_mel_spectrogram.register_fake
def _(signal, sample_rate, frame_ms, stride_ms, nfft, num_feature_bins, lower_edge_hertz, upper_edge_hertz, epsilon):
    cfg = _frontend_config(sample_rate, frame_ms, stride_ms, nfft, num_feature_bins, lower_edge_hertz, upper_edge_hertz, epsilon)
    return signal.new_empty((signal.shape[0], cfg.get_nframes(signal.shape[1]), num_feature_bins))


def log_mel_spectrogram_op(signal: Tensor, config: frontend.FrontendConfig) -> Tensor:
    """:func:`log_mel_spectrogram` on a ``FrontendConfig`` (the fields the kernel reads)."""
    frontend_kernel._check_config(config)
    return log_mel_spectrogram(signal, config.sample_rate, float(config.frame_ms), float(config.stride_ms), config.nfft, config.num_feature_bins,
                               float(config.lower_edge_hertz), float(config.upper_edge_hertz), float(config.epsilon))


# ------------------------------- attention ------------------------------ #


@_op("fused_rel_attention")
def fused_rel_attention(qc: Tensor, qp: Tensor, k: Tensor, v: Tensor, pos: Tensor, kv_bias: Optional[Tensor], q_len: Optional[Tensor], seed: int,
                        rate: float, causal: bool, chunk_size: Optional[int], history_size: Optional[int], pe_causal: bool) -> Tensor:
    return attention_kernel.fused_rel_attention_plain(qc, qp, k, v, pos, kv_bias, q_len, seed, rate, causal, chunk_size, history_size, pe_causal)


@fused_rel_attention.register_kernel("cuda")
def _(qc, qp, k, v, pos, kv_bias, q_len, seed, rate, causal, chunk_size, history_size, pe_causal):
    return attention_kernel.fused_rel_attention_kernel(qc, qp, k, v, pos, kv_bias, q_len, seed, rate, causal, chunk_size, history_size, pe_causal)


@fused_rel_attention.register_fake
def _(qc, qp, k, v, pos, kv_bias, q_len, seed, rate, causal, chunk_size, history_size, pe_causal):
    return torch.empty_like(qc)


@_op("fused_attention")
def fused_attention(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, seed: int, rate: float) -> Tensor:
    return attention_kernel.fused_attention_plain(q, k, v, bias, seed, rate)


@fused_attention.register_kernel("cuda")
def _(q, k, v, bias, seed, rate):
    return attention_kernel.fused_attention_kernel(q, k, v, bias, seed, rate)


@fused_attention.register_fake
def _(q, k, v, bias, seed, rate):
    return torch.empty_like(q)


# ----------------------------- feed-forward ----------------------------- #


@_op("fused_ff")
def fused_ff(x: Tensor, gamma: Tensor, beta: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, seed: int, rate: float, factor: float,
             eps: float) -> Tensor:
    return ff_kernel.fused_ff_plain(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps)


@fused_ff.register_kernel("cuda")
def _(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps):
    return ff_kernel.fused_ff_kernel(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps)


@fused_ff.register_fake
def _(x, gamma, beta, w1, b1, w2, b2, seed, rate, factor, eps):
    return torch.empty_like(x)


# ----------------------------- conv module ------------------------------ #


@_op("conv_front")
def conv_front(x: Tensor, gamma: Tensor, beta: Tensor, wa: Tensor, ba: Tensor, wb: Tensor, bb: Tensor, eps: float) -> Tensor:
    return conv_kernel.conv_front_plain(x, gamma, beta, wa, ba, wb, bb, eps)


@conv_front.register_kernel("cuda")
def _(x, gamma, beta, wa, ba, wb, bb, eps):
    return conv_kernel.conv_front_kernel(x, gamma, beta, wa, ba, wb, bb, eps)


@conv_front.register_fake
def _(x, gamma, beta, wa, ba, wb, bb, eps):
    return torch.empty_like(x)


@_op("conv_back")
def conv_back(x: Tensor, y1: Tensor, mean: Tensor, var: Tensor, scale: Tensor, bias: Tensor, w2: Tensor, b2: Tensor, seed: int, rate: float,
              factor: float, eps: float) -> Tensor:
    return conv_kernel.conv_back_plain(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps)


@conv_back.register_kernel("cuda")
def _(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps):
    return conv_kernel.conv_back_kernel(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps)


@conv_back.register_fake
def _(x, y1, mean, var, scale, bias, w2, b2, seed, rate, factor, eps):
    return torch.empty_like(x)


# --------------------------------- LSTM --------------------------------- #


@_op("lstm")
def lstm(xg: Tensor, wh: Tensor, h0: Tensor, c0: Tensor) -> tuple[Tensor, Tensor]:
    y, cseq, _ = lstm_kernel.lstm_fwd_plain(xg, wh, h0, c0)
    return y, cseq


@lstm.register_kernel("cuda")
def _(xg, wh, h0, c0):
    y, cseq, _ = lstm_kernel.lstm_fwd_kernel(xg, wh, h0, c0)
    return y, cseq


@lstm.register_fake
def _(xg, wh, h0, c0):
    b, t, g4 = xg.shape
    return xg.new_empty((b, t, g4 // 4)), xg.new_empty((b, t, g4 // 4))


# ----------------------------- greedy decode ---------------------------- #


def _decode_params(embed, w_ih, w_hh, b, ln, proj_w, proj_b, wp, bp, wv, bv, w_enc, b_enc, hidden, ln_eps) -> decode_kernel.FusedDecodeParams:
    layers = tuple(decode_kernel.FusedLayer(w_ih=wi, w_hh=wh, b=bi, ln=l, proj=None if pw is None else (pw, pb))
                   for wi, wh, bi, l, pw, pb in zip(w_ih, w_hh, b, ln, proj_w, proj_b))
    return decode_kernel.FusedDecodeParams(embed=embed, layers=layers, wp=wp, bp=bp, wv=wv, bv=bv, w_enc=w_enc, b_enc=b_enc, hidden=hidden,
                                           ln_eps=ln_eps)


@_op("fused_greedy_decode")
def fused_greedy_decode(encoded: Tensor, encoded_length: Tensor, initial_tokens: Tensor, initial_states: Tensor, embed: Tensor, w_ih: list[Tensor],
                        w_hh: list[Tensor], b: list[Tensor], ln: list[Optional[Tensor]], proj_w: list[Optional[Tensor]], proj_b: list[Optional[Tensor]],
                        wp: Tensor, bp: Tensor, wv: Tensor, bv: Tensor, w_enc: Tensor, b_enc: Tensor, hidden: int, ln_eps: float, blank: int,
                        window: int, max_token_factor: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    params = _decode_params(embed, w_ih, w_hh, b, ln, proj_w, proj_b, wp, bp, wv, bv, w_enc, b_enc, hidden, ln_eps)
    tokens, lengths, next_tokens, states = decode_kernel.fused_greedy_decode_plain(
        encoded, encoded_length, params, initial_tokens, decode_kernel.unstack_states(initial_states), blank, window, max_token_factor)
    return tokens.contiguous(), lengths, next_tokens.clone(), decode_kernel.stack_states(states)


@fused_greedy_decode.register_kernel("cuda")
def _(encoded, encoded_length, initial_tokens, initial_states, embed, w_ih, w_hh, b, ln, proj_w, proj_b, wp, bp, wv, bv, w_enc, b_enc, hidden, ln_eps,
      blank, window, max_token_factor):
    params = _decode_params(embed, w_ih, w_hh, b, ln, proj_w, proj_b, wp, bp, wv, bv, w_enc, b_enc, hidden, ln_eps)
    return decode_kernel.fused_greedy_decode_kernel_stacked(encoded, encoded_length, params, initial_tokens,
                                                            decode_kernel.unstack_states(initial_states), blank, window, max_token_factor)


@fused_greedy_decode.register_fake
def _(encoded, encoded_length, initial_tokens, initial_states, embed, w_ih, w_hh, b, ln, proj_w, proj_b, wp, bp, wv, bv, w_enc, b_enc, hidden, ln_eps,
      blank, window, max_token_factor):
    batch, t = encoded.shape[:2]
    max_tokens = max_token_factor * t + 1  # decode_kernel._budget
    i64 = dict(dtype=torch.int64, device=encoded.device)
    return (encoded.new_empty((batch, max_tokens), **i64), encoded.new_empty((batch,), **i64), encoded.new_empty((batch,), **i64),
            torch.empty_like(initial_states, dtype=torch.float32))


def fused_greedy_decode_op(encoded, encoded_length, params: decode_kernel.FusedDecodeParams, initial_tokens, initial_states, blank: int = 0,
                           window: int = 16, max_token_factor: int = 2):
    """:func:`fused_greedy_decode` with ``decode_kernel.fused_greedy_decode``'s arguments and returns."""
    layers = params.layers
    tokens, lengths, next_tokens, states = fused_greedy_decode(
        encoded, encoded_length, initial_tokens, decode_kernel.stack_states(initial_states), params.embed, [l.w_ih for l in layers],
        [l.w_hh for l in layers], [l.b for l in layers], [l.ln for l in layers], [l.proj and l.proj[0] for l in layers],
        [l.proj and l.proj[1] for l in layers], params.wp, params.bp, params.wv, params.bv, params.w_enc, params.b_enc, params.hidden,
        float(params.ln_eps), blank, window, max_token_factor)
    return tokens, lengths, next_tokens, decode_kernel.unstack_states(states)
