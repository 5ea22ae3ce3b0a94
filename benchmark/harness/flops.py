"""Useful operations and irreducible bytes of a training step or a served
request, from a configuration's own sizes and each utterance's real length.

Work, not implementation: products (2 operations a multiply-add) of the
frontend's mel filterbank and FFT, the subsampling convolutions, every
linear layer, the attention products over each row's real frames (the
relative scores count T × T, the useful part of the T × (2T − 1) product
that the shift trick computes), the depthwise convolution, the prediction
net's LSTM and the joint over each row's (T × U+1) lattice. Elementwise
work, the norms and the RNN-T recursion are left out. A training step is
3 × its forward (the backward twice the forward). A served request counts
the encoder over real frames, one joint evaluation a decision (a frame's
blank or an emitted token) and one prediction step a token. Padding never
counts, so a program that skips it, fuses kernels or renames them reads
the same work.

Irreducible bytes: a training step reads and writes every f32 parameter,
its gradient and Adam's two moments once (32 bytes a parameter) and reads
the batch once; a request reads every f32 parameter and its audio once.
"""

from __future__ import annotations

import math

from ..reference import model as rm


def _ceil2(n: int) -> int:
    return (n + 1) // 2


def encoder_terms(a: rm.Arch, samples: int) -> dict:
    """Forward operations of the frontend and encoder over one utterance of ``samples`` samples, by part."""
    frames = -(-samples // a.frame_step)
    bins = a.nfft // 2 + 1
    out = {"frontend_fft": frames * 2.5 * a.nfft * math.log2(a.nfft), "frontend_mel": 2.0 * frames * bins * a.mels}
    t, f, cin, sub = frames, a.mels, 1, 0.0
    for c in a.filters:
        t, f = _ceil2(t), _ceil2(f)
        sub += 2.0 * t * f * c * 9 * cin
        cin = c
    out["subsampling"] = sub
    d, inner, h = a.dmodel, a.heads * a.head_size, a.heads
    out["linear"] = 2.0 * t * (f * cin) * d
    ff = 2 * (2.0 * t * d * a.ff_factor * d * 2)
    proj = 4 * 2.0 * t * d * inner + 2.0 * (2 * t - 1) * d * inner
    attend = 3 * 2.0 * h * t * t * a.head_size
    conv = 2.0 * t * d * 2 * d + 2.0 * t * d * a.kernel_size + 2.0 * t * d * d
    out["blocks"] = a.blocks * (ff + proj + attend + conv)
    return out


def encoder_flops(a: rm.Arch, samples: int) -> float:
    return sum(encoder_terms(a, samples).values())


def encoder_frames(a: rm.Arch, samples: int) -> int:
    t = -(-samples // a.frame_step)
    for _ in a.filters:
        t = _ceil2(t)
    return t


def lstm_step_flops(a: rm.Arch) -> float:
    return 2.0 * 4 * a.rnn_units * (a.embed_dim + a.rnn_units)


def train_utterance_flops(a: rm.Arch, samples: int, labels: int) -> float:
    """Forward operations of one training utterance: encoder, prediction net over U+1 positions, joint over T × (U+1)."""
    t, u1, j = encoder_frames(a, samples), labels + 1, a.joint_dim
    pred = u1 * (lstm_step_flops(a) + 2.0 * a.rnn_units * j)
    joint = 2.0 * t * a.dmodel * j + 2.0 * t * u1 * j * a.vocab
    return encoder_flops(a, samples) + pred + joint


def train_step_flops(a: rm.Arch, samples: list, labels: list) -> float:
    """Useful operations of a training step: 3 × the forward of each utterance."""
    return 3.0 * sum(train_utterance_flops(a, n, u) for n, u in zip(samples, labels))


def serve_utterance_flops(a: rm.Arch, samples: int, tokens: int) -> float:
    """Encoder, encoder projection, one prediction step a token (and the first), one joint evaluation a decision."""
    t, j = encoder_frames(a, samples), a.joint_dim
    pred = (tokens + 1) * (lstm_step_flops(a) + 2.0 * a.rnn_units * j)
    joint = 2.0 * t * a.dmodel * j + (t + tokens) * 2.0 * j * a.vocab
    return encoder_flops(a, samples) + pred + joint


def parameter_count(a: rm.Arch) -> int:
    return sum(math.prod(s) for n, s in rm.leaf_shapes(a).items() if not n.endswith(("running_mean", "running_var")))


def train_step_bytes(a: rm.Arch, batch: int, padded_samples: int, padded_labels: int) -> float:
    """32 bytes a parameter (value, gradient, two moments, each read and written once) and the batch read once."""
    return 32.0 * parameter_count(a) + batch * (4.0 * padded_samples + 8.0 * (2 * padded_labels + 1) + 24.0)


def serve_request_bytes(a: rm.Arch, batch: int, padded_samples: int) -> float:
    return 4.0 * parameter_count(a) + batch * (4.0 * padded_samples + 8.0)
