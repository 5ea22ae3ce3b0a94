"""Plain PyTorch Conformer-Transducer, the benchmark's reference.

It computes what a configuration's ``model_config`` states, from weights
handed in as a dict of tensors keyed by leaf name, in float32 (the caller
turns TF32 off) or, for the control, with every product's operands rounded
to a lower precision (:class:`Operands`). It imports nothing of the program
under test: the names, shapes, init scales, the dropout counter hash, the
SpecAugment draws and the seed streams are the benchmark's own frozen copies
of what the configuration and the training recipe state.

The computation, per utterance batch of raw 16 kHz audio:

- frontend: preemphasis 0.97, 25 ms Hann frames every 10 ms (end padded),
  |rfft|² at ``nfft``, an HTK mel filterbank, natural log with ε 1e-6;
- SpecAugment when training: frequency then time masks set to the mask
  value, drawn from the augment stream;
- Conv2d subsampling (causal padding on both axes, stride 2), BatchNorm
  (batch statistics over every frame, padding included, when training;
  the running statistics otherwise), swish; the last two axes merged with
  the channels fastest;
- the input linear, dropout, the relative sinusoidal encoding rolled per
  row by its length;
- blocks of FF(½) → relative MHSA → conv module → FF(½) → LayerNorm, with
  the query rows past a row's length given −1e9 on every key and the
  padded keys left visible, the conv module's BatchNorm on batch
  statistics (unclipped variance) over every frame;
- the prediction net: embedding (zero past the label length), one LSTM
  scanned over every position, LayerNorm;
- the joint: tanh(enc·Weᵀ + be + pred·Wpᵀ + bp)·Wvᵀ + bv.

Dropout sites, in the order the training step draws their seeds from the
dropout stream: the input linear's output (a uniform draw on the device),
then per block the first FF (one seed for its two sites, hashed by row and
column), the attention probabilities (one seed, hashed per head row), the
attention output (a uniform draw), the conv module's output (hashed), the
second FF (hashed).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = BN_EPS = 1e-3
NEG = -1e9  # the additive score of a query row past its length

# ----------------------------------------------------------------------------
# configuration


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes and options of one Conformer-Transducer configuration."""

    sample_rate: int
    frame_ms: int
    stride_ms: int
    nfft: int
    mels: int
    preemphasis: float
    freq_masks: tuple  # (num_masks, mask_factor, prob, value)
    time_masks: tuple  # (num_masks, p_upperbound, prob, value)
    filters: tuple
    dmodel: int
    blocks: int
    heads: int
    head_size: int
    kernel_size: int
    ff_factor: int
    ff_residual: float
    mhsa_residual: float
    conv_residual: float
    dropout: float
    embed_dim: int
    rnn_units: int
    joint_dim: int
    vocab: int
    blank: int

    @property
    def frame_length(self) -> int:
        return int(round(self.sample_rate * self.frame_ms / 1000.0))

    @property
    def frame_step(self) -> int:
        return int(round(self.sample_rate * self.stride_ms / 1000.0))


_EXPECTED = {  # options this reference implements only at these values
    "encoder_mha_type": "relmha", "encoder_interleave_relpe": True, "encoder_use_attention_causal_mask": False,
    "encoder_use_attention_auto_mask": True, "encoder_mhsam_use_attention_bias": False, "encoder_padding": "causal",
    "encoder_mhsam_causal": False, "encoder_module_norm_position": "pre", "encoder_block_norm_position": "post",
    "encoder_convm_scale_factor": 2, "encoder_convm_use_group_conv": False, "encoder_convm_dw_norm_type": "batch",
    "prediction_label_encode_mode": "embedding", "prediction_num_rnns": 1, "prediction_rnn_type": "lstm", "prediction_layer_norm": True,
    "prediction_projection_units": 0, "prejoint_encoder_linear": True, "prejoint_prediction_linear": True, "postjoint_linear": False,
    "joint_activation": "tanh", "joint_mode": "add",
}


def arch_of(model_config: dict) -> Arch:
    """The :class:`Arch` of a reference-style ``model_config`` (``class_name``
    and a flat ``config``); raises on an option this reference does not implement."""
    c = model_config["config"]
    for key, want in _EXPECTED.items():
        if c.get(key, want) != want:
            raise ValueError(f"the reference implements {key} = {want!r} only, not {c[key]!r}")
    sp = c["speech_config"]
    for key, want in (("feature_type", "log_mel_spectrogram"), ("pad_end", True), ("use_librosa_like_stft", False), ("log_base", "e"),
                      ("normalize_signal", False), ("normalize_zscore", False), ("normalize_min_max", False), ("padding", 0)):
        if sp.get(key, want) != want:
            raise ValueError(f"the reference implements speech_config {key} = {want!r} only")
    sub = c["encoder_subsampling"]["config"]
    if (list(sub.get("kernels", [3, 3])) != [3, 3] or list(sub.get("strides", [2, 2])) != [2, 2] or set(sub.get("paddings", [])) != {"causal"}
            or set(sub.get("norms", [])) != {"batch"} or set(sub.get("activations", [])) != {"swish"}):
        raise ValueError("the reference implements the Conv2d ×4 subsampling with causal 3×3 convs, BatchNorm and swish only")
    fm = sp.get("augmentation_config", {}).get("feature_augment", {})
    f, t = fm.get("freq_masking"), fm.get("time_masking")
    return Arch(
        sample_rate=sp.get("sample_rate", 16000), frame_ms=sp.get("frame_ms", 25), stride_ms=sp.get("stride_ms", 10), nfft=sp.get("nfft", 512),
        mels=sp.get("num_feature_bins", 80), preemphasis=sp.get("preemphasis", 0.97),
        freq_masks=() if f is None else (f.get("num_masks", 1), f.get("mask_factor", 27), f.get("prob", 1.0), float(f.get("mask_value", 0))),
        time_masks=() if t is None else (t.get("num_masks", 1), t.get("p_upperbound", 1.0), t.get("prob", 1.0), float(t.get("mask_value", 0))),
        filters=tuple(sub["filters"]), dmodel=c["encoder_dmodel"], blocks=c["encoder_num_blocks"], heads=c["encoder_num_heads"],
        head_size=c["encoder_head_size"], kernel_size=c["encoder_kernel_size"], ff_factor=c.get("encoder_ffm_scale_factor", 4),
        ff_residual=float(c.get("encoder_ffm_residual_factor", 0.5)), mhsa_residual=float(c.get("encoder_mhsam_residual_factor", 1.0)),
        conv_residual=float(c.get("encoder_convm_residual_factor", 1.0)), dropout=float(c.get("encoder_dropout", 0.1)),
        embed_dim=c["prediction_embed_dim"], rnn_units=c["prediction_rnn_units"], joint_dim=c["joint_dim"], vocab=c["vocab_size"],
        blank=c.get("blank", 0),
    )


def leaf_shapes(a: Arch) -> dict:
    """Every weight and statistic of the configuration: name → shape."""
    d, inner, hd = a.dmodel, a.heads * a.head_size, a.head_size
    out = {"encoder.content_attention_bias": (a.heads, hd), "encoder.positional_attention_bias": (a.heads, hd)}
    cin, freq = 1, a.mels
    for i, c in enumerate(a.filters):
        out[f"encoder.subsampling.conv_{i}.weight"] = (c, cin, 3, 3)
        out[f"encoder.subsampling.conv_{i}.bias"] = (c,)
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"encoder.subsampling.norm_{i}.{s}"] = (c,)
        cin, freq = c, (freq + 1) // 2
    out["encoder.linear.weight"], out["encoder.linear.bias"] = (d, freq * cin), (d,)

    def dense(name, n_in, n_out):
        out[f"{name}.weight"], out[f"{name}.bias"] = (n_out, n_in), (n_out,)

    def norm(name, n):
        out[f"{name}.weight"], out[f"{name}.bias"] = (n,), (n,)

    for b in range(a.blocks):
        p = f"encoder.block_{b}"
        for ff in ("ff_module_1", "ff_module_2"):
            norm(f"{p}.{ff}.ln", d)
            dense(f"{p}.{ff}.dense_1", d, a.ff_factor * d)
            dense(f"{p}.{ff}.dense_2", a.ff_factor * d, d)
        norm(f"{p}.mhsa_module.ln", d)
        for proj in ("query", "key", "value", "encoding"):
            dense(f"{p}.mhsa_module.mhsa.{proj}", d, inner)
        dense(f"{p}.mhsa_module.mhsa.output", inner, d)
        c = f"{p}.conv_module"
        norm(f"{c}.ln", d)
        out[f"{c}.pw_conv_1.weight"], out[f"{c}.pw_conv_1.bias"] = (2 * d, d, 1), (2 * d,)
        out[f"{c}.dw_conv.weight"], out[f"{c}.dw_conv.bias"] = (d, 1, a.kernel_size), (d,)
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{c}.dw_norm.{s}"] = (d,)
        out[f"{c}.pw_conv_2.weight"], out[f"{c}.pw_conv_2.bias"] = (d, d, 1), (d,)
        norm(f"{p}.ln_post", d)
    h = a.rnn_units
    out["prediction.embedding.embeddings.weight"] = (a.vocab, a.embed_dim)
    out["prediction.rnn_0.cell.weight_ih"], out["prediction.rnn_0.cell.weight_hh"] = (4 * h, a.embed_dim), (4 * h, h)
    out["prediction.rnn_0.cell.bias"] = (4 * h,)
    norm("prediction.ln_0", h)
    dense("joint.enc", d, a.joint_dim)
    dense("joint.pred", h, a.joint_dim)
    dense("joint.vocab", a.joint_dim, a.vocab)
    return out


def init_scale(name: str, shape: tuple) -> tuple[str, float]:
    """The init rule of a leaf: ("normal", std) or ("fill", value). Matrices
    and conv kernels lecun-normal (std 1/√fan-in), the embedding table
    standard normal, norm scales and running variances 1, every bias,
    running mean and attention bias 0."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("embeddings.weight"):
        return "normal", 1.0
    if len(shape) >= 2 and not name.endswith("attention_bias"):
        return "normal", 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf in ("weight", "running_var"):
        return "fill", 1.0
    return "fill", 0.0


def make_weights(a: Arch, seed: int, blank_bias: float, device) -> dict:
    """Every leaf from ``seed``: one standard-normal draw on ``device`` (a
    generator there) for all normal leaves, cut and scaled per leaf; then
    the joint's blank row of the vocabulary weight set to zero and its bias
    to ``blank_bias``, so that the blank logit is the configuration's
    constant and every seed's random joint emits tokens at about the same
    rate (a random blank row shifts it from none to the 2T + 1 budget). float32."""
    shapes = leaf_shapes(a)
    rules = {n: init_scale(n, s) for n, s in shapes.items()}
    total = sum(math.prod(s) for n, s in shapes.items() if rules[n][0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, s in shapes.items():
        kind, v = rules[n]
        if kind == "normal":
            k = math.prod(s)
            out[n] = flat[at:at + k].view(s).mul_(v)
            at += k
        else:
            out[n] = torch.full(s, v, device=device)
    out["joint.vocab.weight"][a.blank] = 0.0
    out["joint.vocab.bias"][a.blank] = blank_bias
    return out


# ----------------------------------------------------------------------------
# precision of the products


class Operands:
    """Rounds each product's operands: ``"f32"`` leaves them, ``"bf16"``
    rounds to bfloat16, ``"fp8"`` to float8 e4m3 under a per-tensor scale
    (amax → 448). Gradients pass straight through the rounding."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown operand precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        with torch.no_grad():
            if self.kind == "bf16":
                r = x.to(torch.bfloat16).float()
            else:
                s = x.abs().amax().clamp(min=1e-30) / 448.0
                r = (x / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - x).detach() if x.requires_grad else r


F32 = Operands("f32")


def linear(x, w, b, q: Operands):
    return torch.matmul(q(x), q(w).t()) + b


# ----------------------------------------------------------------------------
# random streams: frozen copies of the training recipe's rules

AUGMENT_STREAM = 2**32  # the augment stream's seed is the step seed plus this
SALT_BH = 40499  # attention mask: seed + (b·heads + h)·SALT_BH
SALT_SITE2 = 7919  # the FF's second site: seed + SALT_SITE2
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_keep(seed, rows: torch.Tensor, cols: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep factors (0 or 1/(1 − rate)) of the counter hash: the murmur3
    finaliser of (row·2654435761) ^ (col·97538843) ^ seed in uint32, kept
    iff ≥ rate·2³²; ``rows``, ``cols`` (int64) and ``seed`` broadcast."""
    x = _mul32(rows, 2654435761) ^ _mul32(cols, 97538843) ^ (torch.as_tensor(seed, dtype=torch.int64, device=rows.device) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    thresh = min(int(rate * 4294967296.0), 4294967295)
    return (x >= thresh).float() / torch.tensor(1.0 - rate, dtype=torch.float32)


def row_col_keep(seed: int, n: int, m: int, rate: float, device) -> torch.Tensor:
    return hash_keep(seed, torch.arange(n, device=device)[:, None], torch.arange(m, device=device)[None, :], rate)


class Streams:
    """The random streams of a training run, each seeded once and drawn on
    from step to step: dropout (a CPU generator seeded with the run's step
    seed) and SpecAugment (one seeded with it plus AUGMENT_STREAM)."""

    def __init__(self, seed: int, rate: float):
        self.gen = torch.Generator().manual_seed(int(seed))
        self.augment = torch.Generator().manual_seed(AUGMENT_STREAM + int(seed))
        self.rate = rate

    def seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.gen))

    def uniform_drop(self, x: torch.Tensor) -> torch.Tensor:
        """Inverted dropout with a uniform draw of x's shape from a generator on x's device seeded from the stream."""
        g = torch.Generator(device=x.device)
        g.manual_seed(self.seed())
        keep = torch.rand(x.shape, generator=g, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), device=x.device))


# ----------------------------------------------------------------------------
# frontend and SpecAugment


def _hertz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_matrix(mels: int, bins: int, sample_rate: int) -> np.ndarray:
    """HTK triangular filters [bins, mels] from 0 Hz to the Nyquist rate, a zero DC row."""
    freqs = np.linspace(0.0, sample_rate / 2.0, bins)[1:]
    m = _hertz_to_mel(freqs)[:, None]
    edges = np.linspace(_hertz_to_mel(0.0), _hertz_to_mel(sample_rate / 2.0), mels + 2)
    lo, ce, hi = edges[:-2][None], edges[1:-1][None], edges[2:][None]
    w = np.maximum(0.0, np.minimum((m - lo) / (ce - lo), (hi - m) / (hi - ce)))
    return np.pad(w, [[1, 0], [0, 0]])


def features(a: Arch, signal: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N] audio → ([B, T, mels] log-mel float32, [B] frame counts); the spectra in float64."""
    s = signal.double()
    s = torch.cat([s[:, :1], s[:, 1:] - a.preemphasis * s[:, :-1]], dim=1)
    n, step, fl = s.shape[1], a.frame_step, a.frame_length
    frames_n = -(-n // step)
    s = F.pad(s, (0, max(0, (frames_n - 1) * step + fl - n)))
    frames = s.unfold(1, fl, step)[:, :frames_n]
    window = torch.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(fl) / fl), dtype=torch.float64, device=s.device)
    power = torch.fft.rfft(frames * window, n=a.nfft, dim=-1).abs().square()
    mel = torch.tensor(mel_matrix(a.mels, a.nfft // 2 + 1, a.sample_rate), dtype=torch.float64, device=s.device)
    return torch.log(power @ mel + 1e-6).float(), -(-lengths.long() // step)


def spec_augment(a: Arch, x: torch.Tensor, flens: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Frequency masks, then time masks, drawn from the CPU ``gen``: per
    method a [3, B, masks] uniform draw (gate, width, start); an integer in
    [0, n) is floor(u·n) in float64."""
    b, t, f = x.shape
    dev = x.device
    if a.freq_masks:
        num, factor, prob, value = a.freq_masks
        u = torch.rand((3, b, num), generator=gen).double()
        on = (u[0] <= prob).double()
        width = torch.clamp_max(torch.floor(u[1] * max(factor, 1)), f) * on
        start = torch.floor(u[2] * torch.clamp_min(f - width, 1)) * on
        i = torch.arange(f, dtype=torch.float64)[None, None, :]
        cover = ((i >= start[..., None]) & (i < (start + width)[..., None])).any(dim=1)  # [B, F]
        x = x.masked_fill(cover[:, None, :].to(dev), value)
    if a.time_masks:
        num, p_upper, prob, value = a.time_masks
        u = torch.rand((3, b, num), generator=gen).double()
        on = (u[0] <= prob).double()
        length = flens.cpu().float()
        bound = torch.clamp_min(torch.floor(length * p_upper), 1.0).double()[:, None]
        length = length.double()[:, None]
        width = torch.clamp_max(torch.floor(u[1] * on * bound), length)
        start = torch.floor(torch.clamp_min(length - width, 1.0) * (u[2] * on))
        i = torch.arange(t, dtype=torch.float64)[None, None, :]
        cover = ((i >= start[..., None]) & (i < (start + width)[..., None])).any(dim=1)  # [B, T]
        x = x.masked_fill(cover[:, :, None].to(dev), value)
    return x


# ----------------------------------------------------------------------------
# encoder


def layer_norm(x, w, prefix):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], LN_EPS)


def batch_norm(x, w, prefix, train: bool, clip: bool):
    """Over the last (channel) axis: batch statistics over every other axis when training (E[x²] − E[x]²), else the running ones."""
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = (x * x).mean(dim=axes) - mean * mean
        if clip:
            var = var.clamp(min=0.0)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w[f"{prefix}.weight"] + w[f"{prefix}.bias"]


def subsample(a: Arch, w, x, flens, train: bool, q: Operands):
    """[B, T, F] → ([B, T/4, F/4·C], lengths)."""
    y = x[:, None]  # NCHW, H = time, W = frequency
    for i in range(len(a.filters)):
        y = F.pad(y, (2, 0, 2, 0))
        y = F.conv2d(q(y), q(w[f"encoder.subsampling.conv_{i}.weight"]), w[f"encoder.subsampling.conv_{i}.bias"], stride=2)
        y = F.silu(batch_norm(y.permute(0, 2, 3, 1), w, f"encoder.subsampling.norm_{i}", train, clip=True).permute(0, 3, 1, 2))
        flens = (flens + 1) // 2
    b, c, t, f = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, t, f * c), flens


def relative_encoding(d: int, t: int, lengths: torch.Tensor, device) -> torch.Tensor:
    """[B, 2T−1, D]: the interleaved sinusoid of positions T−1 … −(T−1), rolled per row by T − length and zero past 2·length − 1."""
    pos = torch.arange(t - 1, -t, -1, device=device).double()
    ts = torch.pow(torch.tensor(1e-4, dtype=torch.float64), (2.0 * (torch.arange(d, device=device) // 2)) / d)
    ang = pos[:, None] * ts[None, :]
    odd = (torch.arange(d, device=device) % 2).bool()
    pe = torch.where(odd, torch.cos(ang), torch.sin(ang)).float()  # [2T-1, D]
    r = 2 * t - 1
    lengths = lengths.long()
    idx = (torch.arange(r, device=device)[None, :] + (t - lengths)[:, None]) % r
    valid = torch.arange(r, device=device)[None, :] < (2 * lengths - 1)[:, None]
    return pe[idx] * valid[..., None]


def _ff(a: Arch, w, p, x, seed, q: Operands):
    n = x.shape[0] * x.shape[1]
    h = F.silu(linear(layer_norm(x, w, f"{p}.ln"), w[f"{p}.dense_1.weight"], w[f"{p}.dense_1.bias"], q))
    if seed is not None:
        h = h * row_col_keep(seed, n, h.shape[-1], a.dropout, x.device).view(h.shape)
    z = linear(h, w[f"{p}.dense_2.weight"], w[f"{p}.dense_2.bias"], q)
    if seed is not None:
        z = z * row_col_keep(seed + SALT_SITE2, n, z.shape[-1], a.dropout, x.device).view(z.shape)
    return x + a.ff_residual * z


def _mhsa(a: Arch, w, p, x, relpe, lengths, streams, q: Operands):
    b, t, _ = x.shape
    hn, hd = a.heads, a.head_size
    y = layer_norm(x, w, f"{p}.ln")
    m = f"{p}.mhsa"
    heads = lambda z: z.reshape(b, z.shape[1], hn, hd).transpose(1, 2)  # [B, H, L, hd]
    qh = heads(linear(y, w[f"{m}.query.weight"], w[f"{m}.query.bias"], q))
    k = heads(linear(y, w[f"{m}.key.weight"], w[f"{m}.key.bias"], q))
    v = heads(linear(y, w[f"{m}.value.weight"], w[f"{m}.value.bias"], q))
    pos = heads(linear(relpe, w[f"{m}.encoding.weight"], w[f"{m}.encoding.bias"], q))  # [B, H, 2T-1, hd]
    scale = 1.0 / math.sqrt(hd)
    cq = (qh + w["encoder.content_attention_bias"][None, :, None, :]) * scale
    pq = (qh + w["encoder.positional_attention_bias"][None, :, None, :]) * scale
    scores = torch.matmul(q(cq), q(k).transpose(-1, -2))  # [B, H, T, T]
    rel = torch.matmul(q(pq), q(pos).transpose(-1, -2))  # [B, H, T, 2T-1]
    idx = torch.arange(t, device=x.device)[None, :] + (t - 1 - torch.arange(t, device=x.device))[:, None]  # [T(query), T(key)]
    scores = scores + torch.gather(rel, 3, idx.expand(b, hn, t, t))
    past = torch.arange(t, device=x.device)[None, :] >= lengths.long()[:, None]  # [B, T] query rows past the length
    scores = scores + torch.where(past, NEG, 0.0)[:, None, :, None]
    prob = torch.softmax(scores, dim=-1)
    if streams is not None:
        seeds = (streams.seed() + torch.arange(b * hn, device=x.device) * SALT_BH).view(b, hn, 1, 1)
        prob = prob * hash_keep(seeds, torch.arange(t, device=x.device)[:, None], torch.arange(t, device=x.device)[None, :], a.dropout)
    out = torch.matmul(q(prob), q(v)).transpose(1, 2).reshape(b, t, hn * hd)
    out = linear(out, w[f"{m}.output.weight"], w[f"{m}.output.bias"], q)
    if streams is not None:
        out = streams.uniform_drop(out)
    return x + a.mhsa_residual * out


def _conv(a: Arch, w, p, x, seed, train: bool, q: Operands):
    b, t, d = x.shape
    y = layer_norm(x, w, f"{p}.ln")
    w1, b1 = w[f"{p}.pw_conv_1.weight"][:, :, 0], w[f"{p}.pw_conv_1.bias"]
    ga = linear(y, w1[:d], b1[:d], q)
    gb = linear(y, w1[d:], b1[d:], q)
    glu = (ga * torch.sigmoid(gb)).transpose(1, 2)  # [B, D, T]
    k = a.kernel_size
    y1 = F.conv1d(F.pad(q(glu), (k - 1, 0)), q(w[f"{p}.dw_conv.weight"]), w[f"{p}.dw_conv.bias"], groups=d).transpose(1, 2)
    bn = batch_norm(y1, w, f"{p}.dw_norm", train, clip=False)
    z = linear(F.silu(bn), w[f"{p}.pw_conv_2.weight"][:, :, 0], w[f"{p}.pw_conv_2.bias"], q)
    if seed is not None:
        z = z * row_col_keep(seed, b * t, d, a.dropout, x.device).view(z.shape)
    return x + a.conv_residual * z


def encode(a: Arch, w, signal, lengths, q: Operands = F32, streams: Streams | None = None):
    """Raw audio → (encoded [B, T', D], lengths'). With ``streams`` the
    training branch: SpecAugment and dropout drawn from them, BatchNorm on
    batch statistics."""
    train = streams is not None
    x, flens = features(a, signal, lengths)
    if train and (a.freq_masks or a.time_masks):
        x = spec_augment(a, x, flens, streams.augment)
    drop = streams if train and a.dropout > 0 else None
    x, elens = subsample(a, w, x, flens, train, q)
    x = linear(x, w["encoder.linear.weight"], w["encoder.linear.bias"], q)
    if drop is not None:
        x = drop.uniform_drop(x)
    relpe = relative_encoding(a.dmodel, x.shape[1], elens, x.device)
    for i in range(a.blocks):
        p = f"encoder.block_{i}"
        x = _ff(a, w, f"{p}.ff_module_1", x, None if drop is None else drop.seed(), q)
        x = _mhsa(a, w, f"{p}.mhsa_module", x, relpe, elens, drop, q)
        x = _conv(a, w, f"{p}.conv_module", x, None if drop is None else drop.seed(), train, q)
        x = _ff(a, w, f"{p}.ff_module_2", x, None if drop is None else drop.seed(), q)
        x = layer_norm(x, w, f"{p}.ln_post")
    return x, elens


# ----------------------------------------------------------------------------
# prediction net and joint


def lstm_cell(w, x, state, q: Operands):
    c, h = state
    p = "prediction.rnn_0.cell"
    gates = torch.matmul(q(x), q(w[f"{p}.weight_ih"]).t()) + torch.matmul(q(h), q(w[f"{p}.weight_hh"]).t()) + w[f"{p}.bias"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return c, h


def predict(a: Arch, w, tokens: torch.Tensor, lengths: torch.Tensor | None, q: Operands = F32) -> torch.Tensor:
    """[B, U+1] blank-prepended tokens → [B, U+1, H]: the LSTM scanned over every position, then LayerNorm."""
    b, u1 = tokens.shape
    x = w["prediction.embedding.embeddings.weight"][tokens.long()]
    if lengths is not None:
        x = x * (torch.arange(u1, device=x.device)[None, :] < lengths.to(x.device)[:, None])[..., None]
    state = (torch.zeros(b, a.rnn_units, device=x.device), torch.zeros(b, a.rnn_units, device=x.device))
    ys = []
    for i in range(u1):
        state = lstm_cell(w, x[:, i], state, q)
        ys.append(state[1])
    return layer_norm(torch.stack(ys, dim=1), w, "prediction.ln_0")


def project_encoder(w, enc, q: Operands = F32):
    return linear(enc, w["joint.enc.weight"], w["joint.enc.bias"], q)


def project_prediction(w, pred, q: Operands = F32):
    return linear(pred, w["joint.pred.weight"], w["joint.pred.bias"], q)


def joint_logits(w, enc_p, pred_p, q: Operands = F32):
    """[..., T, 1, J] + [..., 1, U, J] → [..., T, U, V]."""
    return linear(torch.tanh(enc_p + pred_p), w["joint.vocab.weight"], w["joint.vocab.bias"], q)
