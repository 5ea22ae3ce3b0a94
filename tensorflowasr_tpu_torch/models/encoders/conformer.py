"""Conformer encoder (counterpart of
``tensorflowasr_tpu/models/encoders/conformer.py``), with every option of
the JAX encoder.

subsampling (Conv2d, Conv1d or VGG) → linear → relative (or, for vanilla
MHA, absolute) PE → N × ConformerBlock, each block FF(½) → MHSA → conv
module → FF(½) → LN. The modules dispatch to the fused kernels under the
JAX package's structural conditions, condition for condition: the FF
kernel under pre-norm with a numeric residual factor (``FFModule`` :203),
the conv kernels under pre-norm, batch norm, scale 2, no group conv and a
numeric factor (``ConvModule`` :337-346); relative MHA runs kernel B
(kernel A under an explicit attention mask), vanilla MHA kernel A. Any
other configuration (post- or no module norm, trainable residual factors,
a grouped or layer-norm conv module, another conv scale) runs the plain
modules, on the card too. The TPU shape gates and environment switches
are not ported. ``MHSAModule`` is also the Transformer encoder's
(``encoders/transformer.py``). With ``memory_length`` each block's attention keeps
a KV memory (``init_state`` and ``forward(initial_state=...)``, JAX
``ConformerEncoder.init_state`` / ``__call__``), the streaming state that
``recognize`` carries from chunk to chunk. Parameter names mirror the JAX
tree, so ``bridge.py`` maps one onto the other.

``train=True`` is the JAX training branch: dropout at the encoder's rate
(in-kernel in the FF, attention and conv kernels, each under a seed drawn
once per call site from the step's ``generator``; plain ``dr.dropout`` after
the input linear and on the MHSA output, as flax ``nn.Dropout`` there), and
BatchNorm on batch statistics with the running-statistics update.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.layers.attention import MemoryState, MultiHeadAttention, MultiHeadRelativeAttention
from tensorflowasr_tpu_torch.models.layers.convolution import Conv1D, DepthwiseConv1D
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, Dense, LayerNorm, make_norm
from tensorflowasr_tpu_torch.models.layers.positional import RelativeSinusoidalPositionalEncoding, SinusoidalPositionalEncoding
from tensorflowasr_tpu_torch.models.layers.residual import Residual, is_trainable
from tensorflowasr_tpu_torch.models.layers.subsampling import Conv1dSubsampling, Conv2dSubsampling, VggSubsampling
from tensorflowasr_tpu_torch.ops import dropout as dr
from tensorflowasr_tpu_torch.ops import routes
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel, ff_kernel
from tensorflowasr_tpu_torch.ops.cuda.conv_kernel import conv_back, conv_front, depthwise_conv1d
from tensorflowasr_tpu_torch.ops.cuda.ff_kernel import fused_ff
from tensorflowasr_tpu_torch.utils import math_util


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def build_subsampling(config: dict, in_features: int, dtype=torch.float32) -> nn.Module:
    """Subsampling module from a reference-style config dict (JAX
    ``build_subsampling``): Conv2dSubsampling, Conv1dSubsampling or VggSubsampling."""
    cls_name = config["class_name"].split(">")[-1]
    cfg = dict(config.get("config", {}))
    if cls_name == "VggSubsampling":
        return VggSubsampling(in_features, filters=tuple(cfg.get("filters", (32, 64))), kernel_size=cfg.get("kernel_size", 3),
                              pool_size=cfg.get("pool_size", 2), strides=cfg.get("strides", 2), padding=cfg.get("padding", "same"),
                              activation=cfg.get("activation", "relu"), dtype=dtype)
    if cls_name not in ("Conv2dSubsampling", "Conv1dSubsampling"):
        raise KeyError(f"Unknown subsampling class {config['class_name']!r}")
    n = len(cfg["filters"])
    one_d = cls_name == "Conv1dSubsampling"
    return (Conv1dSubsampling if one_d else Conv2dSubsampling)(
        in_features,
        filters=tuple(cfg["filters"]),
        strides=tuple(cfg.get("strides", [2, 2]) if one_d else (_pair(s) for s in cfg.get("strides", [2, 2]))),
        kernels=tuple(cfg.get("kernels", [3, 3]) if one_d else (_pair(k) for k in cfg.get("kernels", [3, 3]))),
        paddings=tuple(cfg.get("paddings", ["causal"] * n)),
        norms=tuple(cfg.get("norms", ["none"] * n)),
        activations=tuple(cfg.get("activations", ["relu"] * n)),
        dtype=dtype,
    )


NORM_POSITIONS = ("pre", "post", "none")


def _layer_norm_unless_none(module: nn.Module, position: str, dim: int, dtype) -> None:
    if position not in NORM_POSITIONS:
        raise ValueError(f"norm position {position!r} must be one of {NORM_POSITIONS}")
    if position != "none":
        module.ln = LayerNorm(dim, dtype=dtype)


class FFModule(nn.Module):
    """Half-step feed-forward module (JAX ``FFModule``): LN (``norm_position``
    pre) → dense 4D → swish → dropout → dense → dropout → LN (post) → residual.
    Pre-norm with a numeric residual factor runs the fused ``fused_ff``
    kernel (JAX :203) at the widths it takes (``ff_kernel.supported``); any
    other configuration or width the plain modules. ``route`` says which the
    last call took: "kernel", "plain" (a width the kernel refuses) or
    "config" (a configuration JAX runs without its kernel)."""

    def __init__(self, input_dim: int, scale_factor: int = 4, residual_factor: float | str = 0.5, dropout: float = 0.0, dtype=torch.float32,
                 norm_position: str = "pre"):
        super().__init__()
        self.dropout, self.dtype, self.norm_position = float(dropout), dtype, norm_position
        _layer_norm_unless_none(self, norm_position, input_dim, dtype)
        self.dense_1 = Dense(input_dim, scale_factor * input_dim, dtype)
        self.dense_2 = Dense(scale_factor * input_dim, input_dim, dtype)
        self.residual = Residual(residual_factor)
        self.fused = norm_position == "pre" and not is_trainable(residual_factor)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        rate = dr.active_rate(self.dropout, train, generator)
        self.route = "config" if not self.fused else "kernel" if routes.take(
            "fused_ff", ff_kernel.supported(x.shape[-1], self.dense_1.weight.shape[0], x.dtype)) else "plain"
        if self.route != "kernel":
            out = self.ln(x) if self.norm_position == "pre" else x
            out = dr.dropout(F.silu(self.dense_1(out)), rate, generator)
            out = dr.dropout(self.dense_2(out), rate, generator)
            if self.norm_position == "post":
                out = self.ln(out)
            return self.residual(x, out)
        w = lambda dense: dense.weight.t().contiguous().to(dt)  # [in, out], the JAX kernel layout
        out = fused_ff(
            x.reshape(-1, x.shape[-1]).contiguous(), self.ln.weight, self.ln.bias,
            w(self.dense_1), self.dense_1.bias.to(dt), w(self.dense_2), self.dense_2.bias.to(dt),
            dr.draw_seed(generator) if rate > 0.0 else 0, rate, self.residual.value, 1e-3,
        )
        return out.reshape(x.shape)


class MHSAModule(nn.Module):
    """MHSA with residual (JAX ``MHSAModule``): relative (``mha_type="relmha"``,
    kernel B) or vanilla (``"mha"``, kernel A) attention, LayerNorm before it
    (``norm_position="pre"``), after the output dropout before the residual
    (``"post"``) or nowhere (``"none"``). Padded keys stay visible (the
    reference masks query rows only, ``mask_kv=False``)."""

    def __init__(self, dmodel: int, head_size: int, num_heads: int, residual_factor: float | str = 1.0, relmha_causal: bool = False,
                 chunk_size: Optional[int] = None, history_size: Optional[int] = None, dropout: float = 0.0, dtype=torch.float32,
                 mha_type: str = "relmha", norm_position: str = "pre", use_attention_bias: bool = False, memory_length: Optional[int] = None):
        super().__init__()
        if mha_type not in ("relmha", "mha"):
            raise ValueError(f"mha_type {mha_type!r} must be relmha or mha")
        self.dropout, self.mha_type, self.norm_position = float(dropout), mha_type, norm_position
        _layer_norm_unless_none(self, norm_position, dmodel, dtype)
        if mha_type == "relmha":
            self.mhsa = MultiHeadRelativeAttention(dmodel, num_heads, head_size, dmodel, causal=relmha_causal, chunk_size=chunk_size,
                                                   history_size=history_size, dropout=dropout, dtype=dtype, use_attention_bias=use_attention_bias,
                                                   memory_length=memory_length)
        else:
            self.mhsa = MultiHeadAttention(dmodel, num_heads, head_size, output_dim=dmodel, dropout=dropout, chunk_size=chunk_size,
                                           history_size=history_size, dtype=dtype, memory_length=memory_length)
        self.residual = Residual(residual_factor)

    def forward(self, x, relpe, *, mask=None, content_attention_bias=None, positional_attention_bias=None, memory_state=None,
                use_causal_mask: bool = False, train: bool = False, generator: Optional[torch.Generator] = None):
        """Returns ``(out, new_memory)`` (``new_memory`` None without a memory)."""
        y = self.ln(x) if self.norm_position == "pre" else x
        if self.mha_type == "relmha":
            out, new_memory = self.mhsa(y, y, relpe=relpe, content_attention_bias=content_attention_bias,
                                        positional_attention_bias=positional_attention_bias, query_mask=mask, use_causal_mask=use_causal_mask,
                                        memory_state=memory_state, train=train, generator=generator)
        else:
            out, new_memory = self.mhsa(y, y, query_mask=mask, use_causal_mask=use_causal_mask, memory_state=memory_state, train=train,
                                        generator=generator)
        out = dr.dropout(out, dr.active_rate(self.dropout, train, generator), generator)
        if self.norm_position == "post":
            out = self.ln(out)
        return self.residual(x, out), new_memory


class ConvModule(nn.Module):
    """Conv module (JAX ``ConvModule``): LN (pre) → pointwise ×``scale_factor``
    → GLU → depthwise (or grouped, ``use_group_conv``) conv → BatchNorm /
    LayerNorm / none (``dw_norm_type``) → swish → pointwise → dropout → LN
    (post) → residual. Under JAX's condition (pre-norm, batch norm, scale 2,
    no group conv, a numeric residual factor; :337-346) it runs the fused
    route: ``conv_front`` → library depthwise conv → ``conv_back`` with the
    running statistics, at the widths the kernels take
    (``conv_kernel.supported``); otherwise the plain modules. ``route`` as
    :class:`FFModule`'s."""

    def __init__(self, input_dim: int, kernel_size: int = 32, padding: str = "causal", residual_factor: float | str = 1.0, dropout: float = 0.0,
                 dtype=torch.float32, scale_factor: int = 2, norm_position: str = "pre", dw_norm_type: str = "batch", use_group_conv: bool = False):
        super().__init__()
        if padding not in ("causal", "same"):
            raise ValueError(f"conv-module padding {padding!r} must be causal or same")
        self.padding, self.dropout, self.dtype, self.norm_position = padding, float(dropout), dtype, norm_position
        d = input_dim
        glu_dim = scale_factor * d // 2
        _layer_norm_unless_none(self, norm_position, d, dtype)
        self.pw_conv_1 = _PointwiseConv(d, scale_factor * d)
        if use_group_conv:  # JAX Conv1D(filters=D, groups=D) over the GLU's scale·D/2 channels
            self.dw_conv = Conv1D(glu_dim, d, kernel_size, padding=padding, groups=d, dtype=dtype)
        else:
            self.dw_conv = DepthwiseConv1D(glu_dim, kernel_size, padding=padding, dtype=dtype)
        dw_dim = d if use_group_conv else glu_dim
        self.dw_norm = make_norm(dw_norm_type, dw_dim, dtype=dtype)
        self.pw_conv_2 = _PointwiseConv(dw_dim, d)
        self.residual = Residual(residual_factor)
        self.fused = (norm_position == "pre" and dw_norm_type == "batch" and scale_factor == 2 and not use_group_conv
                      and not is_trainable(residual_factor))

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, d = self.dtype, x.shape[-1]
        rate = dr.active_rate(self.dropout, train, generator)
        self.route = "config" if not self.fused else "kernel" if routes.take("conv_module", conv_kernel.supported(d, x.dtype)) else "plain"
        if self.route != "kernel":
            return self._plain(x, rate, train, generator)
        w1 = self.pw_conv_1.weight[:, :, 0].t()  # [D, 2D], the JAX kernel layout
        b1 = self.pw_conv_1.bias
        glu = conv_front(x.contiguous(), self.ln.weight, self.ln.bias, w1[:, :d].contiguous().to(dt), b1[:d].to(dt),
                         w1[:, d:].contiguous().to(dt), b1[d:].to(dt))
        y1 = depthwise_conv1d(glu, self.dw_conv.weight, self.dw_conv.bias, self.padding).contiguous()
        bn = self.dw_norm
        # training: batch statistics over all B·T frames, padding included,
        # with the fast variance unclipped (conformer.py:368-371)
        mean, var = bn.batch_stats(y1, clip=False) if train else (bn.running_mean, bn.running_var)
        return conv_back(x.contiguous(), y1, mean, var, bn.weight, bn.bias, self.pw_conv_2.weight[:, :, 0].t().contiguous().to(dt),
                         self.pw_conv_2.bias.to(dt), dr.draw_seed(generator) if rate > 0.0 else 0, rate, self.residual.value)

    def _plain(self, x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        dt = self.dtype
        pointwise = lambda conv, y: F.linear(y.to(dt), conv.weight[:, :, 0].to(dt), conv.bias.to(dt))
        out = self.ln(x) if self.norm_position == "pre" else x
        a, gate = pointwise(self.pw_conv_1, out).chunk(2, dim=-1)
        out = self.dw_conv(a * torch.sigmoid(gate))
        out = self.dw_norm(out, train=train) if isinstance(self.dw_norm, BatchNorm) else self.dw_norm(out)
        out = dr.dropout(pointwise(self.pw_conv_2, F.silu(out)), rate, generator)
        if self.norm_position == "post":
            out = self.ln(out)
        return self.residual(x, out)


class _PointwiseConv(nn.Module):
    """Parameters of a kernel-size-1 ``Conv1D`` (weight [out, in, 1]); the
    fused kernels read them as a [in, out] matrix."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class ConformerBlock(nn.Module):
    """FF(½) → MHSA → conv module → FF(½), with a LayerNorm before them
    (``block_norm_position="pre"``, ``ln_pre``) or after them (``"post"``,
    ``ln_post``, the default) or none."""

    def __init__(self, input_dim: int, ffm_scale_factor: int = 4, ffm_residual_factor: float | str = 0.5, head_size: int = 36, num_heads: int = 4,
                 mhsam_residual_factor: float | str = 1.0, mhsam_causal: bool = False, kernel_size: int = 32, padding: str = "causal",
                 convm_residual_factor: float | str = 1.0, chunk_size: Optional[int] = None, history_size: Optional[int] = None, dropout: float = 0.0,
                 dtype=torch.float32, mhsam_use_attention_bias: bool = False, memory_length: Optional[int] = None, mha_type: str = "relmha",
                 convm_scale_factor: int = 2, convm_use_group_conv: bool = False, convm_dw_norm_type: str = "batch", module_norm_position: str = "pre",
                 block_norm_position: str = "post"):
        super().__init__()
        if block_norm_position not in NORM_POSITIONS:
            raise ValueError(f"block_norm_position {block_norm_position!r} must be one of {NORM_POSITIONS}")
        self.block_norm_position = block_norm_position
        if block_norm_position == "pre":
            self.ln_pre = LayerNorm(input_dim, dtype=dtype)
        self.ff_module_1 = FFModule(input_dim, ffm_scale_factor, ffm_residual_factor, dropout, dtype, module_norm_position)
        self.mhsa_module = MHSAModule(input_dim, head_size, num_heads, mhsam_residual_factor, mhsam_causal, chunk_size, history_size, dropout, dtype,
                                      mha_type=mha_type, norm_position=module_norm_position, use_attention_bias=mhsam_use_attention_bias,
                                      memory_length=memory_length)
        self.conv_module = ConvModule(input_dim, kernel_size, padding, convm_residual_factor, dropout, dtype, convm_scale_factor, module_norm_position,
                                      convm_dw_norm_type, convm_use_group_conv)
        self.ff_module_2 = FFModule(input_dim, ffm_scale_factor, ffm_residual_factor, dropout, dtype, module_norm_position)
        if block_norm_position == "post":
            self.ln_post = LayerNorm(input_dim, dtype=dtype)

    def forward(self, x, relpe, mask=None, content_attention_bias=None, positional_attention_bias=None, memory_state=None,
                use_causal_mask: bool = False, train: bool = False, generator: Optional[torch.Generator] = None):
        """Returns ``(out, new_memory)`` (``new_memory`` None without a memory)."""
        if self.block_norm_position == "pre":
            x = self.ln_pre(x)
        x = self.ff_module_1(x, train, generator)
        x, new_memory = self.mhsa_module(x, relpe, mask=mask, content_attention_bias=content_attention_bias,
                                         positional_attention_bias=positional_attention_bias, memory_state=memory_state,
                                         use_causal_mask=use_causal_mask, train=train, generator=generator)
        x = self.conv_module(x, train, generator)
        x = self.ff_module_2(x, train, generator)
        if self.block_norm_position == "post":
            x = self.ln_post(x)
        return x, new_memory


class ConformerEncoder(nn.Module):
    """``forward(features [B, T, F], lengths, initial_state=None) → (encoded
    [B, T', D], lengths', new_states)``: ``new_states`` one KV memory per
    block (``initial_state`` given and ``memory_length`` set), else None.
    ``mha_type="mha"`` adds the absolute ``SinusoidalPositionalEncoding``
    (``pe``) and no attention biases; ``use_attention_auto_mask=False``
    gives the blocks no query mask."""

    def __init__(self, subsampling: dict, in_features: int, dmodel: int = 144, num_blocks: int = 16, mha_type: str = "relmha", head_size: int = 36,
                 num_heads: int = 4, kernel_size: int = 32, padding: str = "causal", interleave_relpe: bool = True,
                 use_attention_causal_mask: bool = False, use_attention_auto_mask: bool = True, ffm_scale_factor: int = 4,
                 ffm_residual_factor: float | str = 0.5, mhsam_residual_factor: float | str = 1.0, mhsam_use_attention_bias: bool = False,
                 mhsam_causal: bool = False, convm_scale_factor: int = 2, convm_residual_factor: float | str = 1.0, convm_use_group_conv: bool = False,
                 convm_dw_norm_type: str = "batch", dropout: float = 0.1, module_norm_position: str = "pre", block_norm_position: str = "post",
                 memory_length: Optional[int] = None, history_size: Optional[int] = None, chunk_size: Optional[int] = None, use_remat: bool = False,
                 dtype=torch.float32):
        super().__init__()
        del use_remat  # a memory knob of the JAX step; PyTorch keeps the activations
        if mha_type not in ("relmha", "mha"):
            raise ValueError(f"mha_type {mha_type!r} must be relmha or mha")
        self.num_blocks, self.num_heads, self.head_size, self.dropout = num_blocks, num_heads, head_size, float(dropout)
        self.dmodel, self.memory_length, self.mha_type = dmodel, memory_length, mha_type
        self.use_attention_causal_mask, self.use_attention_auto_mask = use_attention_causal_mask, use_attention_auto_mask
        self.subsampling = build_subsampling(subsampling, in_features, dtype)
        self.linear = Dense(self.subsampling.output_dim, dmodel, dtype)
        if mha_type == "relmha":
            self.relpe = RelativeSinusoidalPositionalEncoding(interleave=interleave_relpe, memory_length=memory_length, causal=mhsam_causal,
                                                              dtype=dtype)
        else:
            self.pe = SinusoidalPositionalEncoding(interleave=interleave_relpe)
        # encoder-global biases for relative MHA unless each attention layer owns its own (conformer.py:579-583)
        if mha_type != "relmha" or mhsam_use_attention_bias:
            self.content_attention_bias = self.positional_attention_bias = None
        else:
            self.content_attention_bias = nn.Parameter(torch.zeros(num_heads, head_size))
            self.positional_attention_bias = nn.Parameter(torch.zeros(num_heads, head_size))
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                dmodel, ffm_scale_factor, ffm_residual_factor, head_size, num_heads, mhsam_residual_factor, mhsam_causal, kernel_size,
                padding, convm_residual_factor, chunk_size, history_size, dropout, dtype, mhsam_use_attention_bias, memory_length, mha_type,
                convm_scale_factor, convm_use_group_conv, convm_dw_norm_type, module_norm_position, block_norm_position,
            ))

    @property
    def time_reduction_factor(self) -> int:
        return self.subsampling.time_reduction_factor

    def output_length(self, length):
        return self.subsampling.output_length(length)

    def init_state(self, batch: int, device=None) -> Optional[list]:
        """One zero KV memory per block, its mask all False (JAX ``init_state``); None without ``memory_length``."""
        if self.memory_length is None:
            return None
        return [MemoryState.init(batch, self.memory_length, self.dmodel, device=device) for _ in range(self.num_blocks)]

    def forward(self, features: torch.Tensor, features_length: torch.Tensor, initial_state: Optional[list] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``train``: the training branch; dropout needs a ``generator`` too (without one it is off)."""
        if features.dim() == 3:
            features = features[..., None]
        x, lengths = self.subsampling(features, features_length, train=train)
        x = self.linear(x)
        x = dr.dropout(x, dr.active_rate(self.dropout, train, generator), generator)
        x, relpe = self.relpe(x, lengths) if self.mha_type == "relmha" else self.pe(x, lengths)
        mask = math_util.sequence_mask(lengths, x.shape[1]) if self.use_attention_auto_mask else None
        new_states = []
        for i in range(self.num_blocks):
            mem = None if initial_state is None else initial_state[i]
            x, new_mem = getattr(self, f"block_{i}")(x, relpe, mask, self.content_attention_bias, self.positional_attention_bias, mem,
                                                     self.use_attention_causal_mask, train, generator)
            if new_mem is not None:
                new_states.append(new_mem)
        return x, lengths, (new_states or None)
