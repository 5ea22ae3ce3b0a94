"""Conformer encoder, inference path (counterpart of
``tensorflowasr_tpu/models/encoders/conformer.py``).

subsampling → linear → relative PE → N × ConformerBlock, each block
FF(½) → rel-MHSA → conv module → FF(½) → LN. The modules dispatch to the
fused kernels under the JAX package's structural conditions
(``FFModule`` :203, ``ConvModule`` :337-345, rel-MHSA without an explicit
attention mask); the TPU shape gates and environment switches are not
ported. Configurations outside those conditions (post-norm modules,
trainable residual factors, group or layer-norm conv modules, vanilla
MHA), streaming memory and training are not ported yet and raise.
Parameter names mirror the JAX tree, so ``bridge.py`` maps one onto the
other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tensorflowasr_tpu_torch.models.layers.attention import MultiHeadRelativeAttention
from tensorflowasr_tpu_torch.models.layers.convolution import DepthwiseConv1D
from tensorflowasr_tpu_torch.models.layers.general import BatchNorm, Dense, LayerNorm
from tensorflowasr_tpu_torch.models.layers.positional import RelativeSinusoidalPositionalEncoding
from tensorflowasr_tpu_torch.models.layers.residual import residual
from tensorflowasr_tpu_torch.models.layers.subsampling import Conv2dSubsampling
from tensorflowasr_tpu_torch.ops.cuda.conv_kernel import conv_back, conv_front, depthwise_conv1d
from tensorflowasr_tpu_torch.ops.cuda.ff_kernel import fused_ff
from tensorflowasr_tpu_torch.utils import math_util


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def build_subsampling(config: dict, in_features: int, dtype=torch.float32) -> Conv2dSubsampling:
    """Subsampling module from a reference-style config dict (Conv2dSubsampling only)."""
    cls_name = config["class_name"].split(">")[-1]
    if cls_name != "Conv2dSubsampling":
        raise NotImplementedError(f"subsampling {cls_name!r} is not ported yet")
    cfg = dict(config.get("config", {}))
    n = len(cfg["filters"])
    return Conv2dSubsampling(
        in_features,
        filters=tuple(cfg["filters"]),
        strides=tuple(_pair(s) for s in cfg.get("strides", [2, 2])),
        kernels=tuple(_pair(k) for k in cfg.get("kernels", [3, 3])),
        paddings=tuple(cfg.get("paddings", ["causal"] * n)),
        norms=tuple(cfg.get("norms", ["none"] * n)),
        activations=tuple(cfg.get("activations", ["relu"] * n)),
        dtype=dtype,
    )


class FFModule(nn.Module):
    """Half-step feed-forward module, pre-norm: the fused ``fused_ff`` path."""

    def __init__(self, input_dim: int, scale_factor: int = 4, residual_factor: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.residual_factor, self.dtype = float(residual_factor), dtype
        self.ln = LayerNorm(input_dim, dtype=dtype)
        self.dense_1 = Dense(input_dim, scale_factor * input_dim, dtype)
        self.dense_2 = Dense(scale_factor * input_dim, input_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w = lambda dense: dense.weight.t().contiguous().to(dt)  # [in, out], the JAX kernel layout
        out = fused_ff(
            x.reshape(-1, x.shape[-1]).contiguous(), self.ln.weight, self.ln.bias,
            w(self.dense_1), self.dense_1.bias.to(dt), w(self.dense_2), self.dense_2.bias.to(dt),
            0, 0.0, self.residual_factor, 1e-3,
        )
        return out.reshape(x.shape)


class MHSAModule(nn.Module):
    """Pre-norm relative MHSA with residual. Padded keys stay visible
    (the reference masks query rows only, ``mask_kv=False``)."""

    def __init__(self, dmodel: int, head_size: int, num_heads: int, residual_factor: float = 1.0, relmha_causal: bool = False,
                 chunk_size: Optional[int] = None, history_size: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.residual_factor = residual_factor
        self.ln = LayerNorm(dmodel, dtype=dtype)
        self.mhsa = MultiHeadRelativeAttention(dmodel, num_heads, head_size, dmodel, causal=relmha_causal, chunk_size=chunk_size,
                                               history_size=history_size, dtype=dtype)

    def forward(self, x, relpe, *, mask=None, content_attention_bias=None, positional_attention_bias=None, use_causal_mask: bool = False):
        y = self.ln(x)
        out = self.mhsa(y, y, relpe=relpe, content_attention_bias=content_attention_bias, positional_attention_bias=positional_attention_bias,
                        query_mask=mask, use_causal_mask=use_causal_mask)
        return residual(x, out, self.residual_factor)


class ConvModule(nn.Module):
    """Pre-norm conv module with batch norm: ``conv_front`` → library
    depthwise conv → ``conv_back`` with the running statistics."""

    def __init__(self, input_dim: int, kernel_size: int = 32, padding: str = "causal", residual_factor: float = 1.0, dtype=torch.float32):
        super().__init__()
        if padding not in ("causal", "same"):
            raise ValueError(f"conv-module padding {padding!r} must be causal or same")
        self.padding, self.residual_factor, self.dtype = padding, float(residual_factor), dtype
        d = input_dim
        self.ln = LayerNorm(d, dtype=dtype)
        self.pw_conv_1 = _PointwiseConv(d, 2 * d)
        self.dw_conv = DepthwiseConv1D(d, kernel_size, padding=padding, dtype=dtype)
        self.dw_norm = BatchNorm(d, dtype=dtype)
        self.pw_conv_2 = _PointwiseConv(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, d = self.dtype, x.shape[-1]
        w1 = self.pw_conv_1.weight[:, :, 0].t()  # [D, 2D], the JAX kernel layout
        b1 = self.pw_conv_1.bias
        glu = conv_front(x.contiguous(), self.ln.weight, self.ln.bias, w1[:, :d].contiguous().to(dt), b1[:d].to(dt),
                         w1[:, d:].contiguous().to(dt), b1[d:].to(dt))
        y1 = depthwise_conv1d(glu, self.dw_conv.weight, self.dw_conv.bias, self.padding).contiguous()
        bn = self.dw_norm
        return conv_back(x.contiguous(), y1, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         self.pw_conv_2.weight[:, :, 0].t().contiguous().to(dt), self.pw_conv_2.bias.to(dt), 0, 0.0, self.residual_factor)


class _PointwiseConv(nn.Module):
    """Parameters of a kernel-size-1 ``Conv1D`` (weight [out, in, 1]); the
    fused kernels read them as a [in, out] matrix."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))


class ConformerBlock(nn.Module):
    def __init__(self, input_dim: int, ffm_scale_factor: int = 4, ffm_residual_factor: float = 0.5, head_size: int = 36, num_heads: int = 4,
                 mhsam_residual_factor: float = 1.0, mhsam_causal: bool = False, kernel_size: int = 32, padding: str = "causal",
                 convm_residual_factor: float = 1.0, chunk_size: Optional[int] = None, history_size: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.ff_module_1 = FFModule(input_dim, ffm_scale_factor, ffm_residual_factor, dtype)
        self.mhsa_module = MHSAModule(input_dim, head_size, num_heads, mhsam_residual_factor, mhsam_causal, chunk_size, history_size, dtype)
        self.conv_module = ConvModule(input_dim, kernel_size, padding, convm_residual_factor, dtype)
        self.ff_module_2 = FFModule(input_dim, ffm_scale_factor, ffm_residual_factor, dtype)
        self.ln_post = LayerNorm(input_dim, dtype=dtype)

    def forward(self, x, relpe, mask=None, content_attention_bias=None, positional_attention_bias=None, use_causal_mask: bool = False):
        x = self.ff_module_1(x)
        x = self.mhsa_module(x, relpe, mask=mask, content_attention_bias=content_attention_bias,
                             positional_attention_bias=positional_attention_bias, use_causal_mask=use_causal_mask)
        x = self.conv_module(x)
        x = self.ff_module_2(x)
        return self.ln_post(x)


# Options of the JAX ConformerEncoder whose non-default values are not ported yet.
_UNPORTED = {
    "mha_type": "relmha", "module_norm_position": "pre", "block_norm_position": "post", "convm_scale_factor": 2, "convm_use_group_conv": False,
    "convm_dw_norm_type": "batch", "mhsam_use_attention_bias": False, "memory_length": None, "use_attention_auto_mask": True,
}


class ConformerEncoder(nn.Module):
    """``forward(features [B, T, F], lengths) → (encoded [B, T', D], lengths')``."""

    def __init__(self, subsampling: dict, in_features: int, dmodel: int = 144, num_blocks: int = 16, head_size: int = 36, num_heads: int = 4,
                 kernel_size: int = 32, padding: str = "causal", interleave_relpe: bool = True, use_attention_causal_mask: bool = False,
                 ffm_scale_factor: int = 4, ffm_residual_factor: float = 0.5, mhsam_residual_factor: float = 1.0, mhsam_causal: bool = False,
                 convm_residual_factor: float = 1.0, dropout: float = 0.1, chunk_size: Optional[int] = None, history_size: Optional[int] = None,
                 use_remat: bool = False, dtype=torch.float32, **options):
        super().__init__()
        for key, value in options.items():
            if key not in _UNPORTED:
                raise TypeError(f"unknown ConformerEncoder option {key!r}")
            if value != _UNPORTED[key]:
                raise NotImplementedError(f"ConformerEncoder {key}={value!r} is not ported yet")
        del dropout, use_remat  # training-only options
        self.num_blocks, self.num_heads, self.head_size = num_blocks, num_heads, head_size
        self.use_attention_causal_mask = use_attention_causal_mask
        self.subsampling = build_subsampling(subsampling, in_features, dtype)
        self.linear = Dense(self.subsampling.output_dim, dmodel, dtype)
        self.relpe = RelativeSinusoidalPositionalEncoding(interleave=interleave_relpe, causal=mhsam_causal, dtype=dtype)
        self.content_attention_bias = nn.Parameter(torch.zeros(num_heads, head_size))
        self.positional_attention_bias = nn.Parameter(torch.zeros(num_heads, head_size))
        for i in range(num_blocks):
            self.add_module(f"block_{i}", ConformerBlock(
                dmodel, ffm_scale_factor, ffm_residual_factor, head_size, num_heads, mhsam_residual_factor, mhsam_causal, kernel_size,
                padding, convm_residual_factor, chunk_size, history_size, dtype,
            ))

    @property
    def time_reduction_factor(self) -> int:
        return self.subsampling.time_reduction_factor

    def output_length(self, length):
        return self.subsampling.output_length(length)

    def forward(self, features: torch.Tensor, features_length: torch.Tensor):
        if features.dim() == 3:
            features = features[..., None]
        x, lengths = self.subsampling(features, features_length)
        x = self.linear(x)
        x, relpe = self.relpe(x, lengths)
        mask = math_util.sequence_mask(lengths, x.shape[1])
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, relpe, mask, self.content_attention_bias, self.positional_attention_bias, self.use_attention_causal_mask)
        return x, lengths
