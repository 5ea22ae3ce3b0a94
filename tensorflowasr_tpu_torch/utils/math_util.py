"""Length arithmetic and masks (counterpart of ``tensorflowasr_tpu/utils/math_util.py``).

Works on Python ints and on integer tensors alike.
"""

from __future__ import annotations

import torch


def cdiv(a, b):
    return -(-a // b)


def get_nframes(nsamples, frame_length: int, frame_step: int, pad_end: bool = True, use_librosa_like_stft: bool = False, nfft: int | None = None):
    """STFT frame count: ``ceil(n / step)`` with ``pad_end``, else
    ``1 + (n - window) // step`` (window = nfft for librosa-style STFT)."""
    if pad_end:
        return cdiv(nsamples, frame_step)
    window = (nfft if nfft is not None else frame_length) if use_librosa_like_stft else frame_length
    return 1 + (nsamples - window) // frame_step


def conv_output_length(input_length, filter_size: int, padding: str, stride: int, dilation: int = 1):
    """Output length of a conv; ``padding`` in {same, valid, full, causal}."""
    if padding not in ("same", "valid", "full", "causal"):
        raise ValueError(f"unknown padding {padding!r}")
    dilated = filter_size + (filter_size - 1) * (dilation - 1)
    if padding in ("same", "causal"):
        out = input_length
    elif padding == "valid":
        out = input_length - dilated + 1
    else:
        out = input_length + dilated - 1
    return (out + stride - 1) // stride


def get_reduced_length(length, reduction_factor: int):
    return cdiv(length, reduction_factor)


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[..., maxlen] bool mask, True where position < length."""
    positions = torch.arange(maxlen, device=lengths.device)
    return positions < lengths.to(torch.int64).unsqueeze(-1)


def merge_two_last_dims(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
