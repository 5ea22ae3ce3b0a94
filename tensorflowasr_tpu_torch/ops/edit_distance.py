"""Batched edit distance on the device (counterpart of
``tensorflowasr_tpu/ops/edit_distance.py``).

A Levenshtein DP over padded token arrays: one step per hypothesis
position, carrying the DP row over reference positions. Within a step the
row's dependence on its own previous entry is resolved by a running
minimum (``torch.cummin``, where JAX takes ``lax.associative_scan`` of
minima). Plain PyTorch: the JAX function is a ``lax.scan``, not a TPU
kernel. A WER or CER on the card without copying the tokens to the host.
"""

from __future__ import annotations

import torch


def edit_distance(ref: torch.Tensor, ref_len: torch.Tensor, hyp: torch.Tensor, hyp_len: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance per batch row between ``ref[b, :ref_len[b]]``
    and ``hyp[b, :hyp_len[b]]``: ref [B, U], hyp [B, V] int tokens,
    lengths [B]; returns [B] int64 on ``ref``'s device."""
    b, u = ref.shape
    dev = ref.device
    ref_len, hyp_len, hyp = ref_len.to(dev, torch.int64), hyp_len.to(dev, torch.int64), hyp.to(dev)
    offs = torch.arange(u, device=dev)
    row = torch.arange(u + 1, device=dev).expand(b, u + 1)  # row[j] = distance(ref[:j], hyp[:i])
    for i in range(hyp.shape[1]):
        sub = (ref != hyp[:, i : i + 1]).to(torch.int64)  # [B, U]
        # new_row[j+1] = min(row[j+1] + 1, row[j] + sub[j], new_row[j] + 1): the candidates without
        # new_row, then the prefix fix-up min over k <= j of (cand[k] + j - k) as a running minimum
        cand = torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)
        run_min = torch.cummin(torch.clamp(cand - offs, max=i + 1), dim=1).values
        new_row = torch.cat([torch.full((b, 1), i + 1, dtype=torch.int64, device=dev), run_min + offs], dim=1)
        row = torch.where((i < hyp_len)[:, None], new_row, row)  # rows past their hypothesis stay
    return row.gather(1, ref_len[:, None])[:, 0]


def wer_on_device(ref, ref_len, hyp, hyp_len) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of edit distances, sum of reference lengths) for a streaming error rate."""
    return edit_distance(ref, ref_len, hyp, hyp_len).sum(), ref_len.to(ref.device, torch.int64).sum()
