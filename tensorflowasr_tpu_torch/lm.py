"""Token-level n-gram language models for shallow-fusion beam search
(counterpart of ``tensorflowasr_tpu/lm.py``).

``NGramLM`` holds one dense table of log-probabilities, ``[V] * order``,
already interpolated across orders, so scoring is a gather: log p(token |
order − 1 previous tokens). The builders are the JAX module's numpy code,
copied: counts with add-k smoothing interpolated with the next lower order
(``from_token_corpus``, ``from_text_corpus``), or a token-level ARPA file
(log10 → ln, recursive backoff, ``unk_log10`` for unseen unigrams).

The table stays dense, as in JAX: V^order f32 entries, so a trigram over a
1000-token vocabulary takes 4 GB (order 2 takes 4 MB). Orders 1–3.
``score`` and ``beam_score_fn`` index it as a torch tensor on the device of
their arguments (a copy per device, made at the first call there);
``sequence_logprob`` runs on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

LOG10 = math.log(10.0)


class NGramLM:
    """Dense-table n-gram LM over token ids: ``table`` [V] * ``order``, ln p."""

    def __init__(self, table: np.ndarray, order: int, bos_id: int = 0):
        self.order = order
        self.table = torch.as_tensor(np.asarray(table, np.float32))  # [V]*order, on the host
        self.vocab_size = self.table.shape[-1]
        self.bos_id = bos_id
        self._on_device: dict[torch.device, torch.Tensor] = {}

    # ------------------------------ building -------------------------------- #

    @classmethod
    def from_token_corpus(cls, sequences: Sequence[Sequence[int]], vocab_size: int, order: int = 2, add_k: float = 0.5, interpolation: float = 0.3):
        """Count-based LM: the order-n estimate interpolated with the (n−1) one."""
        assert 1 <= order <= 3
        uni = np.full((vocab_size,), add_k, np.float64)
        for seq in sequences:
            for t in seq:
                uni[t] += 1
        p_uni = uni / uni.sum()
        if order == 1:
            return cls(np.log(p_uni).astype(np.float32), 1)

        bi = np.full((vocab_size, vocab_size), add_k, np.float64)
        for seq in sequences:
            prev = None
            for t in seq:
                if prev is not None:
                    bi[prev, t] += 1
                prev = t
        p_bi = bi / bi.sum(axis=-1, keepdims=True)
        p_bi = (1 - interpolation) * p_bi + interpolation * p_uni[None, :]
        if order == 2:
            return cls(np.log(p_bi).astype(np.float32), 2)

        tri = np.full((vocab_size, vocab_size, vocab_size), add_k, np.float64)
        for seq in sequences:
            for i in range(2, len(seq)):
                tri[seq[i - 2], seq[i - 1], seq[i]] += 1
        p_tri = tri / tri.sum(axis=-1, keepdims=True)
        p_tri = (1 - interpolation) * p_tri + interpolation * p_bi[None, :, :]
        return cls(np.log(p_tri).astype(np.float32), 3)

    @classmethod
    def from_text_corpus(cls, texts: Sequence[str], tokenizer, order: int = 2, **kwargs):
        """``from_token_corpus`` of each text's ``tokenizer.tokenize`` ids over ``tokenizer.num_classes``."""
        seqs = [np.asarray(tokenizer.tokenize(t)).tolist() for t in texts]
        return cls.from_token_corpus(seqs, tokenizer.num_classes, order=order, **kwargs)

    @classmethod
    def from_arpa(cls, path: str, token_to_id: dict, order: Optional[int] = None, unk_log10: float = -99.0):
        """Load a token-level ARPA file (log10 probabilities; backoffs folded
        into a dense table of the highest order by recursive backoff)."""
        grams: dict[int, dict[tuple, tuple]] = {}
        cur = None
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line.startswith("\\") and "-grams:" in line:
                    cur = int(line[1: line.index("-")])
                    grams[cur] = {}
                    continue
                if not line or line.startswith("\\") or "=" in line and cur is None:
                    continue
                if cur is None:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                logp = float(parts[0])
                toks = tuple(parts[1].split())
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
                grams[cur][toks] = (logp, backoff)
        max_order = order or max(grams)

        def lookup(ctx_toks: tuple, tok: str) -> float:
            key = (*ctx_toks, tok)
            if key in grams.get(len(key), {}):
                return grams[len(key)][key][0]
            if not ctx_toks:
                return grams.get(1, {}).get((tok,), (unk_log10, 0.0))[0]
            bo = grams.get(len(ctx_toks), {}).get(ctx_toks, (0.0, 0.0))[1]
            return bo + lookup(ctx_toks[1:], tok)

        names = [t for t, _ in sorted(token_to_id.items(), key=lambda kv: kv[1])]
        if max_order == 1:
            table = np.asarray([lookup((), t) for t in names], np.float64) * LOG10
            return cls(table.astype(np.float32), 1)
        if max_order == 2:
            table = np.asarray([[lookup((a,), b) for b in names] for a in names], np.float64) * LOG10
            return cls(table.astype(np.float32), 2)
        table = np.asarray([[[lookup((a, b), c) for c in names] for b in names] for a in names], np.float64) * LOG10
        return cls(table.astype(np.float32), 3)

    # ------------------------------- scoring -------------------------------- #

    def table_on(self, device) -> torch.Tensor:
        """The table on ``device`` (copied there once)."""
        device = torch.device(device)
        if device.type == "cpu":
            return self.table
        if device not in self._on_device:
            self._on_device[device] = self.table.to(device)
        return self._on_device[device]

    def score(self, context: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
        """log p(candidates | context): ``context`` [..., order − 1] previous
        ids (``bos_id`` padding), ``candidates`` [..., K] → [..., K]."""
        candidates = torch.as_tensor(candidates).long()
        table = self.table_on(candidates.device)
        if self.order == 1:
            return table[candidates]
        context = torch.as_tensor(context, device=candidates.device).long()
        if self.order == 2:
            return table[context[..., -1][..., None], candidates]
        return table[context[..., -2][..., None], context[..., -1][..., None], candidates]

    def beam_score_fn(self):
        """Adapter for ``ctc_beam_search_decode(lm_score_fn=...)``:
        (tokens [B, W, T], lengths [B, W], cand_ids [B, K]) → [B, W, K]."""

        def fn(tokens: torch.Tensor, lengths: torch.Tensor, cand_ids: torch.Tensor) -> torch.Tensor:
            b, w, t = tokens.shape
            # the last and second-to-last emitted tokens (bos where there are none)
            last = torch.gather(tokens, 2, (lengths - 1).clamp(0, t - 1)[..., None])[..., 0]
            last = torch.where(lengths > 0, last, self.bos_id)
            prev = torch.gather(tokens, 2, (lengths - 2).clamp(0, t - 1)[..., None])[..., 0]
            prev = torch.where(lengths > 1, prev, self.bos_id)
            context = torch.stack([prev, last], dim=-1)  # [B, W, 2]
            return self.score(context, cand_ids[:, None, :].expand(b, w, cand_ids.shape[-1]))

        return fn

    def sequence_logprob(self, tokens: Sequence[int]) -> float:
        """Total log p of a token sequence, on the host."""
        table = self.table.numpy()
        ctx = [self.bos_id] * max(self.order - 1, 0)
        total = 0.0
        for t in tokens:
            total += float(table[tuple(ctx[len(ctx) - (self.order - 1):]) + (int(t),)])
            ctx.append(int(t))
        return total
