"""The general traffic generator: batches and requests from a traffic file's
parameters and the run's seed.

Every seed gets the same set of sizes: the lengths are drawn once from the
file's ``layout_seed`` (the lognormal of the JAX package's benchmark,
``bench.py:149-157``: around ``median`` seconds with ``sigma``, clipped to
[``min``, ``max``]) and grouped into the same batches or requests (training
batches dealt by rank, so that each holds about the same audio; requests as
drawn); the run's seed orders them and draws their content (audio noise on the device at the
file's ``amplitude``, shaped by its ``envelope`` where it has one; labels in [1, V)). The pool is held in pinned host
memory, as a data loader hands batches over.
"""

from __future__ import annotations

import numpy as np
import torch


def layout_lengths(traffic: dict, n: int) -> np.ndarray:
    """``n`` lengths in samples from the file's length distribution and layout seed."""
    ls = traffic["lengths_s"]
    rng = np.random.default_rng(traffic["layout_seed"])
    secs = np.clip(rng.lognormal(mean=np.log(ls["median"]), sigma=ls["sigma"], size=n), ls["min"], ls["max"])
    return (secs * traffic["sample_rate"]).astype(np.int64)


def _audio(lengths: np.ndarray, width: int, traffic: dict, gen: torch.Generator, device) -> torch.Tensor:
    """Noise at the file's ``amplitude``; with an ``envelope``, cut into segments of ``segment_s`` seconds, each at its own level
    (uniform over ``level_db`` dB below the amplitude) and spectral tilt (each sample plus ``tilt`` × its predecessor, ``tilt``
    uniform in ±``tilt``), so that frames differ as syllables and pauses do and not only by the noise."""
    x = torch.randn((len(lengths), width), generator=gen, device=device).mul_(traffic["amplitude"])
    env = traffic.get("envelope")
    if env:
        seg = int(env["segment_s"] * traffic["sample_rate"])
        n_seg = -(-width // seg)
        level = torch.empty((len(lengths), n_seg), device=device).uniform_(-env["level_db"], 0.0, generator=gen)
        tilt = torch.empty((len(lengths), n_seg), device=device).uniform_(-env["tilt"], env["tilt"], generator=gen)
        at = torch.arange(width, device=device) // seg
        x = (x + tilt[:, at] * torch.roll(x, 1, dims=1)).mul_(torch.pow(10.0, level[:, at] / 20.0))
    x.masked_fill_(torch.arange(width, device=device)[None, :] >= torch.as_tensor(lengths, device=device)[:, None], 0.0)
    return x


def _host(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied from the card straight into pinned host memory (the CPU tests keep theirs)."""
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x) if x.device.type == "cuda" else x


def train_pool(traffic: dict, vocab: int, seed: int, device) -> list:
    """``pool`` batches of ``batch`` utterances, each padded to ``pad_s`` seconds and ``max_labels`` labels:
    a list of dicts with the ``TrainData`` tensors' parts and the batch's real samples and labels."""
    b, pool = traffic["batch"], traffic["pool"]
    lens = np.sort(layout_lengths(traffic, b * pool)).reshape(b, pool).T  # dealt by rank: every batch holds one length of each stratum
    width = int(traffic["pad_s"] * traffic["sample_rate"])
    u_max = traffic["max_labels"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = []
    for i in rng.permutation(pool):
        n = lens[i]
        u = np.clip(np.round(n / traffic["sample_rate"] * traffic["tokens_per_s"]).astype(np.int64), 1, u_max)
        labels = rng.integers(1, vocab, (b, u_max))
        labels[np.arange(u_max)[None, :] >= u[:, None]] = 0
        preds = np.concatenate([np.zeros((b, 1), np.int64), labels], axis=1)
        out.append({"audio": _host(_audio(n, width, traffic, gen, device)), "audio_len": torch.tensor(n), "preds": torch.tensor(preds),
                    "preds_len": torch.tensor(u + 1), "labels": torch.tensor(labels), "labels_len": torch.tensor(u),
                    "samples": n.tolist(), "label_counts": u.tolist()})
    return out


def serve_pool(traffic: dict, seed: int, device) -> list:
    """``requests`` requests of ``batch`` utterances, each padded to its own longest: dicts with the audio, its lengths and the
    request's index in the layout."""
    b, n_req = traffic["batch"], traffic["requests"]
    lens = layout_lengths(traffic, b * n_req).reshape(n_req, b)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = []
    for r in rng.permutation(n_req):
        n = lens[r]
        out.append({"audio": _host(_audio(n, int(n.max()), traffic, gen, device)), "audio_len": torch.tensor(n), "layout_index": int(r),
                    "samples": n.tolist()})
    return out
