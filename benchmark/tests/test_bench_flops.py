"""The operation counts behind ``mfu.*`` and ``roofline.*`` held to
``torch.utils.flop_counter.FlopCounterMode`` over the reference, at a small
unpadded size on the CPU, and independent of padding."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops
from benchmark.reference import model as rm
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def arch():
    return rm.arch_of(tiny.config(dropout=0.0)["model_config"])


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def weights(a):
    return rm.make_weights(a, 5, 0.0, torch.device("cpu"))


@pytest.mark.parametrize("samples", [4000, 9601, 16000])
def test_encoder_count_equals_the_counted_products(arch, samples):
    """One unpadded utterance through the reference's encoder: the counter sees every product the count names, except the FFT
    (which it does not count) and the relative scores' T × (T − 1) columns that the shift trick computes and the count leaves out."""
    w = weights(arch)
    audio = torch.randn(1, samples) * 0.1
    got = counted(lambda: rm.encode(arch, w, audio, torch.tensor([samples])))
    terms = flops.encoder_terms(arch, samples)
    t = flops.encoder_frames(arch, samples)
    shift_extra = arch.blocks * 2.0 * arch.heads * t * (t - 1) * arch.head_size
    assert got == pytest.approx(flops.encoder_flops(arch, samples) - terms["frontend_fft"] + shift_extra, rel=1e-9)


def test_train_utterance_count_equals_the_counted_forward(arch):
    """Encoder, prediction net and joint over one unpadded utterance's whole lattice."""
    w = weights(arch)
    samples, labels = 12000, 5
    audio = torch.randn(1, samples) * 0.1
    tokens = torch.tensor([[0, 3, 4, 5, 6, 7]])

    def forward():
        enc, _ = rm.encode(arch, w, audio, torch.tensor([samples]))
        pred = rm.predict(arch, w, tokens, torch.tensor([labels + 1]))
        rm.joint_logits(w, rm.project_encoder(w, enc)[:, :, None], rm.project_prediction(w, pred)[:, None])

    t = flops.encoder_frames(arch, samples)
    terms = flops.encoder_terms(arch, samples)
    shift_extra = arch.blocks * 2.0 * arch.heads * t * (t - 1) * arch.head_size
    want = flops.train_utterance_flops(arch, samples, labels) - terms["frontend_fft"] + shift_extra
    assert counted(forward) == pytest.approx(want, rel=1e-9)
    assert flops.train_step_flops(arch, [samples], [labels]) == pytest.approx(3 * flops.train_utterance_flops(arch, samples, labels))


def test_counts_do_not_see_padding(arch):
    """The counts take each utterance's real length: padding a batch (or reordering it) leaves them unchanged, and the
    reference's counted products grow with the padding while the count does not."""
    lens, labels = [9000, 12000, 4000], [3, 5, 2]
    assert flops.train_step_flops(arch, lens, labels) == flops.train_step_flops(arch, lens[::-1], labels[::-1])
    w = weights(arch)
    short = counted(lambda: rm.encode(arch, w, torch.zeros(1, 9000), torch.tensor([9000])))
    padded = counted(lambda: rm.encode(arch, w, torch.zeros(1, 16000), torch.tensor([9000])))
    assert padded > short
    assert flops.encoder_flops(arch, 9000) < flops.encoder_flops(arch, 16000)


def test_serve_count_grows_with_tokens(arch):
    base = flops.serve_utterance_flops(arch, 16000, 0)
    per_token = 2.0 * arch.joint_dim * arch.vocab + flops.lstm_step_flops(arch) + 2.0 * arch.rnn_units * arch.joint_dim
    assert flops.serve_utterance_flops(arch, 16000, 10) == pytest.approx(base + 10 * per_token)
