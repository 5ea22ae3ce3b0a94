"""The plain reference held to the program at a tiny width on the CPU, in
float32 on seeded weights: a training step's loss, every gradient and the
parameters after three Adam steps (dropout and SpecAugment on, their masks
worked out again by the reference), and ``recognize``'s encoder output and
tokens."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import serve, train
from benchmark.harness import traffic as tr
from benchmark.reference import loss as rl
from benchmark.reference import model as rm
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def arch():
    return rm.arch_of(tiny.config()["model_config"])


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_train_steps_equal_the_program(arch, seed):
    cfg = tiny.config()
    s = train.seeds(seed)
    weights = rm.make_weights(arch, s["weights"], cfg["blank_bias"], CPU)
    items = tr.train_pool(tiny.TRAIN, arch.vocab, s["content"], CPU)[:train.CHECK_STEPS]
    prog = train.Program(cfg, weights, s["steps"], CPU)
    got = prog.first_steps(items, weights)
    ref = train.reference_steps(arch, cfg["optimizer"], weights, items, s["steps"], rm.F32, cfg["reference_rows"])
    numbers = train.compare(got, ref)
    assert numbers["loss_gap"] < 2e-6 and numbers["grad_gap"] < 2e-5 and numbers["change_gap"] < 2e-5, numbers
    med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    for name, p in prog.model.named_parameters():  # every parameter after the three updates but those that move by round-off alone
        if ref["grad"][name] < 1e-3 * med:  # (a bias before a BatchNorm: its gradient is 0 to rounding)
            continue
        # Adam moves an element by ±lr whatever its gradient's size, so an element whose gradient is 0 to rounding may step the
        # other way: at most a few in a thousand may differ
        off = ~torch.isclose(p.detach(), ref["params"][name], rtol=1e-4, atol=1e-6)
        assert int(off.sum()) <= max(1, off.numel() // 200), (name, int(off.sum()), off.numel())


def test_serving_equals_the_program(arch):
    cfg = tiny.config()
    s = train.seeds(4242)
    weights = rm.make_weights(arch, s["weights"], cfg["blank_bias"], CPU)
    prog = serve.Program(cfg, weights, CPU)
    for item in tr.serve_pool(tiny.SERVE, s["content"], CPU)[:2]:
        rows = prog.serve(item)
        with torch.no_grad():
            enc, elens = rm.encode(arch, weights, item["audio"], item["audio_len"])
            got, got_len, _ = prog.model.encode(item["audio"], item["audio_len"])
        assert torch.equal(elens, got_len)
        torch.testing.assert_close(got, enc, rtol=1e-4, atol=2e-5)
        ref = rl.greedy_decode(arch, weights, enc, elens)
        assert [r.tolist() for r in rows] == [r.tolist() for r in ref]
        assert max(serve.request_gaps(arch, weights, item, rows)) == 0.0


def test_served_gap_reads_a_wrong_token(arch):
    """A token replaced, dropped or added reads a gap; the served row itself reads 0."""
    cfg = tiny.config()
    weights = rm.make_weights(arch, 77, cfg["blank_bias"], CPU)
    item = tr.serve_pool(tiny.SERVE, 78, CPU)[0]
    with torch.no_grad():
        enc, elens = rm.encode(arch, weights, item["audio"], item["audio_len"])
    row = rl.greedy_decode(arch, weights, enc, elens)[0]
    assert len(row) > 1
    assert serve.request_gaps(arch, weights, item, [row])[0] == 0.0
    swapped = row.clone()
    swapped[0] = swapped[0] % (arch.vocab - 1) + 1
    for bad in (swapped, row[1:], torch.cat([row, row[-1:]])):
        assert serve.request_gaps(arch, weights, item, [bad])[0] > 1e-3


def test_rnnt_loss_equals_a_brute_force_sum():
    """The anti-diagonal recursion against the log of the summed probability of every alignment."""
    import itertools

    gen = torch.Generator().manual_seed(0)
    t, u, v = 3, 2, 4
    logits = torch.randn(1, t, u + 1, v, generator=gen, dtype=torch.float64)
    labels = torch.tensor([[2, 3]])
    lp = torch.log_softmax(logits, dim=-1)[0]
    total = []
    for blanks_at in itertools.combinations(range(t + u), t):  # positions of the t blanks among t + u decisions
        if blanks_at[-1] != t + u - 1:  # every path ends in the blank at (T − 1, U)
            continue
        ti = ui = 0
        s = 0.0
        for k in range(t + u):
            if k in blanks_at:
                s += lp[ti, ui, 0]
                ti += 1
            else:
                s += lp[ti, ui, labels[0, ui]]
                ui += 1
        total.append(s)
    want = -torch.logsumexp(torch.stack(total), dim=0)
    got = rl.rnnt_losses(logits, labels, torch.tensor([t]), torch.tensor([u]))[0]
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-5, atol=1e-5)
