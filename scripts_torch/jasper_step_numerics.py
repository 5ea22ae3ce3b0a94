"""Where a Jasper training step's f32 gradients on a CUDA card part from the CPU's.

The step is ``chip_smoke.jasper_parity``'s: a 2-block Jasper at its
published widths (``examples/models/ctc/jasper/base.yml.j2``, dropout 0),
batch 2 × 4 s, BatchNorm on batch statistics, from the same base-10 log-mel
features (the CPU frontend's). Runs:

- ``cpu f64`` (the reference) and ``card f64``: the same code in float64
  (``chip_smoke.float64_plain_path``, the plain CTC recursion), which
  separates the code from rounding;
- ``cpu f32``, ``card f32`` (cuDNN), a second ``card f32`` and
  ``card f32 no cudnn``, each with its own ReLU pattern;
- ``cpu f32`` and ``card f32`` with float64's ReLU pattern replayed
  (``chip_smoke.jasper_relu_masks``).

For every run it prints how many ReLU inputs lie on another side of 0
than in float64, and per BatchNorm the distance to ``cpu f64`` (max abs
error over the reference's max abs) of its input x, batch mean and
variance, output y and gradients dy and dx, layer by layer, then of every
parameter gradient.

Then each op alone, fed the ``cpu f32`` run's own f32 inputs on both
devices and held to float64 on the same inputs: the batch statistics
(the port's E[x²] − E[x]² and the two-pass E[(x − E[x])²]), the BatchNorm
backward given (x, dy), and the convolution's output and weight gradient
given its input and output gradient, with cuDNN and without.

Run from the repository root on a CUDA card (``--device cpu`` runs the
card's side on the CPU too, a dry run of the script):

    python3 scripts_torch/jasper_step_numerics.py
"""
import argparse
import contextlib
import copy
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tensorflowasr_tpu_torch.models.layers import general  # noqa: E402
from tensorflowasr_tpu_torch.models.layers.convolution import Conv1D  # noqa: E402
from tensorflowasr_tpu_torch.ops.losses import get_ctc_loss_fn  # noqa: E402


@contextlib.contextmanager
def recording(model):
    """Per BatchNorm: x, mean, var, y, dy, dx; per Conv1D: its input."""
    rec, hooks, fast = {}, [], general.BatchNorm.batch_stats
    names = {m: n for n, m in model.named_modules()}

    def stats(self, x, clip=True):
        mean, var = fast(self, x, clip)
        rec.setdefault(names[self], {}).update(mean=mean.detach(), var=var.detach())
        return mean, var

    def bn_hook(m, inputs, out):
        r = rec.setdefault(names[m], {})
        r.update(x=inputs[0].detach(), y=out.detach())
        inputs[0].register_hook(lambda g: r.update(dx=g.detach()))
        out.register_hook(lambda g: r.update(dy=g.detach()))

    def conv_hook(m, inputs, out):
        rec.setdefault(names[m], {}).update(x=inputs[0].detach())

    for m in model.modules():
        if isinstance(m, general.BatchNorm):
            hooks.append(m.register_forward_hook(bn_hook))
        elif isinstance(m, Conv1D):
            hooks.append(m.register_forward_hook(conv_hook))
    general.BatchNorm.batch_stats = stats
    try:
        yield rec
    finally:
        general.BatchNorm.batch_stats = fast
        for h in hooks:
            h.remove()


def dist(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.detach().cpu().double(), ref.detach().cpu().double()
    return ((a - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


def step(base, tmp, feats, flens, labels, label_len, device, dtype, cudnn=True, masks=None, replay=False):
    """One training step; ``masks`` records the run's ReLU pattern or, with ``replay``, supplies it."""
    torch.backends.cudnn.enabled = cudnn
    if dtype == torch.float64:
        model = cs.family_model("jasper", torch.float64, "cpu", tmp, depth=2, dropout=0.0).double()
        model.load_state_dict(base.state_dict())
        model.to(device)
    else:
        model = copy.deepcopy(base).to(device)
    masks = {} if masks is None else masks
    with (cs.float64_plain_path() if dtype == torch.float64 else contextlib.nullcontext()), recording(model) as rec, \
            cs.jasper_relu_masks(model, masks, replay):
        enc, elens, _ = model.encoder(feats.to(device, dtype), flens.to(device), train=True)
        loss = get_ctc_loss_fn("xla" if dtype == torch.float64 else "auto")(model.vocab(enc), elens, labels.to(device), label_len.to(device))
        loss.backward()
    torch.backends.cudnn.enabled = True
    grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
    return loss.item(), grads, {n: {k: v.cpu().double() for k, v in r.items()} for n, r in rec.items()}, model, masks


def ops_alone(model_cpu, rec32, dev) -> None:
    """Each op on the cpu f32 run's own inputs, card and CPU against float64 on those inputs."""
    mods = dict(model_cpu.named_modules())
    print("\nops alone, on the cpu f32 run's inputs (distance to float64 on the same inputs):")
    for name, r in rec32.items():
        m = mods[name]
        if isinstance(m, general.BatchNorm):
            x = r["x"].float()
            ref_mean = x.double().mean(dim=(0, 1))
            ref_var = ((x.double() - ref_mean) ** 2).mean(dim=(0, 1))
            ratio = (ref_mean.abs() / ref_var.sqrt().clamp_min(1e-30))
            line = [f"  {name}: |mean|/std median {ratio.median().item():.3g} max {ratio.max().item():.3g};"]
            for where in ("cpu", dev):
                xd = x.to(where)
                mean = xd.mean(dim=(0, 1))
                fast = (xd * xd).mean(dim=(0, 1)) - mean * mean
                two = ((xd - mean) ** 2).mean(dim=(0, 1))
                line.append(f"{'cpu' if where == 'cpu' else 'card'} mean {dist(mean, ref_mean):.2e} var E[x²]-E[x]² {dist(fast, ref_var):.2e} "
                            f"two-pass {dist(two, ref_var):.2e};")
            dy = r["dy"].float()
            grads = {}
            for where, dt in (("f64", torch.float64), ("cpu", torch.float32), ("card", torch.float32)):
                bn = copy.deepcopy(m).to("cpu" if where != "card" else dev).to(dt)
                xx = x.to(dt).to(bn.weight.device).requires_grad_(True)
                with cs.float64_plain_path() if dt == torch.float64 else contextlib.nullcontext():
                    bn.dtype = dt
                    y = bn(xx, train=True)
                    (dx,) = torch.autograd.grad(y, xx, dy.to(xx.device, dt))
                grads[where] = dx
            line.append(f"BN backward dx cpu {dist(grads['cpu'], grads['f64']):.2e} card {dist(grads['card'], grads['f64']):.2e}")
            print(" ".join(line))
    for name, r in rec32.items():
        m = mods[name]
        if isinstance(m, Conv1D):
            bn_name = name.rsplit(".", 1)[0] + ".bn"
            xin, dyc = r["x"].float(), rec32[bn_name]["dx"].float()
            ref = None
            out, fwd = {}, {}
            for where, dt, cudnn in (("f64", torch.float64, True), ("cpu", torch.float32, True), ("card", torch.float32, True),
                                     ("card no cudnn", torch.float32, False)):
                torch.backends.cudnn.enabled = cudnn
                conv = copy.deepcopy(m).to(dev if where.startswith("card") else "cpu")
                conv.to(dt)
                conv.dtype = dt
                y = conv(xin.to(conv.weight.device, dt))
                (dw,) = torch.autograd.grad(y, conv.weight, dyc.to(y.device, dt))
                out[where], fwd[where] = dw, y.detach()
                torch.backends.cudnn.enabled = True
            ref, ref_y = out.pop("f64"), fwd.pop("f64")
            xm = xin.double().mean(dim=(0, 1))
            xs = xin.double().std(dim=(0, 1))
            row_sum = dyc.double().sum(dim=(0, 1)).abs().max().item() / dyc.double().abs().sum(dim=(0, 1)).max().item()
            print(f"  {name} weight gradient: input |mean|/std median {(xm.abs() / xs.clamp_min(1e-30)).median().item():.3g}; "
                  f"|sum_t dy| / sum_t |dy| {row_sum:.2e}; " + ", ".join(f"{k} {dist(v, ref):.2e}" for k, v in out.items())
                  + "; output " + ", ".join(f"{k} {dist(v, ref_y):.2e}" for k, v in fwd.items()))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cpu' runs the 'card' side on the CPU too: a dry run of the script")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        cs._need_card()
    cs._no_tf32()
    dev = torch.device(args.device)
    print(f"device {torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu'}; torch {torch.__version__}; TF32 off")
    with tempfile.TemporaryDirectory(prefix="tfasr-jasper-") as tmp:
        base = cs.family_model("jasper", torch.float32, "cpu", tmp, depth=2, dropout=0.0)
        batch = cs.train_batch(np.random.default_rng(cs.SEED + 3), 2, 4.0, 32, base.vocab_size)
        with torch.no_grad():
            feats, flens = base.feature_extraction(batch.inputs.inputs, batch.inputs.inputs_length)
        labels, label_len = batch.labels.labels, batch.labels.labels_length
        print(f"features {tuple(feats.shape)}, lengths {flens.tolist()}, mean {feats.mean().item():.3f} std {feats.std().item():.3f}")
        runs = {}
        for name, device, dtype, cudnn in (("cpu f64", "cpu", torch.float64, True), ("card f64", dev, torch.float64, True),
                                           ("cpu f32", "cpu", torch.float32, True), ("card f32", dev, torch.float32, True),
                                           ("card f32 again", dev, torch.float32, True), ("card f32 no cudnn", dev, torch.float32, False)):
            runs[name] = step(base, tmp, feats, flens, labels, label_len, device, dtype, cudnn)
        ref_masks = runs["cpu f64"][4]
        for name, device in (("cpu f32 f64 pattern", "cpu"), ("card f32 f64 pattern", dev)):
            runs[name] = step(base, tmp, feats, flens, labels, label_len, device, torch.float32, masks=ref_masks, replay=True)
        ref_loss, ref_g, ref_rec, _, _ = runs["cpu f64"]
        others = [n for n in runs if n != "cpu f64"]
        total = sum(m.numel() for m in ref_masks.values())
        print("\nReLU inputs on another side of 0 than in float64 (of " + str(total) + "): " + "; ".join(
            f"{n} {sum(int((runs[n][4][k] != m).sum()) for k, m in ref_masks.items())} "
            f"{ {k.removeprefix('encoder.'): int((runs[n][4][k] != m).sum()) for k, m in ref_masks.items() if (runs[n][4][k] != m).any()} }"
            for n in others if "pattern" not in n))
        print(f"\nloss: f64 {ref_loss:.12g}; " + ", ".join(f"{n} {runs[n][0]:.10g}" for n in others))
        print("\nper BatchNorm, distance to cpu f64 (forward order): " + " | ".join(others))
        for layer, r in ref_rec.items():
            if "mean" not in r:
                continue
            for key in ("x", "mean", "var", "y"):
                print(f"  {layer:40s} {key:4s} " + "  ".join(f"{dist(runs[n][2][layer][key], r[key]):.2e}" for n in others))
        print("\nper BatchNorm, gradients (backward order): " + " | ".join(others))
        for layer in reversed([k for k, r in ref_rec.items() if "dx" in r]):
            for key in ("dy", "dx"):
                print(f"  {layer:40s} {key:4s} " + "  ".join(f"{dist(runs[n][2][layer][key], ref_rec[layer][key]):.2e}" for n in others))
        print("\nparameter gradients (distance to cpu f64): " + " | ".join(others))
        gmax = max(g.abs().max().item() for g in ref_g.values())
        for p, g in ref_g.items():
            if g.abs().max().item() > cs.TRAIN_PARITY_FLOOR * gmax:
                print(f"  {p:55s} " + "  ".join(f"{dist(runs[n][1][p], g):.2e}" for n in others))
        print("\ncard f32 twice: largest parameter-gradient difference relative to scale "
              f"{max(dist(runs['card f32'][1][p], runs['card f32 again'][1][p]) for p in ref_g if ref_g[p].abs().max() > 0):.2e}")
        ops_alone(runs["cpu f32"][3], runs["cpu f32"][2], dev)
        print(f"\n{cs.subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()}"
              if dev.type == "cuda" else "")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
