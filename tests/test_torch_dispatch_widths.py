"""Each kernel's shape predicate, the layers' routes by it, and a
Conformer-L-shaped transducer against JAX, on the CPU.

Every CUDA kernel wrapper of the port says by a pure function of shapes and
dtype (``supported``) which shapes its kernel takes, and the layers consult
it before any launch: an out-of-range shape takes the plain PyTorch route
(recorded in ``ops/routes.py``) and the kernel's entry point is not called,
also under ``torch.export`` (``torch.compiler.is_exporting()``), where the
wrappers' custom operators refuse such a shape. The predicates are held at
their edges; the layers' dispatch with their kernel entry points replaced by
recorders (a CPU tensor would take the same plain versions either way).

The Conformer-L-shaped transducer (Gulati et al. 2020, Table 1, at 2 of its
17 blocks: D 512, 8 heads of 64, conv kernel 32, FF 2048, LSTM-640, joint
640, V 1024) runs in both packages from the same weights (``bridge.py``),
f32, dropout 0, B 2 of ~1 s: the encoder forward, then one training step's
loss, ``grad_norm`` and every gradient. JAX runs its XLA routes
(``TFASR_{FF,CONV,ATTN,LOSS}_IMPL=xla``); the port its default dispatch
(the kernels' plain versions on the CPU, which the kernels' own tests hold
to JAX's Pallas kernels). Tolerances as ``tests/test_torch_slice.py`` and
``tests/test_torch_train_slice.py`` state them: the encoder 2e-5 absolute
(summation order over two blocks, unit-scale outputs; at D 512 3e-5), the
loss 1e-5 relative, each gradient 1e-4 of its largest magnitude plus 1e-6
of the largest gradient, and ``grad_norm`` 1e-4 relative (the K-step bound
of ``tests/test_torch_train_slice.py``): the conv modules' gradients reach
JAX's XLA route, whose BatchNorm takes the centred variance, from the fused
route's unclipped E[x²] − E[x]² (JAX's own fused route's), 1.7e-5 apart in
norm on this batch, which moves ``grad_norm`` by 1.3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowasr_tpu import schemas as jschemas
from tensorflowasr_tpu.models.transducer.conformer import Conformer as JConformer
from tensorflowasr_tpu.training import trainer as jtrainer
from tensorflowasr_tpu_torch import bridge, schemas
from tensorflowasr_tpu_torch.configs import Config
from tensorflowasr_tpu_torch.models import build_model
from tensorflowasr_tpu_torch.models.encoders import conformer as tconf
from tensorflowasr_tpu_torch.models.layers import attention as tattn
from tensorflowasr_tpu_torch.models.layers import rnn as trnn
from tensorflowasr_tpu_torch.models.transducer import base as tbase
from tensorflowasr_tpu_torch.models.transducer.conformer import CONFORMER_L_SOURCE, Conformer, conformer_large_config
from tensorflowasr_tpu_torch.ops import losses, routes
from tensorflowasr_tpu_torch.ops.cuda import attention_kernel as ak
from tensorflowasr_tpu_torch.ops.cuda import conv_kernel as ck
from tensorflowasr_tpu_torch.ops.cuda import ctc_kernel as ctk
from tensorflowasr_tpu_torch.ops.cuda import decode_kernel as dk
from tensorflowasr_tpu_torch.ops.cuda import ff_kernel as fk
from tensorflowasr_tpu_torch.ops.cuda import joint_loss_kernel as jk
from tensorflowasr_tpu_torch.ops.cuda import lstm_kernel as lk
from tensorflowasr_tpu_torch.ops.cuda import rnnt_kernel as rk
from tensorflowasr_tpu_torch.ops.ctc_loss import ctc_loss
from tensorflowasr_tpu_torch.ops.rnnt_loss import rnnt_loss
from tensorflowasr_tpu_torch.training import trainer as ttrainer
from tensorflowasr_tpu_torch.training.trainer import Trainer

F32, BF16 = torch.float32, torch.bfloat16

# (predicate, arguments, expected): each kernel at the edges of the range it takes
EDGES = {
    "ff D 256": (fk.supported, (256, 1024, BF16), True),
    "ff D 512": (fk.supported, (512, 2048, BF16), True),
    "ff D 512 f32": (fk.supported, (512, 2048, F32), True),
    "ff D 520": (fk.supported, (520, 2080, BF16), False),
    "ff D 520 f32": (fk.supported, (520, 2080, F32), False),
    "ff f16": (fk.supported, (144, 576, torch.float16), False),
    "conv D 256": (ck.supported, (256, BF16), True),
    "conv D 512": (ck.supported, (512, BF16), True),
    "conv D 512 f32": (ck.supported, (512, F32), True),
    "conv D 520": (ck.supported, (520, BF16), False),
    "conv D 520 f32": (ck.supported, (520, F32), False),
    "joint J 384": (jk.supported, (384, BF16), True),
    "joint J 640": (jk.supported, (640, BF16), True),
    "joint J 640 f32": (jk.supported, (640, F32), True),
    "joint J 648": (jk.supported, (648, BF16), False),
    "joint J 644": (jk.supported, (644, F32), False),
    "kernel B head 128": (ak.rel_supported, (128, 400, BF16), True),
    "kernel B head 256": (ak.rel_supported, (256, 400, BF16), False),
    "kernel B f32 head 128, 2,000 keys": (ak.rel_supported, (128, 2000, F32), True),
    "kernel B f32 head 128, 4,000 keys": (ak.rel_supported, (128, 4000, F32), False),
    "kernel B bf16 head 128, 4,000 keys": (ak.rel_supported, (128, 4000, BF16), True),
    "kernel A head 128": (ak.supported, (128, 400, BF16), True),
    "kernel A head 256": (ak.supported, (256, 400, BF16), False),
    "kernel A f32 head 64, 20,000 keys": (ak.supported, (64, 20000, F32), False),
    "ctc S 1024": (ctk.supported, (1024,), True),
    "ctc S 1025": (ctk.supported, (1025,), False),
    "rnnt U+1 1024": (rk.supported, (1024,), True),
    "rnnt U+1 1025": (rk.supported, (1025,), False),
    "lstm bf16 H 1024": (lk.supported, (1024, BF16), True),
    "lstm bf16 H 1280": (lk.supported, (1280, BF16), False),
    "lstm f32 H 1024": (lk.supported, (1024, F32), True),
    "decode 4 layers": (dk.supported, (640, 640, 0, 640, 1024, 4), True),
    "decode 5 layers": (dk.supported, (640, 640, 0, 640, 1024, 5), False),
    "decode Conformer-L net": (dk.supported, (640, 640, 0, 640, 1024, 1), True),
    "decode vectors past shared memory": (dk.supported, (8192, 8192, 0, 8192, 1024, 1), False),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_predicate_at_its_edges(case):
    fn, args, want = EDGES[case]
    assert fn(*args) is want


def test_wrappers_assert_their_predicates():
    """The wrappers' own checks refuse what the predicates refuse, on a CPU tensor too, before any launch."""
    x = torch.zeros(2, 520)
    v, w = torch.zeros(520), torch.zeros(520, 8)
    with pytest.raises(ValueError, match="model width"):
        fk._check(x, v, v, w, torch.zeros(8), torch.zeros(8, 520), v)
    x3 = torch.zeros(1, 2, 520)
    with pytest.raises(ValueError, match="model width"):
        ck._check_front(x3, v, v, torch.zeros(520, 520), v, torch.zeros(520, 520), v)
    with pytest.raises(ValueError, match="joint width"):
        jk._check(torch.zeros(1, 2, 648), torch.zeros(1, 3, 648), torch.zeros(5, 648), torch.zeros(5), torch.zeros(1, 2, dtype=torch.long))
    with pytest.raises(ValueError, match="label positions"):
        rk.dp_warps(1025)


class _Recorder:
    """A stand-in for a kernel entry point: counts its calls and runs the plain version it is given."""

    def __init__(self, plain):
        self.calls, self.plain = 0, plain

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.plain(*args, **kwargs)


def _x(shape, seed, scale=1.0):
    return torch.tensor((np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


@pytest.fixture()
def exporting(monkeypatch, request):
    """Whether the layers see ``torch.compiler.is_exporting()`` (the parameter), and the route counts cleared."""
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: request.param)
    routes.counts.clear()
    return request.param


@pytest.mark.parametrize("exporting", [False, True], indirect=True)
@pytest.mark.parametrize("d", [512, 520])
def test_ff_and_conv_modules_route_by_width(monkeypatch, exporting, d):
    rec_ff, rec_front, rec_back = _Recorder(fk.fused_ff_plain), _Recorder(ck.conv_front_plain), _Recorder(ck.conv_back_plain)
    monkeypatch.setattr(tconf, "fused_ff", rec_ff)
    monkeypatch.setattr(tconf, "conv_front", rec_front)
    monkeypatch.setattr(tconf, "conv_back", rec_back)
    ff, conv = tconf.FFModule(d), tconf.ConvModule(d, kernel_size=3)
    for m in (ff, conv):
        for p in m.parameters():
            torch.nn.init.normal_(p, std=d ** -0.5)
    x = _x((1, 5, d), 0)
    with torch.no_grad():
        ff(x), conv(x)
    taken = d <= 512
    assert (rec_ff.calls, rec_front.calls, rec_back.calls) == ((1, 1, 1) if taken else (0, 0, 0))
    assert ff.route == conv.route == ("kernel" if taken else "plain")
    assert routes.counts[("fused_ff", ff.route)] == 1 and routes.counts[("conv_module", conv.route)] == 1


def test_plain_routes_compute_the_modules_function():
    """At a width the kernels refuse, the FF and conv modules' plain routes give what their fused routes' plain versions would."""
    d = 520
    ff, conv = tconf.FFModule(d), tconf.ConvModule(d, kernel_size=3)
    for m in (ff, conv):
        for p in m.parameters():
            torch.nn.init.normal_(p, std=d ** -0.5)
    x = _x((2, 6, d), 1)
    with torch.no_grad():
        got_ff, got_conv = ff(x), conv(x)
        t = lambda dense: dense.weight.t()
        ref_ff = fk.fused_ff_plain(x.reshape(-1, d), ff.ln.weight, ff.ln.bias, t(ff.dense_1), ff.dense_1.bias, t(ff.dense_2), ff.dense_2.bias)
        w1 = conv.pw_conv_1.weight[:, :, 0].t()
        glu = ck.conv_front_plain(x, conv.ln.weight, conv.ln.bias, w1[:, :d], conv.pw_conv_1.bias[:d], w1[:, d:], conv.pw_conv_1.bias[d:])
        y1 = ck.depthwise_conv1d(glu, conv.dw_conv.weight, conv.dw_conv.bias, "causal")
        bn = conv.dw_norm
        ref_conv = ck.conv_back_plain(x, y1, bn.running_mean, bn.running_var, bn.weight, bn.bias, conv.pw_conv_2.weight[:, :, 0].t(), conv.pw_conv_2.bias)
    assert ff.route == conv.route == "plain"
    torch.testing.assert_close(got_ff, ref_ff.reshape(x.shape), rtol=0, atol=2e-5)
    torch.testing.assert_close(got_conv, ref_conv, rtol=0, atol=2e-5)


@pytest.mark.parametrize("exporting", [False, True], indirect=True)
@pytest.mark.parametrize("head", [128, 256])
def test_attention_layers_route_by_head_size(monkeypatch, exporting, head):
    rec_b, rec_a = _Recorder(ak.fused_rel_attention_plain), _Recorder(ak.fused_attention_plain)
    monkeypatch.setattr(tattn, "fused_rel_attention", rec_b)
    monkeypatch.setattr(tattn, "fused_attention", rec_a)
    d = 2 * head
    rel, mha = tattn.MultiHeadRelativeAttention(d, 2, head), tattn.MultiHeadAttention(d, 2, head)
    for m in (rel, mha):
        for p in m.parameters():
            torch.nn.init.normal_(p, std=d ** -0.5)
    x, relpe = _x((1, 4, d), 2), _x((1, 7, d), 3)
    with torch.no_grad():
        out_rel, _ = rel(x, x, relpe=relpe)
        out_mha, _ = mha(x, x)
    taken = head <= 128
    assert (rec_b.calls, rec_a.calls) == ((1, 1) if taken else (0, 0))
    assert routes.counts[("fused_rel_attention", "kernel" if taken else "plain")] == 1
    assert routes.counts[("fused_attention", "kernel" if taken else "plain")] == 1
    assert torch.isfinite(out_rel).all() and torch.isfinite(out_mha).all()


@pytest.mark.parametrize("exporting", [False, True], indirect=True)
@pytest.mark.parametrize("units", [1024, 1280])
def test_lstm_layer_routes_by_width(monkeypatch, exporting, units):
    rec = _Recorder(lk.lstm_layer_fused)
    monkeypatch.setattr(trnn, "lstm_layer_fused", rec)
    layer = trnn.RNN(8, units, dtype=BF16, rnn_impl="pallas")
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.05)
    with torch.no_grad():
        y, _ = layer(_x((2, 3, 8), 4).to(BF16))
    assert rec.calls == (1 if units <= 1024 else 0)
    assert routes.counts[("lstm", "kernel" if units <= 1024 else "plain")] == 1
    assert y.shape == (2, 3, units) and torch.isfinite(y.float()).all()


@pytest.mark.parametrize("u", [1023, 1024])
def test_rnnt_loss_routes_by_label_positions(u):
    """U+1 = 1024 takes the unfused kernels' route, 1025 the plain DP, each
    with the same value (on the CPU both are plain)."""
    routes.counts.clear()
    g = np.random.default_rng(5)
    logits = torch.tensor(g.standard_normal((1, 2, u + 1, 3)).astype(np.float32))
    labels = torch.tensor(g.integers(1, 3, (1, u)))
    t_len, u_len = torch.tensor([2]), torch.tensor([1])
    got = losses.get_rnnt_loss_fn("auto")(logits, t_len, labels, u_len)
    torch.testing.assert_close(got, rnnt_loss(logits, t_len, labels, u_len).mean(), rtol=1e-6, atol=1e-6)
    assert routes.counts == {("rnnt_dp", "kernel" if u + 1 <= 1024 else "plain"): 1}


@pytest.mark.parametrize("u", [511, 512])
def test_ctc_loss_routes_by_extended_states(u):
    """S = 2U+1 = 1023 takes the CTC kernel's route, 1025 the plain α recursion, each with the same value."""
    routes.counts.clear()
    g = np.random.default_rng(6)
    logits = torch.tensor(g.standard_normal((1, u + 3, 4)).astype(np.float32))
    labels = torch.tensor(g.integers(1, 4, (1, u)))
    t_len, u_len = torch.tensor([u + 3]), torch.tensor([3])
    got = losses.get_ctc_loss_fn("auto")(logits, t_len, labels, u_len)
    torch.testing.assert_close(got, ctc_loss(logits, t_len, labels, u_len).mean(), rtol=1e-5, atol=1e-5)
    assert routes.counts == {("ctc_loss", "kernel" if 2 * u + 1 <= 1024 else "plain"): 1}


def _tiny_transducer(joint_dim: int = 16, num_rnns: int = 1) -> Conformer:
    cfg = conformer_large_config(vocab_size=12, num_blocks=1, dropout=0.0)
    cfg["encoder_subsampling"]["config"]["filters"] = [8, 8]
    cfg.update(speech_config={**cfg["speech_config"], "num_feature_bins": 16}, encoder_dmodel=16, encoder_head_size=4, encoder_num_heads=4,
               encoder_kernel_size=3, prediction_embed_dim=8, prediction_rnn_units=8, prediction_num_rnns=num_rnns, joint_dim=joint_dim)
    model = Conformer.from_config(cfg, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("joint_dim", [16, 648])
def test_fused_joint_loss_routes_by_joint_width(monkeypatch, joint_dim):
    rec = _Recorder(jk.rnnt_loss_fused_joint)
    monkeypatch.setattr(ttrainer, "rnnt_loss_fused_joint", rec)
    routes.counts.clear()
    model = _tiny_transducer(joint_dim)
    g = np.random.default_rng(7)
    sig = torch.tensor((g.standard_normal((2, 4000)) * 0.3).astype(np.float32))
    labels = torch.tensor([[1, 2, 3], [4, 5, 0]])
    inputs = schemas.TrainInput(sig, torch.tensor([4000, 3000]), torch.cat([torch.zeros(2, 1, dtype=torch.long), labels], 1), torch.tensor([4, 3]))
    loss = ttrainer.make_train_loss(model, "auto")(model, inputs, schemas.TrainLabel(labels, torch.tensor([3, 2])))
    loss.backward()
    taken = joint_dim <= 640
    assert rec.calls == int(taken)
    assert routes.counts[("rnnt_fused_joint", "kernel" if taken else "plain")] == 1
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    if not taken:  # the plain route is the joint's logits and the plain DP: the xla loss of the same forward
        ref = ttrainer.make_train_loss(model, "xla")(model, inputs, schemas.TrainLabel(labels, torch.tensor([3, 2])))
        torch.testing.assert_close(loss, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_rnns", [4, 5])
def test_decode_params_decline_nets_past_the_kernel(num_rnns):
    """A net of 5 LSTM layers gets no fused-decode parameters (the eager WIND
    loop runs, recorded), 4 do; both decode to the sync loop's tokens."""
    routes.counts.clear()
    model = _tiny_transducer(num_rnns=num_rnns).eval()
    assert (tbase.extract_decode_params(model) is None) == (num_rnns > 4)
    sig = _x((2, 3000), 8, 0.3)
    inputs = schemas.PredictInput(sig, torch.tensor([3000, 2000]))
    out = tbase.recognize(model, inputs)
    assert routes.counts[("fused_decode", "kernel" if num_rnns <= 4 else "plain")] == 1
    assert routes.plain_routes() == ({} if num_rnns <= 4 else {"fused_decode": 1})
    ref = tbase.recognize(model, inputs, decode_mode="sync")
    torch.testing.assert_close(out.tokens, ref.tokens, rtol=0, atol=0)


def test_exporting_wrappers_refuse_what_their_kernels_refuse(monkeypatch):
    """Under ``torch.export`` a wrapper reaches its ``tfasr::*`` operator only at a shape its kernel takes."""
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    d = 520
    x, v = torch.zeros(3, d), torch.zeros(d)
    with pytest.raises(ValueError, match="model width"):
        fk.fused_ff(x, v, v, torch.zeros(d, 8), torch.zeros(8), torch.zeros(8, d), v)
    x3 = torch.zeros(1, 3, d)
    with pytest.raises(ValueError, match="model width"):
        ck.conv_front(x3, v, v, torch.zeros(d, d), v, torch.zeros(d, d), v)
    with pytest.raises(ValueError, match="model width"):
        ck.conv_back(x3, x3, v, v, v, v, torch.zeros(d, d), v)
    q = torch.zeros(2, 4, 256)
    with pytest.raises(ValueError, match="head size"):
        ak.fused_attention(q, q, q, torch.zeros(1, 4, 4))
    with pytest.raises(ValueError, match="head size"):
        ak.fused_rel_attention(q, q, q, q, torch.zeros(2, 7, 256), None, None)
    with pytest.raises(ValueError, match="LSTM"):
        lk.lstm_core(torch.zeros(1, 2, 4 * 1280, dtype=BF16), torch.zeros(1280, 4 * 1280, dtype=BF16), torch.zeros(1, 1280, dtype=BF16),
                     torch.zeros(1, 1280, dtype=BF16))


# ------------------------------ the Conformer-L-shaped transducer against JAX ------------------------------ #

L_BLOCKS = 2


def _large_batch(rng, vocab: int):
    b, n, u = 2, 16000, 5
    sig = (rng.standard_normal((b, n)) * 0.5).astype(np.float32)
    lens = np.array([n, 11000], np.int32)
    label_len = np.array([u, 3], np.int32)
    labels = rng.integers(1, vocab, (b, u)).astype(np.int32)
    labels[np.arange(u)[None, :] >= label_len[:, None]] = 0
    preds = np.concatenate([np.zeros((b, 1), np.int32), labels], axis=1)
    return sig, lens, preds, label_len + 1, labels, label_len


@pytest.fixture(scope="module")
def large():
    """The Conformer-L config at 2 blocks through ``Config`` and ``build_model``
    (f32, dropout 0) in both packages from JAX's init; JAX's encoder output and
    one training step's loss, grad_norm and gradients (SGD at 0: the step
    records the gradients and moves nothing)."""
    cfg = conformer_large_config(num_blocks=L_BLOCKS, dropout=0.0)
    config = Config({"model_config": {"class_name": "Conformer", "config": cfg}, "source": CONFORMER_L_SOURCE})
    assert config.source.startswith("Gulati et al.")
    vocab = cfg["vocab_size"]
    rng = np.random.default_rng(0)
    arrs = _large_batch(rng, vocab)
    with pytest.MonkeyPatch.context() as mp:
        for impl in ("FF", "CONV", "ATTN", "LOSS"):
            mp.setenv(f"TFASR_{impl}_IMPL", "xla")
        jm = JConformer.from_config(cfg)
        sig, lens, preds, plen, labels, llen = map(jnp.asarray, arrs)
        jb = jschemas.TrainData(jschemas.TrainInput(sig, lens, preds, plen), jschemas.TrainLabel(labels, llen))
        v = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(jax.random.PRNGKey(1), jb.inputs))
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: (a + 0.2 * rng.random(a.shape)).astype(np.float32), v["batch_stats"])
        enc, enc_len, _ = jax.jit(lambda v, s, n: jm.apply(v, s, n, method=jm.encode))(v, sig, lens)
        record = optax.GradientTransformation(lambda params: params, lambda updates, state, params=None: (updates, updates))
        tx = optax.chain(record, optax.sgd(0.0))
        state = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, v), tx, jax.random.PRNGKey(0))
        state, metrics = jax.jit(jtrainer.make_train_step(jm, tx))(state, jb)
        jgrads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    tm = build_model(config.model_config, vocab_size=vocab, device="cpu")
    tm.load_state_dict(bridge.state_dict_from_flax(v), strict=True)
    return dict(arrs=arrs, enc=np.asarray(enc), enc_len=np.asarray(enc_len), loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                jgrads=jgrads, tm=tm)


def test_conformer_l_shape_transducer_matches_jax(large):
    tm = large["tm"]
    enc_cfg = tm.encoder_config
    assert (enc_cfg["dmodel"], enc_cfg["num_heads"], enc_cfg["head_size"], enc_cfg["kernel_size"], tm.joint.vocab.weight.shape) == (512, 8, 64, 32,
                                                                                                                                     (1024, 640))
    blocks = [getattr(tm.encoder, f"block_{i}") for i in range(L_BLOCKS)]
    assert blocks[0].ff_module_1.dense_1.weight.shape == (2048, 512)
    sig, lens, preds, plen, labels, llen = large["arrs"]
    routes.counts.clear()
    with torch.no_grad():
        got, got_len, _ = tm.eval().encode(torch.tensor(sig), torch.tensor(lens))
    assert all(b.ff_module_1.route == b.conv_module.route == "kernel" for b in blocks)  # D 512: the kernels' routes (their plain versions here)
    np.testing.assert_array_equal(got_len.numpy(), large["enc_len"])
    np.testing.assert_allclose(got.numpy(), large["enc"], rtol=0, atol=3e-5)

    trainer = Trainer(tm.train(), {"class_name": "SGD", "config": {"learning_rate": 0.0}}, device="cpu")
    tstate = trainer.init_state(seed=0)
    tb = schemas.TrainData(schemas.TrainInput(*(torch.tensor(a).long() if a.dtype == np.int32 else torch.tensor(a) for a in (sig, lens, preds, plen))),
                           schemas.TrainLabel(torch.tensor(labels).long(), torch.tensor(llen).long()))
    routes.counts.clear()
    tstate, metrics = trainer.train_step(tstate, tb)
    assert routes.plain_routes() == {} and routes.counts[("rnnt_fused_joint", "kernel")] == 1
    np.testing.assert_allclose(float(metrics["loss"]), large["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), large["grad_norm"], rtol=1e-4)
    ref = bridge.state_dict_from_flax({"params": large["jgrads"]})
    got_g = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got_g) == {k for k in ref if not k.endswith(("running_mean", "running_var"))}
    gmax = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, g in got_g.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max() + 1e-6 * gmax, err_msg=name)


@pytest.mark.parametrize("u", [1023, 1024])
def test_tp_rnnt_loss_routes_by_label_positions(tmp_path, u):
    """The vocab-sharded loss (one rank, gloo) takes the DP kernel's route to
    U+1 1024 and the plain DP's above, each with the loss and gradient of the
    plain loss over the whole logits."""
    import torch.distributed as dist

    from tensorflowasr_tpu_torch.parallel import tp

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        routes.counts.clear()
        g = np.random.default_rng(9)
        logits = torch.tensor(g.standard_normal((1, 2, u + 1, 3)).astype(np.float32), requires_grad=True)
        labels = torch.tensor(g.integers(1, 3, (1, u)))
        t_len, u_len = torch.tensor([2]), torch.tensor([1])
        got = tp.tp_rnnt_loss(logits, t_len, labels, u_len, 3)
        (grad,) = torch.autograd.grad(got.sum(), logits)
        ref = rnnt_loss(logits, t_len, labels, u_len)
        (ref_grad,) = torch.autograd.grad(ref.sum(), logits)
    finally:
        dist.destroy_process_group()
    assert routes.counts == {("rnnt_dp", "kernel" if u + 1 <= 1024 else "plain"): 1}
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-5, atol=1e-6)
