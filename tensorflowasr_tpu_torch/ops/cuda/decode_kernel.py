"""The fused greedy transducer decode: the whole batched WIND loop in one
kernel launch (``csrc/decode.cu``).

Replaces ``scripts_dev/decode_kernel.py:fused_greedy_decode`` (the Pallas
``_decode_kernel``): per iteration a windowed joint
``tanh(enc_p[t..t+K) + pred_p)·W_v + b_v`` over K = min(window, T) frames,
the argmax of each frame (lowest index on ties), the first non-blank frame
in the window that is valid (at or past t, before the length) while the
token budget ``factor·T + 1`` lasts, the token written at the row's next
position, the advance ``t ← max(any ? start + first : min(start + K, len),
t)`` with ``start = min(t, T − K)``, and on emission one prediction-network
step (embedding row, per layer an LSTM cell with flax's gate order i, f, g,
o and bias on the hidden product, optional LayerNorm over the units with
the centred variance, optional projection; then the prejoint ``W_p``).
The carry-out follows the WIND convention: the next token is the last one
emitted (not yet consumed) and the states are those from before its step.
The encoder's prejoint projection ``enc·W_enc + b`` runs outside the kernel
as one matrix product, as in JAX.

Rounding points, as the Pallas kernel's: every product reads its operands
in the compute dtype (the weights', ``params.wv.dtype``) and accumulates in
f32; enc_p is rounded to the compute dtype, z = tanh(·) is f32 and rounded
for the vocabulary product; gates, carries, LayerNorm and biases are f32
(the LSTM biases rounded to the compute dtype first, as JAX casts them).

:func:`fused_greedy_decode_plain` is the plain version: the same
operations in PyTorch as a batched host loop (one flag read per iteration),
the recognizer's CPU path; at f32 its LSTM step is the eager
``TransducerPrediction.step``'s arithmetic op for op.

The kernel runs one thread-block cluster of C blocks per utterance
(``csrc/decode.cu``): block r owns the gate rows of its H/C LSTM units, its
share of the projection, prejoint and vocabulary rows, and holds as much of
that slice in its shared memory as :func:`decode_plan` assigns (Wv first,
then Wp, Whh, Wih, the projections); the vectors each stage produces are
exchanged through distributed shared memory behind a cluster barrier. C is
16 or 8, chosen from the card's occupancy (:func:`choose_cluster`); larger
batches run in waves.

What bounds the kernel on the card: the chain of up to (factor + 1)·T + 1
dependent iterations per utterance, each a few cluster barriers and the
block's share of the weights read from shared memory; not the card's
bandwidth or its arithmetic (times in PERF.md, row 13).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops.cuda import _build
from tensorflowasr_tpu_torch.utils import tracing

last_launch: Optional[dict] = None  # the last launch's cluster size, occupancy and shared-memory plan

MAX_LAYERS = 4  # csrc/decode.cu DEC_MAX_LAYERS
CLUSTER_SIZES = (16, 8)  # blocks per utterance, in order of preference
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use on the card
SMEM_RESERVE = 2048  # kept free of the plan (the kernel's ~1.1 KB of static shared memory, headroom)
_THREADS, _GROUP = 512, 4  # csrc/decode.cu DEC_THREADS, DEC_GROUP


class FusedLayer(NamedTuple):
    """One prediction-net LSTM layer in the kernel's layout (PyTorch's [out, in] weights)."""

    w_ih: torch.Tensor  # [4H, In] input kernel, compute dtype, gate rows i, f, g, o
    w_hh: torch.Tensor  # [4H, H] hidden kernel, compute dtype
    b: torch.Tensor  # [4H] f32 (rounded to the compute dtype, as JAX casts it)
    ln: Optional[torch.Tensor]  # [2, H] f32 LayerNorm scale (row 0) and bias (row 1), or None
    proj: Optional[Tuple[torch.Tensor, torch.Tensor]]  # ([P, H] compute dtype, [P] f32), or None


class FusedDecodeParams(NamedTuple):
    embed: torch.Tensor  # [V, E] label embedding table, compute dtype
    layers: Tuple[FusedLayer, ...]
    wp: torch.Tensor  # [J, P_last] prejoint prediction kernel, compute dtype
    bp: torch.Tensor  # [J] f32
    wv: torch.Tensor  # [V, J] vocabulary kernel, compute dtype
    bv: torch.Tensor  # [V] f32
    w_enc: torch.Tensor  # [J, E_enc] prejoint encoder kernel (applied outside the kernel), compute dtype
    b_enc: torch.Tensor  # [J] f32
    hidden: int  # LSTM units
    ln_eps: float


def project_encoder(encoded: torch.Tensor, params: FusedDecodeParams) -> torch.Tensor:
    """enc_p [B, T, J] in the compute dtype: the f32 product of the operands
    in the compute dtype, plus the f32 bias, then rounded (JAX ``:388-392``)."""
    dt = params.wv.dtype
    return F.linear(encoded.to(dt).float(), params.w_enc.float(), params.b_enc).to(dt)


def _budget(t: int, window: int, max_token_factor: int):
    """(K, max_tokens, step_max) of a T-frame decode."""
    return min(window, t), max_token_factor * t + 1, (max_token_factor + 1) * t + 1


def _pred_step(params: FusedDecodeParams, tokens: torch.Tensor, states):
    """One prediction-network step on [B] tokens: (pred_p [B, J] f32, new states)."""
    dt = params.embed.dtype
    vocab = params.embed.shape[0]
    in_range = (tokens >= 0) & (tokens < vocab)  # JAX reads the row by a one-hot product: an id outside the table gives 0
    x = params.embed[tokens.clamp(0, vocab - 1)].float() * in_range[:, None]
    new_states = []
    for lyr, (c, h) in zip(params.layers, states):
        gates = F.linear(x.to(dt).float(), lyr.w_ih.float()) + F.linear(h.to(dt).float(), lyr.w_hh.float(), lyr.b)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        new_states.append((c, h))
        x = h
        if lyr.ln is not None:
            x = F.layer_norm(x, x.shape[-1:], lyr.ln[0], lyr.ln[1], params.ln_eps)
        if lyr.proj is not None:
            x = F.linear(x.to(dt).float(), lyr.proj[0].float(), lyr.proj[1])
    return F.linear(x.to(dt).float(), params.wp.float(), params.bp), tuple(new_states)


def _select(mask: torch.Tensor, new, old):
    """Per-row select over a (nested) tuple of [B, ...] tensors."""
    if isinstance(new, tuple):
        return tuple(_select(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def stack_states(states) -> torch.Tensor:
    """One (c [B, H], h [B, H]) pair per layer → [L, 2, B, H] f32, contiguous."""
    return torch.stack([torch.stack([c.float(), h.float()]) for c, h in states]).contiguous()


def unstack_states(stacked: torch.Tensor):
    """[L, 2, B, H] → one (c, h) pair per layer (views)."""
    return tuple((stacked[i, 0], stacked[i, 1]) for i in range(stacked.shape[0]))


def fused_greedy_decode_plain(encoded, encoded_length, params: FusedDecodeParams, initial_tokens, initial_states, blank: int = 0, window: int = 16,
                              max_token_factor: int = 2, gaps: bool = False):
    """Plain PyTorch version of :func:`fused_greedy_decode` (same arguments
    and returns): the JAX kernel's shared loop over the batch, one flag read
    back per iteration. With ``gaps``, also returns [B, max_tokens + 1] f32:
    at each emitted token's position the smallest top-1 minus top-2 logit
    gap over the frames scanned since the previous emission (at position
    ``lengths`` the frames scanned after the last one): how close a
    decision was to flipping."""
    dev = encoded.device
    enc_p = project_encoder(encoded, params)
    batch, t_max = enc_p.shape[:2]
    k, max_tokens, step_max = _budget(t_max, window, max_token_factor)
    tlen = encoded_length.to(dev, torch.int64).clamp(0, t_max)
    rows, ar = torch.arange(batch, device=dev), torch.arange(k, device=dev)
    prev = initial_tokens.to(dev, torch.int64).reshape(batch)
    lag = tuple((c.float(), h.float()) for c, h in initial_states)
    pred_p, cur = _pred_step(params, prev, lag)
    t = torch.zeros(batch, dtype=torch.int64, device=dev)
    idx = torch.zeros(batch, dtype=torch.int64, device=dev)
    tokens = torch.full((batch, max_tokens + 1), blank, dtype=torch.int64, device=dev)  # last column: write sink
    if gaps:
        gap, run_gap = torch.full((batch, max_tokens + 1), float("inf"), device=dev), torch.full((batch,), float("inf"), device=dev)
    step = 0
    while step < step_max and k > 0 and bool((t < tlen).any()):
        start = t.clamp(max=t_max - k)
        offs = start[:, None] + ar[None, :]  # [B, K]
        win = torch.gather(enc_p, 1, offs[:, :, None].expand(batch, k, enc_p.shape[2]))
        z = torch.tanh(win.float() + pred_p[:, None, :]).to(params.wv.dtype)
        logits = F.linear(z.float(), params.wv.float(), params.bv)  # [B, K, V]
        ids = logits.argmax(dim=-1)
        valid = (offs >= t[:, None]) & (offs < tlen[:, None])
        nonblank = (ids != blank) & valid & (idx < max_tokens)[:, None]
        emit = nonblank.any(dim=1)
        first = torch.where(emit, nonblank.to(torch.int8).argmax(dim=1), k)
        tok = ids[rows, first.clamp(max=k - 1)]
        if gaps:
            top2 = logits.topk(min(2, logits.shape[-1]), dim=-1).values
            diff = top2[..., 0] - top2[..., -1]
            scanned = valid & (ar[None, :] <= first[:, None])
            run_gap = torch.minimum(run_gap, torch.where(scanned, diff, float("inf")).amin(dim=1))
            gap[rows, torch.where(emit, idx, max_tokens)] = torch.where(emit, run_gap, gap[rows, max_tokens])
            run_gap = torch.where(emit, float("inf"), run_gap)
        tokens[rows, torch.where(emit, idx, max_tokens)] = torch.where(emit, tok, blank)
        prev = torch.where(emit, tok, prev)
        idx = torch.where(emit, idx + 1, idx)
        t = torch.maximum(torch.where(emit, start + first, torch.minimum(start + k, tlen)), t)
        new_pred, stepped = _pred_step(params, prev, cur)
        pred_p = _select(emit, new_pred, pred_p)
        lag = _select(emit, cur, lag)
        cur = _select(emit, stepped, cur)
        step += 1
    out = (tokens[:, :max_tokens], idx, prev, lag)
    if gaps:
        gap[rows, idx] = run_gap
        return out + (gap,)
    return out


# ----------------------------- the cluster's shared-memory plan ----------------------------- #


def split(n: int, cluster: int, rank: int) -> Tuple[int, int]:
    """(start, count) of block ``rank``'s share of n rows (csrc/decode.cu dec_split_*)."""
    base, rem = divmod(n, cluster)
    return rank * base + min(rank, rem), base + (rank < rem)


class Matrix(NamedTuple):
    """One weight matrix as the kernel partitions it."""

    name: str
    rows: int  # rows of the whole matrix
    k: int  # row length
    gate: bool  # LSTM gate rows: a block owns the four gate rows of each of its units


def matrices(e: int, hidden: int, p: int, j: int, vocab: int, n_layers: int) -> Tuple[Matrix, ...]:
    """The kernel's weight matrices in residency order: Wv, Wp, Whh of each
    layer, Wih of each layer, the projections (csrc/decode.cu dec_mat_k)."""
    last = p or hidden
    out = [Matrix("wv", vocab, j, False), Matrix("wp", j, last, False)]
    out += [Matrix(f"w_hh{l}", 4 * hidden, hidden, True) for l in range(n_layers)]
    out += [Matrix(f"w_ih{l}", 4 * hidden, e if l == 0 else last, True) for l in range(n_layers)]
    out += [Matrix(f"proj{l}", p, hidden, False) for l in range(n_layers)]
    return tuple(out)


def owned_rows(m: Matrix, hidden: int, cluster: int, rank: int) -> list:
    """Global rows of ``m`` that block ``rank`` owns, in its local order."""
    if m.gate:
        u0, nu = split(hidden, cluster, rank)
        return [g * hidden + u0 + u for g in range(4) for u in range(nu)]
    n0, cnt = split(m.rows, cluster, rank)
    return list(range(n0, n0 + cnt))


def _a4(n: int) -> int:
    return (n + 3) & ~3


def _vec_floats(e: int, hidden: int, p: int, j: int, n_layers: int, cluster: int) -> int:
    """Floats of one block's vectors (csrc/decode.cu dec_vec)."""
    nu = -(-hidden // cluster)
    return (_a4(max(e, hidden, p)) + 2 * _a4(hidden) + 2 * n_layers * _a4(hidden) + n_layers * _a4(p) + _a4(j) + _a4(_GROUP * j) + 2 * _a4(4 * nu)
            + 2 * n_layers * _a4(nu) + 2 * (_THREADS // 32) * _GROUP + 4 * cluster * _GROUP + _GROUP)


class DecodePlan(NamedTuple):
    cluster: int
    matrices: Tuple[Matrix, ...]
    rows: Tuple[int, ...]  # per matrix: rows of the largest block's slice
    resident: Tuple[int, ...]  # per matrix: rows of each block's slice held in shared memory
    smem_bytes: int  # dynamic shared memory per block: its vectors, then the resident rows
    resident_bytes: int  # weight bytes resident per block
    slice_bytes: int  # weight bytes of the largest block's slices

    @property
    def whole(self) -> bool:
        """Every block's whole slice is resident."""
        return self.resident == self.rows


def decode_plan(e: int, hidden: int, p: int, j: int, vocab: int, n_layers: int, cluster: int, elt: int) -> DecodePlan:
    """How much of each block's weight slice a cluster of ``cluster`` blocks
    keeps in shared memory at ``elt`` bytes per weight: the vectors first,
    then rows of Wv, Wp, Whh, Wih and the projections in that order, as many
    as fit in SMEM_LIMIT − SMEM_RESERVE (each matrix's region 16-byte
    aligned). Pure function of the widths."""
    mats = matrices(e, hidden, p, j, vocab, n_layers)
    a16 = lambda b: (b + 15) & ~15
    left = SMEM_LIMIT - SMEM_RESERVE - 4 * _vec_floats(e, hidden, p, j, n_layers, cluster)
    if left < 0:
        raise ValueError(f"the decode's vectors need more than {SMEM_LIMIT} bytes of shared memory per block")
    rows, resident, used = [], [], 0
    for m in mats:
        n = 4 * -(-hidden // cluster) if m.gate else -(-m.rows // cluster)
        row_bytes = m.k * elt
        keep = min(n, left // row_bytes) if row_bytes else n
        while keep and a16(keep * row_bytes) > left:
            keep -= 1
        left -= a16(keep * row_bytes)
        used += a16(keep * row_bytes)
        rows.append(n)
        resident.append(keep)
    smem = 4 * _vec_floats(e, hidden, p, j, n_layers, cluster) + used
    slice_bytes = sum(n * m.k * elt for n, m in zip(rows, mats))
    return DecodePlan(cluster, mats, tuple(rows), tuple(resident), smem, sum(r * m.k * elt for r, m in zip(resident, mats)), slice_bytes)


def supported(e: int, hidden: int, p: int, j: int, vocab: int, n_layers: int) -> bool:
    """Whether the kernel takes a prediction net of ``n_layers`` LSTM layers
    (1 to 4) whose vectors fit one block's shared memory at every cluster
    size it may choose (:func:`decode_plan`; the weights stream from L2
    where they do not fit). A pure function of the widths; the recognizer
    runs the eager WIND loop for any other net."""
    if not 1 <= n_layers <= MAX_LAYERS:
        return False
    return all(SMEM_LIMIT - SMEM_RESERVE - 4 * _vec_floats(e, hidden, p, j, n_layers, c) >= 0 for c in CLUSTER_SIZES)


_occupancy: dict = {}


def cluster_occupancy(dev: torch.device, code: int, plan: DecodePlan) -> int:
    """How many clusters of ``plan`` the card can hold at once
    (``cudaOccupancyMaxActiveClusters``), or minus the CUDA error code when
    such a cluster cannot launch at all."""
    key = (dev.index, code, plan.cluster, plan.smem_bytes)
    if key not in _occupancy:
        lib = _build.build()
        with torch.cuda.device(dev):
            _occupancy[key] = lib.tfasr_decode_clusters(plan.cluster, plan.smem_bytes, code)
    return _occupancy[key]


def choose_cluster(batch: int, occupancy: dict) -> int:
    """The cluster size for ``batch`` utterances given the co-resident
    clusters of each size ({16: n16, 8: n8}, 0 where it cannot launch):
    16 unless 8 lets more of the batch run at once (n16 < min(batch, n8)),
    then 8; raises when neither can launch."""
    n16, n8 = occupancy.get(16, 0), occupancy.get(8, 0)
    if n16 < 1 and n8 < 1:
        raise RuntimeError(f"fused_greedy_decode: neither a cluster of 16 nor of 8 blocks can launch on this card (occupancy {occupancy})")
    return 16 if n16 >= 1 and n16 >= min(batch, n8) else 8


def _check(encoded, encoded_length, params: FusedDecodeParams, initial_tokens, initial_states):
    dev, dt = encoded.device, params.wv.dtype
    code = _build.compute_dtype(params.wv, "params.wv")
    if encoded.dim() != 3:
        raise ValueError("encoded must be [B, T, E]")
    batch = encoded.shape[0]
    n_layers = len(params.layers)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"{n_layers} LSTM layers: the kernel takes 1 to {MAX_LAYERS}")
    if len(initial_states) != n_layers:
        raise ValueError(f"{len(initial_states)} initial states for {n_layers} layers")
    vocab, e = params.embed.shape
    hidden = params.hidden
    j = params.wv.shape[1]
    proj = params.layers[0].proj
    p = proj[0].shape[0] if proj is not None else 0
    in_dim = e
    for i, lyr in enumerate(params.layers):
        _build.require(lyr.w_ih, f"layer {i} w_ih", device=dev, dtype=dt, shape=(4 * hidden, in_dim))
        _build.require(lyr.w_hh, f"layer {i} w_hh", device=dev, dtype=dt, shape=(4 * hidden, hidden))
        _build.require(lyr.b, f"layer {i} b", device=dev, dtype=torch.float32, shape=(4 * hidden,))
        if lyr.ln is not None:
            _build.require(lyr.ln, f"layer {i} ln", device=dev, dtype=torch.float32, shape=(2, hidden))
        if (lyr.proj is None) != (proj is None):
            raise ValueError("every layer or none has a projection")
        if lyr.proj is not None:
            _build.require(lyr.proj[0], f"layer {i} projection", device=dev, dtype=dt, shape=(p, hidden))
            _build.require(lyr.proj[1], f"layer {i} projection bias", device=dev, dtype=torch.float32, shape=(p,))
        in_dim = p or hidden
    if not supported(e, hidden, p, j, vocab, n_layers):
        raise ValueError(f"the decode's vectors (E {e}, H {hidden}, P {p}, J {j}) need more than {SMEM_LIMIT} bytes of shared memory per block")
    _build.require(params.embed, "embed", device=dev, dtype=dt, shape=(vocab, e))
    _build.require(params.wp, "wp", device=dev, dtype=dt, shape=(j, in_dim))
    _build.require(params.bp, "bp", device=dev, dtype=torch.float32, shape=(j,))
    _build.require(params.wv, "wv", device=dev, dtype=dt, shape=(vocab, j))
    _build.require(params.bv, "bv", device=dev, dtype=torch.float32, shape=(vocab,))
    for name, x in (("encoded_length", encoded_length), ("initial_tokens", initial_tokens)):
        if x.device != dev or x.numel() != batch:
            raise ValueError(f"{name}: {x.numel()} values on {x.device}, expected {batch} on {dev}")
    for i, (c, h) in enumerate(initial_states):
        for name, x in (("c", c), ("h", h)):
            if x.device != dev or tuple(x.shape) != (batch, hidden):
                raise ValueError(f"initial state {name} of layer {i}: {tuple(x.shape)} on {x.device}, expected ({batch}, {hidden}) on {dev}")
    return code, (e, hidden, p, j, vocab)


def fused_greedy_decode_kernel(encoded, encoded_length, params: FusedDecodeParams, initial_tokens, initial_states, blank: int = 0, window: int = 16,
                               max_token_factor: int = 2, cluster: Optional[int] = None):
    """The kernel on CUDA tensors: one cluster of blocks per utterance runs
    its own WIND loop (a finished row of the JAX shared loop only idles, so
    the outputs are the same). ``cluster`` fixes the blocks per utterance
    (default: :func:`choose_cluster` from the card's occupancy); a size the
    card cannot launch raises."""
    tokens, lengths, next_tokens, states = fused_greedy_decode_kernel_stacked(encoded, encoded_length, params, initial_tokens, initial_states, blank,
                                                                             window, max_token_factor, cluster)
    return tokens, lengths, next_tokens, unstack_states(states)


def fused_greedy_decode_kernel_stacked(encoded, encoded_length, params: FusedDecodeParams, initial_tokens, initial_states, blank: int = 0,
                                       window: int = 16, max_token_factor: int = 2, cluster: Optional[int] = None):
    """:func:`fused_greedy_decode_kernel` with the states carried out as one
    [L, 2, B, H] f32 tensor (c then h per layer)."""
    global last_launch
    code, (e, hidden, p, j, vocab) = _check(encoded, encoded_length, params, initial_tokens, initial_states)
    dev = encoded.device
    enc_p = project_encoder(encoded, params).contiguous()
    batch, t_max = enc_p.shape[:2]
    k, max_tokens, step_max = _budget(t_max, window, max_token_factor)
    lens = encoded_length.to(torch.int32).reshape(batch).contiguous()
    tok0 = initial_tokens.to(torch.int32).reshape(batch).contiguous()
    st0 = stack_states(initial_states)
    if batch == 0:
        return torch.full((0, max_tokens), blank, dtype=torch.long, device=dev), torch.zeros(0, dtype=torch.long, device=dev), tok0.long(), st0.clone()
    with tracing.kernel("kernel.decode", enc_p, params.wv):
        tokens = torch.full((batch, max_tokens), blank, dtype=torch.int32, device=dev)
        out_len, next_tok = torch.zeros(batch, dtype=torch.int32, device=dev), tok0.clone()
        st_out = st0.clone()
        n = len(params.layers)
        elt = params.wv.element_size()
        sizes = (cluster,) if cluster is not None else CLUSTER_SIZES
        plans = {c: decode_plan(e, hidden, p, j, vocab, n, c, elt) for c in sizes}
        occ = {c: cluster_occupancy(dev, code, plans[c]) for c in sizes}
        if cluster is None:
            chosen = choose_cluster(batch, {c: max(n, 0) for c, n in occ.items()})
        elif occ[cluster] < 1:
            raise RuntimeError(f"fused_greedy_decode: a cluster of {cluster} blocks with {plans[cluster].smem_bytes} bytes of shared memory each "
                               f"cannot launch on this card (occupancy {occ[cluster]}: a negative value is minus the CUDA error)")
        else:
            chosen = cluster
        plan = plans[chosen]
        arr = lambda ptrs: (ctypes.c_void_p * MAX_LAYERS)(*ptrs)  # host arrays, one pointer per layer
        layers = params.layers
        w_ih, w_hh, b = arr([l.w_ih.data_ptr() for l in layers]), arr([l.w_hh.data_ptr() for l in layers]), arr([l.b.data_ptr() for l in layers])
        ln = arr([_build.ptr(l.ln) for l in layers])
        w_proj, b_proj = arr([_build.ptr(l.proj and l.proj[0]) for l in layers]), arr([_build.ptr(l.proj and l.proj[1]) for l in layers])
        res = (ctypes.c_int * len(plan.resident))(*plan.resident)
        lib = _build.build()
        with torch.cuda.device(dev):
            err = lib.tfasr_greedy_decode(
                enc_p.data_ptr(), lens.data_ptr(), tok0.data_ptr(), params.embed.data_ptr(), n,
                *(ctypes.addressof(a) for a in (w_ih, w_hh, b, ln, w_proj, b_proj)),
                params.wp.data_ptr(), params.bp.data_ptr(), params.wv.data_ptr(), params.bv.data_ptr(), st0.data_ptr(),
                tokens.data_ptr(), out_len.data_ptr(), next_tok.data_ptr(), st_out.data_ptr(),
                batch, t_max, e, hidden, p, j, vocab, k, max_tokens, step_max, int(blank), float(params.ln_eps), plan.cluster, ctypes.addressof(res),
                code, _build.stream_of(enc_p),
            )
        _build.check(err, "fused_greedy_decode")
        last_launch = dict(cluster=plan.cluster, occupancy=occ, smem_bytes=plan.smem_bytes, resident_bytes=plan.resident_bytes,
                           slice_bytes=plan.slice_bytes, whole=plan.whole, batch=batch)
    return tokens.long(), out_len.long(), next_tok.long(), st_out


def fused_greedy_decode(encoded, encoded_length, params: FusedDecodeParams, initial_tokens, initial_states, blank: int = 0, window: int = 16,
                        max_token_factor: int = 2):
    """Batched WIND greedy decode in one kernel launch (the JAX
    ``fused_greedy_decode`` minus ``interpret``).

    encoded: [B, T, E_enc] encoder output (before the joint's projection);
    encoded_length, initial_tokens: [B]; initial_states: one (c [B, H], h
    [B, H]) per LSTM layer; params: :class:`FusedDecodeParams` (its dtype is
    the compute dtype). Returns (tokens [B, factor·T + 1] int64 blank-padded,
    lengths [B], next_tokens [B], next_states) with the WIND carry-out
    (the states from before the last emitted token's step, f32). A CUDA
    tensor launches the kernel or raises; a CPU tensor takes
    :func:`fused_greedy_decode_plain`. Under ``torch.export`` the call is the
    custom operator ``tfasr::fused_greedy_decode`` (``ops/cuda/library.py``),
    which does the same at run time.
    """
    if torch.compiler.is_exporting():
        from tensorflowasr_tpu_torch.ops.cuda import library

        return library.fused_greedy_decode_op(encoded, encoded_length, params, initial_tokens, initial_states, blank, window, max_token_factor)
    if encoded.device.type == "cpu":
        return fused_greedy_decode_plain(encoded, encoded_length, params, initial_tokens, initial_states, blank, window, max_token_factor)
    if encoded.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {encoded.device}")
    return fused_greedy_decode_kernel(encoded, encoded_length, params, initial_tokens, initial_states, blank, window, max_token_factor)
