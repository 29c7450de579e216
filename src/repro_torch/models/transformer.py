"""Decoder-style transformer LM: RoPE / GQA / SwiGLU / RMSNorm, optional MoE
(sort-based static-capacity dispatch), optional bidirectional mode with
learned positions (BERT4Rec reuses this), optional SPLADE-style sparse head.

The port of ``repro.models.transformer``, as plain functions over a
parameter dict with the reference's layout: layer weights stacked
``[L, ...]`` and applied as ``x @ W``, so parameters carry over unchanged
(``bridge.transformer_params_from_arrays``). The projections, the FFN
(dense or MoE: the expert products are batched ``torch.bmm``) and the
logits are ``torch.matmul``.

Attention is an argument of the forward passes, chosen by the caller.
Serving takes the default, ``attention``: the hand-written flash-attention
kernel (``kernels.flash_attention``) on CUDA tensors, its plain version on
CPU tensors. The kernel has no backward, so the training loss
(``lm_loss``, and every loss that differentiates a forward) passes
``scores_attention``, the port of the reference's ``_attention``, which
autograd differentiates.

Mixed precision: parameters are stored in ``param_dtype`` (fp32 by
default) and every weight is cast to ``compute_dtype`` where it is used, as
in the reference. ``compute_params`` makes that cast once, ahead of serving;
the values are the same. Logits are float32 at any compute dtype.

Sharding: ``Rules.c`` and ``Rules.w`` are the reference's sharding
constraints; they act on ``DTensor``s (a mesh-sharded model, the dry run)
and leave plain tensors untouched, so a model on one card runs as it
did. ``Rules.dp_size`` is semantics, the MoE layer's number of dispatch
groups. ``unroll`` is kept so that the configs read as the reference's,
and has no effect here.
``attn_chunk`` bounds ``scores_attention``'s scores to that many query
rows at a time (the kernel never holds more than a tile's). ``remat``
recomputes each layer in the backward pass (``remat_policy="full"``,
``torch.utils.checkpoint``) when a forward without a cache runs with
gradients on. ``forward`` returns the MoE layers' summed load-balancing
loss. A KV cache is updated in place (the reference returns a new one)
and returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from ..core.index import check_full_f32
from ..dist.sharding import as_placed
from ..core.traversal import _topk_stable
from ..kernels import flash_attention as fa
from ..sparse_ops import take_rows


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    moe: MoEConfig | None = None
    causal: bool = True
    rope: bool = True
    max_position: int = 0      # >0: learned positional embeddings
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    sparse_head: bool = False  # SPLADE-style log1p-relu-maxpool head
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True         # recompute each layer in the backward pass
    remat_policy: str = "full"  # only "full" is ported
    unroll: bool = False       # no effect: layers are a Python loop
    attn_chunk: int = 0        # >0: scores_attention holds chunk rows at once
    kv_quant: bool = False     # int8 KV cache (per-position scales)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a 128 multiple (the reference's layout;
        logical ``vocab`` is kept for sampling and the sparse head)."""
        return -(-self.vocab // 128) * 128

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (2 * self.n_heads + 2 * self.n_kv_heads)
        if self.moe is not None:
            ffn = (self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                   + d * self.moe.n_experts)
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        embed = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        pos = self.max_position * d
        return self.n_layers * per_layer + embed + pos + d

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        attn = d * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        per_layer = attn + ffn + 2 * d + d * self.moe.n_experts
        embed = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.max_position * d + d


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axis names (None = replicated), as the
    reference's. ``c`` and ``w`` are the reference's sharding constraints,
    acting on ``DTensor``s (their own ``device_mesh`` names the axes) and
    leaving plain tensors untouched, so a model on one card runs as it
    did. One field is semantics, not a hint: ``dp_size`` sets the MoE
    layer's number of dispatch groups, and capacity (which assignments
    drop) is per group."""
    batch: Any = None       # activation batch dim
    heads: Any = None       # attention heads / ffn inner / experts
    kv_seq: Any = None      # KV cache sequence (SP for long decode)
    vocab: Any = None
    dp_size: int = 1        # data-shard count = MoE dispatch group count
    gather_weights: bool = False  # FSDP: all-gather weights in compute dtype

    def c(self, x, spec):
        """A DTensor ``x`` laid out as ``spec`` (entry d: the mesh axes that
        split dim d, or None), a dim that its axes do not divide
        replicated, as the placement rules replicate one; anything else
        as it is."""
        return constrain(x, spec)

    def w(self, weight, dtype):
        """A parameter cast for compute; under FSDP a DTensor's cast is
        then replicated, so the per-layer all-gather moves the compute
        dtype, not the float32 master shard."""
        weight = weight.to(dtype)
        if self.gather_weights:
            weight = constrain(weight, (None,) * weight.dim())
        return weight


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _placements_for(shape, spec, mesh) -> tuple:
    """DTensor placements of ``spec`` for a tensor of ``shape`` on
    ``mesh``: dims beyond the spec, and dims its axes do not divide,
    replicated."""
    from ..dist.sharding import P, placements
    from ..launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)
    entries = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        entries.append(e if axes and n % math.prod(sizes[a] for a in axes)
                       == 0 else None)
    return placements(P(*entries), mesh)


def constrain(x, spec):
    """``Rules.c``: a DTensor redistributed to ``spec``'s placements on its
    own mesh (``_placements_for``), its gradient laid out alike in the
    backward pass (as JAX constrains a sharding constraint's cotangent);
    a plain tensor untouched."""
    if not _is_dtensor(x):
        return x
    want = _placements_for(x.shape, spec, x.device_mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return _GradLaidOut.apply(x)


NO_RULES = Rules()


def quantize_kv(x):
    """Per-(batch, pos, head) int8 quantization: [..., Dh] -> (q, scale)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree's shapes, in the reference's layout (MoE: a
    router ``[L, d, E]`` and per-expert FFN weights ``[L, E, ...]``)."""
    d, dh = cfg.d_model, cfg.head_dim
    h, hkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    shapes = {
        "embed": (cfg.padded_vocab, d),
        "final_norm": (d,),
        "layers": {
            "attn_norm": (n, d), "ffn_norm": (n, d),
            "wq": (n, d, h * dh), "wk": (n, d, hkv * dh),
            "wv": (n, d, hkv * dh), "wo": (n, h * dh, d),
        },
    }
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        shapes["layers"].update(router=(n, d, e), w_gate=(n, e, d, f),
                                w_up=(n, e, d, f), w_down=(n, e, f, d))
    else:
        shapes["layers"].update(w_gate=(n, d, cfg.d_ff),
                                w_up=(n, d, cfg.d_ff),
                                w_down=(n, cfg.d_ff, d))
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.padded_vocab)
    if cfg.max_position:
        shapes["pos_embed"] = (cfg.max_position, d)
    return shapes


def init_params(cfg: TransformerConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device: norms 1, matrices normal with
    std sqrt(2 / (fan_in + fan_out)) over their last two dims (the
    reference's scheme; its draws differ, its key being a JAX key)."""
    dev, pt = gen.device, cfg.param_dtype

    def make(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=pt, device=dev)
        t = torch.randn(shape, generator=gen, device=dev)
        t.mul_((2.0 / (shape[-2] + shape[-1])) ** 0.5)
        return t.to(pt)

    return {name: ({n: make(n, s) for n, s in shape.items()}
                   if isinstance(shape, dict) else make(name, shape))
            for name, shape in param_shapes(cfg).items()}


def compute_params(cfg: TransformerConfig, params: dict) -> dict:
    """Every parameter cast to ``compute_dtype`` once: the values each use
    casts to anyway, held ahead of serving, and the logits head of those
    values widened to float32 (``head_f32``, which ``logits_fn`` would
    otherwise widen at every call). Returns a new tree (a tensor already
    in that dtype is shared)."""
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(cfg.compute_dtype)
                for k, v in tree.items()}
    out = cast(params)
    out["head_f32"] = _head(cfg, out).float()
    return out


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def rms_norm(x, w, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w.to(x.dtype)


def rope(x, positions, theta):
    """x: [B, S, H, Dh]; positions: [B, S]. cos and sin in float32, cast to
    x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs             # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, causal: bool, q_offset: int, chunk: int = 0):
    """q: [B, Sq, H, Dh]; k, v: [B, Skv, Hkv, Dh] -> [B, Sq, H, Dh].

    One flash-attention call on transposed views (the kernel reads the
    [B, S, H, Dh] layout in place); ``chunk`` has nothing to bound, as the
    kernel holds one tile of scores at a time. The kernel has no backward:
    on the card it refuses inputs that require grad in grad mode. The reference's ``_attention`` divides
    the float32 scores by sqrt(Dh) and masks with -1e30; the kernel
    multiplies by 1/sqrt(Dh) and masks with -inf: the same up to float32
    rounding. The reference rounds the softmax weights to the compute
    dtype before P V; so does the plain version here (``round_p``), and on
    the card the "mma" and "split" routes, which round the unnormalized
    weights as the TPU kernel does."""
    o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           kv_offset=q_offset, round_p=True)
    return o.transpose(1, 2)


def scores_attention(q, k, v, causal: bool, q_offset: int, chunk: int = 0):
    """q: [B, Sq, H, Dh]; k, v: [B, Skv, Hkv, Dh] -> [B, Sq, H, Dh], with
    the arithmetic of the reference's ``_attention``: float32 scores of the
    widened operands (each product exact, as the reference's float32
    accumulation of compute-dtype operands) divided by sqrt(Dh), -1e30
    above the causal diagonal, a float32 softmax, and the weights cast to
    v's dtype before the weighted sum. Plain torch ops, so autograd
    differentiates it: the train path's attention. With ``chunk`` > 0 and
    Sq a multiple of it, the query rows go ``chunk`` at a time (each at its
    own offset), so the scores of only ``chunk`` rows exist at once."""
    b, sq, h, dh = q.shape
    if chunk and sq > chunk and sq % chunk == 0:
        return torch.cat([scores_attention(q[:, i:i + chunk], k, v, causal,
                                           q_offset + i)
                          for i in range(0, sq, chunk)], dim=1)
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = s / torch.sqrt(torch.tensor(float(dh)))
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(b, sq, h, dh)


def _dense_ffn(x, w_gate, w_up, w_down, rules: Rules):
    hg = x @ rules.w(w_gate, x.dtype)
    hu = x @ rules.w(w_up, x.dtype)
    h = rules.c(F.silu(hg) * hu, (rules.batch, rules.heads))
    return h @ rules.w(w_down, x.dtype)


@dataclasses.dataclass(frozen=True)
class MoEDispatch:
    """One MoE layer's routing of T = G x Tl tokens, per dispatch group;
    assignments [G, Tl, K] in each token's top-k order (descending
    probability, the lower expert first among ties)."""
    capacity: int               # slots per (group, expert)
    logits: torch.Tensor        # [G, Tl, E] float32
    probs: torch.Tensor         # [G, Tl, E] float32 softmax
    top_e: torch.Tensor         # [G, Tl, K] int64 experts
    top_p: torch.Tensor         # [G, Tl, K] float32, summing to 1 per token
    slot: torch.Tensor          # [G, Tl, K] int64 arrival rank in the expert
    keep: torch.Tensor          # [G, Tl, K] bool: slot < capacity

    @property
    def groups(self) -> int:
        return self.top_e.shape[0]


def moe_groups(t: int, dp_size: int) -> int:
    """The reference's dispatch group count for ``t`` tokens: ``dp_size``,
    or for a ``t`` it does not divide (tiny decode batches) the largest
    power of two <= ``dp_size`` that divides ``t``."""
    g = max(1, dp_size)
    if t % g != 0:
        g = 1
        while t % (g * 2) == 0 and g * 2 <= dp_size:
            g *= 2
    return g


def moe_capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    """Slots per (group, expert), in Python floats as the reference."""
    return int(tokens_per_group * moe.top_k * moe.capacity_factor
               / moe.n_experts + 1)


def moe_route(x, router, moe: MoEConfig, rules: Rules = NO_RULES
              ) -> MoEDispatch:
    """Token-choice top-k routing of x [T, D] with group-wise capacity
    (GShard), as the reference's ``_moe_ffn``: float32 logits of the
    compute-dtype operands (each product exact in float32), a float32
    softmax, a stable top-k, and within each group an expert's slots
    filled in (token, rank) order: a stable sort by expert, its start by
    ``searchsorted``."""
    t, d = x.shape
    g = moe_groups(t, rules.dp_size)
    return _route(x.view(g, t // g, d), rules.w(router, x.dtype), moe)


def _route(xg, router, moe: MoEConfig) -> MoEDispatch:
    """``moe_route`` of the groups xg [G, Tl, D] (plain tensors) with the
    router already cast."""
    g, tl, _ = xg.shape
    e, k = moe.n_experts, moe.top_k
    # TF32 would change the logits, and with them the experts picked
    check_full_f32(xg.device, "the MoE router")
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _topk_stable(probs, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    sorted_e, order = torch.sort(top_e.reshape(g, tl * k), dim=-1,
                                 stable=True)
    experts = torch.arange(e, device=xg.device).expand(g, e).contiguous()
    start = torch.searchsorted(sorted_e, experts, side="left")
    rank = (torch.arange(tl * k, device=xg.device)
            - torch.gather(start, 1, sorted_e))
    slot = torch.empty_like(rank).scatter_(1, order, rank).view(g, tl, k)
    cap = moe_capacity(tl, moe)
    return MoEDispatch(cap, logits, probs, top_e, top_p, slot, slot < cap)


def _moe_rows(r: MoEDispatch) -> torch.Tensor:
    """[G, Tl, K]: each kept assignment's row of the E-major expert buffer
    [E, G, C] flattened; a dropped assignment gets row 0 (``_moe_combine``
    leaves it out)."""
    g, _, _ = r.top_e.shape
    grp = torch.arange(g, device=r.top_e.device).view(g, 1, 1)
    return torch.where(r.keep, (r.top_e * g + grp) * r.capacity + r.slot, 0)


def _moe_combine(out_rows, row, r: MoEDispatch) -> torch.Tensor:
    """y [T, D]: each token's k expert outputs (rows of ``out_rows``
    [E x G x C, D]), each times its weight in the output's dtype, added
    from zero in ascending-expert order: the order of the reference's
    scatter-add over the expert-sorted assignments (one token's k experts
    are distinct). A dropped assignment adds +0, selected by ``keep`` as
    the reference selects its zero rows, so its row-0 output never enters
    the sum (a non-finite row 0 stays out of other tokens). Plain adds, no
    atomics, so the sum is the same on every run."""
    k = row.shape[-1]
    by_expert = torch.argsort(r.top_e, dim=-1, stable=True)
    row = torch.gather(row, -1, by_expert).view(-1, k)
    keep = torch.gather(r.keep, -1, by_expert).view(-1, k, 1)
    w = torch.gather(r.top_p, -1, by_expert).to(out_rows.dtype).view(-1, k, 1)
    y = out_rows.new_zeros(row.shape[0], out_rows.shape[-1])
    for j in range(k):
        y = y + torch.where(keep[:, j], out_rows[row[:, j]] * w[:, j], 0.0)
    return y


def _moe_ffn(x, router, w_gate, w_up, w_down, moe: MoEConfig,
             rules: Rules = NO_RULES):
    """Token-choice top-k MoE over x [T, D] -> (y [T, D], aux loss), the
    port of the reference's ``_moe_ffn``.

    Each kept assignment's token row goes to its (expert, group, slot) row
    of the buffer [E, G x C, D] (one gather: every row has at most one
    kept assignment; an empty row takes token 0, whose outputs there are
    never read), the three expert products are batched over E (float32
    accumulation, the compute dtype out), and ``_moe_combine`` sums each
    token's weighted expert outputs. The aux loss is Switch's,
    E * sum(frac_tokens * frac_probs) over the top-1 experts. A DTensor
    ``x`` takes ``_moe_ffn_sharded``."""
    if _is_dtensor(x):
        return _moe_ffn_sharded(x, router, w_gate, w_up, w_down, moe, rules)
    r = moe_route(x, router, moe, rules)
    ws = [rules.w(w, x.dtype) for w in (w_gate, w_up, w_down)]
    out_e, row = _moe_experts(x, r, ws, 0)
    y = _moe_combine(out_e.view(-1, x.shape[1]), row, r)
    frac_t = F.one_hot(r.top_e[..., 0].reshape(-1), moe.n_experts
                       ).float().mean(0)
    frac_p = r.probs.mean(dim=(0, 1))
    return y, moe.n_experts * (frac_t * frac_p).sum()


def _moe_experts(x, r: MoEDispatch, ws, first: int):
    """(outputs [E', G x C, D] of experts first .. first + E' - 1, the
    assignments' buffer rows [G, Tl, K]) for the tokens x [G x Tl, D] of
    the dispatch ``r`` and those experts' weights ``ws`` (gate, up, down)."""
    t, d = x.shape
    e, k = r.probs.shape[-1], r.top_e.shape[-1]
    rows = e * r.groups * r.capacity
    row = _moe_rows(r)
    # dropped assignments write their token to a spare last entry
    src = torch.zeros(rows + 1, dtype=torch.long, device=x.device)
    src[torch.where(r.keep, row, rows).flatten()] = torch.arange(
        t, device=x.device).repeat_interleave(k)
    n = ws[0].shape[0]
    buf = x[src[:rows]].view(e, -1, d)[first:first + n]
    hg = torch.bmm(buf, ws[0])
    hu = torch.bmm(buf, ws[1])
    return torch.bmm(F.silu(hg) * hu, ws[2]), row


def _moe_ffn_sharded(x, router, w_gate, w_up, w_down, moe: MoEConfig,
                     rules: Rules):
    """``_moe_ffn`` of a DTensor x [T, D] on its mesh, as the reference's
    sharded layer: the G dispatch groups split over the data axes (each
    rank routes its own groups), the expert weights split over E where a
    mesh dim that splits no group splits them (expert parallelism: each
    rank runs its experts on its groups' buffer), their outputs gathered
    over those dims (an all-gather) for the combine. Routing (a sort, a
    ``searchsorted``) and the combine run on each rank's local tensors;
    the aux loss's means are averaged over the group split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    t, d = x.shape
    e = moe.n_experts
    g = moe_groups(t, rules.dp_size)
    xg = rules.c(x.view(g, t // g, d), (rules.batch, None, None))
    mesh = xg.device_mesh
    groups = [p if p == Shard(0) else Replicate() for p in xg.placements]
    xl = xg.redistribute(mesh, groups).to_local()          # [Gl, Tl, D]
    r = _route(xl, _whole(rules.w(router, x.dtype)), moe)
    ws = [rules.w(w, x.dtype) for w in (w_gate, w_up, w_down)]
    experts = [Shard(0) if (p == Shard(0) and groups[m] == Replicate()
                            and e % mesh.shape[m] == 0) else Replicate()
               for m, p in enumerate(ws[0].placements)]
    local = [as_placed(w, mesh, experts).to_local() for w in ws]
    first, n_loc = 0, local[0].shape[0]
    coord = mesh.get_coordinate()
    for m, p in enumerate(experts):
        if p == Shard(0):
            first = first * mesh.shape[m] + coord[m]
    out_l, row = _moe_experts(xl.reshape(-1, d), r, local, first * n_loc)
    by_group = [Shard(1) if p == Shard(0) else Replicate() for p in groups]
    out = DTensor.from_local(out_l, mesh, [
        Shard(0) if p == Shard(0) else by_group[m]
        for m, p in enumerate(experts)], run_check=False)
    out = out.redistribute(mesh, by_group).to_local()     # [E, Gl x C, D]
    y = _moe_combine(out.reshape(-1, d), row, r).view(xl.shape)
    y = DTensor.from_local(y, mesh, groups, run_check=False,
                           shape=xg.shape, stride=xg.stride())
    y = rules.c(y, (rules.batch, None, None)).view(t, d)
    mean = [Partial("avg") if p == Shard(0) else Replicate() for p in groups]
    whole = [Replicate()] * mesh.ndim
    frac_t = F.one_hot(r.top_e[..., 0].reshape(-1), e).float().mean(0)
    frac_p = r.probs.mean(dim=(0, 1))
    frac_t, frac_p = (DTensor.from_local(f, mesh, mean, run_check=False
                                         ).redistribute(mesh, whole)
                      for f in (frac_t, frac_p))
    return y, e * (frac_t * frac_p).sum()


def _whole(t):
    """A DTensor's whole value on every rank (gathered where split), or
    ``t`` itself."""
    return t.full_tensor() if _is_dtensor(t) else t


def _per_shard(attn, q, k, v, causal: bool, q_offset: int, chunk: int):
    """``attn(q, k, v, ...)`` with q [B, Sq, H, Dh], k, v [B, Skv, Hkv, Dh];
    with DTensors, on each rank's shards: the batch where q splits it,
    the heads where q splits them and the split divides H and Hkv (each
    rank's query heads then attend its own kv heads), everything else
    whole. Attention is independent per (batch, head), so the local calls
    are the whole call's parts."""
    if not _is_dtensor(q):
        return attn(q, k, v, causal, q_offset, chunk)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    h, hkv = q.shape[2], k.shape[2]
    place = []
    for m, p in enumerate(q.placements):
        n = mesh.shape[m]
        if p == Shard(0) and q.shape[0] % n == 0:
            place.append(Shard(0))
        elif p == Shard(2) and h % n == 0 and hkv % n == 0:
            place.append(Shard(2))
        else:
            place.append(Replicate())
    ql, kl, vl = (as_placed(t, mesh, place).to_local() for t in (q, k, v))
    o = attn(ql, kl, vl, causal, q_offset, chunk).contiguous()
    return DTensor.from_local(o, mesh, place, run_check=False,
                              shape=q.shape, stride=_contiguous(q.shape))


class _GradLaidOut(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is laid out as the DTensor
    was. Placed after a reshape, it keeps the reshape's backward view
    possible: a gradient split where the forward value was whole (a
    row-split projection's backward splits its input's columns, a sum of
    two gradients may split the tokens over every mesh dim) may not view
    back into heads, or into a batch, that the split does not divide."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is whole on each rank
        ctx.layout = (x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, place = ctx.layout
        if tuple(grad.placements) != place:
            grad = grad.redistribute(mesh, place)
        return grad


def _grad_laid_out(x):
    return _GradLaidOut.apply(x) if _is_dtensor(x) else x


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def _write_cache(cache_t, fresh, start: int):
    """Write ``fresh`` [B, S, ...] into ``cache_t`` [B, max_len, ...] at
    ``start``, in place. The reference's dynamic_update_slice clamps a
    start that would overflow; here that raises."""
    s = fresh.shape[1]
    if start < 0 or start + s > cache_t.shape[1]:
        raise ValueError(f"cache of {cache_t.shape[1]} positions cannot take "
                         f"{s} more at {start}")
    cache_t[:, start:start + s] = fresh


def _layer(cfg: TransformerConfig, rules: Rules, x, lp, positions,
           layer_cache=None, cache_len: int = 0, attn=None):
    """One block. x: [B, S, D]; ``layer_cache`` (k, v) or, with
    ``kv_quant``, (k, v, k_scale, v_scale) of this layer, written in
    place; ``attn`` is ``attention`` (the kernel; None) or
    ``scores_attention``. Returns (x, the MoE aux loss or None)."""
    attn = attn or attention
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    # the norms' backward may split a gradient's tokens where the residual
    # is whole: their inputs keep the residual's layout (_grad_laid_out)
    xn = rms_norm(_grad_laid_out(x), lp["attn_norm"], cfg.norm_eps)
    q = _heads(xn @ rules.w(lp["wq"], cd), h)
    k = _heads(xn @ rules.w(lp["wk"], cd), hkv)
    v = _heads(xn @ rules.w(lp["wv"], cd), hkv)
    if cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q_offset = 0
    if layer_cache is not None and cfg.kv_quant:
        ck, cv, cks, cvs = layer_cache
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for dst, src in ((ck, kq), (cv, vq), (cks, ks), (cvs, vs)):
            _write_cache(dst, src, cache_len)
        k = dequantize_kv(ck, cks, cd)
        v = dequantize_kv(cv, cvs, cd)
        q_offset = cache_len
    elif layer_cache is not None:
        ck, cv = layer_cache
        _write_cache(ck, k, cache_len)
        _write_cache(cv, v, cache_len)
        k, v = ck, cv
        q_offset = cache_len
    o = _per_shard(attn, q, k, v, cfg.causal, q_offset, cfg.attn_chunk)
    x = x + _grad_laid_out(o.reshape(b, s, h * dh)) @ rules.w(lp["wo"], cd)
    xn = _grad_laid_out(rms_norm(_grad_laid_out(x), lp["ffn_norm"],
                                 cfg.norm_eps).reshape(b * s, -1))
    aux = None
    if cfg.moe is not None:
        y, aux = _moe_ffn(xn, lp["router"], lp["w_gate"], lp["w_up"],
                          lp["w_down"], cfg.moe, rules)
    else:
        y = _dense_ffn(xn, lp["w_gate"], lp["w_up"], lp["w_down"], rules)
    return rules.c(x + y.view(b, s, -1), (rules.batch, None, None)), aux


def _heads(x, n: int):
    """[B, S, n x Dh] -> [B, S, n, Dh]. A DTensor split on its last dim by a
    mesh dim that does not divide ``n`` is gathered there first: the
    head counts need not divide the mesh (granite's 8 kv heads on a
    model axis of 16), and a split head cannot be viewed."""
    b, s, f = x.shape
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        want = [Replicate() if p == Shard(2) and n % mesh.shape[m] else p
                for m, p in enumerate(x.placements)]
        if want != list(x.placements):
            x = x.redistribute(mesh, want)
    return x.view(b, s, n, f // n)


CACHE_KEYS = ("k", "v")
CACHE_KEYS_Q = ("k", "v", "k_scale", "v_scale")


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            rules: Rules = NO_RULES, cache: dict | None = None,
            cache_len: int | None = None, *, attention=None):
    """tokens: [B, S]. Returns (hidden [B, S, D], aux_loss, cache or
    None): the aux loss is the sum of the MoE layers' (a float32 scalar,
    0 for a dense model); a cache is written in place from position
    ``cache_len``. ``attention``: None for the kernel (``attention``,
    serving) or ``scores_attention`` (a forward that autograd
    differentiates). With
    ``cfg.remat``, no cache and gradients on, each layer runs under
    ``torch.utils.checkpoint`` (``remat_policy="full"``: only its input is
    kept, the layer is recomputed in the backward pass)."""
    cd = cfg.compute_dtype
    b, s = tokens.shape
    tokens = tokens.long()
    x = take_rows(params["embed"], tokens).to(cd)
    start = 0 if cache is None else int(cache_len)
    positions = (start + torch.arange(s, device=tokens.device)).expand(b, s)
    if cfg.max_position:
        x = x + take_rows(params["pos_embed"], positions).to(cd)
    x = rules.c(x, (rules.batch, None, None))
    keys = CACHE_KEYS_Q if cfg.kv_quant else CACHE_KEYS
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(f"remat_policy {cfg.remat_policy!r}: only "
                                  f"'full' is ported")
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # one unbind per stacked weight: its backward stacks the layers'
    # gradients once (indexing each layer would add a full-size gradient
    # per layer)
    stacked = {name: t.unbind(0) for name, t in params["layers"].items()}
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in stacked.items()}
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer, cfg, rules, x, lp, positions, None, 0, attention,
                use_reentrant=False)
        else:
            layer_cache = (None if cache is None
                           else tuple(cache[key][i] for key in keys))
            x, a = _layer(cfg, rules, x, lp, positions, layer_cache, start,
                          attention)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, cache


def _head(cfg: TransformerConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(cfg: TransformerConfig, params: dict, hidden: torch.Tensor,
              rules: Rules = NO_RULES) -> torch.Tensor:
    """[B, S, padded_vocab] float32 logits. The reference multiplies in the
    compute dtype with float32 accumulation; here both factors are widened
    to float32 first, which is the same product (a product of two bfloat16
    values is exact in float32). The widened head is ``compute_params``'s
    ``head_f32`` where the tree holds one."""
    head = params.get("head_f32")
    if head is None:
        head = _head(cfg, params).to(hidden.dtype).float()
    return rules.c(hidden.float() @ head, (rules.batch, None, rules.vocab))


def splade_encode(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                  mask: torch.Tensor, rules: Rules = NO_RULES, *,
                  attention=None):
    """SPLADE-style learned sparse representation: [B, vocab], the max over
    the masked sequence of log(1 + relu(logits)). ``attention`` as in
    ``forward``: the kernel to encode, ``scores_attention`` to train."""
    hidden, _, _ = forward(cfg, params, tokens, rules, attention=attention)
    acts = torch.log1p(torch.relu(logits_fn(cfg, params, hidden, rules)))
    acts = acts.masked_fill(~(mask[..., None] > 0), -torch.inf)
    rep = acts.amax(dim=1)[:, :cfg.vocab]          # drop pad rows
    return torch.clamp_min(rep, 0.0)


def _pick(logits, tgt):
    """``logits[..., tgt]`` (the targets' logits). DTensor logits split on
    the vocab (the last dim) are read where each target's logit lives:
    each rank gathers the targets in its slice (zeros for the others) and
    a sum over the splitting mesh dims completes them (vocab-parallel);
    the targets keep the logits' split of the other dims."""
    if not _is_dtensor(logits):
        return torch.gather(logits, -1, tgt.unsqueeze(-1)).squeeze(-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = logits.device_mesh, logits.dim() - 1
    vocab = [m for m, p in enumerate(logits.placements)
             if p == Shard(last) and mesh.shape[m] > 1]
    rest = [Replicate() if m in vocab or p == Shard(last) else p
            for m, p in enumerate(logits.placements)]
    local = logits.redistribute(mesh, [
        Shard(last) if m in vocab else p
        for m, p in enumerate(rest)]).to_local()
    t = as_placed(tgt, mesh, rest).to_local()
    first, coord = 0, mesh.get_coordinate()
    for m in vocab:
        first = first * mesh.shape[m] + coord[m]
    t = t - first * local.shape[-1]
    mine = (t >= 0) & (t < local.shape[-1])
    got = torch.gather(local, -1, t.clamp(0, local.shape[-1] - 1)
                       .unsqueeze(-1)).squeeze(-1)
    got = torch.where(mine, got, 0.0)
    return DTensor.from_local(got, mesh, [
        Partial() if m in vocab else p for m, p in enumerate(rest)],
        run_check=False).redistribute(mesh, rest)


def lm_loss(cfg: TransformerConfig, params: dict, batch: dict,
            rules: Rules = NO_RULES):
    """The training loss of ``batch`` {"tokens", "targets"[, "mask"]}: the
    masked mean over positions of logsumexp(logits) - logits[target] (over
    the padded vocab, as the reference), plus 0.01 x the MoE aux loss.
    The forward differentiates: ``scores_attention``."""
    hidden, aux, _ = forward(cfg, params, batch["tokens"], rules,
                             attention=scores_attention)
    logits = logits_fn(cfg, params, hidden, rules)
    tgt = batch["targets"].long()
    picked = _pick(logits, tgt)
    nll = torch.logsumexp(logits, dim=-1) - picked
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss + 0.01 * aux


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device, mesh=None, spec=()) -> dict:
    """A zero KV cache [L, B, max_len, Hkv, Dh] in the compute dtype, or
    int8 with float32 scales [L, B, max_len, Hkv] under ``kv_quant``. With
    a ``DeviceMesh``, DTensors laid out as ``spec`` (each rank allocates
    its own shard)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.compute_dtype

    def zeros(shape, dtype):
        if mesh is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        from torch.distributed.tensor import zeros as dzeros
        return dzeros(shape, dtype=dtype, device_mesh=mesh,
                      placements=_placements_for(shape, spec, mesh))
    cache = {k: zeros(shape, kv_dtype) for k in CACHE_KEYS}
    if cfg.kv_quant:
        for k in CACHE_KEYS_Q[2:]:
            cache[k] = zeros(shape[:-1], torch.float32)
    return cache


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            max_len: int, rules: Rules = NO_RULES):
    """Run the prompt into a new cache of ``max_len`` positions. Returns
    (last-position logits [B, 1, V], cache)."""
    mesh = tokens.device_mesh if _is_dtensor(tokens) else None
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device, mesh,
                       (None, rules.batch, rules.kv_seq, None, None))
    hidden, _, cache = forward(cfg, params, tokens, rules, cache=cache,
                               cache_len=0)
    return logits_fn(cfg, params, hidden[:, -1:, :], rules), cache


def decode_step(cfg: TransformerConfig, params: dict, token: torch.Tensor,
                cache: dict, cache_len: int, rules: Rules = NO_RULES):
    """One decode step. token: [B, 1]. Returns (logits [B, 1, V], cache)."""
    hidden, _, cache = forward(cfg, params, token, rules, cache=cache,
                               cache_len=cache_len)
    return logits_fn(cfg, params, hidden, rules), cache
