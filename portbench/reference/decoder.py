"""Plain float32 reference of a decoder-only language model: the GQA
decoder of InternLM2 and the same decoder with a GShard mixture-of-experts
feed-forward (Qwen1.5-MoE), written from the published descriptions in
plain PyTorch. It imports nothing of the program under test.

Every matrix product runs in float32 with TF32 off (``strict_f32``), or,
for the control, with both operands rounded to float8 e4m3 under a
per-tensor scale (``Precision(fp8=True)``). The weights are the
benchmark's bfloat16 draw (``portbench/weights.py``) in the program's
layout; ``weights_from`` takes the configuration's part of them: the
published vocabulary's rows and the published experts.

Layer equations (configuration keys as in ``portbench/configs``):

  h   = x + Wo · attn(RoPE(Wq · n1), RoPE(Wk · n1), Wv · n1),
        n1 = rmsnorm(x) · ln1, causal softmax(q·kᵀ / sqrt(head_dim)) in
        float32, query head j reading kv head j // (heads / kv_heads)
  out = h + ffn(rmsnorm(h) · ln2)
  ffn = SwiGLU: W_down (silu(W_gate n) ⊙ W_up n), or the MoE: softmax
        router over the experts, the top-k renormalised where
        ``norm_topk_prob``, GShard capacity per group of ``moe_group_size``
        tokens with assignments past it dropped in k-major priority, plus
        the ungated shared SwiGLU expert.
  logits = rmsnorm(h_L) · final_norm · W_unembedᵀ
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0          # largest finite float8 e4m3 value


@contextlib.contextmanager
def strict_f32():
    """Matrix products in true float32: TF32 off while inside."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale (amax -> 448); the
    gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


@dataclasses.dataclass(frozen=True)
class Precision:
    """float32 everywhere, or (the control) every matrix product's
    operands rounded to float8 first."""
    fp8: bool = False

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = _Fp8.apply(x), _Fp8.apply(w)
        return x @ w


F32 = Precision()
FP8 = Precision(fp8=True)


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    norm_topk: bool = True
    group: int = 0
    capacity_factor: float = 0.0

    @classmethod
    def of(cls, c: dict) -> "Dims":
        moe = c.get("num_experts", 0)
        return cls(layers=c["num_hidden_layers"], hidden=c["hidden_size"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"],
                   head_dim=c.get("head_dim") or
                   c["hidden_size"] // c["num_attention_heads"],
                   vocab=c["vocab_size"], rope_theta=float(c["rope_theta"]),
                   eps=float(c["rms_norm_eps"]), experts=moe,
                   top_k=c.get("num_experts_per_tok", 0),
                   norm_topk=bool(c.get("norm_topk_prob", True)),
                   group=c.get("moe_group_size", 0),
                   capacity_factor=float(c.get("moe_capacity_factor", 0)))


def weights_from(tree: dict, d: Dims) -> dict:
    """The configuration's weights out of the program's layout (views,
    still bfloat16): the published vocabulary's rows of the embedding and
    unembedding, the published experts of each MoE leaf and of the
    router. Per layer: ``layers[i]`` a dict of that layer's leaves."""
    lay = tree["layers"]
    per = []
    for i in range(d.layers):
        w = {"ln1": lay["ln1"][i], "ln2": lay["ln2"][i],
             **{k: lay["attn"][k][i] for k in ("wq", "wk", "wv", "wo")}}
        if "moe" in lay:
            m = lay["moe"]
            w.update(router=m["router"][i][:, :d.experts],
                     e_gate=m["w_gate"][i][:d.experts],
                     e_up=m["w_up"][i][:d.experts],
                     e_down=m["w_down"][i][:d.experts],
                     s_gate=m["shared"]["w_gate"][i],
                     s_up=m["shared"]["w_up"][i],
                     s_down=m["shared"]["w_down"][i])
        else:
            w.update(gate=lay["mlp"]["w_gate"][i], up=lay["mlp"]["w_up"][i],
                     down=lay["mlp"]["w_down"][i])
        per.append(w)
    return {"embed": tree["embed"][:d.vocab],
            "unembed": tree["unembed"][:d.vocab],
            "final_norm": tree["final_norm"], "layers": per}


def f32(w: dict) -> dict:
    return {k: v.float() for k, v in w.items()}


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [B, S, H, hd] at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, p: Precision) -> torch.Tensor:
    """Causal GQA attention, q [B, S, H, hd], k/v [B, S, Hkv, hd]."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))      # [B, H, S, hd]
    scores = p.mm(qt, kt.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), -1)
    return p.mm(probs, vt).transpose(1, 2)


def swiglu(x, gate, up, down, p: Precision) -> torch.Tensor:
    return p.mm(F.silu(p.mm(x, gate)) * p.mm(x, up), down)


def moe(t: torch.Tensor, w: dict, d: Dims, p: Precision,
        per_request: int) -> torch.Tensor:
    """The MoE feed-forward of tokens t [T, D], ``per_request`` tokens to a
    request (T a multiple of it): each request's tokens in groups of the
    largest divisor of ``per_request`` not above ``group``; in each group
    the top-k experts of every token by router probability, slots given
    in k-major order (every token's first choice before any second), an
    assignment at or past the capacity dropped."""
    n, dm = t.shape
    gs = min(d.group, per_request)
    while per_request % gs:
        gs -= 1
    cap = max(int(gs * d.top_k * d.capacity_factor / d.experts), 1)
    cap = (cap + 3) // 4 * 4
    probs = torch.softmax(t @ w["router"], -1)            # router in f32
    topv, topi = probs.topk(d.top_k, -1)                  # [n, k]
    if d.norm_topk:
        topv = topv / topv.sum(-1, keepdim=True)
    g = n // gs
    order = topi.reshape(g, gs, d.top_k).transpose(1, 2).reshape(g, -1)
    hot = F.one_hot(order, d.experts)                    # [g, k*gs, E]
    slot = ((hot.cumsum(1) - 1) * hot).sum(-1)
    slot = slot.reshape(g, d.top_k, gs).transpose(1, 2).reshape(n, d.top_k)
    kept = slot < cap
    gate = topv * kept
    out = torch.zeros_like(t)
    for e in range(d.experts):
        tok, j = torch.nonzero((topi == e) & kept, as_tuple=True)
        if tok.numel():
            y = swiglu(t[tok], w["e_gate"][e], w["e_up"][e], w["e_down"][e],
                       p)
            out.index_add_(0, tok, y * gate[tok, j, None])
    for c in range(0, n, per_request):
        out[c:c + per_request] += swiglu(t[c:c + per_request], w["s_gate"],
                                         w["s_up"], w["s_down"], p)
    return out


def attend(x: torch.Tensor, w: dict, d: Dims, p: Precision):
    """The attention half of a layer: (x + attention, the second norm's
    output, k after RoPE, v)."""
    b, s, _ = x.shape
    n = rmsnorm(x, w["ln1"], d.eps)
    q = rope(p.mm(n, w["wq"]).view(b, s, d.heads, d.head_dim), d.rope_theta)
    k = rope(p.mm(n, w["wk"]).view(b, s, d.kv_heads, d.head_dim),
             d.rope_theta)
    v = p.mm(n, w["wv"]).view(b, s, d.kv_heads, d.head_dim)
    h = x + p.mm(attention(q, k, v, p).reshape(b, s, -1), w["wo"])
    return h, rmsnorm(h, w["ln2"], d.eps), k, v


def dense_block(x: torch.Tensor, w: dict, d: Dims, p: Precision
                ) -> torch.Tensor:
    h, n, _, _ = attend(x, w, d, p)
    return h + swiglu(n, w["gate"], w["up"], w["down"], p)


@torch.no_grad()
def prefill(weights: dict, d: Dims, requests: List[torch.Tensor],
            p: Precision = F32, keep_kv: Tuple[int, ...] = ()
            ) -> Tuple[List[torch.Tensor], Dict[int, list]]:
    """Each request's ([B, S] ids) last-position logits [B, V] in float32
    and, for the requests at the indices ``keep_kv``, every layer's (k, v)
    [B, S, kv_heads, head_dim]. Runs layer by layer over all the requests,
    one layer's weights in float32 at a time; the MoE's experts take the
    tokens of every request at once."""
    with strict_f32():
        hs = [weights["embed"][r.long()].float() for r in requests]
        kv = {i: [] for i in keep_kv}
        for w in weights["layers"]:
            w = f32(w)
            normed = []
            for i, x in enumerate(hs):
                hs[i], n, k, v = attend(x, w, d, p)
                normed.append(n)
                if i in kv:
                    kv[i].append((k, v))
            if "router" in w:
                shape = normed[0].shape
                per = shape[0] * shape[1]
                f = moe(torch.cat([n.reshape(per, -1) for n in normed]), w,
                        d, p, per)
                for i, fi in enumerate(f.split(per)):
                    hs[i] = hs[i] + fi.view(shape)
            else:
                for i, n in enumerate(normed):
                    hs[i] = hs[i] + swiglu(n, w["gate"], w["up"], w["down"],
                                           p)
            del w, normed
        fn, un = weights["final_norm"].float(), weights["unembed"].float()
        logits = [p.mm(rmsnorm(x[:, -1], fn, d.eps), un.T) for x in hs]
    return logits, kv


# ------------------------------------------------------------------ train
def loss(params: dict, d: Dims, tokens: torch.Tensor, targets: torch.Tensor,
         p: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy of one microbatch, each layer under
    an activation checkpoint (the same values; only memory differs)."""
    if d.experts:
        raise NotImplementedError("the reference trains the dense decoder")
    x = params["embed"][tokens.long()]
    for w in params["layers"]:
        x = checkpoint(dense_block, x, w, d, p, use_reentrant=False)
    logits = p.mm(rmsnorm(x, params["final_norm"], d.eps),
                  params["unembed"].T)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def leaves(tree: dict) -> Dict[str, List[torch.Tensor]]:
    """name -> the tensors that make up the program's (stacked) leaf of
    that name: one per layer for a layer's leaf."""
    out = {k: [tree[k]] for k in ("embed", "unembed", "final_norm")}
    for w in tree["layers"]:
        for k, t in w.items():
            out.setdefault(k, []).append(t)
    return out


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac``."""
    warm = max(opt["warmup_steps"], 1)
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / warm
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0), 1)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * prog))
    return opt["lr"] * frac


def train(weights: dict, d: Dims, opt: dict, batches: List[torch.Tensor],
          microbatches: int, p: Precision = F32) -> dict:
    """AdamW training from ``weights`` over ``batches`` (one [B, S + 1]
    id tensor per step, split into ``microbatches`` equal parts whose
    gradients are averaged). Parameters are float32 rounded to bfloat16
    after each update (the configuration stores them so), moments
    float32; gradients clipped by their global norm. Returns each step's
    mean loss, the per-leaf norms of the first step's clipped gradient,
    of the first step's raw gradient, and of the change of every leaf
    over all the steps (``leaves`` names)."""
    with strict_f32():
        params = {k: weights[k].float().requires_grad_()
                  for k in ("embed", "unembed", "final_norm")}
        params["layers"] = [{k: t.float().requires_grad_() for k, t in
                             w.items()} for w in weights["layers"]]
        named = leaves(params)
        flat = [t for ts in named.values() for t in ts]
        m = [torch.zeros_like(t) for t in flat]
        v = [torch.zeros_like(t) for t in flat]
        decay = [k != "final_norm" for k, ts in named.items() for _ in ts]
        losses, first, raw = [], None, None
        for step, batch in enumerate(batches, 1):
            acc = [torch.zeros_like(t) for t in flat]
            total = 0.0
            for mb in batch.chunk(microbatches, 0):
                lo = loss(params, d, mb[:, :-1], mb[:, 1:], p)
                for a, g in zip(acc, torch.autograd.grad(lo, flat)):
                    a.add_(g)
                total += float(lo.detach())
            for a in acc:
                a.div_(microbatches)
            gnorm = math.sqrt(sum(float(a.square().sum()) for a in acc))
            scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
            if step == 1:
                raw = _norms(named, acc)
                first = {k: n * scale for k, n in raw.items()}
            lr = lr_at(opt, step)
            b1c, b2c = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            with torch.no_grad():
                for t, g, mi, vi, dec in zip(flat, acc, m, v, decay):
                    g.mul_(scale)
                    mi.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    vi.mul_(opt["b2"]).add_(g.square(), alpha=1 - opt["b2"])
                    delta = (mi / b1c) / ((vi / b2c).sqrt() + opt["eps"])
                    if dec:
                        delta = delta + opt["weight_decay"] * t
                    t.copy_((t - lr * delta).bfloat16().float())
            del acc
            losses.append(total / microbatches)
        start = [t for ts in leaves(weights).values() for t in ts]
        change = _norms(named, [t.detach() - s.float()
                                for t, s in zip(flat, start)])
    return {"loss": losses, "grad": first, "raw_grad": raw,
            "change": change}


def _norms(named: Dict[str, list], flat: List[torch.Tensor]
           ) -> Dict[str, float]:
    """Per leaf name, the norm of its tensors together."""
    out, i = {}, 0
    for k, ts in named.items():
        sq = sum(float(flat[i + j].double().square().sum())
                 for j in range(len(ts)))
        out[k] = math.sqrt(sq)
        i += len(ts)
    return out
