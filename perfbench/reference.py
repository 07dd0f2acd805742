"""The plain reference: a Mixtral-style MoE train step in plain PyTorch,
float32, with no kernel, no cache and no batching trick, written from the
model's equations. It imports nothing of the program and reads nothing the
program made: the weights are drawn again from the seed
(:func:`perfbench.model.draw_weights`) and the batches generated again.

It follows the configuration as the program is meant to run it:

* the token embedding; per layer an RMSNorm, q / k / v projections, RoPE
  (rotation of the two halves of each head), causal GQA attention (q head
  h reads kv head h // (H / KH)) and the output projection, a residual;
  an RMSNorm, the router (f32 logits, softmax, top-k, weights renormalised
  over the k), the SwiGLU experts and the weighted sum of the k outputs, a
  residual;
* under zebra (``capacity=True``) the batch is split by rows into
  microbatches and each microbatch routed alone: an expert keeps its first
  C copies in token order, C = max(roundup(int(T k / E cf), 8), 8) for the
  T tokens of the microbatch, and a dropped copy adds nothing; the router's
  losses are averaged over the microbatches. Dropless: one route, nothing
  dropped;
* the final RMSNorm, the untied head, the mean cross-entropy plus
  ``lm_z_coef`` times the mean squared log-sum-exp, plus every layer's
  load-balance loss E Σ f_e p_e · aux_coef and router z-loss
  mean(logsumexp²) · z_coef;
* AdamW as the port's driver runs it: the global norm clipped to
  ``grad_clip``, linear warmup then cosine, bias-corrected moments,
  decoupled weight decay on leaves of two or more dims.

Products run through a :class:`Precision`: :data:`EXACT` is float32 with
TF32 off (the reference); the controls (:data:`CONTROLS`, one precision
step below the configuration's bfloat16) give each product that the
program computes from bfloat16 operands 8-bit operands instead, scaled
per tensor, forward and backward: e4m3 (:data:`FP8`, the control the
limits are set against) or int8 (:data:`INT8`). The router and the norms
stay float32 in both.

Each layer and each block of the loss is recomputed in the backward, and
attention runs over query blocks with its own recomputing backward, so a
step at the cells' sizes fits the card beside the optimizer state."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.model import MoESpec, draw_leaf, draw_weights


class Precision:
    """How the reference rounds the operands of the program's bfloat16
    products: ``q(t)`` is the operand as the product reads it."""

    name = "float32"

    def q(self, t):
        return t

    def g(self, t):
        """A gradient operand as the backward's product reads it."""
        return t

    def mm(self, a, b):
        return a @ b


def _fp8(t):
    """t rounded to e4m3, scaled per tensor so its largest magnitude lands
    on the format's largest (448)."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _int8(t):
    """t rounded to int8 levels, symmetric, scaled per tensor."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(t / scale).clamp_(-127, 127) * scale


class _QMatmul(torch.autograd.Function):
    """a @ b with rounded operands in the forward (``fwd``) and in both
    products of the backward (``bwd`` for the output's gradient, ``fwd``
    for the saved operands); f32 sums."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        ctx.save_for_backward(a, b)
        ctx.fwd, ctx.bwd = fwd, bwd
        return fwd(a) @ fwd(b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dq = ctx.bwd(dy)
        da = dq @ ctx.fwd(b).transpose(-1, -2)
        db = ctx.fwd(a).reshape(-1, a.shape[-1]).T \
            @ dq.reshape(-1, dy.shape[-1])
        return da, db, None, None


class Rounded(Precision):
    """Products whose operands are rounded by ``fwd`` (and the output
    gradient by ``bwd``) before an f32 sum."""

    def __init__(self, name, fwd, bwd=None):
        self.name, self.fwd, self.bwd = name, fwd, bwd or fwd

    def q(self, t):
        return self.fwd(t)

    def g(self, t):
        return self.bwd(t)

    def mm(self, a, b):
        return _QMatmul.apply(a, b, self.fwd, self.bwd)


EXACT = Precision()
FP8 = Rounded("fp8_e4m3", _fp8)
INT8 = Rounded("int8", _int8)
CONTROLS = {p.name: p for p in (FP8, INT8)}


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x [B, S, heads, hd] at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _CausalAttention(torch.autograd.Function):
    """softmax(q kᵀ · scale, causal) v over query blocks of ``block`` rows;
    the backward recomputes each block's probabilities from the saved
    log-sum-exp. q [B, S, H, hd], k / v [B, S, KH, hd]."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, block: int, prec: Precision):
        B, S, H, hd = q.shape
        KH = k.shape[2]
        G = H // KH
        qh = q.reshape(B, S, KH, G, hd).permute(0, 2, 3, 1, 4)
        kh = k.permute(0, 2, 1, 3)[:, :, None]
        vh = v.permute(0, 2, 1, 3)[:, :, None]
        o = torch.empty_like(qh)
        lse = torch.empty(qh.shape[:-1], dtype=q.dtype, device=q.device)
        for i0 in range(0, S, block):
            i1 = min(S, i0 + block)
            s = prec.q(qh[..., i0:i1, :]) @ \
                prec.q(kh[..., :i1, :]).transpose(-1, -2) * scale
            s = s.masked_fill(_future(i0, i1, q.device), -torch.inf)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            den = p.sum(-1, keepdim=True)
            lse[..., i0:i1] = (m + torch.log(den))[..., 0]
            o[..., i0:i1, :] = prec.q(p / den) @ prec.q(vh[..., :i1, :])
        ctx.save_for_backward(qh, kh, vh, o, lse)
        ctx.scale, ctx.block, ctx.prec = scale, block, prec
        return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, o, lse = ctx.saved_tensors
        scale, block, prec = ctx.scale, ctx.block, ctx.prec
        B, KH, G, S, hd = qh.shape
        doh = do.reshape(B, S, KH, G, hd).permute(0, 2, 3, 1, 4)
        Dt = (doh * o).sum(-1)
        dq = torch.empty_like(qh)
        dk = torch.zeros(B, KH, S, hd, dtype=qh.dtype, device=qh.device)
        dv = torch.zeros_like(dk)
        for i0 in range(0, S, block):
            i1 = min(S, i0 + block)
            qb, dob = qh[..., i0:i1, :], doh[..., i0:i1, :]
            kb, vb = kh[..., :i1, :], vh[..., :i1, :]
            s = prec.q(qb) @ prec.q(kb).transpose(-1, -2) * scale
            s = s.masked_fill(_future(i0, i1, qh.device), -torch.inf)
            p = torch.exp(s - lse[..., i0:i1, None])
            dv[:, :, :i1] += (prec.q(p).transpose(-1, -2)
                              @ prec.g(dob)).sum(2)
            dp = prec.g(dob) @ prec.q(vb).transpose(-1, -2)
            ds = p * (dp - Dt[..., i0:i1, None])
            dq[..., i0:i1, :] = prec.g(ds) @ prec.q(kb) * scale
            dk[:, :, :i1] += (prec.g(ds).transpose(-1, -2)
                              @ prec.q(qb)).sum(2) * scale
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, KH * G, hd)
        return (dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3),
                None, None, None)


def _future(i0: int, i1: int, device):
    """[i1 - i0, i1] True where the key lies after the query."""
    rows = torch.arange(i0, i1, device=device)[:, None]
    return torch.arange(i1, device=device)[None, :] > rows


def capacity(T: int, m: MoESpec) -> int:
    C = int(T * m.top_k / m.n_experts * m.capacity_factor)
    return max(-(-C // 8) * 8, 8)


def moe(u, router, wg, wu, wo, m: MoESpec, capped: bool, prec: Precision):
    """u [T, d] -> (y [T, d], load-balance loss, z-loss)."""
    T = u.shape[0]
    logits = u @ router
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    counts = torch.zeros(m.n_experts, device=u.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=u.device))
    f = counts / (T * m.top_k)
    aux = m.n_experts * (f * probs.mean(0)).sum() * m.router_aux_coef
    z = torch.logsumexp(logits, -1).square().mean() * m.router_z_coef
    C = capacity(T, m) if capped else T
    y = torch.zeros_like(u)
    for e in range(m.n_experts):
        sel = idx == e
        toks = torch.nonzero(sel.any(-1))[:, 0][:C]
        if toks.numel() == 0:
            continue
        xe = u[toks]
        h = F.silu(prec.mm(xe, wg[e])) * prec.mm(xe, wu[e])
        ye = prec.mm(h, wo[e])
        we = (w * sel).sum(-1)[toks]
        y = y.index_add(0, toks, ye * we[:, None])
    return y, aux, z


def loss_fn(params: dict, batch: dict, m: MoESpec, engine: dict,
            prec: Precision, block: int = 512, chunk: int = 2048):
    """The loss of one batch (tokens and targets [B, S] on the params'
    device)."""
    tokens, targets = batch["tokens"].long(), batch["targets"].long()
    B, S = tokens.shape
    x = params["embed/table"][tokens]
    stacked = {k[len("blocks/pos0/"):]: v.unbind(0)
               for k, v in params.items() if k.startswith("blocks/")}
    zebra = engine.get("zebra", False)
    R = int(engine["microbatches"]) if zebra else 1
    while R > 1 and B % R:
        R -= 1
    total_aux = 0.0

    def one(x, *leaves, names):
        lp = dict(zip(names, leaves))
        return layer(x, lp, m, R, zebra, prec, block)

    names = list(stacked)
    for li in range(m.n_layers):
        leaves = [stacked[n][li] for n in names]
        x, aux = checkpoint(one, x, *leaves, names=names,
                            use_reentrant=False)
        total_aux = total_aux + aux
    x = rms_norm(x, params["final_norm/scale"], m.norm_eps)
    head = params["lm_head"]
    xf, tf = x.reshape(-1, x.shape[-1]), targets.reshape(-1)

    def block_loss(xc, tc, head):
        logits = prec.mm(xc, head.T)
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, tc[:, None])[:, 0]
        return (lse - gold).sum(), lse.square().sum()

    nll = zl = 0.0
    for i in range(0, xf.shape[0], chunk):
        a, b = checkpoint(block_loss, xf[i:i + chunk], tf[i:i + chunk], head,
                          use_reentrant=False)
        nll, zl = nll + a, zl + b
    nll, zl = nll / (B * S), zl / (B * S)
    return nll + m.lm_z_coef * zl + total_aux


def layer(x, lp, m: MoESpec, R: int, capped: bool, prec: Precision,
          block: int):
    """One decoder layer on x [B, S, d]: (x, the router losses averaged
    over the R microbatches)."""
    B, S, d = x.shape
    H, KH, hd = m.n_heads, m.n_kv_heads, m.head_dim
    u = rms_norm(x, lp["norm1/scale"], m.norm_eps)
    q = rope(prec.mm(u, lp["mixer/wq"]).reshape(B, S, H, hd), m.rope_theta)
    k = rope(prec.mm(u, lp["mixer/wk"]).reshape(B, S, KH, hd), m.rope_theta)
    v = prec.mm(u, lp["mixer/wv"]).reshape(B, S, KH, hd)
    a = _CausalAttention.apply(q, k, v, hd ** -0.5, block, prec)
    h = x + prec.mm(a.reshape(B, S, H * hd), lp["mixer/wo"])
    u2 = rms_norm(h, lp["norm2/scale"], m.norm_eps)
    ys, losses = [], 0.0
    for r in range(R):
        ur = u2[r * B // R:(r + 1) * B // R].reshape(-1, d)
        y, aux, z = moe(ur, lp["ffn/router"], lp["ffn/wi_gate"],
                        lp["ffn/wi_up"], lp["ffn/wo"], m, capped, prec)
        ys.append(y)
        losses = losses + aux + z
    return h + torch.cat(ys).reshape(B, S, d), losses / R


def lr_at(opt: dict, step: int) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine to
    ``end_lr_frac`` of it at ``total_steps``."""
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], \
        opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    end = opt["end_lr_frac"]
    return peak * (end + (1 - end) * 0.5 * (1 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, opt: dict) -> None:
    """One AdamW step in place (``state``: mu, nu, step)."""
    state["step"] += 1
    t = state["step"]
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = (opt["grad_clip"] / (gnorm + 1e-9)).clamp(max=1.0)
    lr = lr_at(opt, t)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** t, 1 - b2 ** t
    for k, p in params.items():
        g = grads[k] * scale
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square(), alpha=1 - b2)
        delta = (mu / b1c) / ((nu / b2c).sqrt() + opt["eps"])
        if p.dim() >= 2:
            delta += opt["weight_decay"] * p
        p.sub_(lr * delta)


def train_steps(m: MoESpec, seed: int, batches: list, engine: dict,
                opt: dict, device, prec: Precision = EXACT):
    """The reference's first ``len(batches)`` steps from the seed's
    weights: a :class:`perfbench.check.Readings` of each step's loss, each
    leaf's first clipped gradient (from the first moment after one step)
    and its change after the last step, with their sampled elements."""
    from perfbench import check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = draw_weights(m, seed, device)
    names, idx = list(params), {}
    for p in params.values():
        p.requires_grad_(True)
    state = {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
             "nu": {k: torch.zeros_like(p) for k, p in params.items()},
             "step": 0}
    r = check.Readings([], {}, {})
    for i, b in enumerate(batches):
        b = {k: v.to(device) for k, v in b.items()}
        loss = loss_fn(params, b, m, engine, prec)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        r.losses.append(float(loss.detach()))
        adamw(params, grads, state, opt)
        del grads
        if i == 0:
            for k, v in state["mu"].items():
                r.grads[k] = float(v.norm()) / (1 - opt["b1"])
                r.grad_samples[k] = check.sample(
                    v, names.index(k), idx) / (1 - opt["b1"])
    del state
    with torch.no_grad():
        for k, p in params.items():
            d = p - draw_leaf(m, seed, k, device)
            r.changes[k] = float(d.norm())
            r.change_samples[k] = check.sample(d, names.index(k), idx)
    return r
