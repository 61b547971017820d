"""Plain float32 reference of the decoders the benchmark serves.

A pre-norm decoder: RMSNorm, GQA attention with split-halves RoPE and a
causal mask (a sliding window on the layers that have one), RMSNorm, then
a SwiGLU FFN or a top-k MoE (a softmax router over every expert, the top k
renormalised, the chosen experts' SwiGLU outputs summed by weight); a
final RMSNorm and the head (the embedding table when tied).  It follows
the published description, with the departures each configuration file
lists, and computes in float32 with TF32 off.

It imports nothing of the program and takes nothing the program made: the
weights are drawn again from the seed (``weights.draw_group``) one layer at
a time, and each sequence is run whole, every position recomputed, from
its token ids.  The MoE follows the one rule of the program that depends
on how a sequence was cut: within one prefill chunk, an expert takes at
most ``capacity(bucket)`` of the chunk's (token, choice) pairs, in token
order, and drops the rest (the chunk's bucket and place come from the
engine's plans); a decode token is never dropped here.

``mode="fp8"`` is the control: every matrix goes through float8 e4m3 with
one scale per output column before the float32 products.  ``mode="bf16"``
is a witness at the program's own precision: the same products with every
activation rounded to bfloat16 where the program keeps one in bfloat16
(norms, softmax, RoPE and the router in float32).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from h100bench.weights import (draw_group, group_leaves, head_dim,
                               is_moe_layer, layer_window, n_groups)

CAPACITY_FACTOR = 1.25
Q_BLOCK = 1024


def capacity(tokens: int, m: Dict) -> int:
    """An expert's slots for a step of ``tokens`` tokens: 1.25 times the
    mean load, rounded up to 8, at least 8."""
    c = math.ceil(tokens * m["top_k"] / m["n_experts"] * CAPACITY_FACTOR)
    return max(8, -(-c // 8) * 8)


class Sequence_:
    """One served sequence: its token ids (prompt, then the tokens fed to
    the decode steps), the positions whose next token the program emitted,
    and its prefill chunks as (start, length, bucket)."""

    def __init__(self, tokens: List[int], emit: List[int],
                 chunks: Sequence[Tuple[int, int, int]]):
        self.tokens, self.emit, self.chunks = tokens, emit, list(chunks)


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """w rounded through float8 e4m3, one scale per output column."""
    amax = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12)
    scale = 448.0 / amax
    return (w * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _weights(m: Dict, seed: int, g: int, device, mode: str) -> Dict[str, torch.Tensor]:
    raw = draw_group(m, seed, g, device)
    out = {}
    for name, shape, kind, _ in group_leaves(m, g):
        w = raw.pop(name).float()
        if mode == "fp8" and kind != "norm" and len(shape) >= 2:
            w = _fp8(w) if not name.endswith("embed.table") else _fp8(w.T).T
        out[name] = w
    return out


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(m: Dict, w: Dict, p: str, h: torch.Tensor, window: int,
               rnd=_keep) -> torch.Tensor:
    s = h.shape[0]
    hd, nh, kv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    pos = torch.arange(s, device=h.device)
    q = rnd(_rope(rnd(h @ w[p + "self_attn.q_proj.w"]).view(s, nh, hd), pos,
                  m["rope_theta"]))
    k = rnd(_rope(rnd(h @ w[p + "self_attn.k_proj.w"]).view(s, kv, hd), pos,
                  m["rope_theta"]))
    v = rnd(h @ w[p + "self_attn.v_proj.w"]).view(s, kv, hd)
    k = k.repeat_interleave(nh // kv, dim=1)
    v = v.repeat_interleave(nh // kv, dim=1)
    out = torch.empty(s, nh, hd, device=h.device)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        logits = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) / math.sqrt(hd)
        qpos, kpos = pos[q0:q1, None], pos[None, :q1]
        ok = kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        logits = logits.masked_fill(~ok[None], float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v[:q1])
    return rnd(rnd(out.reshape(s, nh * hd)) @ w[p + "self_attn.o_proj.w"])


def _swiglu(x, up, gate, down, rnd=_keep):
    return rnd(rnd(torch.nn.functional.silu(rnd(x @ gate)) * rnd(x @ up)) @ down)


def moe_keep(top_e: torch.Tensor, m: Dict, chunks) -> torch.Tensor:
    """(S, k) bool: the (token, choice) pairs an expert takes.  Within each
    chunk (start, length, bucket) an expert takes the first
    ``capacity(bucket)`` pairs in token order; tokens outside every chunk
    (decode tokens) keep all their choices."""
    keep = torch.ones_like(top_e, dtype=torch.bool)
    e = m["n_experts"]
    for start, length, bucket in chunks:
        te = top_e[start:start + length].reshape(-1)
        onehot = torch.nn.functional.one_hot(te, e)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[start:start + length] = (rank < capacity(bucket, m)).view(length, -1)
    return keep


def _moe(m: Dict, w: Dict, p: str, h: torch.Tensor, chunks, rnd=_keep) -> torch.Tensor:
    probs = torch.softmax(h @ w[p + "moe.router.w"], -1)
    top_p, top_e = torch.topk(probs, m["top_k"], dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    top_p = top_p * moe_keep(top_e, m, chunks)
    out = torch.zeros_like(h)
    up, gate, down = w[p + "moe.up"], w[p + "moe.gate"], w[p + "moe.down"]
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], up[e], gate[e], down[e], rnd)
            out.index_add_(0, tok, rnd(y * rnd(top_p[tok, slot, None])))
    return rnd(out)


def logits(m: Dict, seed: int, seqs: List[Sequence_], device,
           mode: str = "f32") -> List[torch.Tensor]:
    """Float32 logits (len(emit), vocab) of every sequence at its emitted
    positions, computed layer by layer over all sequences."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(m, seed, seqs, device, mode)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _logits(m, seed, seqs, device, mode):
    eps = m.get("norm_eps", 1e-5)
    rnd = _bf16 if mode == "bf16" else _keep
    w0 = _weights(m, seed, 0, device, mode)
    table = w0["embed.table"]
    xs = [table[torch.tensor(s.tokens, device=device)] for s in seqs]
    head = w0.get("lm_head.w")
    head = table.T if head is None else head
    del w0
    for i in range(m["n_layers"]):
        w, p = _weights(m, seed, i + 1, device, mode), f"layers.{i}."
        for j, s in enumerate(seqs):
            x = xs[j]
            x = rnd(x + _attention(m, w, p, rnd(_rms(x, w[p + "ln1.scale"], eps)),
                                   layer_window(m, i), rnd))
            h = rnd(_rms(x, w[p + "ln2.scale"], eps))
            if is_moe_layer(m, i):
                x = rnd(x + _moe(m, w, p, h, s.chunks, rnd))
            else:
                x = rnd(x + _swiglu(h, w[p + "mlp.up_proj.w"], w[p + "mlp.gate_proj.w"],
                                    w[p + "mlp.down_proj.w"], rnd))
            xs[j] = x
        del w
    final = _weights(m, seed, n_groups(m) - 1, device, mode)["final_norm.scale"]
    return [rnd(_rms(x[torch.tensor(s.emit, device=device)], final, eps)) @ head
            for x, s in zip(xs, seqs)]


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The gap by which each token's reference logit lies below the
    reference's best, one per row of ``ref`` (positions)."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None])[:, 0]


def fed_tokens(prompt: List[int], generated: int) -> List[int]:
    """The token ids the engine ran for a request that emitted
    ``generated`` tokens: its prompt, then at each decode step the replay
    token 1 + (tokens emitted so far) % 7, in place of the emitted one."""
    return list(prompt) + [1 + (g % 7) for g in range(1, generated)]


def emit_positions(prompt_len: int, generated: int) -> List[int]:
    """Positions whose next token the program emitted: the prompt's last
    (prefill), then each decode step's."""
    return list(range(prompt_len - 1, prompt_len - 1 + generated))


def sequence(prompt: List[int], generated: int,
             chunks: Optional[Sequence[Tuple[int, int, int]]] = None) -> Sequence_:
    return Sequence_(fed_tokens(prompt, generated),
                     emit_positions(len(prompt), generated), chunks or [])
