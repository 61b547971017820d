"""The benchmark's own seeded weights, in the port's parameter names.

The weights are split into groups: the embedding (and an untied head),
each layer, and the final norm.  Group ``g`` is drawn from a generator on
the device seeded by (``seed``, g), in one normal draw for each of its
dtypes, so that a group can be drawn again alone: the harness draws all of
them for the engine, and the reference draws one layer at a time.
Matrices are normal draws times fan_in**-0.5 (the embedding: d**-0.5) in
the dtype they are served in; norm scales and the router stay float32, as
the port keeps them, and norm scales are 1 + 0.1 * normal so that a norm
that drops its scale shows.

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]    # name, shape, dtype, scale


def _global_layer(m: Dict, i: int) -> bool:
    k = m.get("swa_interleave", 0)
    if not m.get("sliding_window", 0):
        return True
    return k > 0 and i % k == k - 1


def layer_window(m: Dict, i: int) -> int:
    """The sliding window of layer ``i`` (0: global attention)."""
    return 0 if _global_layer(m, i) else m["sliding_window"]


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def is_moe_layer(m: Dict, i: int) -> bool:
    k = m.get("moe_interleave", 1)
    return m.get("n_experts", 0) > 0 and i % k == k - 1


def group_leaves(m: Dict, g: int) -> List[Leaf]:
    """The leaves of group ``g``: 0 the embedding (and untied head), 1..L
    layer g-1, L+1 the final norm."""
    d, dt = m["d_model"], m.get("dtype", "bfloat16")
    n_layers = m["n_layers"]
    if g == 0:
        out = [("embed.table", (m["vocab_size"], d), dt, d ** -0.5)]
        if not m.get("tie_embeddings", False):
            out.append(("lm_head.w", (d, m["vocab_size"]), dt, d ** -0.5))
        return out
    if g == n_layers + 1:
        return [("final_norm.scale", (d,), "norm", 0.0)]
    i = g - 1
    p = f"layers.{i}."
    hd = head_dim(m)
    qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
    out = [(p + "ln1.scale", (d,), "norm", 0.0),
           (p + "self_attn.q_proj.w", (d, qd), dt, d ** -0.5),
           (p + "self_attn.k_proj.w", (d, kvd), dt, d ** -0.5),
           (p + "self_attn.v_proj.w", (d, kvd), dt, d ** -0.5),
           (p + "self_attn.o_proj.w", (qd, d), dt, qd ** -0.5),
           (p + "ln2.scale", (d,), "norm", 0.0)]
    if is_moe_layer(m, i):
        e, f = m["n_experts"], m["moe_d_ff"]
        out += [(p + "moe.up", (e, d, f), dt, d ** -0.5),
                (p + "moe.down", (e, f, d), dt, f ** -0.5),
                (p + "moe.gate", (e, d, f), dt, d ** -0.5),
                (p + "moe.router.w", (d, e), "float32", d ** -0.5)]
    else:
        f = m["d_ff"]
        out += [(p + "mlp.up_proj.w", (d, f), dt, d ** -0.5),
                (p + "mlp.gate_proj.w", (d, f), dt, d ** -0.5),
                (p + "mlp.down_proj.w", (f, d), dt, f ** -0.5)]
    return out


def n_groups(m: Dict) -> int:
    return m["n_layers"] + 2


def draw_group(m: Dict, seed: int, g: int, device) -> Dict[str, torch.Tensor]:
    """Group ``g``'s tensors, drawn on ``device``: one normal draw per dtype
    (norm scales count as float32), sliced and scaled."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + g) % (1 << 63))
    leaves = group_leaves(m, g)
    out: Dict[str, torch.Tensor] = {}
    for dt in sorted({"float32" if kind == "norm" else kind
                      for _, _, kind, _ in leaves}):
        mine = [lf for lf in leaves
                if ("float32" if lf[2] == "norm" else lf[2]) == dt]
        total = sum(_numel(shape) for _, shape, _, _ in mine)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=getattr(torch, dt))
        at = 0
        for name, shape, kind, scale in mine:
            n = _numel(shape)
            t = flat[at:at + n].view(shape)
            at += n
            out[name] = t.mul_(0.1).add_(1.0) if kind == "norm" else t.mul_(scale)
    return out


def state_dict(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the model, for ``Model.load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for g in range(n_groups(m)):
        out.update(draw_group(m, seed, g, device))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
