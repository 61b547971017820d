"""The work the served requests need, counted from the configuration and
the requests' lengths, never from the shapes of the program's kernels: a
later kernel that reads less or pads differently changes the time and not
the count.

A request with a prompt of P tokens that emitted G tokens ran P prompt
tokens and G - 1 decode tokens; the token at position p attends p + 1 keys
(every key at these lengths: the window, 4096, cuts none below it); the
head runs once per emitted token.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from h100bench.weights import head_dim, is_moe_layer, layer_window


def _key_sum(lo: int, hi: int, window: int) -> int:
    """Sum of the keys attended by the tokens at positions lo..hi-1: p + 1
    each, at most ``window`` where the layer has one."""
    cut = hi if not window else max(lo, min(hi, window))
    return (lo + 1 + cut) * (cut - lo) // 2 + (hi - cut) * window


def layer_matmul_params(m: Dict, i: int) -> int:
    """Weights one token multiplies by in layer ``i`` (its top-k experts
    and the router for an MoE layer)."""
    d, hd = m["d_model"], head_dim(m)
    attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
    if is_moe_layer(m, i):
        return attn + d * m["n_experts"] + m["top_k"] * 3 * d * m["moe_d_ff"]
    return attn + 3 * d * m["d_ff"]


def model_flops(m: Dict, lengths: Iterable[Tuple[int, int]]) -> float:
    """Model FLOPs of requests given as (prompt, emitted) lengths: 2 per
    weight a token multiplies by, 4 * heads * head_dim per key it attends
    in each layer, and 2 * d * vocab per emitted token for the head."""
    hd, h = head_dim(m), m["n_heads"]
    flops = 0
    for p, g in lengths:
        n = p + g - 1
        for i in range(m["n_layers"]):
            flops += 2 * layer_matmul_params(m, i) * n
            flops += 4 * h * hd * _key_sum(0, n, layer_window(m, i))
        flops += 2 * m["d_model"] * m["vocab_size"] * g
    return float(flops)


def decode_attention_work(m: Dict, positions: Iterable[int],
                          elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) the decode attention needs for decode tokens at
    ``positions`` (one per row of each step): each token's keys and values
    read once, its query read and its output written once, in every
    layer."""
    hd, h, kv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    positions = list(positions)
    flops = nbytes = 0
    for i in range(m["n_layers"]):
        w = layer_window(m, i)
        keys = sum(_key_sum(p, p + 1, w) for p in positions)
        flops += 4 * h * hd * keys
        nbytes += elem_bytes * (2 * kv * hd * keys + 2 * h * hd * len(positions))
    return float(flops), float(nbytes)


def token_flops(m: Dict, lo: int, hi: int, emitted: int) -> float:
    """Model FLOPs of the tokens at positions lo..hi-1 of one sequence, of
    which ``emitted`` go through the head (as ``model_flops`` counts)."""
    hd, h = head_dim(m), m["n_heads"]
    flops = 0
    for i in range(m["n_layers"]):
        flops += 2 * layer_matmul_params(m, i) * (hi - lo)
        flops += 4 * h * hd * _key_sum(lo, hi, layer_window(m, i))
    return float(flops + 2 * m["d_model"] * m["vocab_size"] * emitted)
