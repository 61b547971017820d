"""The check that decides ``correct``: the tokens the timed path served,
held against the plain float32 reference.

After the window closes, a sample of the finished requests, drawn from the
seed and always holding the one that emitted the most tokens, is run
through the reference over the exact token ids the engine ran (prompt,
then the replay tokens its decode steps were fed).  At every position
where the program emitted a token, the gap by which that token's reference
logit lies below the reference's best is read: ``logit_gap`` is the widest,
``token_mismatch_pct`` the share of positions whose token is not the
reference's best.  A cell's file names the numbers it holds to a limit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100bench.reference import decoder


def sample(requests, emitted: Dict[int, List[int]], n: int, seed: int) -> list:
    """Up to ``n`` finished requests: the one that emitted the most tokens,
    then others drawn from ``seed``."""
    done = [r for r in requests if r.finish_t is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.generated, r.prompt_len, -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 7])
    pick = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs, chunk_log) -> List[decoder.Sequence_]:
    return [decoder.sequence(r.prompt, r.generated, chunk_log.get(r.rid, []))
            for r in reqs]


def readings(gap: torch.Tensor) -> Dict:
    """The numbers a check may compare, from the gaps at every position:
    the widest, the mean, the share of positions whose token is not the
    reference's best, and the share whose gap passes 0.1 or 0.2."""
    if not gap.numel():
        return {"logit_gap": float("inf"), "mean_logit_gap": float("inf"),
                "token_mismatch_pct": 100.0, "gap_over_0.1_pct": 100.0,
                "gap_over_0.2_pct": 100.0, "positions": 0}
    return {"logit_gap": float(gap.max()), "mean_logit_gap": float(gap.mean()),
            "token_mismatch_pct": 100.0 * float((gap > 0).float().mean()),
            "gap_over_0.1_pct": 100.0 * float((gap > 0.1).float().mean()),
            "gap_over_0.2_pct": 100.0 * float((gap > 0.2).float().mean()),
            "positions": int(gap.numel())}


def served_gaps(m: Dict, seed: int, reqs, emitted, chunk_log, device):
    """(the reference's logits and the gaps of the program's served tokens,
    one tensor per request of ``reqs`` that was served all its tokens, and
    ``missing``: sampled requests whose served tokens do not number their
    emitted count)."""
    missing = sum(len(emitted.get(r.rid, [])) != r.generated for r in reqs)
    ok = [r for r in reqs if len(emitted.get(r.rid, [])) == r.generated]
    ref = decoder.logits(m, seed, sequences(ok, chunk_log), device)
    gap = [decoder.gaps(lg, torch.tensor(emitted[r.rid], device=device))
           for lg, r in zip(ref, ok)]
    return ref, gap, missing


def served(m: Dict, seed: int, reqs, emitted, chunk_log, device) -> Dict:
    """The check's readings of the program's served tokens."""
    _, gap, missing = served_gaps(m, seed, reqs, emitted, chunk_log, device)
    return {**readings(torch.cat(gap) if gap else torch.zeros(0)), "missing": missing}


def lower_precision(m: Dict, seed: int, reqs, chunk_log, device, ref,
                    mode: str = "fp8") -> Dict:
    """The readings of the reference computed in ``mode`` (``fp8``: the
    control; ``bf16``: the witness at the program's precision) in the
    program's place: the gaps, in ``ref``, of the tokens it puts first at
    the same positions."""
    low = decoder.logits(m, seed, sequences(reqs, chunk_log), device, mode=mode)
    return readings(torch.cat([decoder.gaps(r, lo.argmax(-1))
                               for r, lo in zip(ref, low)]))
