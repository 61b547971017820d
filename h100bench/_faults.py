"""Faults planted in the program under a whole harness run, for the tests:
each must make the run's ``correct`` come out false.

    python h100bench/_faults.py <seed> <workload>...

runs each cell once per fault on the CPU (``--device cpu``), the fault
planted by replacing a function of the port for that run only, and prints
one JSON object: {workload: {fault: correct}}.  The serving cells can have these:

* ``decode_state_unchanged``: a decode step leaves the K/V cache as it was;
* ``chunk_state_unchanged``: a prefill chunk leaves the K/V cache as it was;
* ``half_batch``: a decode step computes half of its rows and gives the
  others, the first half (where the scheduler places requests first), the
  mean of their logits;
* ``token_altered``: every decode step's logits are shifted by one token
  where they are produced, so each served token changes.

The exchange between chips cannot be left out: every cell runs on one.
"""
from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import run  # noqa: E402


def _faults():
    from repro_torch.models import attention, transformer, zoo

    decode_step = zoo.Model.decode_step

    def half_batch(self, *a, **kw):
        logits, cache = decode_step(self, *a, **kw)
        half = logits.shape[0] // 2
        out = logits.clone()
        out[:half] = logits[half:].mean(0)
        return out, cache

    def token_altered(self, *a, **kw):
        logits, cache = decode_step(self, *a, **kw)
        return logits.roll(1, dims=-1), cache

    return {
        "decode_state_unchanged": (attention, "_scatter_slot", lambda *a, **kw: None),
        "chunk_state_unchanged": (transformer, "_write_chunk", lambda cache, *a, **kw: cache),
        "half_batch": (zoo.Model, "decode_step", half_batch),
        "token_altered": (zoo.Model, "decode_step", token_altered),
    }


def main(workload: str, seed: int) -> dict:
    run._caches()
    out = {}
    for name, (owner, attr, fault) in _faults().items():
        kept = getattr(owner, attr)
        setattr(owner, attr, fault)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = run.main(["--workload", workload, "--seed", str(seed),
                               "--seconds", "0.05", "--device", "cpu"])
        finally:
            setattr(owner, attr, kept)
        lines = buf.getvalue().strip().splitlines()
        out[name] = json.loads(lines[-1])["correct"] if rc == 0 and lines else None
    return out


if __name__ == "__main__":
    print(json.dumps({w: main(w, int(sys.argv[1])) for w in sys.argv[2:]}))
