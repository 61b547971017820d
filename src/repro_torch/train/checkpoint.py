"""Fault-tolerant checkpointing: step-tagged directories, atomic rename,
an async save thread.

Counterpart of ``repro.train.checkpoint``, with its layout and guarantees:

    <dir>/step_00000123.tmp/...   (written)
    <dir>/step_00000123/          (atomic rename on completion)
    <dir>/MANIFEST.json           (latest committed step; written last)

A crashed save leaves only a .tmp directory, which restore ignores —
restart always resumes from the last *committed* step.

A state is a nest of dicts (and lists or tuples) whose leaves are tensors
or Python numbers, such as the trainer's ``{"step", "params", "opt"}``.
Leaves go to ``leaves.npz`` in the order of a depth-first walk; numpy has
no bfloat16, so every tensor is stored as the raw bits of its dtype (a
``uint16`` view for bfloat16 and float16, the array itself otherwise) and
``treedef.json`` records each leaf's path and torch dtype.  bf16 therefore
round-trips bit for bit.  Reading the JAX package's checkpoints is not a
goal.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

#: torch dtypes stored as a same-width integer view
_BITS = {torch.bfloat16: np.uint16, torch.float16: np.uint16}


def _leaves(tree: Tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        kind = str(t.dtype).removeprefix("torch.")
        if t.dtype in _BITS:
            return t.view(torch.int16).numpy().view(_BITS[t.dtype]), kind
        return t.numpy(), kind
    return np.asarray(leaf), type(leaf).__name__


@torch.no_grad()
def _from_numpy(x: np.ndarray, kind: str, like):
    """The leaf ``like`` restored from ``x``: a tensor is overwritten in
    place, a number comes back as a new one of its type."""
    if not torch.is_tensor(like):
        return type(like)(x.item())
    dtype = getattr(torch, kind)
    if dtype in _BITS:
        t = torch.from_numpy(x.view(np.int16)).view(dtype)
    else:
        t = torch.from_numpy(x)
    return like.copy_(t)


def host_state(state: Tree) -> Tree:
    """A copy of ``state`` with every tensor on the host, detached."""
    if isinstance(state, dict):
        return {k: host_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(host_state(v) for v in state)
    if torch.is_tensor(state):
        return state.detach().to("cpu", copy=True)
    return state


def save(directory: str, step: int, state: Tree) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _leaves(state)
    arrays = [_to_numpy(x) for _, x in leaves]
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"l{i}": a for i, (a, _) in enumerate(arrays)})
    with open(os.path.join(tmp, "treedef.json"), "w") as f:
        json.dump({"n_leaves": len(leaves), "step": step,
                   "paths": [p for p, _ in leaves],
                   "dtypes": [kind for _, kind in arrays]}, f)
    os.replace(tmp, final)                       # atomic commit
    manifest = os.path.join(directory, "MANIFEST.json")
    tmp_m = manifest + ".tmp"
    with open(tmp_m, "w") as f:
        json.dump({"latest_step": step, "path": name,
                   "time": time.time()}, f)
    os.replace(tmp_m, manifest)
    return final


class AsyncCheckpointer:
    """Host-offload save thread: training continues while the previous
    state (already copied to the host) serializes."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Tree):
        snapshot = host_state(state)
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(self.directory, step, snapshot), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    manifest = os.path.join(directory, "MANIFEST.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        return json.load(f)["latest_step"]


def _rebuild(like: Tree, stored) -> Tree:
    """``like`` with each leaf restored from the next (array, dtype) pair
    of the iterator ``stored``, in ``_leaves`` order."""
    if isinstance(like, dict):
        return {k: _rebuild(v, stored) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, stored) for v in like)
    return _from_numpy(*next(stored), like)


def restore(directory: str, like: Tree, step: Optional[int] = None
            ) -> Tuple[Tree, int]:
    """Restore into ``like``, as ``load_state_dict`` does: each tensor leaf
    of ``like`` is overwritten in place (so restoring a train state restores
    the model whose parameters it holds), each number comes back as a new
    one of its type in a rebuilt nest.  Returns (state, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "treedef.json")) as f:
        meta = json.load(f)
    expected = _leaves(like)
    if [p for p, _ in expected] != meta["paths"]:
        raise ValueError(f"checkpoint at {path} holds leaves {meta['paths'][:4]}..., "
                         f"expected {[p for p, _ in expected][:4]}...")
    with np.load(os.path.join(path, "leaves.npz")) as data:
        arrays = [data[f"l{i}"] for i in range(meta["n_leaves"])]
    for (p, ref), x in zip(expected, arrays):
        shape = tuple(ref.shape) if torch.is_tensor(ref) else ()
        if tuple(x.shape) != shape:
            raise ValueError(f"leaf {p}: checkpoint shape {x.shape} != "
                             f"expected {shape}")
    return _rebuild(like, zip(arrays, meta["dtypes"])), step
