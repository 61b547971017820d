"""The port's tainted runner — ``core.{taint,tracer,callgraph,runner,opset}``
— against the JAX package's, on the six smoke configs the port serves.

The port traces aten ops under a ``TorchDispatchMode`` where the reference
walks a jaxpr, so their op entries differ by design (an aten ``mm`` on a
merged (B*S) dim against a ``dot_general`` on (B, S)).  What must agree:

* the stateful module entries (kind, count, path, execution context) and
  the token/request/model template of each one's activation input;
* per canonical module, the linear op entries (aten ``mm``/``addmm``/
  ``bmm`` against ``dot_general``), equal in number and in dim templates
  compared through ``Taint.canonical_factors``, so that an aten (B*S) MIX
  dim equals a jaxpr (B, S) pair;
* ``reshape_taints`` on the same inputs.

Other op entries are not compared.  ``core/taint.py`` and
``core/callgraph.py`` are copies of the reference's, as are the latency
DB, the latency model, the journal and the supervisor.
"""
from pathlib import Path

import pytest
import torch
from torch import nn

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import opset as jopset
from repro.core import runner as jrunner
from repro.core import taint as jtaint
from repro.core.tracer import reshape_taints as jax_reshape_taints
from repro_torch.configs import get_smoke_config
from repro_torch.core import opset, runner, taint
from repro_torch.core.tracer import reshape_taints, trace_tainted

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "command-r7b", "yi-9b", "starcoder2-15b", "granite-20b",
         "falcon-mamba-7b"]
LINEAR = ("mm", "addmm", "bmm")


def _as_copy(name: str, ref_text: str) -> str:
    return "\n".join(line.replace("from repro.", "from repro_torch.")
                     if line.startswith("from repro.") else line
                     for line in ref_text.split("\n"))


@pytest.mark.parametrize("name", ["taint", "callgraph", "database",
                                  "latency_model", "journal", "supervisor"])
def test_core_module_is_a_copy(name):
    ref = (ROOT / "src/repro/core" / f"{name}.py").read_text()
    port = (ROOT / "src/repro_torch/core" / f"{name}.py").read_text()
    assert port == _as_copy(name, ref)


def test_stateful_modules_and_config_values_match_the_reference():
    assert opset.STATEFUL_MODULES == jopset.STATEFUL_MODULES
    for arch in ARCHS:
        assert runner.config_taint_values(get_smoke_config(arch)) == \
            jrunner.config_taint_values(jax_smoke_config(arch))


# ---------------------------------------------------------------------------
# reshape_taints against the reference function
# ---------------------------------------------------------------------------

def _taints(module, labels, sizes):
    """Base taints (or BOT for None) of ``module`` for each label."""
    base = {"R": module.REQS, "T": module.TOKS, "M": module.MODEL,
            None: module.BOT}
    return tuple(base[label] for label in labels)


def _registry(module):
    reg = module.TaintRegistry()
    reg.seed_many([128, 32, 4, 384], module.MODEL_CONFIG)
    reg.seed(5, module.NUM_REQS)
    reg.seed(11, module.NUM_TOKS)
    return reg


#: (in shape, in labels, out shape)
RESHAPES = [
    ((5, 11, 128), ("R", "T", "M"), (55, 128)),              # merge
    ((5, 11, 128), ("R", "T", "M"), (5, 11, 4, 32)),         # split by registry
    ((5, 11, 4, 32), ("R", "T", "M", "M"), (5, 11, 128)),    # merge model dims
    ((5, 1, 11, 128), ("R", None, "T", "M"), (5, 11, 128)),  # size-1 dims
    ((5, 11, 128), ("R", "T", "M"), (5, 1, 11, 128)),
    ((5, 11, 128), ("R", "T", "M"), (5, 11 * 128)),
    ((55, 384), (None, "M"), (5, 11, 384)),                  # split untainted
    ((5, 11, 6), ("R", "T", None), (5, 66)),                 # ragged product
    ((6, 10), (None, None), (4, 15)),                        # n -> m
]


@pytest.mark.parametrize("in_shape,labels,out_shape", RESHAPES)
def test_reshape_taints_match_the_reference(in_shape, labels, out_shape):
    got = reshape_taints(in_shape, _taints(taint, labels, in_shape), out_shape,
                         _registry(taint))
    want = jax_reshape_taints(in_shape, _taints(jtaint, labels, in_shape),
                              out_shape, _registry(jtaint))
    assert repr(got) == repr(want)


def test_reshape_taints_split_recovers_a_merge():
    """A (B*S) MIX dim splits back into its (R, T) factors through H."""
    reg = _registry(taint)
    merged = reshape_taints((5, 11, 128), (taint.REQS, taint.TOKS, taint.MODEL),
                            (55, 128), reg)
    assert merged[0].is_mix and merged[0].canonical_factors == (("N", 5), ("N", 11))
    back = reshape_taints((55, 128), merged, (5, 11, 128), reg)
    assert back == (taint.REQS, taint.TOKS, taint.MODEL)


# ---------------------------------------------------------------------------
# the runnable set against the reference's
# ---------------------------------------------------------------------------

def _factors(shape, taints):
    """A dim template through ``canonical_factors``: a MIX dim becomes its
    sorted (label initial, value) factors, a base-tainted dim one such
    pair, an untainted one ("_", size)."""
    out = []
    for size, t in zip(shape, taints):
        if t.is_mix:
            out.extend(t.canonical_factors)
        elif t.is_bot:
            out.append(("_", int(size)))
        else:
            out.append((t.kind[0], int(size)))
    return tuple(out)


def _ref_summary(entries):
    stateful, linear = [], {}
    for e in entries:
        if isinstance(e, jopset.ModuleEntry) and e.context_kind:
            op = e.ops[0]
            stateful.append((e.kind, e.count, e.module, e.context_kind,
                             _factors(op.in_shapes[0], op.in_taints[0])))
        elif isinstance(e, jopset.OpEntry) and e.kind == "dot_general":
            linear.setdefault(e.module, []).append(tuple(
                _factors(s, t) for s, t in zip(e.op.in_shapes, e.op.in_taints)))
    return stateful, {k: sorted(v) for k, v in linear.items()}


def _port_summary(entries):
    stateful, linear = [], {}
    for e in entries:
        if isinstance(e, opset.ModuleEntry) and e.context_kind:
            x = e.call.tensors[0]
            stateful.append((e.kind, e.count, e.module, e.context_kind,
                             _factors(x.shape, x.taints)))
        elif isinstance(e, opset.OpEntry) and e.kind in LINEAR:
            ins = list(zip(e.op.in_shapes, e.op.in_taints))[-2:]   # addmm's bias
            linear.setdefault(e.module, []).append(tuple(
                _factors(s, t) for s, t in ins))
    return stateful, {k: sorted(v) for k, v in linear.items()}


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    arch = request.param
    jtrace = jrunner.trace_model(jax_smoke_config(arch))
    ptrace = runner.trace_model(get_smoke_config(arch))
    return (arch, jtrace, jopset.find_runnable_set(jtrace.trace), ptrace,
            opset.find_runnable_set(ptrace.trace, device="cpu"))


def test_dummy_prompt_matches_the_reference(both):
    _, jtrace, _, ptrace, _ = both
    assert (ptrace.batch, ptrace.seq, ptrace.retraces) == \
        (jtrace.batch, jtrace.seq, jtrace.retraces)


def test_stateful_module_entries_match_the_reference(both):
    arch, _, jentries, _, entries = both
    want, _ = _ref_summary(jentries)
    got, _ = _port_summary(entries)
    assert want and got == want, arch


def test_linear_op_entries_match_the_reference(both):
    arch, _, jentries, _, entries = both
    _, want = _ref_summary(jentries)
    _, got = _port_summary(entries)
    assert want and got == want, arch


def test_op_entries_rerun_at_a_sweep_point(both):
    """An op entry re-runs its aten overload on inputs resized to (toks,
    reqs): the first linear entry's merged (B*S) dim takes the new sizes."""
    *_, entries = both
    mm = next(e for e in entries
              if isinstance(e, opset.OpEntry) and e.kind in LINEAR)
    out = mm.run(toks=7, reqs=2, device="cpu")
    assert out.shape[0] == 14 and out.shape[1] == mm.op.out_shapes[0][1]
    a = mm.callable(toks=7, reqs=2, device="cpu")[1]
    b = mm.callable(toks=7, reqs=2, device="cpu")[1]
    assert all(torch.equal(x, y) for x, y in zip(a, b))      # seeded inputs


def test_stateful_module_entries_rerun_their_module(both):
    *_, ptrace, entries = both
    me = next(e for e in entries
              if isinstance(e, opset.ModuleEntry) and e.context_kind)
    out = me.run(device="cpu")
    assert tuple(out.shape) == (ptrace.batch, ptrace.seq, ptrace.cfg.d_model)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# ambiguity and the module fallback
# ---------------------------------------------------------------------------

def test_a_colliding_dummy_batch_raises_like_the_reference():
    """A dummy batch equal to a model dimension is ambiguous; with the batch
    fixed there is nothing to retrace with, in both packages."""
    cfg, jcfg = get_smoke_config("llama3-8b"), jax_smoke_config("llama3-8b")
    with pytest.raises(jtaint.AmbiguityError):
        jrunner.trace_model(jcfg, batch=cfg.d_model, max_retries=1)
    with pytest.raises(taint.AmbiguityError):
        runner.trace_model(cfg, batch=cfg.d_model, max_retries=1)


class _Body(nn.Module):
    """A draw from softmax probabilities: alone on generated (partly
    negative) inputs ``multinomial`` fails; the module, which makes its
    input a distribution first, runs."""

    def forward(self, x):
        return torch.multinomial(torch.softmax(x, -1), 1)


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = _Body()

    def forward(self, x):
        return self.body(x)


def test_a_failing_op_is_absorbed_into_its_module():
    reg = taint.TaintRegistry()
    reg.seed(5, taint.NUM_REQS)
    reg.seed(7, taint.MODEL_CONFIG)
    toy = _Toy()
    x = torch.zeros((5, 7), device="meta")
    trace = trace_tainted(toy, (x,), registry=reg, root=toy)
    assert [op.path for op in trace.ops] == [("body",), ("body",)]
    entries = opset.find_runnable_set(trace, device="cpu")
    assert [(type(e).__name__, e.kind, e.module) for e in entries] == [
        ("OpEntry", "_softmax", "body"), ("ModuleEntry", "body", "body")]
    absorbed = entries[1]
    assert [op.name for op in absorbed.ops] == ["multinomial"]
    assert absorbed.context_kind is None
    assert tuple(absorbed.run(device="cpu").shape) == (5, 1)
