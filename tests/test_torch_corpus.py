"""The plan over the reference's twelve-model smoke corpus
(``CORPUS_ARCHS``) at two attention backends, against the reference plan's
coverage (paper Table 2 as a dry run).

Per (model, backend), the stateful and linear entries and the stateful and
linear tasks (owners and points) equal the reference plan's; op entries
differ by design (aten ops, not jaxpr primitives), so the corpus totals
differ and are printed side by side.
"""
import torch

from repro.configs import CORPUS_ARCHS as JAX_CORPUS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.database import LatencyDB as JaxLatencyDB
from repro.core.plan import build_plan as jax_build_plan
from repro.core.profiler import QUICK_SWEEP as JAX_QUICK_SWEEP
from repro_torch.configs import CORPUS_ARCHS, get_smoke_config
from repro_torch.core.database import LatencyDB
from repro_torch.core.plan import build_plan
from repro_torch.core.profiler import QUICK_SWEEP

torch.set_num_threads(2)

#: the reference's README runs its twelve-model plan at these backends
BACKENDS = ("xla", "chunked")
#: the reference's corpus task dedup at the smoke configs and BACKENDS
REFERENCE_DEDUP = 0.837


def _structure(plan, linear):
    """Per (model, backend), (name, variant, reused) of the stateful and
    linear entries; the stateful and linear tasks as (owners, points)."""
    entries = [(key, [(e.group, e.variant, e.reused) for e in ents
                      if e.group != "other"])
               for key, ents in plan.entries]
    tasks = [(t.kind, tuple(t.owners), t.n_points) for t in plan.tasks
             if t.kind == "module" or t.payload[2].kind in linear]
    return entries, tasks


def test_corpus_plan_matches_the_reference_coverage(capsys):
    """The twelve smoke configs at both backends in one plan: per model its
    stateful and linear entries and tasks as the reference plan's; the
    corpus task dedup printed beside the reference's 83.7 %."""
    assert CORPUS_ARCHS == JAX_CORPUS
    with LatencyDB() as db:
        plan = build_plan(db, [get_smoke_config(a) for a in CORPUS_ARCHS],
                          backends=BACKENDS, hardware="cpu",
                          oracle="h100_analytical", sweep=QUICK_SWEEP,
                          device="cpu")
    with JaxLatencyDB() as jdb:
        ref = jax_build_plan(jdb, [jax_smoke_config(a) for a in JAX_CORPUS],
                             backends=BACKENDS, hardware="tpu-v5e",
                             oracle="tpu_analytical", sweep=JAX_QUICK_SWEEP)
    got, want = _structure(plan, ("mm", "addmm", "bmm")), \
        _structure(ref, ("dot_general",))
    assert got == want
    cov, jcov = plan.coverage(), ref.coverage()
    assert [(m.label(), m.n_entries > 0) for m in cov.models] == \
        [(m.label(), True) for m in jcov.models]
    kinds = {e.name for _, ents in plan.entries for e in ents}
    assert {"self_attn", "cross_attn", "mla_attn", "mamba", "moe"} <= kinds
    assert abs(jcov.dedup_frac - REFERENCE_DEDUP) < 5e-4
    with capsys.disabled():
        print(f"\n[corpus plan] twelve smoke configs x {BACKENDS}: port "
              f"{cov.plan_tasks} of {cov.naive_tasks} tasks, "
              f"{100 * cov.dedup_frac:.1f} % task dedup; reference "
              f"{jcov.plan_tasks} of {jcov.naive_tasks}, "
              f"{100 * jcov.dedup_frac:.1f} %")
