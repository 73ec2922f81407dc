"""FLIC core: the paper's primary contribution, ported to PyTorch
(``repro.core``'s counterpart, the same public names).

A distributed, loss-tolerant ("soft coherent") fog cache between application
code and a slow cloud backing store:

* ``cache_state`` / ``flic`` — functional set-associative cache with LRU
  eviction and timestamp-resolved (soft-coherence) upserts;
* ``coherence`` — loss models, broadcast merge, and the paper's §II-B bound;
* ``writeback`` — the single queued writer (ring buffer + binary exponential
  backoff + API token bucket);
* ``backing_store`` — simulated cloud store (Google-Sheets-like full-table
  reads, rate caps, failure windows / a well-behaved "db" profile);
* ``simulator`` — the paper's Docker fog testbed as one vectorized tick,
  looped over the run;
* ``workload`` — scenario layer (``WorkloadSpec``/``SCENARIOS``) and the
  plan/execute split (``plan_tick`` -> ``RequestPlan``): key popularity
  (stream/zipf/trace replay), Poisson or cadence arrivals, read recency,
  rate modulation, node churn (DESIGN.md §7);
* ``distributed`` — the pod-scale embodiment on ``torch.distributed``.
"""
from repro_torch.core.cache_state import CacheLine, CacheState, empty_cache, null_line
from repro_torch.core.flic import (
    LookupResult,
    fog_lookup,
    insert,
    insert_batch,
    insert_rows,
    local_lookup,
    lookup_rows,
)
from repro_torch.core.coherence import (
    bernoulli_loss_mask,
    exact_total_loss_prob,
    markov_loss_bound,
    merge_broadcasts,
)
from repro_torch.core.flic import invalidate_nodes, update_rows
from repro_torch.core.metrics import TickMetrics, diff_summaries, summarize
from repro_torch.core.simulator import (
    SimConfig,
    SimState,
    init_sim,
    run_any_engine,
    run_sim,
    sim_tick,
)
from repro_torch.core.workload import (
    SCENARIOS,
    PlanState,
    RequestPlan,
    TraceSpec,
    WorkloadSpec,
    plan_tick,
)

__all__ = [
    "SCENARIOS",
    "WorkloadSpec",
    "TraceSpec",
    "RequestPlan",
    "PlanState",
    "plan_tick",
    "update_rows",
    "invalidate_nodes",
    "CacheLine",
    "CacheState",
    "empty_cache",
    "null_line",
    "LookupResult",
    "fog_lookup",
    "insert",
    "insert_batch",
    "insert_rows",
    "local_lookup",
    "lookup_rows",
    "bernoulli_loss_mask",
    "exact_total_loss_prob",
    "markov_loss_bound",
    "merge_broadcasts",
    "TickMetrics",
    "diff_summaries",
    "summarize",
    "SimConfig",
    "SimState",
    "init_sim",
    "run_any_engine",
    "run_sim",
    "sim_tick",
]
