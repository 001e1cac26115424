"""Per-shape SDDS schedule autotuning on Hopper (the port's twin of the
JAX package's ``autotune``).

ESPIM's bet is that the sparsity is static and known offline, so every
scheduling decision can be made before inference.  The streaming SpMV
kernels leave three such decisions (chunk width, warps a row, U); this
package makes them per pack:

* ``core.sdds.enumerate_schedules`` is the candidate space, filtered by
  the kernels' own legality constraints;
* a transparent cost model (traffic at the HBM rate, a fixed launch
  cost, under-fill of the SMs) ranks the candidates;
* the top-k are timed for real with ``telemetry.profile.time_launch``
  on the actual uploaded planes (the device clock on the card);
* the winner persists in a JSON plan cache keyed by the pack's
  plan-independent integrity fingerprint (``core.integrity``) plus the
  launch context (batch, quant mode, impl, backend) — retune happens the
  moment the pack bytes change, and a warm cache makes
  ``ops.pack_to_device(autotune=True)`` skip the search entirely
  (asserted via ``search_stats`` in the tests and ``chip_smoke.py``).
"""
from repro_torch.autotune.cache import (PlanCache, default_cache,
                                        pack_cache_key, reset_default_cache)
from repro_torch.autotune.tuner import (TunedPlan, autotune_pack,
                                        reset_search_stats, schedule_cost,
                                        search_stats)

__all__ = [
    "PlanCache",
    "default_cache",
    "reset_default_cache",
    "pack_cache_key",
    "TunedPlan",
    "autotune_pack",
    "schedule_cost",
    "search_stats",
    "reset_search_stats",
]
