"""Remediation planner of the port (port of ``repro.plan``).

An admission gate that can only say "no" leaves a scheduler guessing.
The planner turns a rejection into ranked counter-offers: given a
rejected request and a capacity it searches the plan space on the CPU,
trace-frugally, and returns :class:`CounterOffer`\\ s, each with its
peak estimate, its safe threshold (Eq. 5) and a throughput cost from
the analytic roofline priced for the H100, so "cheapest feasible" means
lowest modeled slowdown.

* :class:`RemediationPlanner` — the search (shares the admission
  service's trace cache and sweep path);
* :class:`PlanContext` — attach to ``AdmissionRequest.meta["plan"]``
  and rejections come back with ``counter_offers``;
  :class:`ServingPlanContext` — the same for ``decide_serving``;
* ``CounterOffer.admission_request`` — the exact request an offer
  promises will fit (decisions reproduce bit-identically);
* :func:`run_plan_search` — a one-call search over a smoke job.
"""
from ..core.orchestrator import OffloadPlan  # noqa: F401
from .cost import plan_cost, serving_cost  # noqa: F401
from .planner import (CounterOffer, PlanContext, PlanResult,  # noqa: F401
                      PlanSpace, RemediationPlanner, ServingPlanContext,
                      run_plan_search, serving_trace_budget)

__all__ = ["CounterOffer", "OffloadPlan", "PlanContext", "PlanResult",
           "PlanSpace", "RemediationPlanner", "ServingPlanContext",
           "plan_cost", "run_plan_search", "serving_cost",
           "serving_trace_budget"]
