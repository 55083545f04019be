"""repro_torch.runtime: the multi-host hierarchical aggregation runtime
(port of repro/runtime).

Takes the estimator beyond one process: ``launch`` joins processes to one
runtime through a ``torch.distributed.TCPStore`` hosted by process 0 (and
``spawn_local`` starts local processes, on the card unless the CPU is
asked for); ``hierarchy`` assigns clients to pods and runs the two-level
decode, a pod-local correlation-aware sub-decode, then a cross-pod mean of
d-sized decoded estimates; ``comms`` moves the per-pod records between
processes and models the two-tier (intra-pod / cross-pod) byte ledger;
``workers`` holds the picklable entry points spawned processes run.

Drive it through ``fl.run_rounds`` with
``RoundConfig(hierarchy="hier", pods=P, runtime=ctx)`` or from the CLI via
``python -m repro_torch.fl.run --hosts 2 --pods 2``.
"""
from .comms import CrossPodExchange, cross_pod_traffic, psum_scatter_mean  # noqa: F401
from .hierarchy import (  # noqa: F401
    HierarchicalAggregator,
    PodPlan,
    combine_records,
    combine_rho,
)
from .launch import (  # noqa: F401
    RuntimeContext,
    Topology,
    free_port,
    initialize,
    shutdown,
    spawn_local,
)
