"""Cross-pod communication: the exact record exchange and the two-tier
byte model (port of repro/runtime/comms.py).

Two tiers of traffic exist once aggregation goes hierarchical:

- **intra-pod** (the ICI tier): payload routing inside one pod's server
  decode, modelled by ``dist.collectives.intra_pod_traffic`` and ledgered
  in ``History.intra_pod_bytes``; each pod's decode is a smaller instance
  of the same problem.
- **cross-pod** (the DCN tier): what crosses pod boundaries. Flat
  aggregation ships every non-root survivor's PAYLOAD to the root (n·k-ish
  bytes); the hierarchical route ships each contributing pod's d-sized
  DECODED estimate up and the combined mean back down (d-ish bytes), which
  wins exactly in the n·k > d regime the paper's estimators target.
  ``cross_pod_traffic`` models both routes; ``History.dcn_bytes`` ledgers
  the route taken.

``CrossPodExchange`` moves the per-pod records between runtime processes
through the coordinator's key-value store (a bit-exact byte round-trip).
On a device mesh the decoded tiles combine with
``dist.collectives.psum_scatter_mean`` instead (re-exported here).

Trace contract: DCN bytes annotate spans under the key ``bytes_dcn`` (like
``bytes_intra_pod``), never ``bytes``: the trace gate sums ``bytes``
exactly against the wire ledger and modelled tiers must not enter that sum.
With recording on, the exchange counts its pickled bytes
(``runtime/xpod_bytes``) and records its seconds a round
(``runtime/xpod_seconds``), of which ``runtime/xpod_wait_seconds`` were
spent at the barrier waiting for the other processes' records.
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import torch

from .. import obs
from ..dist.collectives import psum_scatter_mean  # noqa: F401  (re-export)
from .launch import RuntimeContext

__all__ = ["CrossPodExchange", "cross_pod_traffic", "psum_scatter_mean"]


class CrossPodExchange:
    """All-to-all of per-pod round records across runtime processes.

    Each process publishes ONE pickled blob per round, ``{pod: record}`` for
    every pod it owns (possibly empty, so remote gets never hang), then
    gets every other process's blob. Records are plain dicts of tensors and
    scalars; a tensor crosses as a numpy array, which round-trips pickle
    bit-exactly, and comes back on the context's device: that is what the
    2-process == 1-process bitwise-parity contract rides on.

    Single-process contexts (or ``ctx=None``) short-circuit: the owned
    records ARE the global records, and their tensors stay where they are.
    The instance's scope (one per exchange a process makes, the same on
    every process) and a monotone sequence number key each round's blobs
    and barriers, so neither rounds nor runs alias; the publisher deletes
    its blob after the exit barrier.
    """

    def __init__(self, ctx: RuntimeContext | None = None):
        self.ctx = ctx
        self._seq = 0
        self._scope = (ctx.new_scope("repro/xpod") if ctx is not None and ctx.is_distributed
                       else None)

    def exchange(self, owned: dict) -> dict:
        """``owned``: {pod_id: record} for this process's pods. Returns the
        union over all processes, exactly once per call site per round."""
        ctx = self.ctx
        if ctx is None or not ctx.is_distributed:
            return dict(owned)
        t0 = time.perf_counter()
        seq = self._seq
        self._seq += 1
        key = f"{self._scope}/{seq}/{ctx.process_id}"
        host = {p: {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in rec.items()} for p, rec in owned.items()}
        blob = pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL)
        del host
        ctx.put_bytes(key, blob)
        t_wait = time.perf_counter()
        ctx.barrier(f"{self._scope}-ready/{seq}")
        t_wait = time.perf_counter() - t_wait
        records = dict(owned)
        for p in range(ctx.n_processes):
            if p != ctx.process_id:
                # the peers' blobs were written by this program's processes
                peer = pickle.loads(ctx.get_bytes(f"{self._scope}/{seq}/{p}"))
                records.update({q: {k: torch.from_numpy(v).to(ctx.device)
                                    if isinstance(v, np.ndarray) else v
                                    for k, v in rec.items()} for q, rec in peer.items()})
        ctx.barrier(f"{self._scope}-done/{seq}")
        ctx.delete(key)
        obs.count("runtime", "xpod_bytes", len(blob))
        obs.observe("runtime", "xpod_seconds", time.perf_counter() - t0)
        obs.observe("runtime", "xpod_wait_seconds", t_wait)
        return records


def cross_pod_traffic(pipe, cohort, survivors, plan, n_chunks: int, *,
                      stale_pods: int = 0, hierarchy: str = "hier") -> dict:
    """Modelled cross-pod (DCN-tier) bytes of one round's aggregation.

    - ``dcn_bytes_flat``: flat aggregation to a root server placed in pod 0:
      every survivor OUTSIDE pod 0 ships its full payload across the pod
      boundary, per budget group:
      ``sum_g n_nonroot_g * payload_nbytes_g(n_chunks)``.
    - ``dcn_bytes_hier``: the hierarchical route: each contributing non-root
      pod ships ONE d-sized decoded estimate up (float32), pods that also
      admitted a stale group ship that stale mean too (``stale_pods`` of
      them), and the combined mean broadcasts back down to the other P-1
      pods: ``(n_contributing_nonroot + stale_pods + n_pods - 1) * C *
      d_block * 4``.
    - ``dcn_bytes``: the route actually taken: hier at ``n_pods >= 2``,
      else 0 (one pod / flat: nothing crosses a pod boundary; the root IS
      the server). This is the ``History.dcn_bytes`` column.
    """
    pods = np.asarray([plan.pod_of(int(i)) for i in np.asarray(survivors)], dtype=np.int64)
    est_nbytes = n_chunks * pipe.d_block * 4

    flat = 0
    for k_g, ids_g in cohort.budget_groups(survivors, pipe.k):
        if len(ids_g) == 0:
            continue
        n_nonroot = int(np.sum(np.asarray([plan.pod_of(int(i)) for i in ids_g]) != 0))
        flat += n_nonroot * pipe.with_budget(k_g).payload_nbytes(n_chunks)

    contributing_nonroot = int(len({int(p) for p in pods} - {0}))
    up = (contributing_nonroot + int(stale_pods)) * est_nbytes
    down = (plan.n_pods - 1) * est_nbytes
    hier = up + down if plan.n_pods > 1 else 0
    taken = hier if (hierarchy == "hier" and plan.n_pods > 1) else 0
    return {
        "n_pods": plan.n_pods,
        "dcn_bytes_flat": int(flat),
        "dcn_bytes_hier": int(hier),
        "dcn_bytes": int(taken),
    }
