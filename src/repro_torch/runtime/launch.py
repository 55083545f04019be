"""Multi-host bootstrap (port of repro/runtime/launch.py): topology
discovery, the processes' shared key-value store, and a local process
spawner so the whole runtime runs in one machine's processes.

Three pieces:

- ``Topology``: the process-topology descriptor: how many processes
  (hosts), which one this is, where the coordinator lives, and how many
  local devices each process exposes. ``Topology.from_env()`` reads the
  ``REPRO_*`` variables (falling back to single-process) so the same worker
  code runs under ``spawn_local``, a cluster launcher, or bare.
- ``initialize(topo)``: joins this process to the runtime once and returns
  a ``RuntimeContext``. For several processes process 0 hosts a
  ``torch.distributed.TCPStore`` at ``topo.coordinator`` and the others
  connect to it; the store's bytes are the cross-pod transport, and numpy
  arrays round-trip through ``put_bytes`` / ``get_bytes`` bit for bit
  (``runtime.comms.CrossPodExchange`` builds on exactly this). A value
  larger than ``_PIECE_BYTES`` is stored as numbered pieces: the store
  refuses single messages past a few MiB. ``barrier`` is built from
  ``store.add`` and ``store.wait``.
- ``spawn_local(worker, n)``: starts ``n`` fresh processes (spawn context:
  children re-import), wires them to a coordinator on a free localhost
  port, runs ``worker(ctx, *args)`` in each on ``device`` (the card unless
  the caller names the CPU), and returns the per-process results, or raises
  with the children's tracebacks.

Coordinator discovery order: explicit argument > ``REPRO_COORDINATOR`` >
single-process (no coordinator needed).
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import socket
import time
import traceback

from .. import resolve_device

# env keys the spawner sets and Topology.from_env reads
ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_LOCAL_DEVICES = "REPRO_LOCAL_DEVICES"

_DEFAULT_TIMEOUT_MS = 120_000
_PIECE_BYTES = 4 << 20  # one store value; the store refuses messages past 8 MiB


@dataclasses.dataclass(frozen=True)
class Topology:
    """Process topology: hosts x (pods live above, in ``PodPlan``) x local
    devices. One instance per process; ``process_id`` names this process."""

    n_processes: int = 1
    process_id: int = 0
    coordinator: str | None = None  # "host:port"; required when n_processes > 1
    local_devices: int = 1          # devices this process exposes

    def __post_init__(self):
        if self.n_processes < 1:
            raise ValueError(f"n_processes must be >= 1, got {self.n_processes}")
        if not 0 <= self.process_id < self.n_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range [0, {self.n_processes})")
        if self.n_processes > 1 and not self.coordinator:
            raise ValueError("multi-process topology needs a coordinator address (host:port)")

    @classmethod
    def from_env(cls, coordinator: str | None = None, n_processes: int | None = None,
                 process_id: int | None = None) -> "Topology":
        """Env-discovered topology; explicit arguments win over env vars."""
        return cls(
            n_processes=int(n_processes if n_processes is not None
                            else os.environ.get(ENV_NUM_PROCESSES, "1")),
            process_id=int(process_id if process_id is not None
                           else os.environ.get(ENV_PROCESS_ID, "0")),
            coordinator=(coordinator if coordinator is not None
                         else os.environ.get(ENV_COORDINATOR) or None),
            local_devices=int(os.environ.get(ENV_LOCAL_DEVICES, "1")),
        )


def _timeout(ms: int) -> datetime.timedelta:
    return datetime.timedelta(milliseconds=ms)


class RuntimeContext:
    """One process's handle on the multi-host runtime.

    Wraps the topology, the device its work runs on and (multi-process only)
    the coordinator's ``TCPStore``, the exact-byte transport the
    hierarchical decode exchanges pod records through. Single-process
    contexts have no store; ``barrier`` is a no-op and ``put_bytes`` /
    ``get_bytes`` raise, so callers treat "1 process" uniformly via
    ``is_distributed``.
    """

    def __init__(self, topo: Topology, store=None, device=None):
        self.topo = topo
        self.device = device
        self._store = store
        self._scopes = 0

    def new_scope(self, name: str) -> str:
        """A key prefix no earlier call in this process returned: every
        process that makes the same calls in the same order gets the same
        prefixes, so one run's keys never meet another's."""
        self._scopes += 1
        return f"{name}{self._scopes}"

    # ------------------------------------------------------------ topology

    @property
    def n_processes(self) -> int:
        return self.topo.n_processes

    @property
    def process_id(self) -> int:
        return self.topo.process_id

    @property
    def is_distributed(self) -> bool:
        return self.topo.n_processes > 1

    def pods_owned(self, n_pods: int) -> range:
        """Contiguous ceil-block pod ownership (the ``ChunkOwnership``
        idiom): process i owns pods [i*cpp, min((i+1)*cpp, P))."""
        cpp = -(-n_pods // self.n_processes)  # ceil
        lo = min(self.process_id * cpp, n_pods)
        return range(lo, min(lo + cpp, n_pods))

    def owner_of_pod(self, pod: int, n_pods: int) -> int:
        if not 0 <= pod < n_pods:
            raise ValueError(f"pod {pod} out of range [0, {n_pods})")
        cpp = -(-n_pods // self.n_processes)
        return pod // cpp

    # -------------------------------------------------------- KV transport

    def _kv(self):
        if self._store is None:
            raise RuntimeError("single-process context has no KV store")
        return self._store

    def put_bytes(self, key: str, value: bytes) -> None:
        """Store ``value`` under ``key``: its pieces first, then their count,
        so a reader that sees the count finds every piece."""
        store = self._kv()
        view = memoryview(value)
        n = max(1, -(-len(view) // _PIECE_BYTES))
        for i in range(n):
            store.set(f"{key}/{i}", view[i * _PIECE_BYTES:(i + 1) * _PIECE_BYTES].tobytes())
        store.set(f"{key}/n", str(n))

    def get_bytes(self, key: str, timeout_ms: int = _DEFAULT_TIMEOUT_MS) -> bytes:
        """The value under ``key``, waiting up to ``timeout_ms`` for it."""
        store = self._kv()
        store.wait([f"{key}/n"], _timeout(timeout_ms))
        n = int(store.get(f"{key}/n"))
        return b"".join(store.get(f"{key}/{i}") for i in range(n))

    def delete(self, key: str) -> None:
        if self._store is None or not self._store.check([f"{key}/n"]):
            return
        n = int(self._store.get(f"{key}/n"))
        self._store.delete_key(f"{key}/n")
        for i in range(n):
            self._store.delete_key(f"{key}/{i}")

    def barrier(self, name: str, timeout_ms: int = _DEFAULT_TIMEOUT_MS) -> None:
        """Wait until every process has reached the barrier ``name``; a name
        used again is a new barrier (its arrivals counted in generations)."""
        if self._store is None:
            return
        arrived = self._store.add(f"{name}/count", 1)
        generation = (arrived - 1) // self.n_processes
        if arrived % self.n_processes == 0:
            self._store.set(f"{name}/done/{generation}", "1")
        self._store.wait([f"{name}/done/{generation}"], _timeout(timeout_ms))


# this process's runtime membership: one per process, as a process joins one
# coordinator (jax.distributed's global state in the JAX package)
_RUNTIME: dict = {}


def initialize(topo: Topology | None = None, device=None) -> RuntimeContext:
    """Join this process to the runtime described by ``topo`` (default:
    ``Topology.from_env()``), its work on ``device`` (the card when None).

    Single-process topologies return a storeless context. Multi-process
    topologies connect to the ``TCPStore`` at ``topo.coordinator``, which
    process 0 hosts; a second call returns the existing context.
    """
    topo = topo or Topology.from_env()
    dev = resolve_device(device)
    if topo.n_processes == 1:
        return RuntimeContext(topo, device=dev)
    ctx = _RUNTIME.get("ctx")
    if ctx is not None:
        if ctx.topo != topo:
            raise RuntimeError(f"this process already joined the runtime {ctx.topo}")
        return ctx
    import torch.distributed as dist

    host, port = topo.coordinator.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), topo.n_processes, topo.process_id == 0,
                          timeout=_timeout(_DEFAULT_TIMEOUT_MS), wait_for_workers=False)
    ctx = _RUNTIME["ctx"] = RuntimeContext(topo, store=store, device=dev)
    return ctx


def current() -> RuntimeContext | None:
    """This process's multi-process context, None before ``initialize``."""
    return _RUNTIME.get("ctx")


def shutdown(timeout_ms: int = _DEFAULT_TIMEOUT_MS) -> None:
    """Leave the runtime (no-op when never joined): a last barrier, then
    process 0, which hosts the store, waits until every other process has
    said it is done with it."""
    ctx = _RUNTIME.pop("ctx", None)
    if ctx is None:
        return
    ctx.barrier("repro/shutdown", timeout_ms)
    if ctx.process_id:
        ctx._store.add("repro/left", 1)
        return
    deadline = time.monotonic() + timeout_ms / 1000
    while ctx._store.add("repro/left", 0) < ctx.n_processes - 1:
        if time.monotonic() > deadline:
            raise TimeoutError("runtime shutdown: processes did not leave the store")
        time.sleep(0.01)


def free_port() -> int:
    """A free localhost TCP port (bind-to-0 trick; raceable in principle,
    fine for test/CI spawners)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_main(worker, process_id: int, n_processes: int, coordinator: str,
                local_devices: int, device, conn, args: tuple) -> None:
    """Spawned-child entry: name the process in its env, join the runtime,
    run the worker, ship the (pickled) result or traceback back."""
    os.environ[ENV_COORDINATOR] = coordinator
    os.environ[ENV_NUM_PROCESSES] = str(n_processes)
    os.environ[ENV_PROCESS_ID] = str(process_id)
    os.environ[ENV_LOCAL_DEVICES] = str(local_devices)
    try:
        ctx = initialize(Topology.from_env(), device=device)
        if ctx.device.type == "cpu":  # the processes share this host's cores
            import torch

            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_processes))
        try:
            out = worker(ctx, *args)
        finally:
            shutdown()
        conn.send(("ok", out))
    except Exception:
        conn.send(("err", traceback.format_exc()))
    finally:
        conn.close()


def spawn_local(worker, n_processes: int, *, args: tuple = (), device=None,
                local_devices: int = 1, timeout_s: float = 300.0) -> list:
    """Run ``worker(ctx, *args)`` in ``n_processes`` fresh local processes
    wired into one runtime, on ``device`` (the card when None); returns
    ``[worker result] * n`` in process order.

    ``worker`` must be a module-level (picklable) function: the spawn
    context starts clean interpreters. Children talk to a coordinator hosted
    by child 0 on a free localhost port. Raises RuntimeError carrying the
    child tracebacks on any failure, or when the children have not all
    answered within ``timeout_s``; no child outlives the call.
    """
    if n_processes < 1:
        raise ValueError(f"n_processes must be >= 1, got {n_processes}")
    coordinator = f"127.0.0.1:{free_port()}"
    mp = multiprocessing.get_context("spawn")
    procs, conns = [], []
    for i in range(n_processes):
        parent_conn, child_conn = mp.Pipe(duplex=False)
        p = mp.Process(target=_child_main,
                       args=(worker, i, n_processes, coordinator, local_devices, device,
                             child_conn, tuple(args)))
        p.start()
        child_conn.close()
        procs.append(p)
        conns.append(parent_conn)

    results, errors = [None] * n_processes, []
    deadline = time.monotonic() + timeout_s
    try:
        for i, conn in enumerate(conns):
            if not conn.poll(max(0.0, deadline - time.monotonic())):
                errors.append(f"[process {i}] no result within {timeout_s}s")
                continue
            try:
                status, payload = conn.recv()
            except EOFError:
                procs[i].join(timeout=10)
                errors.append(f"[process {i}] exited with code {procs[i].exitcode} "
                              "and no result")
                continue
            if status == "ok":
                results[i] = payload
            else:
                errors.append(f"[process {i}]\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for conn in conns:
            conn.close()
    if errors:
        raise RuntimeError(f"spawn_local: {len(errors)}/{n_processes} workers failed:\n"
                           + "\n".join(errors))
    return results
