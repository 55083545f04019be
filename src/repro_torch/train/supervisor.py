"""Fault-tolerant training supervisor (port of repro/train/supervisor.py).

Production behaviours, exercised on one host via deterministic fault
injection (tests/test_torch_train.py):

- restart-on-failure: any step exception -> restore latest checkpoint and
  continue (data pipeline is a pure function of step, so no data loss).
- elastic client count: the DME estimator depends on n only through
  beta(n, k, d, T); on pod loss/join the supervisor rebuilds the train step
  with the new n and keeps going from the same checkpoint (params are
  client-count independent). Unbiasedness is preserved per round.
- straggler mitigation: a round may drop clients (bounded staleness); the
  decode re-normalises with beta(n_eff) — the estimator stays unbiased over
  the surviving set. Modeled by re-building the step for n_eff.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from . import checkpoint as ckpt_lib


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault injection for tests/demos."""
    fail_at_steps: tuple[int, ...] = ()        # raise before these steps once
    resize_at: dict | None = None              # {step: new_n_clients}

    def __post_init__(self):
        self._fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")

    def resize(self, step: int):
        if self.resize_at:
            return self.resize_at.get(step)
        return None


@dataclasses.dataclass
class Supervisor:
    make_step: Callable[[int], Callable]   # n_clients -> step fn
    make_data: Callable[[int], Callable]   # n_clients -> (step -> batch)
    init_state: Callable[[], tuple]        # () -> (params, state)
    ckpt_dir: str
    n_clients: int
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 10

    def run(self, total_steps: int, fault_plan: FaultPlan | None = None,
            log_every: int = 10, log_fn=print):
        fault_plan = fault_plan or FaultPlan()
        ckptr = ckpt_lib.AsyncCheckpointer(self.ckpt_dir, keep=self.keep)
        params, state = self.init_state()
        start = 0
        if ckpt_lib.latest_step(self.ckpt_dir) is not None:
            (params, state), start = ckpt_lib.restore(self.ckpt_dir, (params, state))
            start += 1
            log_fn(f"[supervisor] resumed from step {start - 1}")
        step_fn = self.make_step(self.n_clients)
        data_fn = self.make_data(self.n_clients)
        restarts = 0
        history = []
        step = start
        while step < total_steps:
            try:
                new_n = fault_plan.resize(step)
                if new_n is not None and new_n != self.n_clients:
                    log_fn(f"[supervisor] elastic resize {self.n_clients} -> {new_n} at step {step}")
                    self.n_clients = new_n
                    step_fn = self.make_step(new_n)
                    data_fn = self.make_data(new_n)
                fault_plan.maybe_fail(step)
                batch = data_fn(step)
                t0 = time.time()
                params, state, metrics = step_fn(params, state, batch, step)
                if step % log_every == 0:
                    loss = float(metrics["loss"])
                    history.append((step, loss))
                    log_fn(f"[step {step}] loss={loss:.4f} ({time.time()-t0:.2f}s)")
                if self.ckpt_every and step % self.ckpt_every == 0 and step > start:
                    ckptr.save_async(step, (params, state))
                step += 1
            except Exception as e:  # noqa: BLE001 — restart-on-any-failure
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                log_fn(f"[supervisor] step {step} failed ({e}); restoring...")
                ckptr.wait()
                last = ckpt_lib.latest_step(self.ckpt_dir)
                if last is not None:
                    (params, state), last = ckpt_lib.restore(self.ckpt_dir, (params, state))
                    step = last + 1
                else:
                    params, state = self.init_state()
                    step = 0
                step_fn = self.make_step(self.n_clients)
                data_fn = self.make_data(self.n_clients)
        ckptr.wait()
        ckpt_lib.save(self.ckpt_dir, total_steps - 1, (params, state), keep=self.keep)
        return params, state, history
