"""Paper §5 task library (port of repro/fl/tasks.py): each task is a pure
``(state, mean) -> state`` step.

A ``Task`` separates the three things a federated round needs:

    client_vectors(state, key) -> (n, dim)   what each client WOULD send
    step(state, mean)          -> state      how the server's model advances
    metric(state)              -> float      task-level error (lower = better)

so any task composes with any estimator, any cohort, and either decode mode
(spatial / temporal); the round driver (fl.rounds) owns everything between
"clients computed vectors" and "server obtained a mean".

Tasks
-----
- ``power_iteration``   distributed power iteration (paper Fig. 4 top)
- ``kmeans``            distributed k-means centroid averaging
- ``linear_regression`` distributed GD on least squares
- ``logistic_regression`` softmax regression on gaussian class blobs
- ``dme``               pure one-shot mean estimation, correlation rho dialed
                        in exactly (x_i = u + sigma * eps_i with
                        sigma^2 = 1/rho - 1 => E[R] ~= rho (n-1))
- ``drift``             slowly-rotating common component: the temporal
                        decoder's showcase (x_i(t) = u(t) + noise, u drifts
                        by ~omega per round)

The data are the JAX package's: host numpy from the same generators and
``fl.clients.partition``, cast to float32 on the host as JAX casts them,
then moved to the task's device once, so both packages start from the same
bits. ``client_vectors``, ``step`` and ``metric`` are plain PyTorch on that
device; ``metric`` returns a Python float (one host read a call).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from ..core import random as prand
from . import clients as clients_lib


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    n_clients: int
    dim: int
    init: Callable[[Any], dict]                 # key -> state
    client_vectors: Callable[[dict, Any], torch.Tensor]  # (state, key) -> (n, dim)
    step: Callable[[dict, torch.Tensor], dict]  # (state, mean) -> state
    metric: Callable[[dict], float] | None = None
    metric_name: str = "err"
    aux: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")


def _image_like_data(n_samples, d, seed=0, n_classes=10):
    """Low-rank + class-structured features (Fashion-MNIST-like moments)."""
    rng = np.random.default_rng(seed)
    rank = 16
    basis = rng.standard_normal((rank, d)) * (1.0 / np.sqrt(d))
    scale = np.geomspace(3.0, 0.3, rank)[:, None]
    z = rng.standard_normal((n_samples, rank))
    labels = rng.integers(0, n_classes, n_samples)
    cls_shift = rng.standard_normal((n_classes, d)) * 0.4 / np.sqrt(d)
    x = z @ (basis * scale) + cls_shift[labels]
    x = x + rng.standard_normal((n_samples, d)) * 0.05
    return x.astype(np.float32), labels


def _f32(a: np.ndarray, dev) -> torch.Tensor:
    """A host array as float32 on ``dev``, cast on the host (numpy rounds to
    nearest, as ``jnp.asarray(a, jnp.float32)`` does)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def power_iteration(
    n_clients=10, d=1024, samples=4000, scheme="iid", alpha=0.3, seed=0, device=None
) -> Task:
    dev = resolve_device(device)
    x, labels = _image_like_data(samples, d, seed=seed)
    shards = _f32(clients_lib.partition(x, labels, n_clients, scheme, alpha, seed), dev)
    v_top = np.linalg.eigh(x.T @ x / len(x))[1][:, -1]

    def init(key):
        return {"t": 0, "v": torch.ones(d, device=dev) / math.sqrt(d)}

    def client_vectors(state, key):
        local = torch.einsum("nmd,d->nm", shards, state["v"])
        vi = torch.einsum("nmd,nm->nd", shards, local)
        return vi / (torch.linalg.norm(vi, dim=1, keepdim=True) + 1e-9)

    def step(state, mean):
        v = mean / (torch.linalg.norm(mean) + 1e-9)
        return {"t": state["t"] + 1, "v": v}

    def metric(state):
        v = state["v"].cpu().numpy()
        return float(min(np.linalg.norm(v - v_top), np.linalg.norm(v + v_top)))

    return Task(
        name="power_iteration", n_clients=n_clients, dim=d, init=init,
        client_vectors=client_vectors, step=step, metric=metric,
        metric_name="eig_err", aux={"v_top": v_top, "shards": shards}, device=dev,
    )


def kmeans(
    n_clients=10, d=256, samples=4000, n_clusters=10, scheme="iid", alpha=0.3,
    seed=2, device=None,
) -> Task:
    dev = resolve_device(device)
    x, labels = _image_like_data(samples, d, seed=seed, n_classes=n_clusters)
    shards = _f32(clients_lib.partition(x, labels, n_clients, scheme, alpha, seed), dev)
    x_all = _f32(x, dev)
    init_cents = _f32(x[:: samples // n_clusters][:n_clusters], dev)

    def init(key):
        return {"t": 0, "cents": init_cents}

    def client_vectors(state, key):
        cents = state["cents"]
        d2 = ((shards[:, :, None, :] - cents[None, None]) ** 2).sum(-1)
        oh = torch.nn.functional.one_hot(torch.argmin(d2, -1), n_clusters).float()
        sums = torch.einsum("nmc,nmd->ncd", oh, shards)
        hits = oh.sum(1)[..., None]
        local = torch.where(hits > 0, sums / hits.clamp_min(1.0), cents[None])
        return local.reshape(n_clients, n_clusters * d)

    def step(state, mean):
        return {"t": state["t"] + 1, "cents": mean.reshape(n_clusters, d)}

    def metric(state):
        d2 = ((x_all[:, None, :] - state["cents"][None]) ** 2).sum(-1)
        return float(d2.min(-1).values.mean())

    return Task(
        name="kmeans", n_clients=n_clients, dim=n_clusters * d, init=init,
        client_vectors=client_vectors, step=step, metric=metric,
        metric_name="quant_loss", aux={"shards": shards}, device=dev,
    )


def linear_regression(
    n_clients=10, d=512, samples=4000, lr=0.05, scheme="iid", alpha=0.3, seed=3,
    device=None,
) -> Task:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_star = rng.standard_normal(d).astype(np.float32) / np.sqrt(d)
    x, labels = _image_like_data(samples, d, seed=seed + 1)
    y = x @ w_star + rng.standard_normal(samples).astype(np.float32) * 0.01
    order_key = y if scheme == "band" else labels  # band-sort by target value
    xs = _f32(clients_lib.partition(x, order_key, n_clients, scheme, alpha, seed), dev)
    ys = _f32(clients_lib.partition(y, order_key, n_clients, scheme, alpha, seed), dev)

    def init(key):
        return {"t": 0, "w": torch.zeros(d, device=dev)}

    def client_vectors(state, key):
        pred = torch.einsum("nmd,d->nm", xs, state["w"])
        return 2 * torch.einsum("nmd,nm->nd", xs, pred - ys) / xs.shape[1]

    def step(state, mean):
        return {"t": state["t"] + 1, "w": state["w"] - lr * mean}

    def metric(state):
        pred = torch.einsum("nmd,d->nm", xs, state["w"])
        return float(((pred - ys) ** 2).mean())

    return Task(
        name="linear_regression", n_clients=n_clients, dim=d, init=init,
        client_vectors=client_vectors, step=step, metric=metric,
        metric_name="mse_loss", aux={"w_star": w_star}, device=dev,
    )


def logistic_regression(
    n_clients=10, feat=64, n_classes=10, samples=4000, lr=0.5,
    scheme="dirichlet", alpha=0.3, seed=5, device=None,
) -> Task:
    """Softmax regression on gaussian class blobs; Dirichlet non-IID default."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_classes, feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, samples)
    x = centers[labels] + 0.8 * rng.standard_normal((samples, feat)).astype(np.float32)
    xs = _f32(clients_lib.partition(x, labels, n_clients, scheme, alpha, seed), dev)
    ys = torch.from_numpy(
        clients_lib.partition(labels, labels, n_clients, scheme, alpha, seed)).to(dev)
    x_all, y_all = _f32(x, dev), torch.from_numpy(labels).to(dev)
    dim = n_classes * feat

    def init(key):
        return {"t": 0, "w": torch.zeros(dim, device=dev)}

    def client_vectors(state, key):
        # every client's softmax-regression gradient, batched over clients
        logits = xs @ state["w"].reshape(n_classes, feat).T  # (n, m, classes)
        p = torch.softmax(logits, dim=-1)
        oh = torch.nn.functional.one_hot(ys, n_classes).float()
        return ((p - oh).mT @ xs / xs.shape[1]).reshape(n_clients, dim)

    def step(state, mean):
        return {"t": state["t"] + 1, "w": state["w"] - lr * mean}

    def _eval(w_flat):
        logits = x_all @ w_flat.reshape(n_classes, feat).T
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, y_all[:, None]).mean()
        acc = (torch.argmax(logits, -1) == y_all).float().mean()
        return nll, acc

    def metric(state):
        return float(_eval(state["w"])[0])

    def accuracy(state):
        return float(_eval(state["w"])[1])

    return Task(
        name="logistic_regression", n_clients=n_clients, dim=dim, init=init,
        client_vectors=client_vectors, step=step, metric=metric,
        metric_name="xent", aux={"accuracy": accuracy}, device=dev,
    )


def dme(n_clients=8, d=256, rho=0.9, seed=0, device=None) -> Task:
    """Static correlated mean estimation: E[R] ~= rho * (n - 1).

    x_i = u + sigma eps_i with ||u|| = 1, eps_i ~ N(0, I/d), and
    sigma = sqrt(1/rho - 1):  R = n<u,u>/(<u,u> + sigma^2) ... = rho (n-1).
    client_vectors is constant across rounds, so averaging the per-round MSE
    over many rounds Monte-Carlo-averages over the estimator's randomness:
    the harness' Fig. 3/4-style MSE-at-equal-bytes probe.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    sigma = np.sqrt(1.0 / rho - 1.0) if rho > 0 else 10.0
    eps = rng.standard_normal((n_clients, d)) / np.sqrt(d)
    xs = _f32(u[None] + sigma * eps, dev)

    def init(key):
        return {"t": 0, "mean": torch.zeros(d, device=dev)}

    def client_vectors(state, key):
        return xs

    def step(state, mean):
        return {"t": state["t"] + 1, "mean": mean}

    return Task(
        name="dme", n_clients=n_clients, dim=d, init=init,
        client_vectors=client_vectors, step=step, metric=None,
        metric_name="mse", aux={"xs": xs, "rho": rho}, device=dev,
    )


def drift(n_clients=8, d=256, rho=0.95, omega=0.03, client_bias=0.0,
          seed=0, device=None) -> Task:
    """Slowly-drifting common component: u(t) rotates by ~omega rad/round.

    Per-round ||u(t) - u(t-1)|| ~= omega << 1 = ||u(t)||, so a temporal
    decoder that encodes deltas against the server's previous estimate spends
    its k on a vector ~1/omega times smaller: the Rand-k-Temporal argument.
    Fresh per-round client noise keeps the task honest (the delta is never 0).
    The noise is ``core.random.normal(key, (n, d)) / sqrt(d)`` of the round
    key, the JAX package's ``jax.random.normal`` draw (within core.random's
    few float32 ulp).

    ``client_bias`` > 0 adds a PERSISTENT per-client offset b_i (unit vector
    scaled by client_bias): x_i(t) = u(t) + b_i + sigma eps_i(t). Broadcast
    temporal decoding cannot capture b_i (the server's estimate carries only
    mean(b)); per-client temporal memories can: this is the workload where
    true Rand-k-Temporal separates from the broadcast variant.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal(d)
    u0 /= np.linalg.norm(u0)
    u1 = rng.standard_normal(d)
    u1 -= u0 * (u0 @ u1)
    u1 /= np.linalg.norm(u1)
    u0_t, u1_t = _f32(u0, dev), _f32(u1, dev)
    sigma = float(np.sqrt(1.0 / rho - 1.0)) if rho > 0 else 10.0
    b = rng.standard_normal((n_clients, d))
    b = client_bias * b / np.linalg.norm(b, axis=1, keepdims=True)
    b_t = _f32(b, dev)

    def init(key):
        return {"t": 0, "mean": torch.zeros(d, device=dev)}

    def client_vectors(state, key):
        angle = torch.tensor(omega * state["t"], dtype=torch.float32, device=dev)
        u_t = torch.cos(angle) * u0_t + torch.sin(angle) * u1_t
        eps = prand.normal(prand.as_key(key, dev), (n_clients, d)) / math.sqrt(d)
        return u_t[None] + b_t + sigma * eps

    def step(state, mean):
        return {"t": state["t"] + 1, "mean": mean}

    return Task(
        name="drift", n_clients=n_clients, dim=d, init=init,
        client_vectors=client_vectors, step=step, metric=None,
        metric_name="mse", aux={"rho": rho, "omega": omega,
                                "client_bias": client_bias}, device=dev,
    )


TASKS: dict[str, Callable[..., Task]] = {
    "power_iteration": power_iteration,
    "kmeans": kmeans,
    "linear_regression": linear_regression,
    "logistic_regression": logistic_regression,
    "dme": dme,
    "drift": drift,
}


def get_task(name: str, device=None, **kw) -> Task:
    """The named task on ``device`` (the card when None)."""
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; have {sorted(TASKS)}")
    return TASKS[name](device=device, **kw)
