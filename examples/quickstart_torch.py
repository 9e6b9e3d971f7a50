"""Quickstart on the PyTorch port: the paper's technique in one function.

Counterpart of `examples/quickstart.py`.  Five clients with
heterogeneous linear-regression data; run the similarity pre-round,
build the Eq. 6 mixing matrix, reduce to 2 personalised streams, and
compare FedAvg with user-centric aggregation on one round of local
models.  Runs on the card unless ``--device cpu`` is given; the mix goes
through the Y = W Θ kernel and Δ through the Gram kernel there.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (fedavg_weights, kmeans, mixing_matrix,
                              silhouette_score, similarity_round,
                              stream_aggregate, user_centric_aggregate)
from repro_torch.device import resolve_device

D, N_I, K = 16, 200, 2
GROUPS = (0, 0, 0, 1, 1)


def make_datasets(device="cuda") -> list:
    """Five clients, two latent groups (w* = +w or -w), y = x w* + 0.1 ε,
    drawn from one `torch.Generator` seeded 0 on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    w_true = torch.randn(D, generator=gen, device=dev)
    out = []
    for g in GROUPS:
        x = torch.randn(N_I, D, generator=gen, device=dev)
        sign = 1.0 if g == 0 else -1.0
        y = x @ (sign * w_true) + 0.1 * torch.randn(N_I, generator=gen,
                                                    device=dev)
        out.append({"x": x, "y": y})
    return out


def loss_fn(params, data):
    pred = data["x"] @ params["w"]
    return torch.mean((pred - data["y"]) ** 2)


def local_model(data) -> torch.Tensor:
    x, y = data["x"], data["y"]
    xtx = x.T @ x + 1e-3 * torch.eye(x.shape[1], device=x.device)
    return torch.linalg.solve(xtx, x.T @ y)


def quickstart(datasets: Optional[Sequence[dict]] = None, *,
               first: Optional[int] = None, device="cuda") -> dict:
    """The quickstart's numbers.  ``datasets`` is a list of ``{"x": (n_i,
    d), "y": (n_i,)}`` (numpy or torch; default `make_datasets`),
    ``first`` the first k-means centre (default drawn from a generator
    seeded 0).  Returns W (m, m), the stream assignment, the silhouette
    at `K` and each client's MSE under FedAvg and under the `K` streams,
    as numpy and floats."""
    dev = resolve_device(device)
    if datasets is None:
        datasets = make_datasets(dev)
    datasets = [{n: torch.as_tensor(v, device=dev) for n, v in ds.items()}
                for ds in datasets]
    m, d = len(datasets), datasets[0]["x"].shape[1]
    if first is None:
        gen = torch.Generator().manual_seed(0)
        first = int(torch.randint(0, m, (), generator=gen))

    # paper §III-A: similarity pre-round
    probe = {"w": torch.zeros(d, device=dev)}
    delta, sigma2, n = similarity_round(loss_fn, probe, datasets)
    w = mixing_matrix(delta, sigma2, n)

    # paper §III-B: stream reduction
    plan = kmeans(w, K, first=first)
    sil = silhouette_score(w, plan.assignment, K)

    # one round: local models, then aggregation
    locals_ = {"w": torch.stack([local_model(ds) for ds in datasets])}
    fedavg = user_centric_aggregate(locals_, fedavg_weights(n))
    ucfl = stream_aggregate(locals_, plan)

    def client_mse(stacked):
        return [float(loss_fn({"w": stacked["w"][i]}, datasets[i]))
                for i in range(m)]

    return {"W": w.cpu().numpy(),
            "assignment": plan.assignment.cpu().numpy(),
            "groups": np.asarray(GROUPS[:m]),
            "silhouette": float(sil),
            "mse_fedavg": client_mse(fedavg),
            "mse_ucfl": client_mse(ucfl)}


def print_report(r: dict) -> None:
    """The reference script's lines."""
    print("mixing matrix W (row-stochastic):")
    print(np.round(r["W"], 3))
    print("\nstream assignment:", r["assignment"],
          " true groups:", r["groups"])
    print(f"silhouette(k={K}):", r["silhouette"])
    print("\nper-client MSE:")
    print("  fedavg:", np.round(r["mse_fedavg"], 3))
    print(f"  ucfl-{K}:", np.round(r["mse_ucfl"], 3))
    print("\nFedAvg averages the two conflicting groups away; the user-centric"
          "\nstreams recover per-group models from the gradient similarity.")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = quickstart(device=args.device)
    print_report(r)
    return r


if __name__ == "__main__":
    main()
