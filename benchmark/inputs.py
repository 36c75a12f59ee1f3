"""The inputs both sides get: the GP's collocation points, made from
``--seed``, and the configuration's problem constants."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import sample, sub_seed

# GradDependentNonlinear's domain: [-0.5, 0.5]^d x [0, 0.5]
RADIUS, T0, T = 0.5, 0.0, 0.5


def collocation(config: dict, seed: int, device):
    """(x_dom (N, d + 1), x_bdy (Nb, d + 1)) float32 on ``device``, drawn as
    a test set is (``traffic.sample``) from a stream of their own."""
    N, Nb = int(config["num_domain"]), int(config["num_boundary"])
    rng = np.random.default_rng(sub_seed(seed, "collocation"))
    pts = torch.as_tensor(sample(rng, N, Nb, int(config["dim"]), RADIUS, T0, T), device=device)
    return pts[:N].contiguous(), pts[N:].contiguous()
