"""Trained-GP state, its npz checkpoint, and the weight carry from the JAX
package.

Port of ``scasml_gp_tpu/gp/state.py``.  ``save_state`` writes and
``load_state`` reads the same npz layout as the JAX package (one array per
field), so the port evaluates a surrogate trained there; ``state_from_numpy``
does the same from a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from scasml_gp_torch.utils.device import resolve_device

FIELDS = ("x_dom", "x_bdy", "right_vector", "sol", "gamma", "loss_history")


@dataclasses.dataclass(eq=False)
class GPState:
    """Everything needed to evaluate the trained GP posterior."""

    x_dom: torch.Tensor         # (N, d+1) training interior points
    x_bdy: torch.Tensor         # (Nb, d+1) training boundary points
    right_vector: torch.Tensor  # (4N+Nb,) representer weights
    sol: torch.Tensor           # (3N,) final (z1, z3, z5) unknowns
    gamma: torch.Tensor         # (3,) or () kernel precisions (gs, gt, gr)
    loss_history: torch.Tensor  # (steps+1,) Newton loss trace
    _fused: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_domain(self) -> int:
        return self.x_dom.shape[0]

    @property
    def n_boundary(self) -> int:
        return self.x_bdy.shape[0]

    @property
    def dim(self) -> int:
        return self.x_dom.shape[1] - 1

    def fused_inputs(self, operand_dtype=torch.float32, mesh=None):
        """The fused kernel's stacked inputs for ``operand_dtype`` (float32 or
        the bf16 variant's), or with a mesh of more than one 'model' rank
        this rank's slice of them; built on first use and cached (the
        state's tensors are never modified in place)."""
        from scasml_gp_torch.gp import fused_posterior as fp

        od = fp.operand_dtype_of(operand_dtype)
        shard = None
        if mesh is not None and mesh.model > 1:
            from scasml_gp_torch.parallel.mesh import train_point_sharding

            shard = train_point_sharding(mesh, self.n_domain + self.n_boundary)
        key = (od, shard)
        if key not in self._fused:
            if shard is None:
                self._fused[key] = fp.prepare_inputs(
                    self.x_dom, self.x_bdy, self.right_vector, self.gamma,
                    self.dim, od)
            else:
                self._fused[key] = fp.shard_inputs(self.fused_inputs(od), *shard)
        return self._fused[key]


def state_from_numpy(arrays: dict, device) -> GPState:
    """GPState on ``device`` from numpy arrays keyed by field name (the JAX
    package's parameters, e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``)."""
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    return GPState(**{
        k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
        for k in FIELDS
    })


def save_state(path: str, state: GPState) -> None:
    np.savez(path, **{k: getattr(state, k).detach().cpu().numpy() for k in FIELDS})


def load_state(path: str, device=None) -> GPState:
    """The state saved at ``path``, on ``device`` (by default the card)."""
    with np.load(path) as data:
        return state_from_numpy({k: data[k] for k in FIELDS}, resolve_device(device))
