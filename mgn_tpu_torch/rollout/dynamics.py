"""The learned ODE right-hand side du/dt = MGN(u, mesh): the port's
``mgn_tpu/rollout/dynamics.py``.

Unpack the state slab into target fields, merge with the frozen non-target
inputs, assemble the normalized graph, run the network, de-normalize each
output block, zero non-updated node types, and (forced variant) overwrite
inflow nodes with ground truth at the enclosing frame.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from mgn_tpu_torch.core.graph import GraphTemplate
from mgn_tpu_torch.models.mgn import MGNConfig, apply_mgn
from mgn_tpu_torch.train.common import FieldSpec, NormState, assemble_graph, unpack_fields

__all__ = ["make_deriv_fn"]


def make_deriv_fn(
    params: Any,
    model_cfg: MGNConfig,
    norm: NormState,
    template: GraphTemplate,
    spec: FieldSpec,
    non_target_inputs: Dict[str, torch.Tensor],
    val_mask: torch.Tensor,  # (N_pad,) float — nodes whose du is applied
    inflow_mask: Optional[torch.Tensor] = None,  # (N_pad,) bool
    forcing_data: Optional[torch.Tensor] = None,  # (T, N_pad, F_out) ground truth
    forcing_times: Optional[torch.Tensor] = None,  # (T,) timestamps of forcing_data
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build ``deriv(y, t) -> du`` over the packed state slab (N_pad, F_out).

    - non-target dynamic fields stay frozen at their initial values;
    - inflow forcing: nodes in ``inflow_mask`` are overwritten with ground
      truth at the frame whose timestamp is the largest
      ``forcing_times[k] <= t``;
    - output: per-field de-normalized network output, masked by ``val_mask``.
    """
    eps = None
    if forcing_times is not None:
        # t exactly on a frame time selects that frame despite float roundoff
        eps = (1e-4 * torch.diff(forcing_times).min() if forcing_times.shape[0] > 1
               else torch.zeros((), dtype=torch.float32, device=forcing_times.device))

    def frame_of(t: torch.Tensor) -> torch.Tensor:
        k = torch.searchsorted(forcing_times, (t + eps).reshape(1), right=True)[0] - 1
        return torch.clamp(k, 0, forcing_times.shape[0] - 1)

    def deriv(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if forcing_data is not None:
            gt = forcing_data[frame_of(t)]
            y = torch.where(inflow_mask[:, None], gt, y)
        values = dict(non_target_inputs)
        values.update(unpack_fields(y, spec))
        graph = assemble_graph(norm, template, values, spec)
        out = apply_mgn(params, graph, model_cfg, template.row_offsets)
        parts = []
        for ti, (f, sl) in enumerate(zip(spec.target_fields, spec.target_slices())):
            pred = norm.output[f].inverse(out[:, sl])
            if spec.mode(ti) == "absolute":
                # relax toward the predicted value over one save interval:
                # Euler with dt=save_dt lands exactly on the prediction
                if forcing_times is None or forcing_times.shape[0] < 2:
                    raise ValueError("absolute output fields need a save-time grid "
                                     "of at least two frames (forcing_times)")
                k = torch.clamp(frame_of(t), max=forcing_times.shape[0] - 2)
                local_dt = forcing_times[k + 1] - forcing_times[k]
                parts.append((pred - y[..., sl]) / local_dt)
            else:
                parts.append(pred)
        du = torch.cat(parts, dim=-1)
        return du * val_mask[:, None]

    return deriv
