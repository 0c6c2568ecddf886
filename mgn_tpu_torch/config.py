"""Framework configuration: the port's copy of ``mgn_tpu/config.py``.

``Args`` keeps every field of the JAX package's ``Args`` so that configs carry
over.  The TPU-only knobs (``spatial_reorder``, ``fused``, ``fused_backward``,
``unroll``, ``aggregation_backend``, ``halo_rounds``, ``telescope_stages``)
are accepted and have no effect on the GPU, where the processor always runs
through the hand-written kernels of :mod:`mgn_tpu_torch.ops.fused`.  Two
settings need modules that are not ported yet and raise in
:meth:`Args.resolve_auto`: ``spatial_reorder=True`` (node permutation through
``parallel/partition``) and ``graph_parallel > 1``; ROADMAP.md lists both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from mgn_tpu_torch.train.strategies import DerivativeTraining, TrainingStrategy

__all__ = ["Args"]


@dataclasses.dataclass
class Args:
    # --- model ---
    mps: int = 15
    layer_size: int = 128
    hidden_layers: int = 2

    # --- training schedule ---
    batchsize: int = 1
    epochs: int = 1
    steps: int = 10_000_000
    checkpoint: int = 10_000
    norm_steps: int = 1000  # steps of normalizer warmup before optimizer updates
    max_norm_steps: float = 10e6  # online-normalizer accumulation cap

    # --- node-type semantics ---
    types_updated: Tuple[int, ...] = (0, 5)
    types_noisy: Tuple[int, ...] = (0,)
    types_inflow: Tuple[int, ...] = (1,)

    # --- strategy / evaluation ---
    training_strategy: TrainingStrategy = dataclasses.field(
        default_factory=DerivativeTraining
    )
    num_rollouts: int = 10
    use_valid: bool = True
    solver_valid: str = "tsit5_adaptive"
    solver_valid_dt: Optional[float] = None
    reset_valid: bool = False
    rtol: float = 1e-4
    atol: float = 1e-6
    cell_idxs: Tuple[int, ...] = (0,)

    # --- reproducibility ---
    seed: int = 1234

    # --- precision and TPU-only knobs (accepted; no effect on the GPU) ---
    compute_dtype: str = "float32"  # or 'bfloat16'
    aggregation_backend: Optional[str] = None
    unroll: bool = False
    spatial_reorder: Optional[bool] = None
    fused: Optional[bool] = None
    fused_backward: Optional[bool] = None
    node_bucket_multiple: int = 128
    edge_bucket_multiple: int = 512
    data_axis: str = "data"
    graph_axis: str = "graph"
    graph_parallel: int = 1
    halo_rounds: Optional[int] = None
    telescope_stages: Optional[int] = None
    world_capacity: Optional[int] = None
    prefetch: int = 2
    cache_bytes: int = 4 << 30

    # --- logging ---
    wandb_logger: Any = None
    log_every: int = 100

    def model_dims(self) -> dict:
        return dict(latent_size=self.layer_size, hidden_layers=self.hidden_layers,
                    message_passing_steps=self.mps)

    def resolve_auto(self) -> "Args":
        """Resolve the ``None`` (= auto) knobs without asking any backend.

        The TPU-only knobs stay as given (they are no-ops here);
        ``spatial_reorder`` resolves to False.  Raises
        ``NotImplementedError`` for settings whose modules are not ported yet.
        """
        if self.spatial_reorder:
            raise NotImplementedError(
                "spatial_reorder=True permutes nodes through parallel/partition, "
                "which mgn_tpu_torch does not port yet (ROADMAP.md, queue A); "
                "the GPU kernels need no spatial node order")
        if self.graph_parallel > 1:
            raise NotImplementedError(
                "graph_parallel > 1 needs the parallel/ modules, which "
                "mgn_tpu_torch does not port yet (ROADMAP.md, A7)")
        return dataclasses.replace(
            self,
            spatial_reorder=False,
            halo_rounds=(self.mps if self.halo_rounds is None
                         else self.halo_rounds),
        )
