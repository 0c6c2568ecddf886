"""Disjoint-union batching: B prepared trajectories -> one graph, the port's
``mgn_tpu/data/union.py``.

The B graphs' node and edge arrays are concatenated with index offsets, so a
batch runs through the processor kernels as one bigger graph.  Each subgraph
keeps its own padding: the union has B trash rows (graph ``i``'s dead edges
land on its node ``(i + 1) * N - 1``) and dead edges between the subgraphs'
live ones.  The kernels take that layout as it is: they mask dead edges by
``edge_mask`` and read rows from the CSR offsets, never from the array ends.

Not ported: the TPU banding plan (``build_fused_plan``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from mgn_tpu_torch.core.graph import GraphTemplate
from mgn_tpu_torch.data.prep import PreparedTrajectory

__all__ = ["union_prepared", "UnionInfo"]


class UnionInfo:
    """Bookkeeping for a union of B graphs of equal buckets."""

    def __init__(self, batch: int, nodes_per_graph: int, edges_per_graph: int):
        self.batch = batch
        self.nodes_per_graph = nodes_per_graph
        self.edges_per_graph = edges_per_graph

    def node_graph_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.batch), self.nodes_per_graph)


def union_prepared(preps: Sequence[PreparedTrajectory]
                   ) -> Tuple[GraphTemplate, Dict[str, torch.Tensor], torch.Tensor, UnionInfo]:
    """Concatenate B prepared trajectories (equal buckets, equal T) into one.

    Returns ``(template, fields, times, info)``:
    - ``template``: a :class:`GraphTemplate` over ``B * N_pad`` nodes and
      ``B * E_pad`` edges, node indices and CSR offsets shifted per graph;
      the sender-side CSR is graph ``i``'s shifted by ``i * E_pad`` (its
      senders all lie in ``[i * N_pad, (i + 1) * N_pad)``, so this is the
      union's stable sender sort);
    - ``fields``: ``{f: (T, B * N_pad, dim)}``;
    - ``times``: ``(T,)``, the first trajectory's (a batch shares one grid);
    - ``info``: :class:`UnionInfo`.
    """
    b = len(preps)
    t0 = preps[0].template
    n, e = t0.num_nodes, t0.num_edges
    tl = preps[0].times.shape[0]
    for p in preps:
        if p.template.num_nodes != n or p.template.num_edges != e:
            raise ValueError("union requires equal graph buckets")
        if p.times.shape[0] != tl:
            raise ValueError("union requires equal trajectory lengths")
    tms = [p.template for p in preps]

    def cat(name: str) -> torch.Tensor:
        return torch.cat([getattr(t, name) for t in tms], dim=0)

    def shifted(name: str, step: int) -> torch.Tensor:
        return torch.cat([getattr(t, name) + i * step for i, t in enumerate(tms)])

    def offsets(name: str) -> torch.Tensor:
        return torch.cat([getattr(t0, name)[:1]]
                         + [getattr(t, name)[1:] + i * e for i, t in enumerate(tms)])

    template = GraphTemplate(
        node_type_onehot=cat("node_type_onehot"),
        mesh_edge_features=cat("mesh_edge_features"),
        senders=shifted("senders", n),
        receivers=shifted("receivers", n),
        row_offsets=offsets("row_offsets"),
        node_mask=cat("node_mask"),
        edge_mask=cat("edge_mask"),
        node_type=cat("node_type"),
        sender_perm=shifted("sender_perm", e),
        sender_offsets=offsets("sender_offsets"),
    )
    fields = {f: torch.cat([p.fields[f] for p in preps], dim=1) for f in preps[0].fields}
    return template, fields, preps[0].times, UnionInfo(b, n, e)
