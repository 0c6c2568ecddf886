"""HDF5/JLD2 trajectory reader: the port's copy of ``mgn_tpu/data/hdf5.py``.

One group per trajectory; features located by the meta ``key`` pattern, with
support for

- plain keys: one dataset per feature,
- ``%d``-indexed keys: one dataset per mesh point (grid meshes), placed at the
  grid linear index,
- ``split`` keys: one dataset per coordinate, named ``key[c]``,
- ``has_ev``: companion ``<key>.ev`` extra-value datasets,
- per-trajectory ``dt`` timestamp vectors (``meta['dt']`` names the dataset),
- ``custom_edges`` explicit edge lists with node-type/index exclusion,
- structured-grid edge synthesis when no edges are given (1-D, 2-D and 3-D
  grids, :func:`mgn_tpu_torch.core.graph.grid_edges`).

Layout convention is row-major: dynamic datasets ``(T, N, dim)`` (or ``(T, N)``
for dim=1, or per-point ``(T, dim)``), static ``(N, dim)``/``(N,)``.  JLD2
files are HDF5 files, and Julia's column-major arrays read dimension-reversed
through h5py, which lands on the same row-major shapes.

``h5py`` is imported inside the functions that read or write a file, never
when this module is imported: where it is not installed, only those calls
raise (:func:`import_h5py`), and TFRecord datasets need none of it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from mgn_tpu_torch.core.graph import grid_edges
from mgn_tpu_torch.data.meta import feature_dtype

__all__ = ["read_trajectory", "read_structure", "trajectory_keys", "grid_num_nodes",
           "import_h5py"]

#: what a reader's ImportError suggests where h5py is missing
TFRECORD_ROUTE = ("convert the dataset to TFRecord (python -m mgn_tpu_torch.data.convert "
                  "to-tfrecord, where h5py is installed) and use the .tfrecord split, "
                  "which the port reads without h5py")


def import_h5py(what: str, route: str = ""):
    """The ``h5py`` module, imported at the call.  Where it is not installed,
    an ``ImportError`` that names ``what`` needed it (and ``route``, the way
    around it, where given)."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(f"{what} needs h5py, which is not installed"
                          + (f"; {route}" if route else "")) from err
    return h5py


def _open(path: str):
    return import_h5py(f"reading {path}", TFRECORD_ROUTE).File(path, "r")

#: top-level groups that are file metadata, not trajectories (JLD2 writes a
#: ``_types`` group for committed Julia datatypes; JLD.jl used ``_refs``)
_RESERVED_GROUPS = ("_types", "_refs", "_require", "_creator")


def trajectory_keys(path: str) -> List[str]:
    """Sorted trajectory group names in an HDF5/JLD2 file (numeric-aware
    order).  JLD2-internal metadata groups are skipped — JLD2 files are valid
    HDF5 bytes (the format is implemented on the HDF5 file format), so plain
    numeric-array trajectory groups read identically through h5py; only
    Julia-custom-typed payloads (which the documented dataset layout never
    uses) are out of scope."""
    with _open(path) as f:
        keys = [k for k in f.keys() if k not in _RESERVED_GROUPS]

    def sort_key(k):
        m = re.search(r"\d+", k)
        return (int(m.group()) if m else 0, k)

    return sorted(keys, key=sort_key)


def grid_num_nodes(meta: Dict[str, Any]) -> Optional[int]:
    dims = meta["dims"]
    if isinstance(dims, (list, tuple)):
        return int(np.prod(dims))
    return None


def _key_regex(key: str, split: bool) -> re.Pattern:
    pat = re.escape(key).replace(re.escape("%d"), r"\d+")
    if split:
        pat = pat + re.escape("[") + r"\d+" + re.escape("]")
    return re.compile(pat + r"$")


def _grid_linear_index(dims: Sequence[int], idx: Sequence[int]) -> int:
    """Column-major (Fortran) linear index over grid dims, 0-based.

    Julia's ``LinearIndices`` convention, so ``%d``-keyed grid datasets land
    on the node order a Julia-written dataset has.
    """
    li = 0
    stride = 1
    for d, i in zip(dims, idx):
        li += i * stride
        stride *= d
    return li


def _place(dest: np.ndarray, data: np.ndarray, node_idx, coord, tl: int) -> None:
    """Write one matched dataset into dest (T, N, dim) — explicit layout rules.

    The accepted shape is fully determined by the meta.json feature entry (no
    size-coincidence guessing): ``tl`` (= trajectory_length for dynamic
    features, 1 for static), whether the key addresses a single mesh point
    (``node_idx``, ``%d`` keys) and whether it addresses a single coordinate
    (``coord``, ``split`` keys):

    ============== ======= ================ ==================
    node_idx       coord   dynamic shape    static shape
    ============== ======= ================ ==================
    None           None    (T,N,dim)|(T,N)¹ (N,dim) | (N,)¹
    None           c       (T,N)            (N,)
    point p        None    (T,dim)|(T,)¹    (dim,) | scalar¹
    point p        c       (T,)             scalar | (1,)
    ============== ======= ================ ==================

    ¹ short form only when dim == 1.  Julia-written files (HDF5.jl / JLD2)
    store column-major, which h5py reads dimension-reversed — landing exactly
    on these row-major shapes, so one rule set covers both producers.
    Anything else raises with the expected/actual shapes.
    """
    data = np.asarray(data)
    dyn = tl > 1
    n, dim = dest.shape[1], dest.shape[2]

    def fail(expected: str):
        raise ValueError(
            f"dataset shape {data.shape} does not match the meta.json layout "
            f"(expected {expected}; trajectory_length={tl}, nodes={n}, "
            f"dim={dim}, node_idx={node_idx}, coord={coord})")

    if node_idx is None and coord is None:
        if dyn:
            if data.ndim == 3 and data.shape[:1] == (tl,) and data.shape[1] == n \
                    and data.shape[2] == dim:
                dest[:] = data
            elif data.ndim == 2 and dim == 1 and data.shape == (tl, n):
                dest[:, :, 0] = data
            else:
                fail(f"({tl}, {n}, {dim})" + (f" or ({tl}, {n})" if dim == 1 else ""))
        else:
            if data.ndim == 2 and data.shape == (n, dim):
                dest[0] = data
            elif data.ndim == 1 and dim == 1 and data.shape == (n,):
                dest[0, :, 0] = data
            else:
                fail(f"({n}, {dim})" + (f" or ({n},)" if dim == 1 else ""))
    elif node_idx is None:
        if dyn:
            if data.ndim == 2 and data.shape == (tl, n):
                dest[:, :, coord] = data
            else:
                fail(f"({tl}, {n})")
        else:
            if data.ndim == 1 and data.shape == (n,):
                dest[0, :, coord] = data
            else:
                fail(f"({n},)")
    elif coord is None:
        if dyn:
            if data.ndim == 2 and data.shape == (tl, dim):
                dest[:, node_idx, :] = data
            elif data.ndim == 1 and dim == 1 and data.shape == (tl,):
                dest[:, node_idx, 0] = data
            else:
                fail(f"({tl}, {dim})" + (f" or ({tl},)" if dim == 1 else ""))
        else:
            if data.ndim == 1 and data.shape == (dim,):
                dest[0, node_idx, :] = data
            elif data.ndim == 0 and dim == 1:
                dest[0, node_idx, 0] = data
            else:
                fail(f"({dim},)" + (" or scalar" if dim == 1 else ""))
    else:
        if dyn:
            if data.ndim == 1 and data.shape == (tl,):
                dest[:, node_idx, coord] = data
            else:
                fail(f"({tl},)")
        else:
            if data.ndim == 0 or data.shape in ((1,), ()):
                dest[0, node_idx, coord] = np.asarray(data).reshape(())
            else:
                fail("scalar or (1,)")


def read_structure(path: str, traj_key: str, meta: Dict[str, Any]):
    """Shape-only probe: ``(num_nodes, cells, edges)`` without reading any
    field data — used to size shared buckets over EVERY trajectory cheaply
    (heterogeneous datasets like airfoil vary mesh size per trajectory).
    ``edges`` is the UNfiltered custom-edges list (an upper bound on the
    filtered count, which is all bucketing needs).  Returns ``None`` when the
    layout defeats the cheap probe (regex-only keys) — callers fall back to a
    full read."""
    dims = meta["dims"]
    grid = isinstance(dims, (list, tuple))
    with _open(path) as f:
        traj = f[traj_key]
        n_nodes = grid_num_nodes(meta)
        if n_nodes is None:
            order = ["mesh_pos"] + [fn for fn in meta["feature_names"]
                                    if fn not in ("mesh_pos", "cells")]
            for fn in order:
                if fn not in meta["features"]:
                    continue
                key = meta["features"][fn].get("key", fn)
                if key in traj:
                    shp = traj[key].shape
                    if meta["features"][fn].get("type", "static") == "static":
                        n_nodes = shp[0] if len(shp) <= 2 else shp[1]
                    else:
                        n_nodes = shp[1] if len(shp) >= 2 else 1
                    break
            if n_nodes is None:
                return None
        cells = None
        edges = None
        if "cells" in meta.get("feature_names", ()):
            key = meta["features"].get("cells", {}).get("key", "cells")
            if key in traj:
                c = np.asarray(traj[key])
                cells = c.reshape(-1, c.shape[-1]).astype(np.int32)
        if "custom_edges" in meta:
            ek = meta["custom_edges"]
            if ek not in traj:
                return None
            edges = np.asarray(traj[ek]).reshape(-1, 2).astype(np.int32)
        elif cells is None and grid:
            s, r = grid_edges(dims, node_type=None, no_edges_node_types=())
            edges = np.stack([s, r], axis=1)
        if cells is None and edges is None:
            return None
    return int(n_nodes), cells, edges


def read_trajectory(
    path: str, traj_key: str, meta: Dict[str, Any]
) -> Dict[str, np.ndarray]:
    """Read one trajectory group into ``{feature: (T, N, dim)}`` (+ ``times``,
    optional ``edges``/``cells``/``<f>.ev``)."""
    tl = int(meta["trajectory_length"])
    dims = meta["dims"]
    grid = isinstance(dims, (list, tuple))
    out: Dict[str, np.ndarray] = {}

    with _open(path) as f:
        traj = f[traj_key]
        traj_keys_all = list(traj.keys())

        n_nodes = grid_num_nodes(meta)
        if n_nodes is None:
            # infer from mesh_pos / first plain node feature (cells counts
            # elements, not nodes — skip it)
            order = ["mesh_pos"] + [f for f in meta["feature_names"]
                                    if f not in ("mesh_pos", "cells")]
            for fn in order:
                if fn not in meta["features"]:
                    continue
                key = meta["features"][fn].get("key", fn)
                if key in traj:
                    shp = traj[key].shape
                    if meta["features"][fn].get("type", "static") == "static":
                        n_nodes = shp[0] if len(shp) <= 2 else shp[1]
                    else:
                        n_nodes = shp[1] if len(shp) >= 2 else 1
                    break
            if n_nodes is None:
                raise ValueError(f"cannot infer node count for {traj_key}")

        for fn in meta["feature_names"]:
            fmeta = meta["features"][fn]
            if fn == "cells":
                key = fmeta.get("key", fn)
                cells = np.asarray(traj[key])
                out["cells"] = cells.reshape(-1, cells.shape[-1]).astype(np.int32)
                continue
            dim = int(fmeta.get("dim", 1))
            ftl = tl if fmeta.get("type", "static") == "dynamic" else 1
            dest = np.zeros((ftl, n_nodes, dim), feature_dtype(meta, fn))
            has_ev = bool(fmeta.get("has_ev", False))
            dest_ev = np.zeros((ftl, n_nodes, 2), dest.dtype) if has_ev else None
            split = bool(fmeta.get("split", False))
            key = fmeta.get("key", fn)
            rx = _key_regex(key, split)
            matched = [k for k in traj_keys_all if rx.match(k)]
            if not matched:
                raise KeyError(f"feature {fn!r}: no dataset matches {key!r} in {traj_key}")
            for m in matched:
                bracket_groups = re.findall(r"\[([\d,]+)\]", m)
                # %d index (grid point) appears in the key position
                node_idx = None
                if "%d" in key:
                    # digits at the %d position
                    probe = re.escape(key).replace(re.escape("%d"), r"(\d+)")
                    gm = re.match(probe, m)
                    if gm:
                        pt = [int(gm.group(1))]
                        node_idx = (
                            _grid_linear_index(dims, _multi_idx(dims, pt))
                            if grid and len(pt) == 1
                            else pt[0]
                        )
                coord = None
                if split and bracket_groups:
                    coord = [int(x) for x in bracket_groups[-1].split(",")][0]
                data = np.asarray(traj[m])
                _place(dest, data, node_idx, coord, ftl)
                if has_ev and (m + ".ev") in traj:
                    _place(dest_ev, np.asarray(traj[m + ".ev"]), node_idx, None, ftl)
            out[fn] = dest
            if has_ev:
                out[fn + ".ev"] = dest_ev

        # timestamps
        dt_meta = meta["dt"]
        if isinstance(dt_meta, str):
            out["times"] = np.asarray(traj[dt_meta], np.float32).reshape(-1)[:tl]
        else:
            out["times"] = (np.arange(tl, dtype=np.float32)) * np.float32(dt_meta)

        # explicit custom edges
        if "custom_edges" in meta:
            ek = meta["custom_edges"]
            if ek not in traj:
                raise KeyError(f"custom_edges key {ek!r} not in trajectory {traj_key}")
            edges = np.asarray(traj[ek]).reshape(-1, 2).astype(np.int32)
            node_type = out.get("node_type")
            excluded = set(int(i) for i in meta.get("exclude_node_indices", []))
            bad_types = set(int(t) for t in meta.get("no_edges_node_types", []))
            if node_type is not None and bad_types:
                nt = node_type[0, :, 0].astype(int)
                excluded |= {i for i in range(len(nt)) if nt[i] in bad_types}
            if excluded:
                keep = ~(
                    np.isin(edges[:, 0], list(excluded))
                    | np.isin(edges[:, 1], list(excluded))
                )
                edges = edges[keep]
            out["edges"] = edges
        elif "cells" not in out and grid:
            nt = out["node_type"][0, :, 0] if "node_type" in out else None
            s, r = grid_edges(
                dims, node_type=nt,
                no_edges_node_types=meta.get("no_edges_node_types", ()),
            )
            out["edges"] = np.stack([s, r], axis=1)

    return out


def _multi_idx(dims: Sequence[int], pt: List[int]) -> List[int]:
    """A single %d index may already be linear; treat it as such."""
    if len(pt) == 1:
        li = pt[0]
        idx = []
        for d in dims:
            idx.append(li % d)
            li //= d
        return idx
    return pt
