"""State carried across from the JAX reference package.

For this system the "weights" are the LSDB — adjacency and prefix
databases — plus the encoded tables the kernels read.  The reference
serializes both database types with ``to_wire()`` into plain dicts;
:func:`lsdb_from_wire` builds this package's LinkState/PrefixState from
those dicts alone, and :func:`tables_from_numpy` turns numpy arrays (the
reference's kernel inputs or outputs) into tensors with the same dtypes.
Nothing here imports the reference package.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import dataclasses

import numpy as np
import torch

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.types import AdjacencyDatabase, PrefixDatabase


def lsdb_from_wire(
    adj_dbs: Dict[str, dict],
    prefix_dbs: Dict[str, dict],
    my_node_name: str = "",
) -> Tuple[Dict[str, LinkState], PrefixState]:
    """Wire dicts → (area_link_states, prefix_state).

    ``adj_dbs`` and ``prefix_dbs`` map any key (e.g. the KvStore key) to
    an ``AdjacencyDatabase`` / ``PrefixDatabase`` wire dict; the area of
    each comes from its own ``area`` field.  ``my_node_name`` is the
    vantage LinkState needs for adj_only_used_by_other_node adjacencies.
    Prefix databases flagged ``delete_prefix`` are skipped."""
    area_link_states: Dict[str, LinkState] = {}
    for wire in adj_dbs.values():
        db = AdjacencyDatabase.from_wire(wire)
        ls = area_link_states.get(db.area)
        if ls is None:
            ls = area_link_states[db.area] = LinkState(db.area, my_node_name)
        ls.update_adjacency_database(db)
    prefix_state = PrefixState()
    for wire in prefix_dbs.values():
        db = PrefixDatabase.from_wire(wire)
        if db.delete_prefix:
            continue
        for entry in db.prefix_entries:
            prefix_state.update_prefix(db.this_node_name, db.area, entry)
    return area_link_states, prefix_state


_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
}


def tables_from_numpy(
    arrays: Iterable[np.ndarray], device="cpu"
) -> Tuple[torch.Tensor, ...]:
    """numpy arrays → contiguous tensors of the same dtype on ``device``
    (int32 ids stay int32, int8 lanes int8, bool masks bool; uint32 bit
    words become int32 tensors of the same bits, ``ops/bits.py``)."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if a.dtype not in _DTYPES:
            raise TypeError(f"unsupported table dtype {a.dtype}")
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)



def _fields_of(cls, fields) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        out[f.name] = np.array(v, copy=True) if isinstance(v, np.ndarray) else v
    return out


def repair_plan_from_fields(fields):
    """The reference's ``RepairPlan`` as a mapping of its fields → the
    port's ``ops/repair.py`` RepairPlan (arrays copied with their
    dtypes)."""
    from openr_tpu_torch.ops.repair import RepairPlan

    return RepairPlan(**_fields_of(RepairPlan, fields))


def sweep_candidates_from_fields(fields):
    """The reference's ``SweepCandidates`` (or ``EncodedPrefixCandidates``)
    fields → the port's ``ops/sweep_select.py`` SweepCandidates."""
    from openr_tpu_torch.ops.sweep_select import SweepCandidates

    return SweepCandidates(**_fields_of(SweepCandidates, fields))
