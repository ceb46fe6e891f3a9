"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), built with nvcc at
first use and bound through ctypes (``build.py``).

``LAUNCHES`` counts every kernel launch by name: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its main path went through the kernels."""

from typing import Dict

KERNEL_NAMES = (
    "dense_spf_distances",
    "dense_spf_nexthop_lanes",
    "multi_area_select_from_tables",
    "warm_spf_distances",
    "spf_nexthop_lanes_reset",
    "warm_subgraph_repair",
    "multi_area_select_delta_from_tables",
    "sweep_spf_link_failures",
    "repair_sweep",
    "select_chunk",
    "compact_deltas",
    "fleet_spf_dense",
    "fleet_select",
    "spf_segment_batch",
    "spf_distances_masked",
    "batched_spf",
    "batched_select_routes",
    "gather_selection_rows",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
