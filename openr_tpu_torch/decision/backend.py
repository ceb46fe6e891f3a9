"""Decision compute backend on a CUDA card: the cold route build and the
three steady-state ticks.

The backend seam is the reference's pure-compute boundary (SpfSolver takes
LinkState/PrefixState in, RouteDb out, SpfSolver.h:136).  `CudaBackend` is
the counterpart of ``openr_tpu.decision.backend.TpuBackend`` on a single
device (one shard).  A build runs:

  1. encode: LinkStates → topology arrays (``ops/csr.py``; a perturbation
     tick patches the previous encoding's weights and drains in O(links),
     and membership churn, a node or link joining or leaving, patches it
     slot by slot: tombstoned, revived or renamed in place, the layout
     unchanged)
     and PrefixState → [cap, C] candidate table (``decision/cand_table.py``;
     an exact prefix delta re-encodes only its rows)
  2. per-area SPF from me, kept device-resident per encoding:
       * cold: ``multi_area_spf_tables_dense`` (two CUDA kernels), or for an
         encoding that declines the dense layout (an in-degree above the
         largest bucket) ``multi_area_spf_tables`` over the segment form
         (kernel 14 at one batch row)
       * warm topology tick (``warm_delta``, or ``structural_delta`` on a
         slot-patched encoding): the previous generation's tables seed
         ``ops/spf.py`` ``warm_spf_one`` (two kernels) or, for a
         pure-weakening delta, the bounded ``warm_subgraph_repair`` (one
         kernel), from the host plan of ``ops/repair.py``
  3. selection (one CUDA kernel), over one of
       * only the changed prefixes' rows, gathered to a [K, C] batch
         (prefix churn on an unchanged topology: the incremental branch)
       * only the rows a warm tick can have moved (warm-selective branch)
       * the whole table, fused with a diff against the previous full
         build's device-resident outputs (the delta branch: an unhinted
         tick with exact prefix churn), so only changed rows reach the host
       * the whole table (every other build)
  4. host decode of the selected rows, patched into the previous RouteDb
     (every route outside the changed set is the previous object), or a
     full RouteDb with the static-route overlay and the MPLS label routes

On a CUDA device every device build runs the hand kernels; on the CPU
(``device="cpu"``) the same path runs their plain PyTorch versions.  Every
path must produce the RouteDb the scalar ``SpfSolver`` produces and that
``TpuBackend(warm_rebuild=True)`` produces, with the same path counters and
changed sets.

Admission (the reference's ``TpuBackend.build_route_db``): a
``BackendHealthGovernor`` (``resilience/governor.py``) admits each build to
the device, as a half-open probe, or not at all, and shadow-verifies the
first device build, 1 in ``shadow_sample_every`` after it and every probe
against the scalar ``SpfSolver``; a mismatch quarantines the device and
serves the scalar RouteDb (shadow checks count in the governor's
``resilience.backend.*`` gauges).  ``resilience=None`` builds a governor
with ``ResilienceConfig``'s defaults; ``ResilienceConfig(enabled=False)``
keeps the one-way ``device_failed`` latch with no verification.  Every
other scalar build is counted, never silent:

  * ``num_scalar_builds``: disabled best-route selection or another
    selection algorithm, an empty ``area_link_states``, a build while
    quarantined (also ``num_fallback_injected``), and a ``CapacityError``:
    a world the device layout cannot hold, found on the host before any
    launch (a prefix with more candidates than the largest candidate
    bucket, also ``num_fallback_cand_overflow``; a count past an encode
    bucket; a non-positive metric)
  * ``num_small_scalar_builds``: the small-build cutover
    (``min_device_prefixes``: N prefixes, or None to weigh the estimated
    scalar cost against the measured dispatch round trip)
  * ``num_dispatch_errors``: any other exception of the device build,
    scored by the governor's breaker (re-raised with no governor)

Raised, and never caught or counted (``KERNEL_ERRORS``):
``build.KernelError`` (a kernel failed to build, load, bind its C symbol or
launch), ``torch.AcceleratorError`` (the CUDA runtime),
``torch.OutOfMemoryError`` (an allocation on the card: the device layout
is sized on the host, so running out is a fault of that sizing, not of the
card's health), and a launcher's refusal of its arguments: every other
``ValueError`` (a shape or a device), a ``TypeError`` (a dtype,
``build.check_tensor``) and a ``ctypes.ArgumentError`` (an argument the C
entry point cannot take).  A scalar answer there would hide a broken kernel
behind a correct RouteDb, so they leave the breaker, ``device_failed`` and
the counters as they were (an admitted probe is released unscored).  Whatever leaves the
backend as an exception first drops the previous RouteDb, the candidate
table's sync and the resident selection outputs, so no half-built state
serves as the next build's base.

KSP2_ED_ECMP prefixes (classified by the forwarding algorithm of the MIN
selection winner) are collected during the decode with their per-area
destinations; one ``Ksp2DeviceEngine.seed`` per area solves the k = 2
re-solves of every destination the LinkState k-path memo lacks as one
batch on the card (kernel 15) and traces the paths on the host, then the
scalar KSP2 chain (``SpfSolver.create_route_for_prefix``) builds those
routes from the seeded memo.  Their routes read the whole topology, so
while any KSP2 prefix is live the delta and warm-selective branches
decline; a full decode re-derives that.

Not in this backend yet: the reference's device pool, with its per-card
health governance and multi-card dispatch.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from openr_tpu_torch.config import ResilienceConfig
from openr_tpu_torch.decision.cand_table import CandidateTable
from openr_tpu_torch.decision.ksp2 import Ksp2DeviceEngine
from openr_tpu_torch.decision.link_state import INF, LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb, RibUnicastEntry
from openr_tpu_torch.decision.spf_solver import SpfSolver, drained_entry
from openr_tpu_torch.device import DeviceLike, resolve_device, synchronize
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels.build import KernelError
from openr_tpu_torch.ops.csr import (
    CapacityError,
    bucket_for,
    encode_multi_area,
    patch_encoded_multi_area_slots,
)
from openr_tpu_torch.ops.repair import PLAN_CACHE, plan_generation_delta
from openr_tpu_torch.ops.route_select import (
    gather_selection_rows,
    multi_area_select_delta_from_tables,
    multi_area_select_from_tables,
    multi_area_spf_tables,
    multi_area_spf_tables_dense,
)
from openr_tpu_torch.ops.spf import warm_spf_one, warm_subgraph_repair
from openr_tpu_torch.resilience.governor import (
    ADMIT_PROBE,
    ADMIT_QUARANTINED,
    BackendHealthGovernor,
)
from openr_tpu_torch.types import (
    NextHop,
    PrefixForwardingAlgorithm,
    RouteComputationRules,
    prefix_is_v4,
)

#: max-out-degree lane buckets (the D axis of the lane tables).  The
#: reference stops at 1024 and builds such LSDBs with its scalar solver;
#: every encoding that declines the dense layout (an in-degree above 1024)
#: has a node of out-degree above 1024, so the segment form needs the
#: wider buckets to run on the card at all.
DEGREE_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

#: most rows a gathered selection takes (the reference's largest gathered
#: row bucket): more changed rows than this run the full-table selection
MAX_GATHERED_ROWS = 262144

#: delta-fetch cutover: when more than this fraction of the rows changed,
#: the compacted gather stops paying for itself — fetch the full outputs
DELTA_FETCH_MAX_FRACTION = 0.5

#: the phases every build records in ``last_phase_ms`` (plus "total");
#: a build that met KSP2 prefixes also records "ksp2", carved out of
#: "decode": the seed (kernel 15 and its fetch), the path trace and the
#: scalar KSP2 route chain
PHASES = ("encode", "spf", "select", "decode")

#: the selection algorithms the device build implements (with best-route
#: selection enabled); every other build is a counted scalar build
DEVICE_ALGORITHMS = (
    RouteComputationRules.SHORTEST_DISTANCE,
    RouteComputationRules.PER_AREA_SHORTEST_DISTANCE,
)

#: errors of the kernels themselves: they leave ``build_route_db`` as they
#: are, uncounted, so no scalar answer hides them.  ``ValueError``,
#: ``TypeError`` and ``ctypes.ArgumentError`` cover the launchers' refusals
#: (``CapacityError`` is caught before them).
KERNEL_ERRORS = (
    ValueError,
    TypeError,
    ctypes.ArgumentError,
    KernelError,
    torch.AcceleratorError,
    torch.OutOfMemoryError,
)


def measure_dispatch_rt_ms(device: torch.device) -> float:
    """Median device dispatch round trip (ms): one tiny op on ``device``,
    then a synchronize — the number the auto device-vs-host cutover
    calibrates against."""
    torch.zeros(4, device=device) + 1
    synchronize(device)  # warm-up
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        torch.zeros(4, device=device) + 1
        synchronize(device)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[1] * 1000.0


def estimate_scalar_work_items(area_link_states, prefix_state) -> int:
    """Work items (prefix rows + directed edges) for the auto cutover's
    scalar-cost estimate."""
    return len(prefix_state.prefixes()) + 2 * sum(
        ls.num_links() for ls in area_link_states.values()
    )


def _with_slot_changes(mask: np.ndarray, enc) -> np.ndarray:
    """``mask`` [A, V] with each area's membership-changed slots
    (``slot_changed`` of a slot-patched encoding) set, in place."""
    for ai, t in enumerate(enc.topos):
        if t.slot_changed is not None:
            mask[ai] |= t.slot_changed
    return mask


def _patch_route_db(
    prev_db: DecisionRouteDb,
    results: Dict[str, Optional[RibUnicastEntry]],
    static_routes: Dict[str, RibUnicastEntry],
) -> DecisionRouteDb:
    """Previous RouteDb + per-changed-prefix results → new RouteDb.  A
    None result falls back to the static overlay (full-build rule: static
    routes fill prefixes the prefix states didn't produce,
    SpfSolver.cpp:343-349), else the route is deleted."""
    db = DecisionRouteDb(
        unicast_routes=dict(prev_db.unicast_routes),
        mpls_routes=dict(prev_db.mpls_routes),
    )
    for prefix, entry in results.items():
        if entry is None:
            entry = static_routes.get(prefix)
        if entry is None:
            db.unicast_routes.pop(prefix, None)
        else:
            db.unicast_routes[prefix] = entry
    return db


class DecisionBackend:
    def build_route_db(
        self,
        area_link_states: Dict[str, LinkState],
        prefix_state: PrefixState,
        changed_prefixes: Optional[Set[str]] = None,
        force_full: bool = False,
        cache_result: bool = True,
        warm_delta: bool = False,
        structural_delta: bool = False,
    ) -> Optional[DecisionRouteDb]:
        """Full RouteDb for the solver's node, or None when that node is
        in no area.  ``changed_prefixes`` is the EXACT prefix-churn delta
        since the previous call (None = unknown).  ``force_full`` demands a
        full recomputation (topology, static-route or policy change).
        ``cache_result=False`` means the caller mutates the returned db, so
        it is no incremental base.  ``warm_delta`` / ``structural_delta``
        classify this tick's topology churn (perturbation / membership);
        a backend re-verifies them against its own caches.  Whatever the
        hints, the result equals a cold full build."""
        raise NotImplementedError

    def take_full_replace(self) -> bool:
        """True exactly once after a build whose result must be diffed
        against the WHOLE previous RouteDb even on an incremental tick."""
        return False

    def take_last_changed_prefixes(self) -> Optional[Set[str]]:
        """One-shot: the exact prefix set the LAST build could have
        changed, when it PATCHED its previous RouteDb (every other route is
        the previous object); None = diff everything."""
        return None


class _PhaseClock:
    """Host wall time per phase in ms; each lap ends with a device
    synchronize so kernel time lands in its phase.  Laps add up, and every
    phase of ``PHASES`` is present (0.0 when a path skips it)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.ms = dict.fromkeys(PHASES, 0.0)
        self.t0 = self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.ms[name] += (now - self.t) * 1e3
        self.t = now

    def done(self) -> Dict[str, float]:
        self.ms["total"] = (time.perf_counter() - self.t0) * 1e3
        return self.ms


class CudaBackend(DecisionBackend):
    """Device-accelerated buildRouteDb, cold and steady-state."""

    #: warm-context host mirrors beyond this size are not kept
    WARM_MAX_TABLE_BYTES = 64 << 20
    #: the auto cutover's assumed scalar build cost per work item (prefix
    #: row or directed edge), and the device build's cost in dispatch round
    #: trips (encode + SPF + select + one bulk fetch); the reference's values
    SCALAR_US_PER_ITEM = 10.0
    DEVICE_OVERHEAD_TRIPS = 2.5

    def __init__(
        self,
        solver: SpfSolver,
        device: DeviceLike = None,
        warm_rebuild: bool = True,
        min_device_prefixes: Optional[int] = 0,
        clock=None,
        counters=None,
        tracer=None,
        resilience: Optional[ResilienceConfig] = None,
    ) -> None:
        self.solver = solver  # scalar fallback, static/MPLS routes, drains
        self.device = resolve_device(device)
        #: device-vs-scalar cutover: 0 = always device; N = a scalar build
        #: below N prefixes; None = auto, a scalar build when the estimated
        #: scalar cost cannot amortize the dispatch round trip (measured
        #: once, at the first build that asks)
        self.min_device_prefixes = min_device_prefixes
        self.auto_dispatch_rt_ms: Optional[float] = None
        self._cand_table = CandidateTable()
        #: the table holds every prefix delta so far (a build that raised
        #: or went scalar leaves it stale: the next build re-reads PrefixState)
        self._table_synced = False
        #: (area/topology_seq key, pinned LinkStates, encoding, device
        #: arrays): prefix-only rebuilds reuse the encoding
        self._enc_cache: Optional[tuple] = None
        #: the encoding and RouteDb of the previous build
        self._last_enc = None
        self._last_db: Optional[DecisionRouteDb] = None
        self._last_changed_prefixes: Optional[Set[str]] = None
        #: one-shot: a shadow check replaced the device result, so the
        #: caller diffs this build against its WHOLE previous RouteDb
        self._full_replace = False
        #: device SPF tables (dist, nh, overloaded, soft), valid while
        #: (_tables_enc is the live encoding, _tables_degree == D)
        self._tables = None
        self._tables_enc = None
        self._tables_degree = None
        #: warm generation-delta context: the previous generation's tables
        #: (device) and their host mirrors for the next delta's planning
        self._warm_enabled = bool(warm_rebuild)
        self._warm_ctx: Optional[dict] = None
        self._warm_changed_nodes: Optional[np.ndarray] = None  # [A, V]
        self._warm_base_enc = None  # ctx encoding the last warm solve diffed
        self._warm_solved = False  # this build's tables came in warm
        self._warm_rounds = None  # (rounds_d, rounds_l) device tensors
        #: the previous full build's device-resident selection outputs,
        #: the next full build's delta base
        self._prev_sel: Optional[dict] = None
        #: KSP2 seeding engines per (area, topology_seq), reset with every
        #: new encoding; and whether the last full decode met a live KSP2
        #: prefix (the delta and warm-selective branches then decline)
        self._ksp2_engines: Dict[tuple, Ksp2DeviceEngine] = {}
        self._ksp2_present = False
        self._ksp2_ms = 0.0
        self.num_device_builds = 0
        self.num_scalar_builds = 0
        self.num_small_scalar_builds = 0
        #: scalar builds caused by a prefix with more candidates than the
        #: largest candidate bucket (a cause of its own among scalar builds)
        self.num_fallback_cand_overflow = 0
        self.num_fallback_injected = 0
        self.num_dispatch_errors = 0
        self.num_encode_hits = 0
        self.num_encode_patches = 0
        self.num_encode_slot_patches = 0
        #: cold re-encodes of membership churn the slot patch declined, by
        #: reason (area_change, slot_exhaustion, new_link)
        self._slot_decline_reasons: Dict[str, int] = {}
        self.num_incremental_builds = 0
        self.num_warm_builds = 0
        self.num_warm_subgraph_builds = 0
        self.num_warm_selective_builds = 0
        self.num_warm_cold_fallbacks = 0
        self.num_warm_purges = 0
        self._warm_purge_reasons: Dict[str, int] = {}
        self._warm_fallback_reasons: Dict[str, int] = {}
        #: warm telemetry by delta class (perturbation / structural)
        self._warm_class_builds = {"perturbation": 0, "structural": 0}
        self._warm_class_fallbacks = {"perturbation": 0, "structural": 0}
        self._warm_class_fallback_reasons: Dict[str, Dict[str, int]] = {
            "perturbation": {},
            "structural": {},
        }
        self.num_delta_builds = 0
        self.num_delta_rows_fetched = 0
        self.num_delta_rows_skipped = 0
        self.warm_last_est_depth = 0
        self.warm_last_reset_nodes = 0
        self.warm_last_rounds = (0, 0)
        #: rows each selection of the last build ran over, by branch
        self.last_rows: Dict[str, int] = {}
        #: host wall time of the last build's phases, in ms (empty after a
        #: build that ran no device build)
        self.last_phase_ms: Dict[str, float] = {}
        #: device-outage latch: while set, every build is a scalar build.
        #: With a governor its only writers are the governor and the
        #: injection hooks below.
        self.device_failed = False
        #: injected silent corruption: fetched metrics are perturbed
        #: without raising (what shadow verification exists to catch)
        self._sdc_inject = False
        self.governor: Optional[BackendHealthGovernor] = None
        if resilience is None or resilience.enabled:
            gov_kwargs = (
                {}
                if resilience is None
                else dict(
                    shadow_sample_every=resilience.shadow_sample_every,
                    failure_threshold=resilience.failure_threshold,
                    probe_backoff_initial_s=resilience.probe_backoff_initial_s,
                    probe_backoff_max_s=resilience.probe_backoff_max_s,
                    jitter_pct=resilience.jitter_pct,
                    seed=resilience.seed,
                    per_device=resilience.per_device,
                )
            )
            self.governor = BackendHealthGovernor(
                self, clock=clock, counters=counters, tracer=tracer, **gov_kwargs
            )
            # a quarantine makes device residency suspect: the next
            # generation solves cold and is verified
            self.governor.add_quarantine_listener(
                lambda info: self._purge_warm(f"quarantine:{info.get('reason', '')}")
            )

    # -- build -------------------------------------------------------------

    def build_route_db(
        self,
        area_link_states,
        prefix_state,
        changed_prefixes=None,
        force_full=False,
        cache_result=True,
        warm_delta=False,
        structural_delta=False,
    ):
        self._last_changed_prefixes = None
        self.last_rows = {}
        self.last_phase_ms = {}
        try:
            return self._admitted_build(
                area_link_states, prefix_state, changed_prefixes, force_full,
                cache_result, warm_delta, structural_delta,
            )
        except BaseException:
            # nothing of a build that raised may serve as the next base
            self._last_db = None
            self._table_synced = False
            self._prev_sel = None
            raise

    def _admitted_build(
        self, area_link_states, prefix_state, changed_prefixes, force_full,
        cache_result, warm_delta, structural_delta,
    ):
        """The reference's admission path: governor, eligibility, cutover,
        the device build and its shadow check."""
        gov = self.governor
        probe = False
        if gov is not None:
            mode = gov.admit()
            if mode == ADMIT_QUARANTINED:
                # the daemon keeps producing routes: the scalar oracle
                self.num_fallback_injected += 1
                return self._scalar_fallback(area_link_states, prefix_state)
            probe = mode == ADMIT_PROBE
        elif self.device_failed:
            self.num_fallback_injected += 1
            return self._scalar_fallback(area_link_states, prefix_state)
        solver = self.solver
        if (
            not area_link_states
            or not solver.enable_best_route_selection
            or solver.route_selection_algorithm not in DEVICE_ALGORITHMS
        ):
            if probe:
                gov.abort_probe()
            return self._scalar_fallback(area_link_states, prefix_state)
        delta_class = (
            "structural" if structural_delta else ("perturbation" if warm_delta else None)
        )
        try:
            if self.min_device_prefixes is None:
                small = not self._device_worth_it(area_link_states, prefix_state)
            else:
                small = bool(self.min_device_prefixes) and (
                    len(prefix_state.prefixes()) < self.min_device_prefixes
                )
            if small:
                if probe:
                    gov.abort_probe()
                return self._scalar_fallback(
                    area_link_states, prefix_state, counter="small"
                )
            db = self._build_device(
                area_link_states, prefix_state, changed_prefixes, force_full, delta_class
            )
        except CapacityError:
            # a data-scale limit found before any launch, not a device
            # health signal: scalar, without scoring the breaker
            if gov is not None:
                gov.abort_probe()
            return self._scalar_fallback(area_link_states, prefix_state)
        except KERNEL_ERRORS:
            # a kernel's own failure or refusal: never answered around
            if probe:
                gov.abort_probe()
            raise
        except Exception as e:  # noqa: BLE001 - organic dispatch failure
            if gov is None:
                raise
            # past the breaker's threshold the device is quarantined
            # instead of being re-paid on every rebuild
            self.num_dispatch_errors += 1
            gov.record_dispatch_failure(e)
            return self._scalar_fallback(area_link_states, prefix_state)
        if db is None:
            # my node is in no area: nothing computed, nothing to verify
            if gov is not None:
                gov.abort_probe()
            return None
        if gov is not None:
            db, from_device = gov.after_device_build(
                db, area_link_states, prefix_state, probe=probe
            )
            if not from_device:
                # a shadow check replaced a corrupt device result: no base
                # derived from device output is trustworthy, and the caller
                # diffs this build against its WHOLE previous RouteDb
                self._last_db = None
                self._table_synced = False
                self._full_replace = True
                self._last_changed_prefixes = None
                self._purge_warm("full_replace")
                return db
        self._last_db = db if cache_result else None
        return db

    def _build_device(
        self, area_link_states, prefix_state, changed_prefixes, force_full, delta_class
    ):
        """One device build; None when my node is in no area."""
        self._ksp2_ms = 0.0
        db = self._build(
            area_link_states, prefix_state, changed_prefixes, force_full, delta_class
        )
        if self._ksp2_ms:
            self.last_phase_ms["decode"] -= self._ksp2_ms
            self.last_phase_ms["ksp2"] = self._ksp2_ms
        return db

    def _scalar_fallback(self, area_link_states, prefix_state, counter: str = "scalar"):
        """One build by the scalar solver, counted; every incremental base
        is dropped (the candidate table misses this tick's churn)."""
        if counter == "small":
            self.num_small_scalar_builds += 1
        else:
            self.num_scalar_builds += 1
        self._last_db = None
        self._table_synced = False
        self._prev_sel = None  # resident outputs no longer match _last_db
        return self.solver.build_route_db(area_link_states, prefix_state)

    def _device_worth_it(self, area_link_states, prefix_state) -> bool:
        """Auto cutover: device iff the estimated scalar build cost reaches
        the measured dispatch overhead (both only need order-of-magnitude
        accuracy)."""
        if self.auto_dispatch_rt_ms is None:
            self.auto_dispatch_rt_ms = measure_dispatch_rt_ms(self.device)
        work = estimate_scalar_work_items(area_link_states, prefix_state)
        scalar_us = work * self.SCALAR_US_PER_ITEM
        device_us = self.DEVICE_OVERHEAD_TRIPS * self.auto_dispatch_rt_ms * 1000.0
        return scalar_us >= device_us

    def take_full_replace(self) -> bool:
        fr, self._full_replace = self._full_replace, False
        return fr

    def take_last_changed_prefixes(self) -> Optional[Set[str]]:
        out, self._last_changed_prefixes = self._last_changed_prefixes, None
        return out

    # -- injected faults and counters ---------------------------------------

    def inject_device_failure(self, failed: bool) -> None:
        """Force (or clear) the device-outage path: while set, every build
        is a scalar build.  With a governor, setting it hard-quarantines the
        device and clearing it force-restores it (a probed heal goes
        through ``governor.request_probe`` instead)."""
        if self.governor is not None:
            if failed:
                self.governor.force_quarantine(reason="injected")
            else:
                self.governor.force_restore(reason="injected_clear")
            return
        self.device_failed = failed

    def inject_silent_corruption(self, corrupt: bool) -> None:
        """Perturb the fetched selection metrics WITHOUT raising: wrong but
        plausible route metrics reach the decode, the silent-corruption
        model.  Detecting it is the governor's job (shadow verification),
        never this flag's."""
        self._sdc_inject = corrupt
        if corrupt:
            # nothing device-resident may seed a warm rebuild: the next
            # generation solves cold, and its shadow check is due
            self._purge_warm("tpu_corrupt")

    def _fetched_metrics(self, shortest: np.ndarray) -> np.ndarray:
        """The per-area metrics as fetched to the host.  While corruption is
        injected, every finite one is shifted by a constant: routes stay
        loop-free and reachable, yet provably wrong — the corruption class
        only a RIB diff against the scalar oracle catches.  Deterministic,
        so a seeded run replays exactly."""
        if not self._sdc_inject:
            return shortest
        out = np.array(shortest, copy=True)
        out[np.isfinite(out)] += 7.0
        return out

    def counter_snapshot(self) -> Dict[str, float]:
        """The reference backend's ``decision.backend.*`` gauges (less those
        of the device pool and its stream, not ported yet) plus the
        governor's ``resilience.backend.*``."""
        warm_b, warm_f = self._warm_class_builds, self._warm_class_fallbacks
        out = {
            "decision.backend.device": 1.0,
            "decision.backend.device_failed": 1.0 if self.device_failed else 0.0,
            "decision.backend.num_device_builds": float(self.num_device_builds),
            "decision.backend.num_scalar_builds": float(self.num_scalar_builds),
            "decision.backend.num_small_scalar_builds": float(self.num_small_scalar_builds),
            "decision.backend.num_incremental_builds": float(self.num_incremental_builds),
            "decision.backend.num_fallback_cand_overflow": float(
                self.num_fallback_cand_overflow
            ),
            "decision.backend.num_fallback_injected": float(self.num_fallback_injected),
            "decision.backend.num_dispatch_errors": float(self.num_dispatch_errors),
            "decision.backend.sdc_injected": 1.0 if self._sdc_inject else 0.0,
            "decision.backend.warm_enabled": 1.0 if self._warm_enabled else 0.0,
            "decision.backend.warm_context_ready": 1.0 if self._warm_ctx is not None else 0.0,
            "decision.backend.warm_builds": float(self.num_warm_builds),
            "decision.backend.warm_subgraph_builds": float(self.num_warm_subgraph_builds),
            "decision.backend.warm_selective_builds": float(self.num_warm_selective_builds),
            "decision.backend.warm_cold_fallbacks": float(self.num_warm_cold_fallbacks),
            "decision.backend.warm_purges": float(self.num_warm_purges),
            "decision.backend.warm_encode_patches": float(self.num_encode_patches),
            "decision.backend.warm_encode_slot_patches": float(self.num_encode_slot_patches),
            "decision.backend.warm_hit_ratio": self.num_warm_builds
            / max(1, self.num_warm_builds + self.num_warm_cold_fallbacks),
            "decision.backend.warm_last_est_depth": float(self.warm_last_est_depth),
            "decision.backend.warm_last_reset_nodes": float(self.warm_last_reset_nodes),
            "decision.backend.delta_builds": float(self.num_delta_builds),
            "decision.backend.delta_rows_fetched": float(self.num_delta_rows_fetched),
            "decision.backend.delta_rows_skipped": float(self.num_delta_rows_skipped),
        }
        for cls in ("perturbation", "structural"):
            out[f"decision.backend.warm_builds.{cls}"] = float(warm_b[cls])
            out[f"decision.backend.warm_cold_fallbacks.{cls}"] = float(warm_f[cls])
            out[f"decision.backend.warm_hit_ratio.{cls}"] = warm_b[cls] / max(
                1, warm_b[cls] + warm_f[cls]
            )
        for reason, n in sorted(self._slot_decline_reasons.items()):
            out[f"decision.backend.slot_decline.{reason}"] = float(n)
        for cls, reasons in sorted(self._warm_class_fallback_reasons.items()):
            for reason, n in sorted(reasons.items()):
                out[f"decision.backend.warm_fallback.{cls}.{reason}"] = float(n)
        for reason, n in sorted(self._warm_purge_reasons.items()):
            out[f"decision.backend.warm_purge.{reason}"] = float(n)
        # the process-wide RepairPlan cache the what-if planners share
        for k, v in PLAN_CACHE.gauges().items():
            out[f"decision.backend.{k}"] = v
        if self.governor is not None:
            out.update(self.governor.counter_snapshot())
        return out

    def _build(self, area_link_states, prefix_state, changed_prefixes, force_full, delta_class):
        solver = self.solver
        me = solver.my_node_name
        if not any(ls.has_node(me) for ls in area_link_states.values()):
            # this tick's delta is consumed without reaching the table
            self._last_db = None
            self._table_synced = False
            return None
        clock = _PhaseClock(self.device)
        prev_enc = self._last_enc
        enc, arrays = self._encoded(area_link_states, me)
        self._last_enc = enc

        # table sync is driven ONLY by prefix churn; exact_churn (patched
        # from a known delta) is the precondition of the delta branch
        table = self._cand_table
        exact_churn = changed_prefixes is not None and self._table_synced
        try:
            if exact_churn:
                table.apply_dirty(prefix_state, changed_prefixes)
            else:
                table.full_sync(prefix_state)
        except CapacityError:
            # a prefix wider than the largest candidate bucket: the
            # caller answers through the scalar solver
            self.num_fallback_cand_overflow += 1
            raise
        self._table_synced = True
        dv = table.derived(enc)
        clock.lap("encode")

        incremental = (
            changed_prefixes is not None
            and not force_full
            and self._last_db is not None
            and prev_enc is enc
            and len(changed_prefixes) <= MAX_GATHERED_ROWS
        )
        D = bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
        per_area = (
            solver.route_selection_algorithm
            == RouteComputationRules.PER_AREA_SHORTEST_DISTANCE
        )
        patch_base = self._last_db
        tables = self._spf(enc, arrays, D, delta_class)
        clock.lap("spf")
        statics = solver.get_static_routes()

        # ---- prefix churn on an unchanged topology -----------------------
        if incremental:
            rows = table.rows_for(changed_prefixes)
            deleted = [p for p in changed_prefixes if p not in table.pid]
            self.num_incremental_builds += 1
            if not rows and not deleted:
                self.last_phase_ms = clock.done()
                return self._last_db
            results = {p: None for p in deleted}
            if rows:
                results.update(
                    self._select_rows_gathered(
                        rows, tables, dv, per_area, enc, area_link_states,
                        prefix_state, clock,
                    )
                )
            self.num_device_builds += 1
            # a patched build leaves the resident full-table outputs stale
            self._prev_sel = None
            db = _patch_route_db(self._last_db, results, statics)
            clock.lap("decode")
            self.last_phase_ms = clock.done()
            return db

        # ---- warm-selective: re-select only the rows a warm tick moved ---
        if (
            self._warm_solved
            and self._warm_changed_nodes is not None
            and patch_base is not None
            and prev_enc is self._warm_base_enc
            and not self._ksp2_present
            and not solver.enable_node_segment_label
        ):
            affected = self._warm_affected_rows(dv)
            churn_rows = table.rows_for(changed_prefixes) if changed_prefixes else []
            deleted = [p for p in (changed_prefixes or ()) if p not in table.pid]
            sel_rows = sorted(set(affected.tolist()) | set(churn_rows))
            if len(sel_rows) <= MAX_GATHERED_ROWS:
                results = {p: None for p in deleted}
                if sel_rows:
                    results.update(
                        self._select_rows_gathered(
                            sel_rows, tables, dv, per_area, enc,
                            area_link_states, prefix_state, clock,
                        )
                    )
                self.num_warm_selective_builds += 1
                self.num_device_builds += 1
                changed_out = {
                    table.row_prefix[r]
                    for r in sel_rows
                    if table.row_prefix[r] is not None
                }
                changed_out.update(deleted)
                self._last_changed_prefixes = changed_out
                self._prev_sel = None
                db = _patch_route_db(patch_base, results, statics)
                clock.lap("decode")
                self.last_phase_ms = clock.done()
                return db

        # ---- full build --------------------------------------------------
        cand = tables_from_numpy(dv.selection_inputs(), self.device)
        delta_ctx = self._delta_ctx_for(D, enc, dv, changed_prefixes, exact_churn)
        if delta_ctx is not None:
            db = self._delta_build(
                tables, cand, delta_ctx, per_area, dv, table, enc, D,
                area_link_states, prefix_state, changed_prefixes, patch_base,
                statics, clock,
            )
            self.last_phase_ms = clock.done()
            return db

        outs = self._select(*tables, *cand, per_area)
        self.last_rows["select"] = int(dv.cand_ok.shape[0])
        clock.lap("select")
        self._retain_prev_sel(outs, D, enc, dv)
        use, shortest, lanes, valid = (o.cpu().numpy() for o in outs)
        shortest = self._fetched_metrics(shortest)
        # a full decode re-derives KSP2 presence from scratch
        # (_decode_rows raises the flag on discovery)
        self._ksp2_present = False
        winners = np.nonzero(use.any(axis=1))[0]
        row_items = [
            (int(r), table.row_prefix[r])
            for r in winners
            if table.row_prefix[r] is not None
        ]
        results = self._decode_rows(
            row_items, use, shortest, lanes, valid, dv, None, enc,
            area_link_states, prefix_state,
        )
        route_db = DecisionRouteDb()
        for entry in results.values():
            if entry is not None:
                route_db.add_unicast_route(entry)
        # static-route overlay + MPLS labels: scalar (small)
        for prefix, sentry in statics.items():
            if prefix not in route_db.unicast_routes:
                route_db.add_unicast_route(sentry)
        if solver.enable_node_segment_label:
            solver._build_node_label_routes(area_link_states, route_db)
        self.num_device_builds += 1
        clock.lap("decode")
        self.last_phase_ms = clock.done()
        return route_db

    # -- device steps (kernel dispatch by device) --------------------------

    def _spf_tables(self, in_src, in_w, in_ok, in_rank, in_has, ovl, roots, D):
        return multi_area_spf_tables_dense(
            in_src, in_w, in_ok, in_rank, in_has, ovl, roots, max_degree=D
        )

    def _segment_tables(self, src, dst, w, edge_ok, ovl, roots, D):
        """Cold tables of an encoding without the dense planes."""
        return multi_area_spf_tables(src, dst, w, edge_ok, ovl, roots, max_degree=D)

    def _warm_tables(self, *args):
        """(dist, nh, rounds_d, rounds_l) of the full-edge warm kernels."""
        return warm_spf_one(*args)

    def _subgraph_tables(self, *args):
        """(dist, nh, rounds_d, rounds_l) of the bounded warm repair."""
        return warm_subgraph_repair(*args)

    def _select(self, dist, nh, ovl, soft, *cand_and_flag):
        return multi_area_select_from_tables(dist, nh, ovl, soft, *cand_and_flag)

    def _select_delta(self, *args):
        """(use, shortest, lanes, valid, changed) of the fused select+diff."""
        return multi_area_select_delta_from_tables(*args)

    # -- encoding (cached across prefix-only rebuilds) ---------------------

    def _encoded(self, area_link_states, me):
        areas = sorted(area_link_states)
        key = tuple((a, area_link_states[a].topology_seq) for a in areas)
        cached = self._enc_cache
        # identity is compared via held references (a bare id() could be
        # reused by a replacement object after GC and serve stale arrays)
        if (
            cached is not None
            and cached[0] == key
            and all(ls is area_link_states[a] for a, ls in zip(areas, cached[1]))
        ):
            self.num_encode_hits += 1
            return cached[2], cached[3]
        enc = None
        if self._warm_enabled and cached is not None:
            # a perturbation tick refreshes only the weight/validity/drain
            # columns; membership churn takes the slot-stable patch.  Both
            # share every layout array with the previous encoding.
            enc, kind, reason = patch_encoded_multi_area_slots(
                cached[2], area_link_states, me
            )
            if kind == "slot":
                self.num_encode_slot_patches += 1
            elif kind == "patch":
                self.num_encode_patches += 1
            else:
                self._slot_decline_reasons[reason] = (
                    self._slot_decline_reasons.get(reason, 0) + 1
                )
        if enc is None:
            enc = encode_multi_area(area_link_states, me)
        self._ksp2_engines = {}
        names = ("overloaded", "roots", "soft", "src", "dst", "w", "edge_ok")
        if enc.has_dense:
            names += ("in_src", "in_w", "in_ok", "in_rank", "in_has")
        arrays = dict(
            zip(names, tables_from_numpy([getattr(enc, n) for n in names], self.device))
        )
        self._enc_cache = (key, [area_link_states[a] for a in areas], enc, arrays)
        return enc, arrays

    def _ksp2_engine(self, area: str, link_state, topo) -> Ksp2DeviceEngine:
        key = (area, link_state.topology_seq)
        eng = self._ksp2_engines.get(key)
        if eng is None or eng.link_state is not link_state or eng.topo is not topo:
            eng = Ksp2DeviceEngine(
                link_state, topo, self.solver.my_node_name, device=self.device
            )
            self._ksp2_engines[key] = eng
        return eng

    # -- SPF tables, cold or warm ------------------------------------------

    def _spf(self, enc, arrays, D: int, delta_class):
        """Device (dist [A,V], nh [A,V,D], overloaded, soft), cached per
        encoding.  A warm-classified topology tick with a compatible
        previous generation re-relaxes only the perturbed frontier;
        everything else solves cold.  Either way this generation is kept
        as the next one's warm base."""
        if (
            self._tables is not None
            and self._tables_enc is enc
            and self._tables_degree == D
        ):
            return self._tables
        self._warm_solved = False
        self._warm_changed_nodes = None
        self._warm_rounds = None
        dist = nh = None
        if self._warm_enabled and delta_class is not None and self._warm_ctx is not None:
            dist, nh = self._warm_spf(enc, arrays, D, delta_class)
        elif self._warm_enabled and delta_class is not None:
            # a warm-classified tick whose context was purged (corruption,
            # quarantine, full replace) or never built
            self._warm_fallback("no_context", delta_class)
        elif self._warm_enabled and self._warm_ctx is not None:
            # a topology tick the hint classified cold
            self._warm_fallback("unclassified")
        if dist is None and enc.has_dense:
            a = arrays
            dist, nh = self._spf_tables(
                a["in_src"], a["in_w"], a["in_ok"], a["in_rank"], a["in_has"],
                a["overloaded"], a["roots"], D,
            )
        elif dist is None:
            a = arrays
            dist, nh = self._segment_tables(
                a["src"], a["dst"], a["w"], a["edge_ok"], a["overloaded"], a["roots"], D
            )
        self._tables = (dist, nh, arrays["overloaded"], arrays["soft"])
        self._tables_enc = enc
        self._tables_degree = D
        if self._warm_enabled:
            self._refresh_warm_ctx(enc, D)
        return self._tables

    def _warm_spf(self, enc, arrays, D: int, delta_class):
        """The generation-delta warm solve: (dist, nh) device tables, or
        (None, None) after counting a cold fallback (another degree bucket
        or edge bucket, or a structural delta)."""
        ctx = self._warm_ctx
        old_enc = ctx["enc"]
        if ctx["degree"] != D:
            self._warm_fallback("degree_bucket", delta_class)
            return None, None
        if old_enc.areas != enc.areas:
            self._warm_fallback("structural", delta_class)
            return None, None
        if ctx["dist"] is None:
            # cold builds keep device references only; the host mirrors
            # materialize at the first warm delta that needs them
            ctx["dist"] = ctx["tables"][0].cpu().numpy()
            ctx["nh"] = ctx["tables"][1].cpu().numpy()
        plans = []
        for ai, (old_topo, new_topo) in enumerate(zip(old_enc.topos, enc.topos)):
            if new_topo.padded_edges != old_topo.padded_edges:
                self._warm_fallback("edge_bucket", delta_class)
                return None, None
            # a slot-patched chain shares its layout arrays, which proves
            # the two layouts one: renames are then tolerated and the
            # membership-churned slots are forced into the reset set
            trust = new_topo.src is old_topo.src and new_topo.link_index is old_topo.link_index
            delta = plan_generation_delta(
                old_topo, int(enc.roots[ai]), ctx["dist"][ai], new_topo,
                force_reset=new_topo.slot_changed if trust else None,
                trust_layout=trust,
            )
            if delta is None:
                self._warm_fallback("structural", delta_class)
                return None, None
            plans.append(delta)
        reset = np.stack([p.reset for p in plans])
        self.warm_last_est_depth = max(p.est_depth for p in plans)
        self.warm_last_reset_nodes = int(sum(p.num_reset for p in plans))
        prev_dist, prev_nh = ctx["tables"]
        (reset_dev,) = tables_from_numpy((reset,), self.device)
        # bounded-subgraph eligibility: pure weakening with an unchanged
        # root lane basis — the working set is the perturbed frontier's
        # in-edges, independent of topology size
        if all((not p.has_improvements) and p.lanes_compatible for p in plans):
            sub = tables_from_numpy(self._pack_sub_edges(enc, plans), self.device)
            dist, nh, rounds_d, rounds_l = self._subgraph_tables(
                *sub, prev_dist, prev_nh, reset_dev, D
            )
            self.num_warm_subgraph_builds += 1
        else:
            lane_keep = np.asarray([p.lanes_compatible for p in plans], bool)
            (lane_keep_dev,) = tables_from_numpy((lane_keep,), self.device)
            a = arrays
            dist, nh, rounds_d, rounds_l = self._warm_tables(
                a["src"], a["dst"], a["w"], a["edge_ok"], a["overloaded"],
                a["roots"], prev_dist, prev_nh, reset_dev, lane_keep_dev, D,
            )
        self._warm_solved = True
        self._warm_base_enc = old_enc
        self._warm_rounds = (rounds_d, rounds_l)
        self.num_warm_builds += 1
        if delta_class in self._warm_class_builds:
            self._warm_class_builds[delta_class] += 1
        return dist, nh

    def _warm_fallback(self, reason: str, delta_class: Optional[str] = None) -> None:
        self.num_warm_cold_fallbacks += 1
        self._warm_fallback_reasons[reason] = self._warm_fallback_reasons.get(reason, 0) + 1
        if delta_class in self._warm_class_fallbacks:
            self._warm_class_fallbacks[delta_class] += 1
            by = self._warm_class_fallback_reasons[delta_class]
            by[reason] = by.get(reason, 0) + 1

    def _pack_sub_edges(self, enc, plans):
        """[A, Es] sub-edge arrays (src, dst, w, ok, lane rank) for the
        bounded repair, Es the largest area's count.  Positions come
        dst-sorted from the planner; an area with fewer sub-edges is
        padded after them with ok=False, rank -1 and its last real dst, so
        dst stays non-decreasing."""
        es = max(max((len(p.sub_edges) for p in plans), default=0), 1)
        A = enc.num_areas
        V = enc.topos[0].padded_nodes
        src_sub = np.zeros((A, es), np.int32)
        dst_sub = np.full((A, es), V - 1, np.int32)
        w_sub = np.full((A, es), np.float32(np.inf), np.float32)
        ok_sub = np.zeros((A, es), bool)
        rank_sub = np.full((A, es), -1, np.int32)
        for ai, (topo, plan) in enumerate(zip(enc.topos, plans)):
            pos = plan.sub_edges
            n = len(pos)
            if not n:
                continue
            root = int(enc.roots[ai])
            transit = (~topo.overloaded) | (np.arange(V) == root)
            okf = topo.edge_ok & transit[topo.src]
            rank_full = np.full(topo.padded_edges, -1, np.int32)
            root_out = np.nonzero((topo.src == root) & (topo.link_index >= 0))[0]
            rank_full[root_out] = np.arange(len(root_out), dtype=np.int32)
            src_sub[ai, :n] = topo.src[pos]
            dst_sub[ai, :n] = topo.dst[pos]
            w_sub[ai, :n] = topo.w[pos]
            ok_sub[ai, :n] = okf[pos]
            rank_sub[ai, :n] = rank_full[pos]
            dst_sub[ai, n:] = max(int(topo.dst[pos[-1]]), 0)
        return src_sub, dst_sub, w_sub, ok_sub, rank_sub

    def _refresh_warm_ctx(self, enc, D: int) -> None:
        """Keep THIS generation's tables as the next delta's warm base.
        Cold builds keep device references only (no added copy); warm
        builds copy the new mirrors at once, because the selective path
        needs the changed-node diff before it can pick its rows."""
        dist_d, nh_d = self._tables[0], self._tables[1]
        if dist_d.numel() * 4 + nh_d.numel() > self.WARM_MAX_TABLE_BYTES:
            self._purge_warm("table_too_large", suspect=False)
            return
        dist_h = nh_h = None
        prev = self._warm_ctx
        if self._warm_solved:
            dist_h = dist_d.cpu().numpy()
            nh_h = nh_d.cpu().numpy()
            if (
                prev is not None
                and prev["dist"] is not None
                and prev["dist"].shape == dist_h.shape
                and prev["nh"].shape == nh_h.shape
            ):
                # selection outputs can only move for rows whose
                # candidates read a changed (dist, lane, drain) cell
                changed = (prev["dist"] != dist_h) | (prev["nh"] != nh_h).any(axis=2)
                changed |= prev["enc"].overloaded != enc.overloaded
                changed |= prev["enc"].soft != enc.soft
                # a renamed slot (a replacement node on the same links) can
                # keep its distances and lanes while the name its routes
                # carry changed
                self._warm_changed_nodes = _with_slot_changes(changed, enc)
            rounds_d, rounds_l = self._warm_rounds
            self.warm_last_rounds = (int(rounds_d.max()), int(rounds_l.max()))
        self._warm_ctx = {
            "enc": enc,
            "dist": dist_h,
            "nh": nh_h,
            "degree": D,
            "tables": (dist_d, nh_d),
        }

    def _purge_warm(self, reason: str, suspect: bool = True) -> None:
        """Drop the warm context (the previous generation's tables and host
        mirrors) and make the next device build's shadow check due.
        Triggers: injected corruption, a quarantine and the full-replace
        swap, all ``suspect``: those also drop the cached SPF tables and
        the resident selection outputs, so the next device build solves
        cold; and tables too large to mirror (not suspect: the tables stay
        cached and trusted).  Only an actual drop counts as a purge."""
        key = reason.split(":", 1)[0]
        self._warm_purge_reasons[key] = self._warm_purge_reasons.get(key, 0) + 1
        if suspect:
            self._tables = None
            self._tables_enc = None
            self._tables_degree = None
            self._prev_sel = None
        if self._warm_ctx is None and self._warm_changed_nodes is None:
            return
        self._warm_ctx = None
        self._warm_changed_nodes = None
        self._warm_base_enc = None
        self.num_warm_purges += 1
        if self.governor is not None:
            self.governor.request_shadow_check(reason)

    def _warm_affected_rows(self, dv):
        """Candidate-table rows whose selection inputs can have moved in
        the last warm delta: any candidate whose (area, node) cell —
        own-area id or cross-area resolution — changed distance, lanes or
        drain state.  Every other row reproduces its previous output."""
        ch = self._warm_changed_nodes  # [A, V] bool
        row_hit = (ch[dv.cand_area, dv.cand_node] & dv.cand_ok).any(axis=1)
        cnia = dv.cand_node_in_area  # [P, C, A]
        ok3 = (cnia >= 0) & dv.cand_ok[:, :, None]
        a_idx = np.arange(ch.shape[0])[None, None, :]
        row_hit |= (ok3 & ch[a_idx, np.maximum(cnia, 0)]).any(axis=(1, 2))
        return np.nonzero(row_hit)[0]

    # -- selection over a row subset ---------------------------------------

    def _select_rows_gathered(
        self, rows, tables, dv, per_area, enc, area_link_states, prefix_state, clock
    ):
        """Gather the given candidate-table rows into a [K, C] batch, run
        the selection kernel over it and decode; shared by the incremental
        and warm-selective branches."""
        ridx = np.asarray(rows, np.int64)
        gathered = tables_from_numpy([a[ridx] for a in dv.selection_inputs()], self.device)
        outs = self._select(*tables, *gathered, per_area)
        use, shortest, lanes, valid = (o.cpu().numpy() for o in outs)
        shortest = self._fetched_metrics(shortest)
        self.last_rows["select"] = len(rows)
        clock.lap("select")
        table = self._cand_table
        return self._decode_rows(
            [(i, table.row_prefix[r]) for i, r in enumerate(rows)],
            use, shortest, lanes, valid, dv, ridx, enc, area_link_states,
            prefix_state,
        )

    # -- full build with on-device delta -----------------------------------

    def _delta_ctx_for(self, D: int, enc, dv, changed_prefixes, exact_churn: bool):
        """Eligibility + context for the on-device delta on a FULL build.
        A row may patch through from the previous RouteDb only when
        everything its decode depends on is pinned: the previous full
        build's device-resident outputs, a layout-shared encoding chain
        (same symbol tables and root-out lane order), an exact prefix
        delta (entry content the candidate columns don't encode can only
        move with churn), identical static routes, no live KSP2 prefixes
        (their routes read the whole topology) and no MPLS label pass."""
        prev = self._prev_sel
        if (
            prev is None
            or self._last_db is None
            or not exact_churn
            or self._ksp2_present
            or self.solver.enable_node_segment_label
        ):
            return None
        if prev["degree"] != D or prev["shape"] != dv.cand_ok.shape:
            return None
        prev_enc = prev["enc"]
        if prev_enc.src is not enc.src or prev_enc.areas != enc.areas:
            return None
        statics = self.solver.get_static_routes()
        snap = prev["statics"]
        if len(snap) != len(statics) or any(snap.get(k) is not v for k, v in statics.items()):
            return None
        # drain-state deltas: decode wraps the winning entry from
        # LinkState's drain lookups, so rows touching a node whose drain
        # state moved re-decode even with identical selection outputs
        # membership churn since the delta base: a slot patch keeps the
        # layout check above passing, and a renamed slot can keep
        # byte-identical selection outputs while the names and links its
        # rows decode to moved, so its rows re-decode
        node_changed = _with_slot_changes(
            (prev_enc.overloaded != enc.overloaded) | (prev_enc.soft != enc.soft), enc
        )
        force = None
        if changed_prefixes:
            rows = self._cand_table.rows_for(changed_prefixes)
            if rows:
                force = np.asarray(sorted(rows), np.int64)
        return {"outs": prev["outs"], "node_changed": node_changed, "force_rows": force}

    def _retain_prev_sel(self, outs, D: int, enc, dv) -> None:
        """Keep this full build's device outputs as the next full build's
        delta base."""
        self._prev_sel = {
            "degree": D,
            "shape": dv.cand_ok.shape,
            "outs": tuple(outs[:4]),
            "enc": enc,
            "statics": dict(self.solver.get_static_routes()),
        }

    def _delta_build(
        self, tables, cand, delta_ctx, per_area, dv, table, enc, D,
        area_link_states, prefix_state, changed_prefixes, patch_base, statics, clock,
    ):
        """Full selection fused with a diff against the previous full
        build's outputs; only the changed rows (plus the churned ones)
        cross to the host and re-decode, patched into the previous
        RouteDb."""
        (node_changed,) = tables_from_numpy((delta_ctx["node_changed"],), self.device)
        outs = self._select_delta(
            *tables, *cand, *delta_ctx["outs"], node_changed, per_area
        )
        self._retain_prev_sel(outs, D, enc, dv)
        n = int(dv.cand_ok.shape[0])
        rows = np.nonzero(outs[4].cpu().numpy())[0]
        force = delta_ctx["force_rows"]
        if force is not None:
            rows = np.union1d(rows, force)
        self.last_rows["select"] = n
        self.last_rows["fetched"] = len(rows)
        self.num_delta_rows_fetched += len(rows)
        self.num_delta_rows_skipped += n - len(rows)
        deleted = [p for p in (changed_prefixes or ()) if p not in table.pid]
        results: Dict[str, Optional[RibUnicastEntry]] = {p: None for p in deleted}
        if len(rows) > DELTA_FETCH_MAX_FRACTION * n:
            use, shortest, lanes, valid = (o.cpu().numpy()[rows] for o in outs[:4])
        elif len(rows):
            (idx_dev,) = tables_from_numpy((rows,), self.device)
            gathered = gather_selection_rows(*outs[:4], idx_dev)
            use, shortest, lanes, valid = (g.cpu().numpy() for g in gathered)
        if len(rows):
            shortest = self._fetched_metrics(shortest)
        clock.lap("select")
        if len(rows):
            row_items = [
                (i, table.row_prefix[r])
                for i, r in enumerate(rows)
                if table.row_prefix[r] is not None
            ]
            results.update(
                self._decode_rows(
                    row_items, use, shortest, lanes, valid, dv, rows, enc,
                    area_link_states, prefix_state,
                )
            )
        self.num_device_builds += 1
        self.num_delta_builds += 1
        changed_out = {table.row_prefix[r] for r in rows if table.row_prefix[r] is not None}
        changed_out.update(deleted)
        self._last_changed_prefixes = changed_out
        db = _patch_route_db(patch_base, results, statics)
        clock.lap("decode")
        return db

    # -- decode ------------------------------------------------------------

    def _decode_rows(
        self,
        row_items: List[Tuple[int, str]],
        use,  # [R', C] (R' = gathered batch or full cap)
        shortest,  # [R', A]
        lanes,  # [R', A, D]
        valid,  # [R', A]
        dv,
        gather_rows: Optional[np.ndarray],  # None = output row == table row
        enc,
        area_link_states,
        prefix_state,
    ) -> Dict[str, Optional[RibUnicastEntry]]:
        """Decode device outputs for the given (output row, prefix) pairs.
        When ``gather_rows`` is set, candidate-table columns are indexed by
        gather_rows[i]; device outputs always by i.

        Everything per-winner is vectorized up front (one object-array
        fancy-index resolves every winner name; one ufunc.at pass each
        computes the skip-if-self and min-nexthop gates) and the ECMP
        memo is keyed by the row's raw bytes: many prefixes share one
        advertiser, and their nexthop set + igp metric are fully
        determined by (v4ness, lane bits, per-area validity and metric)."""
        me = self.solver.my_node_name
        all_entries = prefix_state.prefixes()
        out_edges_by_area = [t.root_out_edges(me) for t in enc.topos]
        v4_ok = self.solver.enable_v4 or self.solver.v4_over_v6_nexthop

        R = use.shape[0]
        u_rows, u_cols = np.nonzero(use)
        u_starts = np.searchsorted(u_rows, np.arange(R + 1)).tolist()
        ti_w = gather_rows[u_rows] if gather_rows is not None else u_rows
        ai_w = dv.cand_area[ti_w, u_cols]
        nid_w = dv.cand_node[ti_w, u_cols]
        num_areas = len(enc.topos)
        max_v = max((len(t.id_to_node) for t in enc.topos), default=1)
        name_lut = np.full((num_areas, max(max_v, 1)), None, dtype=object)
        for ai, t in enumerate(enc.topos):
            name_lut[ai, : len(t.id_to_node)] = t.id_to_node
        names_obj = name_lut[ai_w, nid_w]  # [W] object
        names_w = names_obj.tolist()
        areas_w = [enc.areas[a] for a in ai_w.tolist()]
        # row gates: any-winner-is-self, min-nexthop requirement (max
        # over winners, addBestPaths SpfSolver.cpp:596-620; unset is
        # encoded 0 and never gates)
        self_any = np.zeros(R, bool)
        req = np.zeros(R, np.int64)
        if len(u_rows):
            np.logical_or.at(self_any, u_rows, names_obj == me)
            np.maximum.at(req, u_rows, dv.min_nexthop[ti_w, u_cols])
        self_l = self_any.tolist()
        req_l = req.tolist()
        comp = np.concatenate(
            [
                np.ascontiguousarray(lanes.reshape(R, -1), dtype=np.uint8),
                valid.astype(np.uint8),
                np.ascontiguousarray(shortest, dtype=np.float32)
                .view(np.uint8)
                .reshape(R, -1),
            ],
            axis=1,
        )
        nh_memo: Dict[tuple, Optional[tuple]] = {}
        drain_cache: Dict[Tuple[str, str], bool] = {}

        results: Dict[str, Optional[RibUnicastEntry]] = {}
        # KSP2 prefixes, deferred until every area's k-path memo is seeded
        # as one device batch
        ksp2_prefixes: List[str] = []
        ksp2_dests: Dict[str, list] = {}
        for i, prefix in row_items:
            c0 = u_starts[i]
            c1 = u_starts[i + 1]
            if c0 == c1:
                results[prefix] = None
                continue
            if c1 - c0 == 1:
                best = (names_w[c0], areas_w[c0])
            else:
                best = min((names_w[k], areas_w[k]) for k in range(c0, c1))
            entries = all_entries[prefix]
            # the forwarding algorithm of the MIN selection winner
            # classifies the prefix (SpfSolver.cpp:247-250)
            if (
                entries[best].forwarding_algorithm
                == PrefixForwardingAlgorithm.KSP2_ED_ECMP
            ):
                ksp2_prefixes.append(prefix)
                for k in sorted(range(c0, c1), key=lambda k: (names_w[k], areas_w[k])):
                    ksp2_dests.setdefault(areas_w[k], []).append(names_w[k])
                continue
            is_v4 = prefix_is_v4(prefix)
            if is_v4 and not v4_ok:
                results[prefix] = None
                continue
            if self_l[i]:
                results[prefix] = None  # skip-if-self (SpfSolver.cpp:253)
                continue
            key = (comp[i].tobytes(), is_v4)
            cached = nh_memo.get(key, False)
            if cached is False:
                cached = self._merged_nexthops(
                    is_v4, lanes[i], valid[i], shortest[i], out_edges_by_area
                )
                nh_memo[key] = cached
            if cached is None:
                results[prefix] = None
                continue
            total_next_hops, shortest_metric = cached
            if req_l[i] > len(total_next_hops):
                results[prefix] = None
                continue
            best_entry = entries.get(best)
            if best_entry is None:
                results[prefix] = None
                continue
            dr = drain_cache.get(best)
            if dr is None:
                dr = self.solver._is_node_drained(best, area_link_states)
                drain_cache[best] = dr
            entry = drained_entry(best_entry) if dr else best_entry
            local_considered = any(n == me for (n, _a) in entries.keys())
            results[prefix] = RibUnicastEntry(
                prefix=prefix,
                nexthops=total_next_hops,
                best_prefix_entry=entry,
                best_area=best[1],
                igp_cost=shortest_metric,
                local_prefix_considered=local_considered,
            )
        if ksp2_prefixes:
            t0 = time.perf_counter()
            self._ksp2_present = True
            for a, dests in sorted(ksp2_dests.items()):
                ai = enc.areas.index(a)
                self._ksp2_engine(a, area_link_states[a], enc.topos[ai]).seed(dests)
            for prefix in ksp2_prefixes:
                # the scalar KSP2 chain over the device-seeded k-path memo:
                # no host Dijkstra runs
                results[prefix] = self.solver.create_route_for_prefix(
                    prefix, area_link_states, prefix_state
                )
            self._ksp2_ms += (time.perf_counter() - t0) * 1e3
        return results

    def _merged_nexthops(
        self,
        is_v4,
        lanes_row,  # [A, D] for this row
        valid_row,  # [A]
        shortest_row,  # [A]
        out_edges_by_area,
    ) -> Optional[tuple]:
        """Per-area lane decode + cross-area min-metric nexthop merge
        (SpfSolver.cpp:276-302) for one distinct route signature; the
        caller memoizes the result.  Returns (frozen nexthop set, igp
        metric) or None when no usable nexthops survive."""
        me = self.solver.my_node_name
        shortest_metric = INF
        total_next_hops: set = set()
        a_idx, l_idx = np.nonzero(lanes_row)
        by_area: Dict[int, list] = {}
        for ai, lane in zip(a_idx.tolist(), l_idx.tolist()):
            by_area.setdefault(ai, []).append(lane)
        for ai, lanes_hit in by_area.items():
            if not valid_row[ai]:
                continue
            m = float(shortest_row[ai])
            out_edges = out_edges_by_area[ai]
            nhs = set()
            for lane in lanes_hit:
                if lane >= len(out_edges):
                    continue
                link, neighbor = out_edges[lane]
                nhs.add(
                    NextHop(
                        address=(
                            link.get_nh_v4_from_node(me)
                            if is_v4 and not self.solver.v4_over_v6_nexthop
                            else link.get_nh_v6_from_node(me)
                        ),
                        if_name=link.get_iface_from_node(me),
                        metric=int(m),
                        area=link.area,
                        neighbor_node_name=neighbor,
                    )
                )
            if not nhs:
                continue
            if shortest_metric >= m:
                if shortest_metric > m:
                    shortest_metric = m
                    total_next_hops.clear()
                total_next_hops |= nhs
        # the memoized value is handed to MANY RibUnicastEntry objects;
        # freeze it so no later in-place mutation of one route's
        # nexthops can corrupt its siblings
        if not total_next_hops:
            return None
        return frozenset(total_next_hops), shortest_metric
