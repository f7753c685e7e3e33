"""Execution places and resource partitions (paper §2).

An *execution place* is a tuple ``(leader core, resource width)``: the task
runs on cores ``[leader, leader + width)``.  A *resource partition* is a set
of cores sharing a resource domain (an L2 cluster on the TX2, a socket on
Haswell, an ICI domain / pod slice on TPU).  Valid widths are per-partition
and places are width-aligned within their partition, mirroring XiTAO.

The :class:`Topology` additionally pre-computes dense index arrays over its
place list (leaders, widths, per-core local-search candidates, width-1
subset) so the PTT searches can run as vectorized argmins instead of
per-place Python loops, and interns the :class:`ExecutionPlace` objects so
the simulator hot path never re-allocates them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ExecutionPlace:
    """(leader core, width) — cores [leader, leader+width)."""

    leader: int
    width: int

    @functools.cached_property
    def cores(self) -> tuple[int, ...]:
        return tuple(range(self.leader, self.leader + self.width))

    def __repr__(self) -> str:  # matches the paper's (Cx, w) notation
        return f"(C{self.leader},{self.width})"


@dataclasses.dataclass(frozen=True)
class ResourcePartition:
    """A contiguous set of cores sharing a resource domain.

    ``kind`` identifies the hardware class (e.g. "denver", "a57", "haswell",
    "pod") — task base costs are defined per kind.  ``static_rank`` orders
    partitions by *static* (design-time) speed: rank 0 is the statically
    fastest; this is what the FA/FAM-C schedulers key on.
    """

    name: str
    kind: str
    start: int
    size: int
    widths: tuple[int, ...]
    static_rank: int = 0
    bw_domain: str = ""     # shared-memory-bandwidth domain ("" = own name)

    @property
    def domain(self) -> str:
        return self.bw_domain or self.name

    def __post_init__(self) -> None:
        for w in self.widths:
            if w <= 0 or w > self.size or self.size % w:
                raise ValueError(f"invalid width {w} for partition size {self.size}")

    @property
    def cores(self) -> tuple[int, ...]:
        return tuple(range(self.start, self.start + self.size))

    def places(self) -> Iterator[ExecutionPlace]:
        """All width-aligned execution places in this partition."""
        for w in self.widths:
            for leader in range(self.start, self.start + self.size, w):
                yield ExecutionPlace(leader, w)

    def place_containing(self, core: int, width: int) -> ExecutionPlace:
        """The aligned place of ``width`` that contains ``core``."""
        if width not in self.widths:
            raise ValueError(f"width {width} not valid for {self.name}")
        off = (core - self.start) // width * width
        return ExecutionPlace(self.start + off, width)


@dataclasses.dataclass(frozen=True)
class LiveView:
    """The surviving fraction of a topology while some capacity is revoked
    (pod-slice preemption, maintenance events) or fenced off (a control-
    plane shard restricted to its own pods).

    Precomputed index arrays mirror the Topology's dense search metadata so
    the PTT searches can run masked argmins over live places only.  A place
    is live iff *all* its cores are live — for partition-granular down-sets
    (how full revocations arrive) that reduces to the leader test, but
    sub-pod revocations may take a core subset and leave its partition
    partially up (``partial``).  Views are interned per down-set on the
    Topology (:meth:`Topology.live_view` /
    :meth:`Topology.live_view_cores`), so revoke/restore churn never
    re-allocates them.
    """

    place_idx: "np.ndarray"           # indices into topology.places()
    width1_idx: "np.ndarray"          # the width-1 subset of place_idx
    partitions: tuple[ResourcePartition, ...]   # >=1 live core, topo order
    cores: tuple[int, ...]            # live cores, in topology order
    part_cores: tuple[tuple[int, ...], ...] = ()  # live cores per partition
    partial: bool = False             # some live partition is missing cores
    core_set: frozenset = frozenset()  # O(1) membership over ``cores``

    def cores_of(self, partition: ResourcePartition) -> tuple[int, ...]:
        """Live cores of ``partition`` (must be in ``partitions``)."""
        return self.part_cores[self.partitions.index(partition)]


class Topology:
    """A machine: an ordered list of resource partitions over cores 0..N-1."""

    def __init__(self, partitions: Sequence[ResourcePartition]):
        self.partitions = tuple(partitions)
        cores: list[int] = []
        for p in self.partitions:
            cores.extend(p.cores)
        if sorted(cores) != list(range(len(cores))):
            raise ValueError("partitions must tile cores 0..N-1 exactly")
        self.n_cores = len(cores)
        self._part_of = {c: p for p in self.partitions for c in p.cores}
        self._places = tuple(pl for p in self.partitions for pl in p.places())
        self.max_width = max(w for p in self.partitions for w in p.widths)

        # dense search metadata (vectorized PTT argmins + place interning)
        self._place_idx = {(pl.leader, pl.width): i
                           for i, pl in enumerate(self._places)}
        self.place_leaders = np.array([pl.leader for pl in self._places],
                                      dtype=np.int64)
        self.place_widths = np.array([pl.width for pl in self._places],
                                     dtype=np.int64)
        self.place_widths_f = self.place_widths.astype(np.float64)
        self.width1_place_indices = np.flatnonzero(self.place_widths == 1)
        self._local_idx: dict[int, np.ndarray] = {}
        self._live_views: dict[frozenset, LiveView] = {}
        self._live_views_cores: dict[frozenset, LiveView] = {}

    def partition_of(self, core: int) -> ResourcePartition:
        return self._part_of[core]

    def places(self) -> tuple[ExecutionPlace, ...]:
        return self._places

    def place_at(self, leader: int, width: int) -> ExecutionPlace:
        """The interned (shared) place object for ``(leader, width)``."""
        return self._places[self._place_idx[(leader, width)]]

    def place_index(self, leader: int, width: int) -> int:
        return self._place_idx[(leader, width)]

    def local_places(self, core: int) -> list[ExecutionPlace]:
        """Places containing ``core`` — the *local search* candidates (one
        per valid width of the core's partition, leader kept aligned)."""
        places = self._places
        return [places[i] for i in self.local_place_indices(core)]

    def local_place_indices(self, core: int) -> np.ndarray:
        """Indices (into ``places()``) of the local-search candidates."""
        idx = self._local_idx.get(core)
        if idx is None:
            part = self.partition_of(core)
            idx = np.array(
                [self.place_index(pl.leader, pl.width)
                 for pl in (part.place_containing(core, w) for w in part.widths)],
                dtype=np.int64)
            self._local_idx[core] = idx
        return idx

    def fastest_static_partition(self) -> ResourcePartition:
        return min(self.partitions, key=lambda p: p.static_rank)

    def live_view(self, down_partitions: frozenset) -> LiveView:
        """The :class:`LiveView` with the partitions at indices
        ``down_partitions`` revoked.  Views are interned per down-set, so
        repeated revoke/restore cycles through the same configurations hit
        the cache.  Raises if *every* partition would be down — episode
        generation prunes such windows, and the schedulers need somewhere
        to place work."""
        view = self._live_views.get(down_partitions)
        if view is None:
            n = len(self.partitions)
            for i in down_partitions:
                if not 0 <= i < n:
                    raise ValueError(f"partition index {i} outside 0..{n - 1}")
            down_cores = frozenset(c for i in down_partitions
                                   for c in self.partitions[i].cores)
            view = self.live_view_cores(down_cores)
            self._live_views[down_partitions] = view
        return view

    def live_view_cores(self, down_cores: frozenset) -> LiveView:
        """Core-granular :class:`LiveView`: the cores in ``down_cores`` are
        revoked; a partition stays listed while it has at least one live
        core (``partial`` flags views where some listed partition is
        incomplete).  Partition-granular down-sets produce the exact same
        arrays :meth:`live_view` always built, so full-partition callers
        are behavior-identical through this path."""
        view = self._live_views_cores.get(down_cores)
        if view is None:
            for c in down_cores:
                if not 0 <= c < self.n_cores:
                    raise ValueError(
                        f"core {c} outside 0..{self.n_cores - 1}")
            live_parts, part_cores = [], []
            for p in self.partitions:
                cs = tuple(c for c in p.cores if c not in down_cores)
                if cs:
                    live_parts.append(p)
                    part_cores.append(cs)
            if not live_parts:
                raise ValueError("cannot revoke every partition")
            live_cores = tuple(c for cs in part_cores for c in cs)
            core_up = np.zeros(self.n_cores, dtype=bool)
            core_up[list(live_cores)] = True
            # a place is live iff all its cores are — places never cross
            # partitions, so for full-partition down-sets this is exactly
            # the old leader test
            down_cum = np.concatenate(([0], np.cumsum(~core_up)))
            idx = np.flatnonzero(
                down_cum[self.place_leaders + self.place_widths]
                == down_cum[self.place_leaders])
            w1 = idx[self.place_widths[idx] == 1]
            partial = any(len(cs) != p.size
                          for cs, p in zip(part_cores, live_parts))
            view = LiveView(idx, w1, tuple(live_parts), live_cores,
                            tuple(part_cores), partial,
                            frozenset(live_cores))
            self._live_views_cores[down_cores] = view
        return view

    def __repr__(self) -> str:
        inner = ", ".join(f"{p.name}[{p.start}:{p.start + p.size}]" for p in self.partitions)
        return f"Topology({inner})"


# ---------------------------------------------------------------------------
# Platform presets used throughout the paper's evaluation + the TPU target.
# ---------------------------------------------------------------------------

def tx2() -> Topology:
    """NVIDIA Jetson TX2: 2 Denver cores (fast, widths 1/2) + 4 ARM A57
    cores (widths 1/2/4), each cluster with its own shared L2 (paper §2)."""
    return Topology([
        ResourcePartition("denver", "denver", 0, 2, (1, 2), static_rank=0,
                          bw_domain="lpddr4"),
        ResourcePartition("a57", "a57", 2, 4, (1, 2, 4), static_rank=1,
                          bw_domain="lpddr4"),
    ])


def tx2_xl(clusters: int = 4) -> Topology:
    """Synthetic scaled-up TX2-class SoC: ``clusters`` pairs of (2-core
    Denver, 4-core A57) clusters, each pair sharing an LPDDR4-style memory
    domain.  Not a real device — a stress topology for the scheduler sweeps
    (6 x clusters cores, same asymmetry structure as the TX2)."""
    parts = []
    for i in range(clusters):
        base = 6 * i
        parts.append(ResourcePartition(
            f"denver{i}", "denver", base, 2, (1, 2), static_rank=0,
            bw_domain=f"lpddr4_{i}"))
        parts.append(ResourcePartition(
            f"a57_{i}", "a57", base + 2, 4, (1, 2, 4), static_rank=1,
            bw_domain=f"lpddr4_{i}"))
    return Topology(parts)


def _divisor_widths(size: int) -> tuple[int, ...]:
    return tuple(w for w in (1, 2, 4, 5, 8, 10, 16) if w <= size and size % w == 0)


def haswell(sockets: int = 2, cores_per_socket: int = 10) -> Topology:
    """Dual-socket 10-core Intel 2650v3 node (paper §4.2.1) — statically
    symmetric, so all partitions share static_rank 0."""
    parts = [
        ResourcePartition(
            f"socket{s}", "haswell", s * cores_per_socket, cores_per_socket,
            _divisor_widths(cores_per_socket), static_rank=0,
        )
        for s in range(sockets)
    ]
    return Topology(parts)


def haswell_cluster(nodes: int = 4, sockets: int = 2, cores_per_socket: int = 10) -> Topology:
    """4-node Haswell cluster (80 cores) used for the distributed 2D Heat."""
    parts = []
    for n in range(nodes):
        for s in range(sockets):
            start = (n * sockets + s) * cores_per_socket
            parts.append(ResourcePartition(
                f"n{n}s{s}", "haswell", start, cores_per_socket,
                _divisor_widths(cores_per_socket), static_rank=0,
            ))
    return Topology(parts)


# Static speed ranks of the TPU pod generations (rank 0 = fastest): what
# the FA/FAM-C schedulers key on in a mixed-generation fleet.
_POD_RANKS = {"pod": 0, "pod_v4": 1}


def tpu_pod_slices(pods: int = 2, slices_per_pod: int = 16,
                   kinds: Optional[Sequence[str]] = None) -> Topology:
    """TPU adaptation: each 'core' is a pod *slice* (an ICI-connected group
    of chips); a partition is a pod.  Valid widths are powers of two —
    moldability = how many slices a dispatched program spans.

    ``kinds`` assigns a generation per pod (default: all current-gen
    ``"pod"``).  A mixed fleet — e.g. ``("pod", "pod_v4", "pod_v4")``, one
    current-gen pod plus older v4 pods at roughly half its rates — is the
    statically *asymmetric* cloud configuration the preemption benchmarks
    sweep: revoking the fast pod forces criticality-aware schedulers to
    fall back to the statically-next-best live pods."""
    if kinds is None:
        kinds = ("pod",) * pods
    if len(kinds) != pods:
        raise ValueError(f"kinds has {len(kinds)} entries for {pods} pods")
    for k in kinds:
        if k not in _POD_RANKS:
            raise ValueError(f"unknown pod kind {k!r}; "
                             f"known: {', '.join(sorted(_POD_RANKS))}")
    widths = tuple(w for w in (1, 2, 4, 8, 16)
                   if w <= slices_per_pod and slices_per_pod % w == 0)
    parts = [
        ResourcePartition(f"pod{p}", kinds[p], p * slices_per_pod,
                          slices_per_pod, widths,
                          static_rank=_POD_RANKS[kinds[p]])
        for p in range(pods)
    ]
    return Topology(parts)
