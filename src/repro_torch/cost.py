"""Predicted memory traffic of a bucket launch, and the placement choice
of ``mesh="auto"``: the geometry part of ``repro.analysis.cost``.

Prices come from ``ExecKey`` geometry alone (or a plan's buckets at a
``(batch, lane)`` shard shape), split by cause:

  ``useful``      the paper's useful bytes of the member patterns
  ``pad``         lane data of pad lanes and scratch patterns
  ``index``       the int32 index operand
  ``table``       the table at the padded batch (a gather reads it, a
                  scatter reads dst and writes its result)
  ``keep``        a scatter's host keep mask
  ``replicated``  extra table copies along the lane axis: tables split by
                  batch only (``sharding.gs_specs``), so every lane shard
                  holds one

``device_bytes`` (launch-boundary bytes plus replication) is what
``select_shape`` minimises.  The reference's backends map to the port's:
``pallas`` to ``hopper`` and ``xla`` to ``torch``.  As the reference does
for ``pallas``, a ``hopper`` lane split is charged no replication bytes
(its shards run the kernel on their own lanes), so each choice equals the
reference's; its combine still moves one table a lane shard, which the
model does not count.  The calibration, the cost report and its baseline
build on these prices in ``analysis.cost``.
"""
from __future__ import annotations

import dataclasses

TIE_TOL = 0.05                  # relative device-bytes tie band

_INDEX_BYTES = 4                # int32 index operand
_KEEP_BYTES = 1                 # bool keep mask
_LANE_SPLIT_BACKENDS = ("hopper",)   # lane shards move no replication bytes


@dataclasses.dataclass(frozen=True)
class UnitCost:
    """Traffic of one ``(bucket, placement)`` launch, in the reference's
    report schema; ``-1`` marks what is not known: useful and pad bytes
    need the member patterns, ``lowered_bytes`` (the bytes a census saw
    cross the launch: operands plus result; the reference's lowered
    signature) a census, ``predicted_gbs`` a calibration."""
    exec_key: str
    label: str = ""
    backend: str = ""
    kind: str = ""
    placement: str = ""
    batch: int = 0
    lanes: int = 0
    n_members: int = -1
    useful_bytes: int = -1
    pad_bytes: int = -1
    index_bytes: int = 0
    table_bytes: int = 0
    keep_bytes: int = 0
    replicated_bytes: int = 0
    io_bytes: int = 0
    device_bytes: int = 0
    lowered_bytes: int = -1
    predicted_gbs: float = -1.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "UnitCost":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(doc) - known
        if bad:
            raise ValueError(f"unknown UnitCost fields: {sorted(bad)}")
        return cls(**doc)


def _repl_shards(backend: str | None, lane_shards: int) -> int:
    return 1 if backend in _LANE_SPLIT_BACKENDS else lane_shards


def key_cost(key, *, real_elems: int = -1, n_members: int = -1,
             lowered_bytes: int = -1, calibration=None,
             label: str = "") -> UnitCost:
    """Traffic of the launch ``key`` names, from its geometry alone;
    ``real_elems`` (the members' summed ``count * index_len``) splits the
    lane data into useful and pad.  With a ``calibration``
    (``analysis.cost.Calibration``) that measured ``key.backend``, the
    predicted rate is its measured rate scaled by useful over device
    bytes."""
    import torch

    from .plan import pad_lanes, placement_grid
    _, l_shards, _ = placement_grid(key.placement)
    lanes = pad_lanes(key.idx_len, l_shards)
    e = getattr(torch, key.dtype).itemsize
    r = key.row_width
    lane_elems = key.batch * lanes
    lane_data = lane_elems * e * r
    index_b = lane_elems * _INDEX_BYTES
    table_b = key.batch * (key.footprint + 1) * r * e
    scatter = key.kind == "scatter"
    keep_b = lane_elems * _KEEP_BYTES if scatter else 0
    copies = 2 if scatter else 1
    io_b = copies * table_b + index_b + lane_data + keep_b
    repl_b = copies * table_b * (_repl_shards(key.backend, l_shards) - 1)
    useful = real_elems * e * r if real_elems >= 0 else -1
    gbs = -1.0
    if calibration is not None and useful > 0:
        rate = calibration.bw_gbs.get(key.backend, 0.0)
        if rate > 0:
            gbs = rate * useful / (io_b + repl_b)
    return UnitCost(
        exec_key=str(key), label=label, backend=key.backend, kind=key.kind,
        placement=key.placement, batch=key.batch, lanes=lanes,
        n_members=n_members, useful_bytes=useful,
        pad_bytes=lane_data - useful if useful >= 0 else -1,
        index_bytes=index_b, table_bytes=table_b, keep_bytes=keep_b,
        replicated_bytes=repl_b, io_bytes=io_b, device_bytes=io_b + repl_b,
        lowered_bytes=lowered_bytes, predicted_gbs=gbs)


def shape_cost(plan, shape=(1, 1), *, elem_bytes: int = 4,
               row_width: int = 1, backend: str | None = None) -> dict:
    """Predicted traffic of a plan at a ``(batch, lane)`` shard shape:
    ``key_cost`` summed over its buckets, from the plan alone."""
    from .plan import pad_batch, pad_lanes
    b, l = int(shape[0]), int(shape[1])
    l_repl = _repl_shards(backend, l)
    useful = pad = index_b = table_b = keep_b = repl_b = 0
    for bucket in plan.buckets:
        batch = pad_batch(len(bucket.members), b)
        lanes = pad_lanes(bucket.spec.idx_len, l)
        real = sum(plan.patterns[i].count * plan.patterns[i].index_len
                   for i in bucket.members)
        lane_elems = batch * lanes
        scatter = bucket.spec.kind == "scatter"
        copies = 2 if scatter else 1
        table = batch * (bucket.spec.footprint + 1) * row_width * elem_bytes
        useful += real * elem_bytes * row_width
        pad += (lane_elems - real) * elem_bytes * row_width
        index_b += lane_elems * _INDEX_BYTES
        table_b += copies * table
        keep_b += lane_elems * _KEEP_BYTES if scatter else 0
        repl_b += copies * table * (l_repl - 1)
    io_b = useful + pad + index_b + table_b + keep_b
    return {"shape": [b, l], "useful_bytes": useful, "pad_bytes": pad,
            "index_bytes": index_b, "table_bytes": table_b,
            "keep_bytes": keep_b, "replicated_bytes": repl_b,
            "io_bytes": io_b, "device_bytes": io_b + repl_b,
            "overhead": (io_b + repl_b) / useful if useful else float("inf")}


def candidate_shapes(n_devices: int) -> list[tuple[int, int]]:
    """``(1, 1)`` plus every 2-D split of the full device count."""
    shapes = [(1, 1)]
    if n_devices > 1:
        for b in range(1, n_devices + 1):
            if n_devices % b == 0:
                shapes.append((b, n_devices // b))
    return shapes


def select_shape(plan, *, n_devices: int = 1, elem_bytes: int = 4,
                 row_width: int = 1,
                 backend: str | None = None) -> tuple[int, int]:
    """The shard shape of least predicted ``device_bytes``; shapes within
    ``TIE_TOL`` of the least tie, and a tie goes to more batch shards
    (whole patterns a device, bit-identical results), never to lane
    shards."""
    shapes = candidate_shapes(n_devices)
    costs = {s: shape_cost(plan, s, elem_bytes=elem_bytes,
                           row_width=row_width, backend=backend)
             ["device_bytes"]
             for s in shapes}
    best = min(costs.values())
    tied = [s for s in shapes if costs[s] <= best * (1 + TIE_TOL)]
    return max(tied, key=lambda s: (s[0], -s[1]))


def auto_placement(patterns_or_plan, *, n_devices: int, dtype=None,
                   row_width: int = 1, backend: str | None = None):
    """The shard shape ``mesh="auto"`` takes for a plan (or a pattern
    list) over ``n_devices``: a ``(batch, lane)`` tuple, or ``None`` for
    ``(1, 1)`` (unplaced, the ``ExecKey`` placement ``""``)."""
    import torch

    from .plan import SuitePlan
    plan = patterns_or_plan
    if not hasattr(plan, "buckets"):
        plan = SuitePlan.build(list(patterns_or_plan))
    eb = (torch.float32 if dtype is None else dtype).itemsize
    shape = select_shape(plan, n_devices=n_devices, elem_bytes=eb,
                         row_width=row_width, backend=backend)
    return None if shape == (1, 1) else shape
