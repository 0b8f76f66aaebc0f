"""The axis rules of a gather/scatter placement: the port of
``repro.runtime.sharding.gs_specs`` (only its gather/scatter table; the
model-side logical-axis rules are not ported).

A spec is a tuple with one entry per leading dim of an operand: the name
of the placement axis that dim splits over, or ``None`` (whole on every
shard); trailing ``None``s are stripped, so ``()`` is fully replicated,
as the reference's ``PartitionSpec()``.  ``plan.Placement.place`` cuts
every operand by these specs and nothing else, so this table is the one
statement of which operand splits on which axis.
"""
from __future__ import annotations

Spec = tuple


def _gs_spec(*axes: str | None) -> Spec:
    """Spec from per-dim axes, trailing Nones stripped (so a degenerate
    axis gives exactly the 1-D spec)."""
    entries = list(axes)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def gs_specs(kind: str, *, batched: bool, batch_axis: str | None = None,
             lane_axis: str | None = None) -> tuple[tuple[Spec, ...], Spec]:
    """(in_specs, out_spec) of a gather/scatter launch on a ``(batch,
    lane)`` placement; either axis may be ``None`` (degenerate).

    Batched operands (one bucket launch of B patterns): dim 0 is the
    pattern batch and splits over ``batch_axis``; the flattened lane dim
    (dim 1 of idx, vals, keep and of a gather's output) splits over
    ``lane_axis``.  Tables are replicated along the lane axis: every lane
    shard may read (gather) or write (scatter) any row of its pattern's
    table, so a gather's src and a scatter's dst and result split by batch
    only, and a pattern never straddles batch shards.

    Unbatched operands (one pattern, ``GSEngine.sharded``): the lane dim
    is dim 0 of idx, vals, keep and of a gather's output; the table and a
    scatter's result are replicated.  There is no batch dim to split, so
    ``batch_axis`` must be ``None``.

    A scatter takes four operands (dst, idx, vals, keep).  The host keep
    mask rides with the indices: it is computed over the whole padded lane
    buffer before the split, so across all lane shards at most one write
    per row survives, which is what makes the store combine an exact
    select.
    """
    if kind not in ("gather", "scatter"):
        raise ValueError(f"kind must be gather|scatter, got {kind!r}")
    b, l = batch_axis, lane_axis
    if batched:
        if kind == "gather":
            # src (B, F, R), idx (B, N) -> out (B, N, R)
            return (_gs_spec(b), _gs_spec(b, l)), _gs_spec(b, l)
        # dst (B, F, R), idx (B, N), vals (B, N, R), keep (B, N) -> (B, F, R)
        return ((_gs_spec(b), _gs_spec(b, l), _gs_spec(b, l),
                 _gs_spec(b, l)), _gs_spec(b))
    if b is not None:
        raise ValueError("unbatched operands have no pattern-batch dim to "
                         f"split (batch_axis={b!r})")
    if kind == "gather":
        # src (F, R) replicated, idx (N,) -> out (N, R)
        return (_gs_spec(None), _gs_spec(l)), _gs_spec(l)
    # dst (F, R) replicated, idx, vals and keep lane-split -> out replicated
    return ((_gs_spec(None), _gs_spec(l), _gs_spec(l), _gs_spec(l)),
            _gs_spec(None))


def shard_of(x, spec: Spec, coords: dict[str, tuple[int, int]]):
    """The block of ``x`` that the shard at ``coords`` holds: for each dim
    that ``spec`` names an axis for, part ``i`` of ``n`` equal parts,
    where ``coords[axis] == (i, n)``.  Returns a view."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        i, n = coords[axis]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split "
                             f"into {n} shards")
        x = x.narrow(dim, i * (size // n), size // n)
    return x
