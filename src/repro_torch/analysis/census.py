"""The census of one bucket call: what the call did, op by op.

The port's counterpart of the reference's jaxpr primitive counts
(``repro.core.tracing``).  PyTorch traces nothing, so the census watches
one real call of a bucket callable, untimed (the planner takes it on the
warm-up call of the launch that built a cache entry; the lint takes it on
zero operands at the key's shapes, ``plan.key_operands``), and records:

  ``ops``        every aten op by name (``TorchDispatchMode``)
  ``dtypes``     the dtypes of the operands and of every tensor an op made
  ``writes``     in-place writes, by the operand they land in
  ``launches``   the hand-written kernels' launches, by kernel, and the
                 device of each (``_build.observe_launches``: the kernels
                 are called through ``ctypes``, which dispatch never sees)
  ``syncs``      ops that make the host wait for the device: a scalar read
                 (``_local_scalar_dense``), ``nonzero`` and the other ops
                 whose output size depends on the data, an index or index
                 store by a boolean mask, a copy from a card to the host
  ``calls``      each call of the bucket callable (one a shard of a placed
                 launch): its device and the shapes of its operands
  bytes          the operands' and the result's ``nbytes``

Only the calling thread is watched: dispatch modes and the launch
observer are thread-local, so spatterd's other workers, launching at the
same time, are not counted.  A census is never taken inside a timed
region.  A call that fails raises out of ``take``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable

# ops that sort or rank on the device: index preprocessing belongs on the
# host (the keep mask), never in the timed call
SORT_OPS = frozenset({
    "sort", "argsort", "msort", "topk", "kthvalue", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive",
})
# ops whose result size or value the host must read before it can go on
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "is_nonzero", "equal",
    "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive",
})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                        "_index_put_impl_"})
MASK_INDEX = "index by a boolean mask"
DEVICE_TO_HOST = "copy from a card to the host"


@dataclasses.dataclass(frozen=True)
class Census:
    """What one bucket call did (module docstring)."""
    device: str                       # the launch's (first) device
    ops: dict = dataclasses.field(default_factory=dict)
    dtypes: dict = dataclasses.field(default_factory=dict)
    writes: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    launch_devices: tuple = ()        # the device of each launch, in order
    syncs: dict = dataclasses.field(default_factory=dict)
    calls: tuple = ()                 # ((device, operand shapes), ...)
    operand_bytes: int = 0
    result_bytes: int = 0

    @property
    def on_cuda(self) -> bool:
        return self.device.startswith("cuda")

    @property
    def n_launches(self) -> int:
        return sum(self.launches.values())

    def sorts(self) -> dict:
        return {op: n for op, n in self.ops.items() if op in SORT_OPS}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _storage(t) -> tuple | None:
    ptr = t.untyped_storage().data_ptr()
    return (str(t.device), ptr) if ptr else None


def _recorder(operands: dict):
    """A dispatch mode that counts into its own tables (built here so that
    importing this module imports no torch)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    owner = {}
    for name, ts in operands.items():
        for t in ts:
            where = _storage(t)
            if where is not None:
                owner.setdefault(where, name)

    def is_mask(i) -> bool:
        return (isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8))

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.dtypes = Counter(), Counter()
            self.writes, self.syncs = Counter(), Counter()
            self.calls = []

        def wrap(self, fn: Callable) -> Callable:
            """``fn`` that lists each of its calls (device, shapes)."""
            def counted(*args):
                ts = [a for a in args if isinstance(a, torch.Tensor)]
                self.calls.append((str(ts[0].device) if ts else "",
                                   tuple(tuple(t.shape) for t in ts)))
                return fn(*args)
            return counted

        def _sync(self, name, args, kwargs) -> str | None:
            if name in SYNC_OPS:
                return name
            if name in _INDEX_OPS and len(args) > 1 and any(
                    is_mask(i) for i in args[1] if i is not None):
                return MASK_INDEX
            if name == "_to_copy" and args[0].is_cuda:
                dev = kwargs.get("device")
                if dev is not None and torch.device(dev).type == "cpu":
                    return DEVICE_TO_HOST
            if (name == "copy_" and args[0].device.type == "cpu"
                    and args[1].is_cuda):
                return DEVICE_TO_HOST
            return None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            self.ops[name] += 1
            sync = self._sync(name, args, kwargs)
            if sync is not None:
                self.syncs[sync] += 1
            for i, arg in enumerate(func._schema.arguments):
                if arg.alias_info is None or not arg.alias_info.is_write:
                    continue
                val = (args[i] if i < len(args) and not arg.kwarg_only
                       else kwargs.get(arg.name))
                if isinstance(val, torch.Tensor):
                    hit = owner.get(_storage(val))
                    if hit is not None:
                        self.writes[hit] += 1
            out = func(*args, **kwargs)
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.dtypes[_dtype_name(t.dtype)] += 1
            return out

    return Recorder()


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def take(run: Callable, *, device, operands: dict,
         operand_bytes: int | None = None) -> tuple[Census, object]:
    """Run ``run(wrap)`` once under a census; returns ``(census, result)``.

    ``run`` makes the call and passes the bucket callable through ``wrap``
    (``run = lambda wrap: wrap(fn)(*args)``; a placed launch passes
    ``wrap(fn)`` to ``Placement.run``), so that each call of it, one a
    shard, is listed.  ``operands`` names the held operand tensors
    (``{"idx": [t, ...], ...}``: a placed launch lists each shard's)
    whose in-place writes are counted; ``operand_bytes`` is the launch's
    operand bytes at its global shapes (default: the sum over
    ``operands``).  ``device`` is the launch's first device.
    """
    from ..kernels import _build
    rec = _recorder(operands)
    with _build.observe_launches() as seen:
        with rec:
            result = run(rec.wrap)
    for ts in operands.values():
        for t in ts:
            rec.dtypes[_dtype_name(t.dtype)] += 1
    if operand_bytes is None:
        operand_bytes = sum(_nbytes(t) for ts in operands.values()
                            for t in ts)
    return Census(
        device=str(device), ops=dict(rec.ops), dtypes=dict(rec.dtypes),
        writes=dict(rec.writes), launches=dict(Counter(k for k, _ in seen)),
        launch_devices=tuple(d for _, d in seen), syncs=dict(rec.syncs),
        calls=tuple(rec.calls), operand_bytes=int(operand_bytes),
        result_bytes=_nbytes(result)), result


def of_key(key, fn: Callable, *, placement=None, device=None) -> Census:
    """The census of one call of bucket callable ``fn`` on zero operands
    at ``key``'s global shapes (``plan.key_operands``), made as the
    planner makes a launch: on ``device``, or through ``placement.run``
    (every shard, then the combine) when the key is placed.  Waits for the
    devices, so a failed kernel raises here."""
    import torch

    from ..plan import OPERAND_NAMES, _canonical_device, key_operands
    dev = placement.devices[0] if placement else _canonical_device(device)
    ops = key_operands(key, dev)
    names = OPERAND_NAMES[key.kind]
    nbytes = sum(_nbytes(t) for t in ops)
    if placement is None:
        census, _ = take(lambda wrap: wrap(fn)(*ops), device=dev,
                         operands={n: [t] for n, t in zip(names, ops)})
    else:
        scatter = key.kind == "scatter"
        held = ops[1:] if scatter else ops
        shards = placement.place(key.kind, held)
        dst = ops[0] if scatter else None
        scratch = placement.scratch(key.mode, dst) if scatter else None
        census, _ = take(
            lambda wrap: placement.run(wrap(fn), key.kind, key.mode, shards,
                                       scratch, dst),
            device=dev, operand_bytes=nbytes,
            operands={n: [sh[i] for sh in shards]
                      for i, n in enumerate(names[-len(held):])})
        placement.synchronize()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return census
