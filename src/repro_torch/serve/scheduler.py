"""Concurrent, coalescing work-unit scheduler for the port's spatterd.

The port of ``repro.serve.scheduler`` over the port's work units
(``plan.BucketWork`` / ``launch`` / ``demux``):

* ``submit(works)`` enqueues one item per ``BucketWork`` onto a BOUNDED
  queue (``QueueFull`` when it would overflow; the daemon answers 503 +
  Retry-After before any device work) and returns a ``SuiteTicket`` the
  handler thread waits on.

* Worker threads drain the queue with **bucket-affinity batching**: a
  worker pops the head item (FIFO leader), then sweeps the queue for
  items sharing its coalesce key, ``(BucketWork.family, runs)``, and
  stacks them into ONE padded launch.  The batch-polymorphic cache serves
  any pow-2 bracket, and member rows are assembled per work with its own
  seed, so each member's buffers, and so its digest, are those of the
  serial ``run_plan`` path.  Coalescing is capped by the per-suite
  assembly budget (``schema.MAX_SUITE_LANES``) and ``MAX_COALESCE_MEMBERS``.

* Telemetry stays EXACT.  ``launch`` reports whether it built the bucket
  callable (``LaunchResult.compiled``); the scheduler attributes that
  build to the launch leader's ticket, so ``sum(ticket.misses)`` over any
  set of requests equals the cache's ``misses`` delta.  Other
  participants count a hit.  Per-ticket ``queued_ms`` (worst item wait),
  ``lock_wait_ms`` (time its launches waited for the device's lock,
  ``plan.device_lock``) and ``coalesced_launches`` make the scheduling
  observable.

The leader is always the oldest queued item; a swept item only jumps the
line to ride the leader's launch.  ``pause()``/``resume()`` gate the
workers without touching the queue (tests stage a full queue with them);
``stop()`` drains (queued and in-flight work completes, then the workers
exit), ``stop(drain=False)`` fails queued tickets with
``SchedulerStopped``.  ONE condition variable (``self._cv``) guards the
queue, the counters and every ticket; launches run outside it.

Fault tolerance: workers are supervised (an exception escaping the item
loop is counted in ``dead_workers`` and the thread replaced,
``respawned``); a ticket may carry a deadline (work still queued past it
fails with ``DeadlineExceeded`` and never launches; the daemon answers
504); a family whose launches fail ``QUARANTINE_AFTER`` consecutive times
is quarantined (its items fail fast with ``FamilyQuarantined``); and
``cancel(ticket)`` removes an abandoned request's queued items.  A launch
that raises (a failed build, a CUDA error) fails its tickets; nothing is
retried on the CPU or on a plain version.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ..plan import (BucketWork, ExecutorCache, default_cache, demux,
                    launch)
from .schema import MAX_SUITE_LANES

# serving defaults, importable by daemon/CLI and pinned by tests
DEFAULT_WORKERS = 2
DEFAULT_MAX_QUEUE = 256        # queued BucketWork items, not requests
MAX_COALESCE_MEMBERS = 1024    # pattern rows one coalesced launch may carry
QUARANTINE_AFTER = 3           # consecutive launch failures -> quarantine


class QueueFull(RuntimeError):
    """submit() would overflow the bounded queue — backpressure, not
    failure.  ``.depth`` is the queue depth observed; the daemon turns
    this into 503 + Retry-After."""

    def __init__(self, depth: int, limit: int):
        super().__init__(f"scheduler queue full ({depth}/{limit} items)")
        self.depth = depth
        self.limit = limit


class SchedulerStopped(RuntimeError):
    """The scheduler is stopping/stopped and accepts no new work."""


class DeadlineExceeded(RuntimeError):
    """The ticket's deadline passed while its work was still queued —
    nothing launched for the expired items.  The daemon maps this to
    504 (the request's ``deadline_ms``)."""


class RequestCancelled(RuntimeError):
    """The ticket was cancelled (``Scheduler.cancel``) — typically the
    daemon abandoning a request whose client is gone."""


class FamilyQuarantined(RuntimeError):
    """This work family failed ``QUARANTINE_AFTER`` consecutive launches
    and is quarantined: items fail fast instead of launching (clear with
    ``Scheduler.clear_quarantine``)."""


def _work_cost(work: BucketWork) -> int:
    """A work unit's assembly budget in the schema's units: lanes (or
    footprint, whichever dominates) x row_width, summed over members —
    the same quantity ``SuiteRequest.build_patterns`` bounds per
    request, so the coalescing cap below speaks the wire schema's
    language."""
    return sum(max(p.count * p.index_len, p.footprint()) * work.row_width
               for p in work.patterns)


class _Item:
    """One queued BucketWork plus its bookkeeping (slots: the queue can
    hold hundreds of these)."""
    __slots__ = ("ticket", "work", "key", "cost", "t_enq")

    def __init__(self, ticket: "SuiteTicket", work: BucketWork):
        self.ticket = ticket
        self.work = work
        self.key = (work.family, work.runs)   # coalesce identity
        self.cost = _work_cost(work)
        self.t_enq = time.perf_counter()


class SuiteTicket:
    """A submitted request's handle: wait on it, then read results.

    ``results`` maps suite position -> RunResult (complete when ``done``
    is set without ``error``).  Counters mirror the serial daemon's
    per-request cache telemetry: ``misses`` is the exact number of
    compiles attributed to THIS request (it claimed the build),
    ``hits`` the warm serves, ``launches`` how many bucket launches its
    work rode, ``coalesced_launches`` how many of those were shared
    with other requests, ``queued_ms`` the worst queue wait among its
    items, ``lock_wait_ms`` the time its launches waited for the device.
    All mutation happens under the owning scheduler's lock.

    ``deadline`` is an absolute ``time.monotonic()`` instant (or None):
    a worker reaching a queued item past it retires the item with
    ``DeadlineExceeded`` instead of launching.
    """

    def __init__(self, n_works: int, deadline: float | None = None):
        self.results: dict[int, object] = {}
        self.hits = 0
        self.misses = 0
        self.launches = 0
        self.coalesced_launches = 0
        self.queued_ms = 0.0
        self.lock_wait_ms = 0.0
        self.deadline = deadline
        self.error: BaseException | None = None
        self.done = threading.Event()
        self._pending = n_works

    def wait(self, timeout: float | None = None) -> "SuiteTicket":
        """Block until the ticket resolves; re-raise its failure."""
        if not self.done.wait(timeout):
            raise TimeoutError("scheduler ticket not resolved in time")
        if self.error is not None:
            raise self.error
        return self

    def telemetry(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "launches": self.launches,
            "coalesced_launches": self.coalesced_launches,
            "queued_ms": self.queued_ms,
            "lock_wait_ms": self.lock_wait_ms,
        }


class Scheduler:
    """Bounded-queue, multi-worker, bucket-affinity-coalescing executor
    over ``plan.launch``/``plan.demux`` (module docstring)."""

    def __init__(self, cache: ExecutorCache | None = None, *,
                 workers: int = DEFAULT_WORKERS,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 max_coalesce_cost: int = MAX_SUITE_LANES,
                 max_coalesce_members: int = MAX_COALESCE_MEMBERS,
                 faults=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.cache = cache if cache is not None else default_cache()
        self.max_queue = max_queue
        self.max_coalesce_cost = max_coalesce_cost
        self.max_coalesce_members = max_coalesce_members
        self._faults = faults          # FaultInjector | None (serve/faults)
        self._cv = threading.Condition()
        self._queue: deque[_Item] = deque()
        self._paused = False
        self._stopping = False
        self._busy = 0
        self._n_workers = workers
        self._fail_streak: dict = {}   # family -> consecutive launch fails
        self._quarantined: set = set()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.deadline_expired = 0
        self.dead_workers = 0
        self.respawned = 0
        self.total_launches = 0
        self.coalesced_launches = 0
        self.lock_wait_ms = 0.0
        self._threads = [
            threading.Thread(target=self._run_worker,
                             name=f"spatterd-worker-{i}", daemon=True)
            for i in range(workers)
        ]
        # snapshot: a worker killed at its loop top appends its OWN
        # replacement (already started) to _threads while this loop runs
        for t in list(self._threads):
            t.start()

    # -- submission ----------------------------------------------------------
    def submit(self, works: list[BucketWork], *,
               deadline_s: float | None = None) -> SuiteTicket:
        """Enqueue one request's work units; returns its ticket.

        Raises ``QueueFull`` (backpressure) or ``SchedulerStopped``
        BEFORE accepting anything — a request is queued whole or not at
        all, so a ticket's ``_pending`` accounting can never be split
        across an overflow.

        ``deadline_s`` (relative, seconds) arms a queue deadline: items
        still queued when it passes are retired with
        ``DeadlineExceeded`` — they never launch.  Work already
        in-flight at expiry finishes (a launch cannot be
        cancelled midway); its result is discarded by the failed ticket.
        """
        if not works:
            raise ValueError("submit needs at least one work unit")
        ticket = SuiteTicket(len(works),
                             deadline=(time.monotonic() + deadline_s
                                       if deadline_s is not None else None))
        items = [_Item(ticket, w) for w in works]
        with self._cv:
            if self._stopping:
                raise SchedulerStopped("scheduler is stopping")
            if len(self._queue) + len(items) > self.max_queue:
                raise QueueFull(len(self._queue), self.max_queue)
            self._queue.extend(items)
            self.submitted += 1
            self._cv.notify_all()
        return ticket

    # -- worker loop ---------------------------------------------------------
    def _run_worker(self) -> None:
        """Supervised worker shell.  An exception escaping ``_worker``'s
        item loop used to kill the thread silently, shrinking the pool
        forever; now it is counted (``dead_workers``) and the thread
        replaced (``respawned``) — chaos tests kill workers through the
        fault harness and assert the pool recovers.  Item-level failures
        never get here: ``_execute`` resolves them into their tickets.
        """
        try:
            self._worker()
            return                         # clean exit: stopping
        except BaseException:
            pass
        replacement = None
        with self._cv:
            self.dead_workers += 1
            if not self._stopping:
                self.respawned += 1
                replacement = threading.Thread(
                    target=self._run_worker,
                    name=f"spatterd-worker-r{self.respawned}", daemon=True)
                self._threads.append(replacement)
        if replacement is not None:
            replacement.start()

    def _worker(self) -> None:
        while True:
            # the worker-kill fault fires BEFORE taking from the queue,
            # so a killed worker can never strand claimed items
            if self._faults is not None:
                self._faults.check("worker")
            with self._cv:
                while not self._stopping \
                        and (self._paused or not self._queue):
                    self._cv.wait()
                if not self._queue:            # stopping and drained
                    return
                batch = self._take_locked()
                if batch:
                    self._busy += 1
            if not batch:                      # head items were all dead
                continue
            try:
                self._execute(batch)
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _take_locked(self) -> list[_Item]:
        """Pop the FIFO leader plus every queued item sharing its
        coalesce key, within the assembly-cost and member caps.  Dead
        head items are retired on the spot before a leader is chosen:
        ticket already failed (their request got its 500 from an
        earlier launch), deadline passed (``DeadlineExceeded`` — the
        item never launches), or family quarantined
        (``FamilyQuarantined`` fail-fast)."""
        now = time.monotonic()
        while self._queue:
            head = self._queue[0]
            t = head.ticket
            if t.error is not None:
                self._finish_locked(self._queue.popleft())
            elif t.deadline is not None and now > t.deadline:
                self.deadline_expired += 1
                self._fail_locked(self._queue.popleft(), DeadlineExceeded(
                    "deadline expired while queued; work never launched"))
            elif head.key[0] in self._quarantined:
                self._fail_locked(self._queue.popleft(), FamilyQuarantined(
                    f"work family quarantined after {QUARANTINE_AFTER} "
                    f"consecutive launch failures: {head.key[0]}"))
            else:
                break
        if not self._queue:
            return []
        leader = self._queue.popleft()
        batch = [leader]
        cost = leader.cost
        members = leader.work.n_members
        for it in list(self._queue):
            if it.key != leader.key or it.ticket.error is not None:
                continue
            if it.ticket.deadline is not None and now > it.ticket.deadline:
                continue               # expired: head loop retires it
            if cost + it.cost > self.max_coalesce_cost:
                continue
            if members + it.work.n_members > self.max_coalesce_members:
                continue
            self._queue.remove(it)
            batch.append(it)
            cost += it.cost
            members += it.work.n_members
        return batch

    def _finish_locked(self, item: _Item) -> None:
        """Retire one item of a ticket; resolves the ticket when it was
        the last."""
        t = item.ticket
        t._pending -= 1
        if t._pending == 0 and not t.done.is_set():
            if t.error is None:
                self.completed += 1
            t.done.set()

    def _fail_locked(self, item: _Item, exc: BaseException) -> None:
        """Fail an item's whole ticket immediately: the handler thread
        gets its 500 now; the ticket's still-queued items are retired
        as dead when a worker reaches them."""
        t = item.ticket
        if t.error is None:
            t.error = exc
            self.failed += 1
        if not t.done.is_set():
            t.done.set()
        t._pending -= 1

    def _execute(self, batch: list[_Item]) -> None:
        """Run one (possibly coalesced) launch and demux per ticket.

        Launch failures feed the quarantine ledger: ``QUARANTINE_AFTER``
        consecutive failures of one family (reset by any success)
        quarantine it, so a poison bucket stops reaching the workers.
        """
        t_start = time.perf_counter()
        works = [it.work for it in batch]
        family = batch[0].key[0]
        try:
            # the launch fault site: injected exceptions/latency land
            # exactly where a real launch failure would
            if self._faults is not None:
                self._faults.check("launch")
            result = launch(works, self.cache)
            demuxed, offset = [], 0
            for it in batch:
                demuxed.append(demux(result, it.work, offset))
                offset += it.work.n_members
        except BaseException as exc:
            with self._cv:
                self.total_launches += 1
                streak = self._fail_streak.get(family, 0) + 1
                self._fail_streak[family] = streak
                if streak >= QUARANTINE_AFTER:
                    self._quarantined.add(family)
                for it in batch:
                    self._fail_locked(it, exc)
            return
        shared = len(batch) > 1
        with self._cv:
            self.total_launches += 1
            self._fail_streak.pop(family, None)
            if shared:
                self.coalesced_launches += 1
            lock_wait_ms = result.lock_wait_s * 1e3
            self.lock_wait_ms += lock_wait_ms
            for i, it in enumerate(batch):
                t = it.ticket
                if t.error is None:
                    for pos, r in demuxed[i]:
                        t.results[pos] = r
                t.launches += 1
                if shared:
                    t.coalesced_launches += 1
                t.lock_wait_ms += lock_wait_ms
                # the build (if any) belongs to the launch leader:
                # serve_poly_info said whether THIS launch ran the
                # builder, so summed ticket misses == cache misses
                if i == 0 and result.compiled:
                    t.misses += 1
                else:
                    t.hits += 1
                t.queued_ms = max(t.queued_ms,
                                  (t_start - it.t_enq) * 1e3)
                self._finish_locked(it)

    # -- control plane -------------------------------------------------------
    def cancel(self, ticket: SuiteTicket,
               exc: BaseException | None = None) -> int:
        """Abandon a ticket: remove its still-queued items and resolve it.

        The abandoned-ticket fix: a handler whose ``ticket.wait``
        timed out (client gone) previously left queued items live, so
        workers later launched work nobody would read.  Returns the
        number of queued items removed.  In-flight items finish (their
        results are discarded by the failed ticket); a ticket that
        already completed cleanly is left untouched.
        """
        exc = exc if exc is not None else RequestCancelled(
            "request cancelled; queued work removed")
        removed = 0
        with self._cv:
            if ticket.done.is_set() and ticket.error is None:
                return 0
            for it in [i for i in self._queue if i.ticket is ticket]:
                self._queue.remove(it)
                self._fail_locked(it, exc)
                removed += 1
            newly = False
            if ticket.error is None:
                ticket.error = exc
                self.failed += 1
                newly = True
            if not ticket.done.is_set():
                ticket.done.set()
                newly = True
            if removed or newly:
                self.cancelled += 1
        return removed

    def clear_quarantine(self) -> int:
        """Drop every quarantine + failure streak (operator reset after
        fixing the underlying cause); returns families released."""
        with self._cv:
            n = len(self._quarantined)
            self._quarantined.clear()
            self._fail_streak.clear()
        return n

    def pause(self) -> None:
        """Stop workers from taking NEW batches (in-flight ones finish).
        Submissions still queue; tests stage a full queue under pause to
        make coalescing deterministic."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Shut the workers down.  With ``drain`` (default) queued and
        in-flight work completes and every ticket resolves before the
        workers exit; with ``drain=False`` queued tickets fail with
        ``SchedulerStopped`` (in-flight launches still finish — a
        launch cannot be cancelled midway)."""
        with self._cv:
            self._stopping = True
            self._paused = False
            if not drain:
                while self._queue:
                    self._fail_locked(self._queue.popleft(),
                                      SchedulerStopped("scheduler stopped"))
            self._cv.notify_all()
            threads = list(self._threads)   # respawns append concurrently
        for t in threads:
            t.join(timeout=timeout)

    def snapshot(self) -> dict:
        """Queue/worker occupancy + lifetime counters (GET /stats).

        ``workers`` is the configured pool size; ``alive_workers`` the
        threads currently running (supervision keeps them equal outside
        the instant between a death and its respawn); ``dead_workers``/
        ``respawned`` the supervisor's lifetime ledger.
        """
        with self._cv:
            return {
                "workers": self._n_workers,
                "alive_workers": sum(1 for t in self._threads
                                     if t.is_alive()),
                "dead_workers": self.dead_workers,
                "respawned": self.respawned,
                "busy": self._busy,
                "queue_depth": len(self._queue),
                "max_queue": self.max_queue,
                "paused": self._paused,
                "stopping": self._stopping,
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "deadline_expired": self.deadline_expired,
                "quarantined_families": len(self._quarantined),
                "total_launches": self.total_launches,
                "coalesced_launches": self.coalesced_launches,
                "lock_wait_ms": self.lock_wait_ms,
            }
