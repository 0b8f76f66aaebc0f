"""spatterd on the port: a long-lived suite server on the warm ExecutorCache.

The port of ``repro.serve.daemon``, the process that makes repeated
execution the product: it holds one ``ExecutorCache`` open across HTTP
requests, so the FIRST request of a suite builds ``n_buckets`` bucket
callables and every later one, from any client, builds none, and each
response carries the telemetry that proves it (per-request cache
hits/misses, where ``misses`` is an exact build count, plus per-pattern
output digests).  It runs on the card through the hand-written kernels
(``backend: "hopper"``) unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``), where those kernels' plain versions
run; without CUDA the default raises.  Its placements (``mesh``) are laid
over ``devices`` (default: every CUDA device; on the CPU one CPU), a list
in which a device may repeat.

Endpoints (all JSON; stdlib ``http.server``), the reference's wire format:

    POST /run      run a suite (schema.SuiteRequest; bare ``suites/*.json``
                   lists work as-is).  503 + ``Retry-After`` when the
                   scheduler's queue is full; ``deadline_ms`` arms a queue
                   deadline answered with 504 when it expires first.
                   ``mesh``: N or [b, l] places every bucket launch on
                   the daemon's devices (``plan.Placement``); 0 or
                   ``auto`` picks a placement per bucket, ``auto-suite``
                   one for the suite (the cost model; one device gives
                   the unplaced keys); a mesh of more devices than the
                   daemon has is a 400 naming the count.
    POST /warm     build (or restore) every bucket callable a suite needs
                   and call each once on zero buffers; nothing is timed
    GET  /healthz  liveness + device/backend inventory + lifetime stats
    GET  /readyz   readiness: 503 while the disk preload runs, the
                   scheduler is paused, or a drain is in progress
    GET  /cache    lifetime ExecutorCache counters
    GET  /stats    cache counters + scheduler snapshot + disk tier, fault
                   injection, kernel launches and nvcc runs
    GET  /lint     spatterlint over the live cache: every entry audited
                   from the census its first call kept (``analysis.lint.
                   lint_cache``); read-only, runs nothing
    GET  /cost     spattercost over the live cache (``analysis.cost.
                   cost_cache``); read-only, runs nothing

Fault tolerance: ``cache_dir=`` attaches the crash-safe disk tier
(``diskcache.DiskTier``: exec entries and the nvcc-built libraries),
preloaded on a background thread at startup, so a restarted daemon serves
a suite it has seen with ``misses == 0`` and no nvcc run; SIGTERM begins a
graceful drain (readiness off, queued and in-flight requests complete and
answer, then the port closes and the process exits 0); ``faults=`` arms
the deterministic fault injection (``serve.faults``) at the build, launch,
worker, disk and load sites.

Quickstart::

    PYTHONPATH=src python -m repro_torch.serve.daemon --port 8089 &
    PYTHONPATH=src python -m repro_torch.serve.client \\
        --url http://127.0.0.1:8089 --json suites/demo.json -b hopper

Concurrency: request handling is multi-threaded (``ThreadingHTTPServer``)
and execution goes through the coalescing scheduler (``serve.scheduler``):
each request becomes ``BucketWork`` items on a bounded queue, worker
threads stack items of one family (placement included) into one launch,
and the handler waits on its ticket.  Launches hold the lock of every
device they use (``plan.device_locks``, in one order) while they have work
on it, so a timed region holds only its own launch; the STREAM reference
and ``/warm``'s first calls take the same locks.
``workers=0`` keeps the serial baseline: one run lock, telemetry from
cache-stats deltas.
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .faults import ENV_SPEC, FaultInjector
from .scheduler import (DEFAULT_MAX_QUEUE, DEFAULT_WORKERS, DeadlineExceeded,
                        QueueFull, Scheduler, SchedulerStopped)
from .schema import SuiteRequest

# how long a handler waits on its ticket before answering 500: far above
# any admissible suite, so it fires only on a wedged device
TICKET_TIMEOUT_S = 600.0

# extra wait past a request's own deadline before the handler abandons
# the ticket itself (covers a paused or fully busy pool)
DEADLINE_GRACE_S = 0.25

# how long a drain waits for in-flight requests to answer
DRAIN_TIMEOUT_S = 600.0


def _bounded_put(memo: dict, key, value, bound: int = 32) -> None:
    """FIFO-bounded insert: client-controlled memo keys must never grow a
    long-lived daemon's memory without limit."""
    while len(memo) >= bound:
        memo.pop(next(iter(memo)))
    memo[key] = value


class SpatterDaemon:
    """The serving process around one ExecutorCache.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``start()`` serves from a background thread; ``serve_forever()``
    blocks (the CLI path).  ``device=None`` means ``"cuda"``: unplaced
    launches run there.  ``devices`` lists the devices placements are laid
    over (repeats allowed; default every CUDA device, or the one CPU);
    its first is then the unplaced device.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8089, *,
                 cache=None, quiet: bool = True,
                 workers: int = DEFAULT_WORKERS,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 cache_dir: str | None = None,
                 faults: FaultInjector | None = None, device=None,
                 devices=None):
        import torch

        from ..plan import _canonical_device, default_cache
        self.device = _canonical_device(devices[0] if devices else device)
        if devices:
            self.devices = [_canonical_device(d) for d in devices]
        elif self.device.type == "cuda":
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        else:
            self.devices = [self.device]
        self.cache = cache if cache is not None else default_cache()
        self.quiet = quiet
        self.started_at = time.time()
        self.n_requests = 0
        self.faults = faults
        if faults is not None and self.cache.fault_hook is None:
            self.cache.fault_hook = faults.check
        self.disk = None
        if cache_dir:
            from ..diskcache import DiskTier
            mangle = ((lambda payload: faults.mangle("disk", payload))
                      if faults is not None else None)
            self.disk = DiskTier(cache_dir, device=self.device,
                                 mangle=mangle)
        # readiness is not liveness: _ready is set once the disk preload
        # finished; _draining flips on SIGTERM/stop
        self._ready = threading.Event()
        self._draining = False
        self._drained = threading.Event()
        self.scheduler = None if workers == 0 else Scheduler(
            self.cache, workers=workers, max_queue=max_queue, faults=faults)
        self._run_lock = threading.Lock()
        self._memo_lock = threading.Lock()     # guards _stream_refs
        self._state_lock = threading.Condition()   # counters, _inflight
        self._inflight = 0                     # POSTs not yet answered
        self._stream_refs: dict[tuple, object] = {}   # memoized STREAM runs
        self._thread: threading.Thread | None = None
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True

    # -- lifecycle -----------------------------------------------------------
    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _load(self) -> None:
        """Background loader: preload the disk tier (restored entries count
        ``disk_hits``, never ``misses``), then flip readiness on.  A failed
        preload leaves the daemon ready but cold."""
        try:
            if self.faults is not None:
                self.faults.check("load")
            if self.disk is not None:
                n = self.cache.attach_disk(self.disk, preload=True)
                self._log("restored %d bucket(s) from %s", n, self.disk.root)
        except Exception as e:
            self._log("disk preload failed (serving cold): %s", e)
        finally:
            self._ready.set()

    def _start_loader(self) -> None:
        threading.Thread(target=self._load, name="spatterd-loader",
                         daemon=True).start()

    def start(self) -> "SpatterDaemon":
        self._start_loader()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="spatterd", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._start_loader()
        self._httpd.serve_forever()

    def begin_drain(self) -> None:
        """SIGTERM entry point: readiness off now, the blocking drain on a
        helper thread (``shutdown()`` must not run on the serving thread,
        which the signal frame interrupts in the CLI path)."""
        self._draining = True
        threading.Thread(target=self.stop, name="spatterd-drain",
                         daemon=True).start()

    def stop(self) -> None:
        """Graceful drain: stop accepting connections, let queued and
        in-flight work finish and every in-flight request answer, then
        release the port."""
        self._draining = True
        self._httpd.shutdown()
        if self.scheduler is not None:
            self.scheduler.stop(drain=True)
        with self._state_lock:
            self._state_lock.wait_for(lambda: self._inflight == 0,
                                      timeout=DRAIN_TIMEOUT_S)
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._drained.set()

    def wait_drained(self, timeout: float | None = None) -> bool:
        return self._drained.wait(timeout)

    def __enter__(self) -> "SpatterDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _enter_request(self) -> None:
        with self._state_lock:
            self._inflight += 1

    def _leave_request(self) -> None:
        with self._state_lock:
            self._inflight -= 1
            self._state_lock.notify_all()

    # -- request execution ---------------------------------------------------
    def _resolve_mesh(self, req: SuiteRequest, plan):
        """The request's placements, one ``Placement | None`` a bucket of
        ``plan``.  An explicit N or [b, l] places every bucket; ``auto``
        (and a mesh of 0) picks a shape per bucket and ``auto-suite`` one
        for the suite, through the cost model over the daemon's devices
        (``plan.auto_placements``), so an auto-placed bucket runs under
        exactly the keys an explicit mesh of its shape would.  A mesh of
        more devices than the daemon has raises ValueError (a 400)."""
        from ..plan import Placement, auto_placements
        if req.mesh in ("auto", "auto-suite") or not req.mesh:
            placed = auto_placements(
                plan, "auto" if not req.mesh else req.mesh,
                mesh_axis=req.mesh_axis, backend=req.backend,
                row_width=req.row_width, devices=self.devices)
            if isinstance(placed, list):
                return placed
            return [placed] * plan.n_buckets
        return [Placement.create(req.mesh, batch_axis=req.mesh_axis,
                                 devices=self.devices)] * plan.n_buckets

    def _stream_ref_for(self, req: SuiteRequest):
        """Memoized STREAM reference RunResult for a stream_r request, per
        (backend, n, runs): only the first such request times it.  It
        runs under the device's lock like any launch."""
        from ..plan import device_lock
        from ..suite import stream_reference
        skey = (req.backend, req.stream_n, req.runs)
        with self._memo_lock:
            ref = self._stream_refs.get(skey)
        if ref is None:
            with device_lock(self.device):
                ref = stream_reference(n=req.stream_n, runs=req.runs,
                                       backend=req.backend,
                                       device=self.device)
            with self._memo_lock:
                _bounded_put(self._stream_refs, skey, ref)
        return ref

    def run_request(self, req: SuiteRequest) -> dict:
        """Execute one validated request; returns the response document.

        Raises ValueError for request-shaped problems (a bad pattern, a
        mesh of several devices; the handler answers 400),
        ``QueueFull``/``SchedulerStopped`` for backpressure (503),
        ``DeadlineExceeded`` (504), and lets execution failures propagate
        (500).
        """
        # wait for the startup preload: serving a known suite while its
        # entries are still restoring would break the misses == 0 proof
        self._ready.wait(TICKET_TIMEOUT_S)
        from ..plan import SuitePlan
        patterns = req.build_patterns()
        plan = SuitePlan.build(patterns)
        mesh = self._resolve_mesh(req, plan)
        if self.scheduler is None:
            doc = self._run_serial(req, patterns, mesh)
        else:
            doc = self._run_scheduled(req, plan, mesh)
        with self._state_lock:
            self.n_requests += 1
        return doc

    def _run_scheduled(self, req: SuiteRequest, plan, mesh) -> dict:
        """Submit the request's work units and wait.  ``elapsed_s`` covers
        submit to resolve, queue wait included (``serve.queued_ms``).  A
        ticket abandoned by its deadline or a timeout is cancelled, so no
        worker launches work nobody will read."""
        from ..plan import make_work
        from ..suite import aggregate_stats
        t0 = time.perf_counter()
        stream_ref = self._stream_ref_for(req) if req.stream_r else None
        works = make_work(plan, backend=req.backend, runs=req.runs,
                          row_width=req.row_width, mode=req.mode,
                          seed=req.seed, digest=req.digest,
                          device=self.device, mesh=mesh)
        deadline_s = req.deadline_ms / 1e3 if req.deadline_ms else None
        ticket = self.scheduler.submit(works, deadline_s=deadline_s)
        wait_s = (TICKET_TIMEOUT_S if deadline_s is None
                  else min(TICKET_TIMEOUT_S, deadline_s + DEADLINE_GRACE_S))
        try:
            ticket.wait(wait_s)
        except TimeoutError:
            self.scheduler.cancel(ticket)
            if deadline_s is not None:
                raise DeadlineExceeded(
                    f"deadline_ms={req.deadline_ms} expired before the "
                    f"request's work launched") from None
            raise
        results = [ticket.results[i] for i in range(len(plan.patterns))]
        stats = aggregate_stats(results, metric=req.metric, plan=plan,
                                stream_ref=stream_ref)
        return self._response(req, stats, mesh,
                              hits=ticket.hits, misses=ticket.misses,
                              serve=ticket.telemetry(),
                              elapsed_s=time.perf_counter() - t0)

    def _run_serial(self, req: SuiteRequest, patterns, mesh) -> dict:
        """The ``workers=0`` baseline: one run lock, telemetry from
        cache-stats deltas bracketing the run."""
        from ..suite import run_suite
        with self._run_lock:
            t0 = time.perf_counter()
            stream_ref = self._stream_ref_for(req) if req.stream_r else None
            before = self.cache.stats()
            stats = run_suite(
                patterns, backend=req.backend, runs=req.runs,
                row_width=req.row_width, metric=req.metric, mode=req.mode,
                seed=req.seed, cache=self.cache, stream_r=req.stream_r,
                stream_n=req.stream_n, stream_ref=stream_ref,
                digest=req.digest, device=self.device, mesh=mesh)
            after = self.cache.stats()
        delta = after.delta(before)
        return self._response(req, stats, mesh,
                              hits=delta.hits, misses=delta.misses,
                              serve=None,
                              elapsed_s=time.perf_counter() - t0)

    def _response(self, req: SuiteRequest, stats, mesh, *, hits: int,
                  misses: int, serve: dict | None,
                  elapsed_s: float) -> dict:
        # the placements the run used, as the reference reports them: one
        # per bucket for auto (and mesh 0), else the one every bucket took
        names = [m.placement if m is not None else "single" for m in mesh]
        placement = names if req.mesh in ("auto", 0) else names[0]
        lifetime = self.cache.stats()
        return {
            "ok": True,
            "stats": stats.to_json(req.metric),
            "cache": {
                # this request's traffic; misses == exact build count
                "hits": hits,
                "misses": misses,
                "size": lifetime.size,
                "lifetime": lifetime.to_json(),
            },
            "plan": {
                "n_buckets": stats.plan.n_buckets,
                "pad_waste": stats.plan.pad_waste_for(mesh),
                "placement": placement,
            },
            # scheduler telemetry (null on the workers=0 baseline)
            "serve": serve,
            "elapsed_s": elapsed_s,
        }

    def warm(self, req: SuiteRequest) -> dict:
        """POST /warm: build (or restore) every bucket callable the suite
        needs, then call each once on zero buffers at its served batch,
        under the device's lock; a new entry's call runs as its launch
        would (through its placement's shards) and keeps its census
        (``analysis.census.of_key``).  Nothing is timed."""
        import torch

        from ..analysis.census import of_key
        from ..plan import (SuitePlan, bucket_key, build_bucket,
                            device_locks, key_operands)
        t0 = time.perf_counter()
        self._ready.wait(TICKET_TIMEOUT_S)
        patterns = req.build_patterns()
        plan = SuitePlan.build(patterns)
        placements = self._resolve_mesh(req, plan)
        before = self.cache.stats()
        compiled = 0
        for bucket, pl in zip(plan.buckets, placements):
            key = bucket_key(req.backend, bucket.spec, torch.float32,
                             req.row_width, req.mode, len(bucket.members),
                             pl)
            dev = pl.devices[0] if pl else self.device
            fn, served, built = self.cache.serve_poly_info(
                key, lambda key=key, dev=dev: build_bucket(
                    req.backend, key.kind, key.mode, dev, self.cache.disk))
            compiled += built
            with device_locks(pl.devices if pl else (dev,)):
                if built:
                    self.cache.set_census(served, of_key(
                        served, fn, placement=pl, device=dev))
                else:
                    fn(*key_operands(served, dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        delta = self.cache.stats().delta(before)
        with self._state_lock:
            self.n_requests += 1
        return {
            "ok": True,
            "n_executables": plan.n_buckets,
            "compiled": compiled,
            "cache": {"hits": delta.hits, "misses": delta.misses,
                      "disk_hits": delta.disk_hits, "degraded": 0,
                      "lifetime": self.cache.stats().to_json()},
            "elapsed_s": time.perf_counter() - t0,
        }

    def readiness(self) -> dict:
        """GET /readyz: can this process take NEW traffic right now?"""
        snap = (self.scheduler.snapshot()
                if self.scheduler is not None else None)
        loading = not self._ready.is_set()
        paused = bool(snap and snap["paused"])
        draining = self._draining or bool(snap and snap["stopping"])
        ready = not (loading or paused or draining)
        return {"ok": ready, "ready": ready, "loading": loading,
                "paused": paused, "draining": draining}

    def stats(self) -> dict:
        """GET /stats: lifetime cache counters, scheduler state, disk tier
        and fault injection, and the kernels' launch and build counts."""
        from ..kernels import _build
        with _build._count_lock:
            kernels = {"launches": dict(_build.launches),
                       "nvcc_runs": _build.nvcc_runs}
        return {
            "ok": True,
            "n_requests": self.n_requests,
            "uptime_s": time.time() - self.started_at,
            "cache": self.cache.stats().to_json(),
            "scheduler": (self.scheduler.snapshot()
                          if self.scheduler is not None else None),
            "disk": self.disk.stats() if self.disk is not None else None,
            "faults": (self.faults.snapshot()
                       if self.faults is not None else None),
            "kernels": kernels,
        }

    def lint(self) -> dict:
        """GET /lint: spatterlint over the live cache, from the census each
        entry kept from its first call.  Read-only: runs nothing, takes no
        device lock, and moves neither the cache's counters nor its LRU
        order, so it may run beside requests."""
        from ..analysis.lint import lint_cache
        report = lint_cache(self.cache)
        return {"ok": report.ok, "report": report.to_json()}

    def cost(self) -> dict:
        """GET /cost: the traffic of every live cache entry, held against
        its census and the committed baseline; an entry restored from
        disk has no census and gets its key's geometry only.  Read-only,
        as ``lint``."""
        from ..analysis.cost import cost_cache
        report = cost_cache(self.cache)
        return {"ok": report.ok, "report": report.to_json()}

    def health(self) -> dict:
        from .. import backends as B
        from ..engine import device_name
        return {
            "ok": True,
            "service": "spatterd",
            "device": device_name(self.device),
            "n_devices": len(self.devices),
            "backends": sorted(B.BACKENDS),
            "n_requests": self.n_requests,
            "uptime_s": time.time() - self.started_at,
            "cache": self.cache.stats().to_json(),
        }

    def _log(self, fmt: str, *args) -> None:
        if not self.quiet:
            print(f"spatterd: {fmt % args}", flush=True)


MAX_BODY_BYTES = 64 << 20     # one request can't OOM a long-lived daemon


def _make_handler(daemon: SpatterDaemon):
    class Handler(BaseHTTPRequestHandler):
        server_version = "spatterd/1.0"
        protocol_version = "HTTP/1.1"
        # a stalled upload or idle keep-alive connection must not pin a
        # handler thread forever
        timeout = 120

        def log_message(self, fmt, *args):
            daemon._log(fmt, *args)

        def _reply(self, code: int, doc: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._reply(200, daemon.health())
            elif self.path == "/readyz":
                doc = daemon.readiness()
                self._reply(200 if doc["ready"] else 503, doc)
            elif self.path == "/cache":
                self._reply(200, {"ok": True,
                                  "cache": daemon.cache.stats().to_json()})
            elif self.path == "/stats":
                self._reply(200, daemon.stats())
            elif self.path == "/lint":
                self._reply(200, daemon.lint())
            elif self.path == "/cost":
                self._reply(200, daemon.cost())
            else:
                self._reply(404, {"ok": False,
                                  "error": f"no such path {self.path!r}"})

        def do_POST(self):
            daemon._enter_request()
            try:
                self._post()
            finally:
                daemon._leave_request()

        def _post(self):
            # a body we cannot fully drain would desync HTTP/1.1
            # keep-alive: bad framing gets an error AND a closed connection
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                self.close_connection = True
                self._reply(411, {"ok": False,
                                  "error": "chunked bodies unsupported; "
                                           "send Content-Length"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length < 0:
                    raise ValueError(length)
            except (TypeError, ValueError):
                self.close_connection = True
                self._reply(400, {"ok": False,
                                  "error": "bad Content-Length header"})
                return
            if length > MAX_BODY_BYTES:
                self.close_connection = True
                self._reply(413, {"ok": False,
                                  "error": f"body {length} bytes > "
                                           f"{MAX_BODY_BYTES} limit"})
                return
            # drain the body unconditionally: on keep-alive an unread body
            # would be parsed as the NEXT request's start line
            body = self.rfile.read(length)
            if self.path not in ("/run", "/warm"):
                self._reply(404, {"ok": False,
                                  "error": f"no such path {self.path!r}; "
                                           f"POST /run or /warm"})
                return
            try:
                doc = json.loads(body)
                req = SuiteRequest.from_json(doc)
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"ok": False, "error": f"bad request: {e}"})
                return
            try:
                if self.path == "/warm":
                    self._reply(200, daemon.warm(req))
                else:
                    self._reply(200, daemon.run_request(req))
            except (QueueFull, SchedulerStopped) as e:
                # backpressure, decided before the run took a queue slot
                retry = 1 if isinstance(e, SchedulerStopped) else max(
                    1, round(e.depth / max(1, e.limit) * 5))
                self._reply(503, {"ok": False, "error": str(e),
                                  "retry_after_s": retry},
                            headers={"Retry-After": str(retry)})
            except DeadlineExceeded as e:
                self._reply(504, {"ok": False, "error": str(e),
                                  "deadline_ms": req.deadline_ms})
            except ValueError as e:
                self._reply(400, {"ok": False, "error": str(e)})
            except Exception as e:   # execution failure: report, stay alive
                self._reply(500, {"ok": False,
                                  "error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.daemon",
        description="spatterd on the port: a long-lived Spatter suite "
                    "server (warm ExecutorCache across requests)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8089)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--workers", type=int, default=DEFAULT_WORKERS,
                    help="scheduler worker threads (0 = serial run-lock "
                         "baseline)")
    ap.add_argument("--max-queue", type=int, default=DEFAULT_MAX_QUEUE,
                    help="bounded scheduler queue (BucketWork items); "
                         "overflow returns 503 + Retry-After")
    ap.add_argument("--cache-dir", default=None,
                    help="disk tier: bucket recipes and the nvcc-built "
                         "libraries; a restarted daemon preloads it and "
                         "serves suites it has seen with 0 builds and no "
                         "nvcc run")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec, e.g. "
                         "'compile:fail:1,worker:kill:2' (default: env "
                         f"{ENV_SPEC}); see repro_torch.serve.faults")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for injected-latency jitter")
    ap.add_argument("--verbose", action="store_true",
                    help="log one line per handled request")
    args = ap.parse_args(argv)
    faults = (FaultInjector.from_spec(args.faults, seed=args.fault_seed)
              if args.faults else FaultInjector.from_env())
    daemon = SpatterDaemon(args.host, args.port, quiet=not args.verbose,
                           workers=args.workers, max_queue=args.max_queue,
                           cache_dir=args.cache_dir, faults=faults,
                           device=args.device)

    def _on_sigterm(signum, frame):
        daemon.begin_drain()

    signal.signal(signal.SIGTERM, _on_sigterm)
    print(f"spatterd listening on {daemon.url}  (device {daemon.device}; "
          f"POST /run /warm, GET /healthz /readyz /stats /lint /cost)",
          flush=True)
    try:
        daemon.serve_forever()
        daemon.wait_drained(DRAIN_TIMEOUT_S + 60)
        print("spatterd drained cleanly", flush=True)
    except KeyboardInterrupt:
        daemon.stop()


if __name__ == "__main__":
    main()
