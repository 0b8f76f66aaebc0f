"""Client for the port's spatterd (stdlib ``http.client``; see daemon.py).

A copy of ``repro.serve.client``: the wire format is the reference's, so
either client can drive either daemon.  Library::

    from repro_torch.serve import SpatterClient
    c = SpatterClient("http://127.0.0.1:8089")
    r1 = c.run_suite(json.load(open("suites/demo.json")), backend="hopper")
    r2 = c.run_suite(json.load(open("suites/demo.json")), backend="hopper")
    assert r2["cache"]["misses"] == 0            # warm: nothing built
    assert [t["digest"] for t in r1["stats"]["table"]] == \
           [t["digest"] for t in r2["stats"]["table"]]   # bit-identical

CLI::

    PYTHONPATH=src python -m repro_torch.serve.client \
        --url http://127.0.0.1:8089 --json suites/demo.json -b hopper
    PYTHONPATH=src python -m repro_torch.serve.client \
        --url http://127.0.0.1:8089 --stats

Transport: ONE keep-alive ``http.client.HTTPConnection`` per (client,
thread), in ``threading.local`` storage, because one client is often
shared by submitter threads and a connection is not thread-safe.
Idempotent GETs retry a few times on connection errors (a restarted
daemon leaves a dead keep-alive socket).  POSTs never retry on network
errors: a /run may have executed before the connection died.  A 503 is
the daemon's own pre-execution backpressure answer (the run never took a
queue slot), so with ``retries_503 > 0`` the client retries it with
jittered exponential back-off floored by the server's ``Retry-After``;
the default stays fail-fast.  Imports nothing but the stdlib.
"""
from __future__ import annotations

import argparse
import http.client
import json
import random
import threading
import time
from urllib.parse import urlsplit

from .schema import SuiteRequest, parse_mesh

# connection-error retries for idempotent GETs (total attempts = 1 + this)
GET_RETRIES = 2


def _retry_after_s(header: str | None) -> float | None:
    # delta-seconds form only; spatterd never emits the HTTP-date form
    if header is None:
        return None
    try:
        return max(0.0, float(header))
    except ValueError:
        return None


class ServerError(RuntimeError):
    """A failed spatterd exchange; ``.status`` is the HTTP code (0 when
    the daemon could not be reached at all), ``.doc`` the parsed error
    body when there was one, ``.retry_after`` the server's Retry-After
    hint in seconds (None when absent)."""

    def __init__(self, status: int, message: str, *,
                 doc: dict | None = None,
                 retry_after: float | None = None):
        prefix = f"spatterd returned {status}" if status \
            else "cannot reach spatterd"
        super().__init__(f"{prefix}: {message}")
        self.status = status
        self.doc = doc
        self.retry_after = retry_after


class SpatterClient:
    def __init__(self, url: str, timeout: float = 600.0, *,
                 retries_503: int = 0, backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0,
                 backoff_seed: int | None = None):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.retries_503 = retries_503
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._rng = random.Random(backoff_seed)
        parts = urlsplit(self.url if "//" in self.url
                         else "//" + self.url)
        if parts.scheme not in ("", "http"):
            raise ValueError(f"unsupported URL scheme {parts.scheme!r}; "
                             f"spatterd speaks plain http")
        if not parts.hostname:
            raise ValueError(f"URL {url!r} has no host")
        self._host = parts.hostname
        self._port = parts.port if parts.port is not None else 80
        self._prefix = parts.path.rstrip("/")
        self._local = threading.local()

    # -- connection management ----------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _drop(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close THIS thread's cached connection (each thread owns its
        own; a shared client's other threads are unaffected)."""
        self._drop()

    # -- transport -----------------------------------------------------------
    def _request(self, path: str, body: dict | None = None) -> dict:
        payload = None if body is None else json.dumps(body).encode()
        method = "GET" if payload is None else "POST"
        # GETs are idempotent by construction (the daemon's read-only
        # endpoints): retry across dead keep-alive sockets.  POST /run is
        # not: one attempt, the caller decides about replays.
        attempts = 1 + (GET_RETRIES if method == "GET" else 0)
        err: Exception | None = None
        conn_tries = 0
        tries_503 = 0
        while conn_tries < attempts:
            conn = self._conn()
            try:
                conn.request(method, self._prefix + path, body=payload,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                # covers ConnectionError/reset/refused, timeouts, and
                # half-closed keep-alive sockets (BadStatusLine /
                # RemoteDisconnected); drop the socket and maybe retry
                self._drop()
                err = e
                conn_tries += 1
                continue
            if resp.will_close:
                self._drop()
            retry_after = _retry_after_s(resp.getheader("Retry-After"))
            if (resp.status == 503 and method == "POST"
                    and tries_503 < self.retries_503):
                # 503 is the daemon's PRE-execution verdict (queue full /
                # draining): the run never started, so this is the one
                # POST replay that cannot double work
                time.sleep(self._backoff_s(tries_503, retry_after))
                tries_503 += 1
                continue
            if resp.status >= 400:
                doc = None
                try:
                    doc = json.loads(data)
                    msg = doc.get("error", "")
                except (ValueError, AttributeError):
                    msg = ""
                raise ServerError(resp.status,
                                  msg or f"{resp.status} {resp.reason}",
                                  doc=doc if isinstance(doc, dict) else None,
                                  retry_after=retry_after)
            return json.loads(data)
        raise ServerError(0, f"{self.url}: {err}")

    @staticmethod
    def _shape_suite(patterns, options) -> dict:
        if isinstance(patterns, str):
            patterns = json.loads(patterns)
        if isinstance(patterns, dict):          # envelope document
            return {**patterns, **options}
        return {"patterns": list(patterns), **options}

    def _backoff_s(self, attempt: int, retry_after: float | None) -> float:
        """Jittered exponential delay for 503 retry number ``attempt``,
        floored by the server's Retry-After hint, capped last so the
        client's patience bounds even a pathological server hint."""
        base = self.backoff_base_s * (2 ** attempt) * \
            (0.5 + self._rng.random())
        if retry_after is not None:
            base = max(base, retry_after)
        return min(base, self.backoff_cap_s)

    # -- endpoints -----------------------------------------------------------
    def health(self) -> dict:
        return self._request("/healthz")

    def readyz(self) -> dict:
        """Readiness document (GET /readyz).  Unlike the other verbs a
        not-ready 503 is a normal answer here, not a failure: the doc is
        returned either way and the caller reads ``doc["ready"]``."""
        try:
            return self._request("/readyz")
        except ServerError as e:
            if e.status == 503 and e.doc is not None:
                return e.doc
            raise

    def cache(self) -> dict:
        return self._request("/cache")

    def stats(self) -> dict:
        """Live serving stats (GET /stats): lifetime cache counters plus
        the scheduler snapshot — queue depth, worker occupancy, total and
        coalesced launch counts (null on a workers=0 daemon)."""
        return self._request("/stats")

    def lint(self) -> dict:
        """GET /lint (the port answers 501 until ROADMAP A3)."""
        return self._request("/lint")

    def cost(self) -> dict:
        """GET /cost (the port answers 501 until ROADMAP A3)."""
        return self._request("/cost")

    def run_suite(self, patterns, **options) -> dict:
        """POST a suite; ``patterns`` is a list of suite-JSON dicts, a
        full ``{"patterns": [...], ...}`` envelope, or a JSON string of
        either, and ``options`` are the SuiteRequest fields (backend=,
        runs=, mode=, metric=, mesh=, stream_r=, ...) — keyword options
        override same-named envelope fields.

        The request is validated client-side first, so a typo'd option
        fails fast with the same message the server would give.
        """
        doc = self._shape_suite(patterns, options)
        return self._request("/run", SuiteRequest.from_json(doc).to_json())

    def warm(self, patterns, **options) -> dict:
        """POST a suite to /warm: compile (or disk-restore) and prime
        every executable the suite needs WITHOUT running a measured
        suite: the restart-recovery verb.  Same patterns/options shapes
        as :meth:`run_suite`."""
        doc = self._shape_suite(patterns, options)
        return self._request("/warm", SuiteRequest.from_json(doc).to_json())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="POST a JSON suite to a running spatterd, or query "
                    "its serving stats")
    ap.add_argument("--url", default="http://127.0.0.1:8089")
    ap.add_argument("--json", default=None, help="suite file (paper §3.3)")
    ap.add_argument("--stats", action="store_true",
                    help="print the daemon's /stats document (cache "
                         "counters + scheduler queue/worker snapshot) "
                         "instead of posting a suite")
    ap.add_argument("--warm", action="store_true",
                    help="POST the suite to /warm (compile + prime every "
                         "executable, no measured runs) instead of /run")
    ap.add_argument("--deadline-ms", type=int, default=None,
                    help="per-request queue deadline; an expiry before "
                         "launch returns 504 without running anything")
    ap.add_argument("--retries-503", type=int, default=0,
                    help="retry a backpressure 503 this many times with "
                         "jittered exponential backoff (Retry-After "
                         "honored); default fail-fast")
    # option defaults are None = "not given": an envelope suite file's own
    # fields must not be silently overridden by CLI defaults
    ap.add_argument("-b", "--backend", default=None)
    ap.add_argument("-r", "--runs", type=int, default=None)
    ap.add_argument("--mode", default=None, help="scatter mode store|add")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="N|BxL|auto",
                    help="placement over the daemon's devices: N "
                         "(batch axis), BxL (batch x lane), 'auto' or "
                         "'auto-suite'")
    ap.add_argument("--row-width", type=int, default=None)
    ap.add_argument("--metric", default=None,
                    help="gbs column: measured")
    ap.add_argument("--seed", type=int, default=None,
                    help="host-buffer RNG seed")
    ap.add_argument("--stream-r", action="store_true",
                    help="also time the STREAM-like reference")
    ap.add_argument("--stream-n", type=int, default=None,
                    help="STREAM reference size (elements)")
    ap.add_argument("--no-digest", action="store_true",
                    help="skip the per-pattern output digests")
    args = ap.parse_args(argv)
    c = SpatterClient(args.url, retries_503=args.retries_503)
    if args.stats:
        if args.json is not None:
            ap.error("--stats is a read-only verb; drop --json")
        try:
            print(json.dumps(c.stats(), indent=2, sort_keys=True))
        except ServerError as e:
            raise SystemExit(f"error: {e}")
        return
    if args.json is None:
        ap.error("--json SUITE required (or use --stats)")
    opts = {name: v for name, v in
            [("backend", args.backend), ("runs", args.runs),
             ("mode", args.mode), ("mesh", args.mesh),
             ("row_width", args.row_width), ("metric", args.metric),
             ("seed", args.seed), ("stream_n", args.stream_n),
             ("deadline_ms", args.deadline_ms)]
            if v is not None}
    if args.stream_r:
        opts["stream_r"] = True
    if args.no_digest:
        opts["digest"] = False
    # ValueError covers client-side schema rejections AND a malformed
    # --json file (JSONDecodeError): both get the same clean one-liner
    # a server-rejected request would
    try:
        with open(args.json) as f:
            pats = json.load(f)
        if args.warm:
            print(json.dumps(c.warm(pats, **opts), indent=2,
                             sort_keys=True))
            return
        resp = c.run_suite(pats, **opts)
    except (ServerError, ValueError) as e:
        raise SystemExit(f"error: {e}")
    print_response(resp)


def print_response(resp: dict) -> None:
    stats, cache = resp["stats"], resp["cache"]

    def _n(x):
        # to_json serializes non-finite floats as null (strict JSON)
        return float("nan") if x is None else x

    print(f"device: {stats['device']}")
    print(f"{'name':24s} {'type':16s} {'GB/s':>10s} {'digest':>12s}")
    for row in stats["table"]:
        print(f"{row['name']:24s} {row['type']:16s} "
              f"{_n(row['measured_gbs']):10.2f} "
              f"{(row['digest'] or '')[:12]:>12s}")
    extra = ""
    if stats.get("stream_gbs") is not None:
        extra = f"   stream {_n(stats['stream_gbs']):.2f} GB/s"
    print(f"\nsuite: min {_n(stats['min_gbs']):.2f}  "
          f"max {_n(stats['max_gbs']):.2f}  "
          f"harmonic-mean {_n(stats['hmean_gbs']):.2f} GB/s{extra}")
    sched = ""
    if resp.get("serve"):
        sv = resp["serve"]
        sched = (f"  queued {sv['queued_ms']:.0f}ms  "
                 f"launches {sv['launches']} "
                 f"({sv['coalesced_launches']} coalesced)")
    print(f"serve: {resp['plan']['n_buckets']} buckets  "
          f"pad waste {resp['plan']['pad_waste']:.1%}  "
          f"cache hits {cache['hits']} misses {cache['misses']} "
          f"(exact builds this request)  {resp['elapsed_s']:.2f}s"
          f"{sched}")


if __name__ == "__main__":
    main()
