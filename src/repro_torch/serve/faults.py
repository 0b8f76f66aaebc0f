"""Deterministic fault injection for the port's spatterd.

A copy of ``repro.serve.faults`` (stdlib only; the port imports nothing
of the JAX package).  Chaos testing proves something only if the chaos
is reproducible: a ``FaultInjector`` is a seeded registry of fault rules
consulted at fixed sites in the serving stack, so tests can drive every
recovery path (a failed build, a launch exception, injected latency,
disk corruption, a worker kill) and a failing run replays exactly from
its spec and seed.

Spec grammar (env ``SPATTERD_FAULTS`` or ``--faults``)::

    site:action:times[:arg][,site:action:times[:arg]...]

    compile:fail:1            the first bucket build raises InjectedFault
    launch:fail:3             the first three launches raise
    launch:delay:2:0.05       two launches sleep ~0.05 s (seeded jitter)
    worker:kill:1             one worker thread dies (supervisor respawns)
    disk:corrupt:1            one persisted entry is bit-flipped
    load:fail:1               the startup disk preload raises once

Sites are consulted via ``check(site)`` (which may sleep or raise) and
``mangle(site, payload)`` (the disk tier's corruption hook).  Each rule
fires at most ``times`` times; exhausted rules pass cleanly, so a test
injects exactly N faults and then observes recovery.  All decisions are
made under one lock; sleeping happens outside it.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time

ENV_SPEC = "SPATTERD_FAULTS"
SITES = ("compile", "launch", "worker", "disk", "load")
ACTIONS = ("fail", "kill", "delay", "corrupt")


class InjectedFault(RuntimeError):
    """An exception raised on purpose by the fault harness."""


class WorkerKilled(InjectedFault):
    """Worker-kill flavor: escapes the item loop to kill the thread."""


@dataclasses.dataclass
class _Rule:
    site: str
    action: str
    times: int
    arg: float = 0.0
    triggered: int = 0


def _parse_rule(part: str) -> _Rule:
    bits = part.strip().split(":")
    if not 3 <= len(bits) <= 4:
        raise ValueError(f"bad fault rule {part!r}: want "
                         f"site:action:times[:arg]")
    site, action, times = bits[0], bits[1], bits[2]
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r} (sites: {SITES})")
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r} "
                         f"(actions: {ACTIONS})")
    try:
        n = int(times)
    except ValueError:
        n = -1
    if n < 1:
        raise ValueError(f"fault times must be a positive int, got {times!r}")
    arg = 0.0
    if len(bits) == 4:
        try:
            arg = float(bits[3])
        except ValueError:
            raise ValueError(f"bad fault arg {bits[3]!r} in {part!r}")
    return _Rule(site=site, action=action, times=n, arg=arg)


class FaultInjector:
    """Seeded, counted fault rules consulted at fixed sites.

    Thread safe: rule selection and counters live under one lock;
    injected latency sleeps OUTSIDE it so a delay fault cannot serialize
    unrelated sites through the injector.
    """

    def __init__(self, rules, seed: int = 0):
        self._rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._consults: dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        rules = [_parse_rule(p) for p in spec.split(",") if p.strip()]
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls, environ=None) -> "FaultInjector | None":
        environ = os.environ if environ is None else environ
        spec = environ.get(ENV_SPEC, "").strip()
        if not spec:
            return None
        return cls.from_spec(spec, seed=int(environ.get(
            ENV_SPEC + "_SEED", "0")))

    def _arm_locked(self, site: str, actions: tuple[str, ...]) -> _Rule | None:
        # caller holds self._lock; first matching un-exhausted rule fires
        self._consults[site] = self._consults.get(site, 0) + 1
        for rule in self._rules:
            if (rule.site == site and rule.action in actions
                    and rule.triggered < rule.times):
                rule.triggered += 1
                return rule
        return None

    def check(self, site: str) -> None:
        """Consult ``site``: may sleep (delay) or raise (fail/kill)."""
        delay = 0.0
        exc = None
        with self._lock:
            rule = self._arm_locked(site, ("fail", "kill", "delay"))
            if rule is not None:
                if rule.action == "delay":
                    # seeded jitter in [0.5, 1.5) x arg: deterministic
                    # given (spec, seed, consult order)
                    delay = rule.arg * (0.5 + self._rng.random())
                elif rule.action == "kill":
                    exc = WorkerKilled(
                        f"injected kill @{site} "
                        f"({rule.triggered}/{rule.times})")
                else:
                    exc = InjectedFault(
                        f"injected fail @{site} "
                        f"({rule.triggered}/{rule.times})")
        if delay > 0.0:
            time.sleep(delay)
        if exc is not None:
            raise exc

    def mangle(self, site: str, payload: bytes) -> bytes:
        """Corruption hook (``DiskTier`` ``mangle=``): bit-flip one byte
        of ``payload`` when a ``corrupt`` rule for ``site`` fires."""
        with self._lock:
            rule = self._arm_locked(site, ("corrupt",))
        if rule is None:
            return payload
        if not payload:
            return b"\xff"
        i = len(payload) // 2
        return payload[:i] + bytes([payload[i] ^ 0xFF]) + payload[i + 1:]

    def snapshot(self) -> dict:
        """Telemetry for ``GET /stats``: spec-shaped rules + counters."""
        with self._lock:
            return {
                "seed": self.seed,
                "consults": dict(self._consults),
                "rules": [dataclasses.asdict(r) for r in self._rules],
                "triggered": sum(r.triggered for r in self._rules),
            }
