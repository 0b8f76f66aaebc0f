"""Python-``ast`` concurrency lint for the serving layer: a copy of
``repro.analysis.ast_lint`` (stdlib only) over ``repro_torch/serve``.

spatterd handles requests from ``ThreadingHTTPServer`` threads, so every
piece of daemon state shared across handlers must be mutated under a lock
(DESIGN.md §10) — and, dually, nothing slow may run *while holding* one
(the run lock serializes execution on purpose; the memo lock must stay
cheap).  The coalescing scheduler leans on both, so they are enforced
here structurally rather than by per-method tests.

Two checks, both over the source of ``repro_torch/serve`` (no imports:
this module imports neither torch nor jax, like ``report.py``):

``serve-lock-discipline`` — *mostly-locked inference* in the RacerD
style: within a class, an attribute counts as **lock-guarded** when at
least one of its mutations happens inside a ``with self.<lock>:`` block
(any attribute whose name contains ``lock``).  Every other mutation of a
guarded attribute outside ``__init__`` (construction happens before the
threads exist) must then also hold a lock, or it is flagged.  Mutations
are assignments/augmented assignments to ``self.x`` or ``self.x[...]``,
mutator method calls (``self.x.append(...)``, ``.pop``, ``.update``,
...), and passing ``self.x`` as a call argument (how
``_bounded_put(self._placements, ...)`` mutates a memo).  Attributes
never mutated under any lock are presumed handler-local by design
(e.g. the server thread handle) and not flagged — the inference adds no
annotation burden, and seeding one locked use is what opts state in.

``serve-blocking-under-lock`` — flags calls that can block (sleep,
socket/HTTP I/O, file reads, subprocess waits) lexically inside a
``with self.<lock>:`` body.  The *executable* run under the run lock is
exempt by construction: this is a source-level check of the serving
code, and ``run_suite`` executing on-device is the lock's entire
purpose — the check names specific host-blocking calls instead of
guessing at cost.
"""
from __future__ import annotations

import ast
import os

from .report import Violation

# self.<attr>.<method>(...) calls that mutate the receiver in place
MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "clear", "remove", "discard", "move_to_end", "appendleft",
    "popleft",
})

# call names (last dotted component) that can block the holding thread
BLOCKING_CALLS = frozenset({
    "sleep", "urlopen", "recv", "recv_into", "accept", "connect",
    "getresponse", "read", "readline", "readlines", "wait", "wait_for",
    "join", "run", "check_call", "check_output", "communicate", "select",
    "getaddrinfo",
})
# bare open() — a Name call, not an Attribute — blocks too
BLOCKING_NAMES = frozenset({"open", "input"})

# attribute-name tokens that denote a lock-like object: plain locks,
# mutexes, and condition variables (a Condition IS its lock — entering
# ``with self._cv:`` acquires it)
_LOCK_TOKENS = ("lock", "mutex", "cond", "cv")

# methods-called-with-lock-held convention: a method named ``*_locked``
# asserts its callers hold the class lock (the scheduler's
# ``_take_locked``/``_fail_locked`` helpers).  Mutations inside count as
# locked under this synthetic lock name — and blocking calls inside are
# flagged, same as any lexical ``with self.<lock>:`` body.
_LOCKED_METHOD_LOCK = "<caller-held lock>"


def _is_lock_expr(node: ast.expr) -> bool:
    """``self.<lock-like attr>`` — the with-item shape that marks a
    guarded region.  Matches underscore-delimited tokens so ``_cv``
    and ``state_cond`` count while ``_recv`` does not."""
    if not (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return False
    return any(tok in _LOCK_TOKENS
               for tok in node.attr.lower().split("_") if tok)


def _self_attr(node: ast.expr) -> str | None:
    """The attribute name when ``node`` is exactly ``self.<attr>``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _mutation_targets(node: ast.AST) -> list[str]:
    """Attribute names this statement/expression mutates on ``self``."""
    hit: list[str] = []
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            attr = _self_attr(t)
            if attr is None and isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)        # self.x[k] = v
            if attr is not None:
                hit.append(attr)
    elif isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_METHODS:
            attr = _self_attr(node.func.value)    # self.x.append(v)
            if attr is not None:
                hit.append(attr)
        for arg in node.args:                     # f(self.x, ...) may mutate
            attr = _self_attr(arg)
            if attr is not None:
                hit.append(attr)
    return hit


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


class _ClassWalker(ast.NodeVisitor):
    """Collect per-class mutation and under-lock call sites."""

    def __init__(self):
        # (attr, lineno, method, locks_held: frozenset[str])
        self.mutations: list[tuple[str, int, str, frozenset]] = []
        # (call_name, lineno, lock_attr)
        self.locked_calls: list[tuple[str, int, str]] = []
        self._method = ""
        self._locks: list[str] = []

    def visit_FunctionDef(self, node: ast.FunctionDef):
        prev, self._method = self._method, node.name
        held = node.name.endswith("_locked")
        if held:
            self._locks.append(_LOCKED_METHOD_LOCK)
        self.generic_visit(node)
        if held:
            self._locks.pop()
        self._method = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node: ast.With):
        held = [item.context_expr.attr for item in node.items
                if _is_lock_expr(item.context_expr)]
        self._locks.extend(held)
        self.generic_visit(node)
        if held:
            del self._locks[-len(held):]

    def generic_visit(self, node):
        for attr in _mutation_targets(node):
            self.mutations.append((attr, node.lineno, self._method,
                                   frozenset(self._locks)))
        if isinstance(node, ast.Call) and self._locks:
            name = _call_name(node)
            blocking = (name in BLOCKING_CALLS
                        if isinstance(node.func, ast.Attribute)
                        else name in BLOCKING_NAMES)
            if blocking and self._is_sanctioned_wait(node, name):
                blocking = False
            if blocking:
                self.locked_calls.append((name, node.lineno,
                                          self._locks[-1]))
        super().generic_visit(node)

    def _is_sanctioned_wait(self, node: ast.Call, name: str) -> bool:
        """``self.<cv>.wait()`` / ``.wait_for()`` on a condition variable
        the block is HOLDING is the one blocking call condition-variable
        code cannot exist without — wait atomically releases the lock
        while sleeping, so it never pins other threads the way the rule's
        other targets do.  Waiting on anything else (an Event, a foreign
        lock) under a held lock stays flagged: that is a real deadlock
        shape."""
        return (name in ("wait", "wait_for")
                and isinstance(node.func, ast.Attribute)
                and _is_lock_expr(node.func.value)
                and node.func.value.attr in self._locks)


def _walk_classes(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            w = _ClassWalker()
            for stmt in node.body:
                w.visit(stmt)
            yield node.name, w


def check_lock_discipline(tree: ast.Module, path: str) -> list[Violation]:
    """Guarded attributes mutated without their lock (rule
    ``serve-lock-discipline``)."""
    out = []
    for cls, w in _walk_classes(tree):
        guarded = {attr for attr, _, method, locks in w.mutations
                   if locks and method != "__init__"}
        for attr, lineno, method, locks in w.mutations:
            if attr in guarded and not locks and method != "__init__":
                out.append(Violation(
                    rule="serve-lock-discipline",
                    exec_key=os.path.basename(path),
                    location=f"{path}:{lineno}",
                    message=(f"{cls}.{attr} is lock-guarded elsewhere but "
                             f"mutated in {method}() with no lock held — "
                             f"handler threads race on it")))
    return out


def check_blocking_under_lock(tree: ast.Module, path: str
                              ) -> list[Violation]:
    """Blocking calls lexically inside a ``with self.<lock>:`` body (rule
    ``serve-blocking-under-lock``)."""
    out = []
    for cls, w in _walk_classes(tree):
        for name, lineno, lock in w.locked_calls:
            out.append(Violation(
                rule="serve-blocking-under-lock",
                exec_key=os.path.basename(path),
                location=f"{path}:{lineno}",
                message=(f"{cls} calls blocking {name}() while holding "
                         f"self.{lock} — every handler thread queues "
                         f"behind it")))
    return out


def lint_source(source: str, path: str = "<string>") -> list[Violation]:
    """Run both concurrency checks over one module's source."""
    tree = ast.parse(source, filename=path)
    return (check_lock_discipline(tree, path)
            + check_blocking_under_lock(tree, path))


def lint_files(paths) -> tuple[list[Violation], int]:
    """Lint source files; returns (violations, files_checked)."""
    violations: list[Violation] = []
    n = 0
    for p in paths:
        with open(p) as f:
            violations.extend(lint_source(f.read(), p))
        n += 1
    return violations, n


def serve_sources() -> list[str]:
    """The ``repro_torch/serve`` module files, located relative to this
    package (no import of the daemon, which pulls torch)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    serve = os.path.join(pkg, "serve")
    return sorted(os.path.join(serve, f) for f in os.listdir(serve)
                  if f.endswith(".py"))
