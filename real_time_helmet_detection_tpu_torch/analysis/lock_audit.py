"""Concurrency audit of the port's threads (graftlint layer 3), stdlib
`ast` only.

Port of ref real_time_helmet_detection_tpu/analysis/lock_audit.py:161-682,
whole:
lockset inference, the lock-order graph, blocking calls and callbacks
under a lock, with the same rules, annotations and suppressions, over
the port's files (`ast_rules.repo_files`): the serving engine's
dispatcher, fetcher and hang watchdog, the fleet's re-dispatch
callbacks, the metrics writer, heartbeats and watchdogs, the loaders.

Rules (all `lock/*`):

* `lock/unguarded-shared-write` — an attribute touched under `with
  self._lock` in one method and with no lock in another (a torn write
  or a torn read); a guarded attribute whose touches share no common
  lock; a thread body sharing an attribute with other methods with no
  lock at all, and the module-level twin (a threaded module writing a
  `global` with no lock).
* `lock/order-cycle` — a cycle in the lock-order graph over nested
  `with` acquisitions and self-method calls made while holding a lock;
  a self-edge on a non-reentrant lock is a certain deadlock
  (`interleave.py` replays the AB/BA shape into the deadlock).
* `lock/blocking-call-under-lock` — a blocking call inside a lock
  window: JAX's `time.sleep`, `<t>.join()`, `<f>.result()`,
  `<e>.wait()`, `<q>.get()` with no positional argument, `.drain()`,
  `.reload()`, and the card's syncs: `torch.cuda.synchronize()`,
  `<event>.synchronize()`, `<stream>.synchronize()`, and the host
  fetches `.item()`, `.cpu()`, `.tolist()`, `.numpy()` (each waits for
  every kernel queued before it).
* `lock/callback-under-lock` — `add_done_callback` or a callback-named
  value (`cb`, `*_cb`, `*_callback`, `*_hook`, `*_fn`) called while
  holding a lock.

Annotations, as JAX's: `# guarded-by: <lock>` (the touch, the scope on
its `def` line, or the attribute on its `__init__` assignment is
protected by that lock, held by every caller) and `# lock-free:
<reason>` (intentionally unsynchronized, with the reason);
`# graftlint: off=<rule>` works here too. Findings diff against the same
`analysis/baseline.json`, which stays empty.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, \
    Tuple

from . import Finding
from .ast_rules import _call_name, _suppressed, repo_files

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w]*)")
LOCK_FREE_RE = re.compile(r"#\s*lock-free:\s*(\S)")

LOCK_CTORS = {"Lock", "RLock", "Condition"}
REENTRANT_CTORS = {"RLock"}
_LOCK_NAME_RE = re.compile(r"lock|mutex", re.I)
EXEMPT_SCOPES = {"__init__", "__new__", "__del__", "__post_init__",
                 "__init_subclass__"}
_THREAD_CTORS = {"Thread", "ThreadPoolExecutor"}

# blocking leaf-call classification (see module docstring)
_BLOCKING_ANY = {"device_get", "block_until_ready", "synchronize"}
_BLOCKING_METHOD = {"result", "wait", "drain", "reload"}
# host fetches: zero-argument tensor methods that wait for the card
_BLOCKING_FETCH = {"item", "cpu", "tolist", "numpy"}
_MODULE = "<module>"


def _is_self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _Touch:
    __slots__ = ("attr", "kind", "held", "line", "scope", "exempt")

    def __init__(self, attr: str, kind: str, held: FrozenSet[str],
                 line: int, scope: str, exempt: bool):
        self.attr = attr
        self.kind = kind          # "r" | "w"
        self.held = held          # lock names held at the touch
        self.line = line
        self.scope = scope        # method qualname within the owner
        self.exempt = exempt      # __init__-family or lock-free scope


class _Owner:
    """One lockset-analysis unit: a class, or the module itself
    (owner name `<module>`, attrs = `global`-declared names)."""

    __slots__ = ("name", "locks", "rlocks", "touches", "thread_targets",
                 "acquires", "selfcalls", "spawns_threads",
                 "attr_guards", "attr_free")

    def __init__(self, name: str):
        self.name = name
        self.locks: set = set()
        self.rlocks: set = set()
        self.touches: List[_Touch] = []
        self.thread_targets: set = set()   # method names run as threads
        # (scope, lock, held-at-acquire, line)
        self.acquires: List[Tuple[str, str, Tuple[str, ...], int]] = []
        # (scope, callee-method, held-at-call, line)
        self.selfcalls: List[Tuple[str, str, Tuple[str, ...], int]] = []
        self.spawns_threads = False
        self.attr_guards: Dict[str, str] = {}  # attr -> annotated lock
        self.attr_free: set = set()            # attr -> lock-free'd


def _line_annotation(lines: Sequence[str], lo: int, hi: int
                     ) -> Tuple[Optional[str], bool]:
    """(guarded-by lock, lock-free?) from comments on lines [lo, hi]."""
    guard, free = None, False
    for ln in lines[max(0, lo - 1):hi]:
        m = GUARDED_BY_RE.search(ln)
        if m:
            guard = m.group(1)
        if LOCK_FREE_RE.search(ln):
            free = True
    return guard, free


class _FileAnalysis:
    """Single-file lock model: owners (classes + the module), their lock
    windows, touches and acquisition edges."""

    def __init__(self, src: str, relpath: str):
        self.relpath = relpath
        self.lines = src.splitlines()
        try:
            self.tree: Optional[ast.Module] = ast.parse(src)
        except SyntaxError:
            self.tree = None  # ast layer reports the syntax error
        self.owners: Dict[str, _Owner] = {}
        self.module_locks: set = set()
        self.module_globals: set = set()
        if self.tree is not None:
            self._analyze()

    # -- discovery ---------------------------------------------------------

    def _discover_module(self) -> None:
        mod = self.owners.setdefault(_MODULE, _Owner(_MODULE))
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                leaf = _call_name(node.value).split(".")[-1]
                for t in node.targets:
                    if isinstance(t, ast.Name) and leaf in LOCK_CTORS:
                        self.module_locks.add(t.id)
                        mod.locks.add(t.id)
                        if leaf in REENTRANT_CTORS:
                            mod.rlocks.add(t.id)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Global):
                self.module_globals.update(node.names)
            if isinstance(node, ast.Call):
                leaf = _call_name(node).split(".")[-1]
                if leaf in _THREAD_CTORS:
                    mod.spawns_threads = True

    def _discover_class(self, cnode: ast.ClassDef) -> _Owner:
        owner = _Owner(cnode.name)
        for node in ast.walk(cnode):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                attr = None
                for t in targets:
                    attr = attr or _is_self_attr(t)
                if attr is None:
                    continue
                if isinstance(node.value, ast.Call):
                    leaf = _call_name(node.value).split(".")[-1]
                    named_lock = bool(_LOCK_NAME_RE.search(attr))
                    if leaf in LOCK_CTORS or named_lock:
                        owner.locks.add(attr)
                        if leaf in REENTRANT_CTORS:
                            owner.rlocks.add(attr)
                # attribute-wide annotations on the assignment line
                guard, free = _line_annotation(
                    self.lines, node.lineno,
                    getattr(node, "end_lineno", node.lineno))
                if guard:
                    owner.attr_guards[attr] = guard
                if free:
                    owner.attr_free.add(attr)
            if isinstance(node, ast.Call):
                leaf = _call_name(node).split(".")[-1]
                if leaf in _THREAD_CTORS:
                    owner.spawns_threads = True
                if leaf == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            m = _is_self_attr(kw.value)
                            if m:
                                owner.thread_targets.add(m)
        return owner

    # -- walking -----------------------------------------------------------

    def _lock_of(self, expr: ast.AST, owner: _Owner) -> Optional[str]:
        attr = _is_self_attr(expr)
        if attr is not None and (attr in owner.locks
                                 or _LOCK_NAME_RE.search(attr)):
            owner.locks.add(attr)
            return attr
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return expr.id
        return None

    def _scope_annotations(self, fn: ast.AST) -> Tuple[Optional[str], bool]:
        body = getattr(fn, "body", None) or [fn]
        return _line_annotation(self.lines, fn.lineno,
                                max(fn.lineno, body[0].lineno - 1))

    def _walk_scope(self, owner: _Owner, qual: str, fn, exempt: bool
                    ) -> None:
        guard, free = self._scope_annotations(fn)
        scope_exempt = exempt or fn.name in EXEMPT_SCOPES or free
        base_held: Tuple[str, ...] = (guard,) if guard else ()

        def record_touch(attr: str, kind: str, node: ast.AST,
                         held: Tuple[str, ...]) -> None:
            if attr in owner.locks:
                return
            lo = node.lineno
            hi = getattr(node, "end_lineno", lo)
            ln_guard, ln_free = _line_annotation(self.lines, lo, hi)
            if ln_free or attr in owner.attr_free:
                return
            h = set(held)
            if ln_guard:
                h.add(ln_guard)
            if attr in owner.attr_guards:
                h.add(owner.attr_guards[attr])
            owner.touches.append(_Touch(attr, kind, frozenset(h), lo,
                                        qual, scope_exempt))

        def write_targets(t: ast.AST, node, held) -> None:
            if isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    write_targets(e, node, held)
                return
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            attr = _is_self_attr(base)
            if attr is not None:
                record_touch(attr, "w", node, held)
            elif owner.name == _MODULE and isinstance(base, ast.Name) \
                    and base.id in self.module_globals:
                record_touch(base.id, "w", node, held)

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: its body runs later, with no lock inherited
                self._walk_scope(owner, "%s.%s" % (qual, node.name), node,
                                 scope_exempt)
                return
            if isinstance(node, ast.ClassDef):
                return
            if isinstance(node, ast.With):
                new = list(held)
                for item in node.items:
                    ln = self._lock_of(item.context_expr, owner)
                    if ln is not None:
                        owner.acquires.append((qual, ln, tuple(new),
                                               node.lineno))
                        new.append(ln)
                    else:
                        visit(item.context_expr, tuple(new))
                        if item.optional_vars is not None:
                            visit(item.optional_vars, tuple(new))
                for stmt in node.body:
                    visit(stmt, tuple(new))
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    write_targets(t, node, held)
            if isinstance(node, ast.Call):
                callee = _is_self_attr(node.func)
                if callee is not None:
                    owner.selfcalls.append((qual, callee, held,
                                            node.lineno))
                if held and not scope_exempt:
                    self._check_blocking(owner, qual, node, held)
                    self._check_callback(owner, qual, node, held)
            if isinstance(node, ast.Attribute):
                attr = _is_self_attr(node)
                if attr is not None and not isinstance(node.ctx, ast.Store):
                    record_touch(attr, "r", node, held)
            elif isinstance(node, ast.Name) and owner.name == _MODULE \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in self.module_globals:
                record_touch(node.id, "r", node, held)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, base_held)

    # -- under-lock call rules (emitted during the walk) -------------------

    def _check_blocking(self, owner: _Owner, qual: str, node: ast.Call,
                        held: Tuple[str, ...]) -> None:
        name = _call_name(node)
        leaf = name.split(".")[-1]
        is_method = isinstance(node.func, ast.Attribute)
        npos = len(node.args)
        hit = None
        if leaf in _BLOCKING_ANY:
            hit = "%s()" % name
        elif leaf == "sleep" and (name == "sleep"
                                  or name.startswith("time.")):
            hit = "%s()" % name
        elif is_method and leaf == "join" and npos == 0:
            hit = ".join()"
        elif is_method and leaf == "get" and npos == 0:
            hit = ".get() (blocking queue consume)"
        elif is_method and leaf in _BLOCKING_METHOD:
            hit = ".%s()" % leaf
        elif is_method and leaf in _BLOCKING_FETCH and npos == 0 \
                and not node.keywords:
            hit = ".%s() (a host fetch waits for the card)" % leaf
        if hit is None:
            return
        if _suppressed("blocking-call-under-lock", self.lines, node.lineno,
                       getattr(node, "end_lineno", node.lineno)):
            return
        self.findings.append(Finding(
            rule="lock/blocking-call-under-lock", path=self.relpath,
            line=node.lineno, context="%s.%s" % (owner.name, qual),
            message="blocking call %s while holding %s: every thread "
                    "needing that mutex stalls behind the wait (the "
                    "starvation class) — snapshot under the lock, block "
                    "outside it" % (hit, "/".join(sorted(held)))))

    _CB_NAME_RE = re.compile(r"^(cb|callback|hook)$"
                             r"|(_cb|_callback|_hook|_fn)$")

    def _check_callback(self, owner: _Owner, qual: str, node: ast.Call,
                        held: Tuple[str, ...]) -> None:
        name = _call_name(node)
        leaf = name.split(".")[-1]
        hit = None
        if leaf == "add_done_callback":
            hit = "add_done_callback(...) (its inline-fire path runs " \
                  "user code)"
        elif self._CB_NAME_RE.search(leaf):
            hit = "callback %s(...)" % name
        if hit is None:
            return
        if _suppressed("callback-under-lock", self.lines, node.lineno,
                       getattr(node, "end_lineno", node.lineno)):
            return
        self.findings.append(Finding(
            rule="lock/callback-under-lock", path=self.relpath,
            line=node.lineno, context="%s.%s" % (owner.name, qual),
            message="%s invoked while holding %s: the callee can "
                    "re-enter the lock (self-deadlock) or run unbounded "
                    "user code inside the critical section — snapshot "
                    "under the lock, fire after releasing it "
                    "(ServeFuture._run_callback is the shape)"
                    % (hit, "/".join(sorted(held)))))

    # -- orchestration -----------------------------------------------------

    def _analyze(self) -> None:
        self.findings: List[Finding] = []
        self._discover_module()
        mod = self.owners[_MODULE]
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                owner = self._discover_class(node)
                self.owners[node.name] = owner
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._walk_scope(owner, item.name, item,
                                         exempt=False)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_scope(mod, node.name, node, exempt=False)


# ---------------------------------------------------------------------------
# per-owner lockset reporting


def _lockset_findings(fa: _FileAnalysis) -> List[Finding]:
    out: List[Finding] = []
    for owner in fa.owners.values():
        by_attr: Dict[str, List[_Touch]] = {}
        for t in owner.touches:
            by_attr.setdefault(t.attr, []).append(t)
        for attr, touches in sorted(by_attr.items()):
            live = [t for t in touches if not t.exempt]
            writes = [t for t in live if t.kind == "w"]
            if not writes:
                continue  # init-only / read-only: not shared mutable state
            locked = [t for t in live if t.held]
            if locked:
                unguarded = [t for t in live if not t.held]
                reported: set = set()
                for t in unguarded:
                    if _suppressed("unguarded-shared-write", fa.lines,
                                   t.line, t.line):
                        continue
                    key = (t.scope, attr)
                    if key in reported:
                        continue
                    reported.add(key)
                    guards = sorted({ln for lt in locked for ln in lt.held})
                    out.append(Finding(
                        rule="lock/unguarded-shared-write", path=fa.relpath,
                        line=t.line,
                        context="%s.%s:%s" % (owner.name, t.scope, attr),
                        message="%s of %r outside any lock window, but it "
                                "is guarded by %s elsewhere: a concurrent "
                                "writer makes this a torn %s — hold the "
                                "lock, or annotate `# guarded-by:` / "
                                "`# lock-free: <reason>`"
                                % ("write" if t.kind == "w" else "read",
                                   attr, "/".join(guards),
                                   "state" if t.kind == "w" else "read")))
                if not unguarded:
                    common = frozenset.intersection(
                        *[t.held for t in locked])
                    if not common and len(locked) > 1:
                        t0 = sorted(locked, key=lambda t: t.line)[0]
                        if not _suppressed("unguarded-shared-write",
                                           fa.lines, t0.line, t0.line):
                            out.append(Finding(
                                rule="lock/unguarded-shared-write",
                                path=fa.relpath, line=t0.line,
                                context="%s:%s" % (owner.name, attr),
                                message="no single lock covers every "
                                        "touch of %r (%s): two mutexes "
                                        "that do not exclude each other "
                                        "guard nothing" % (attr, ", ".join(
                                            sorted({"/".join(sorted(t.held))
                                                    for t in locked})))))
            elif owner.spawns_threads:
                # signature (c): thread-shared state with no lock at all
                if owner.name == _MODULE:
                    shared = bool(writes)
                else:
                    in_t = [t for t in live
                            if t.scope.split(".")[0]
                            in owner.thread_targets]
                    out_t = [t for t in live
                             if t.scope.split(".")[0]
                             not in owner.thread_targets]
                    shared = bool(
                        owner.thread_targets
                        and ((any(t.kind == "w" for t in in_t) and out_t)
                             or (any(t.kind == "w" for t in out_t)
                                 and in_t)))
                if shared:
                    t0 = sorted(writes, key=lambda t: t.line)[0]
                    if _suppressed("unguarded-shared-write", fa.lines,
                                   t0.line, t0.line):
                        continue
                    where = ("a threaded module"
                             if owner.name == _MODULE
                             else "thread target(s) %s" % ", ".join(
                                 sorted(owner.thread_targets)))
                    out.append(Finding(
                        rule="lock/unguarded-shared-write", path=fa.relpath,
                        line=t0.line,
                        context="%s:%s" % (owner.name, attr),
                        message="%r is shared with %s with no lock "
                                "anywhere: concurrent access is a data "
                                "race — guard it, or annotate "
                                "`# lock-free: <reason>`" % (attr, where)))
    return out


# ---------------------------------------------------------------------------
# lock-order graph


def _order_edges(fa: _FileAnalysis) -> List[Tuple[str, str, str, int]]:
    """(from-lock, to-lock, file:scope, line) edges; lock node ids are
    `relpath::Owner.attr` so identically-named locks in different
    classes/files never merge."""
    edges = []
    for owner in fa.owners.values():
        def node(lock: str) -> str:
            if lock in fa.module_locks and owner.name == _MODULE:
                return "%s::%s" % (fa.relpath, lock)
            if lock in fa.module_locks and lock not in owner.locks:
                return "%s::%s" % (fa.relpath, lock)
            return "%s::%s.%s" % (fa.relpath, owner.name, lock)

        # transitive per-method acquisition summaries via self-calls
        direct: Dict[str, set] = {}
        for scope, lock, _held, _line in owner.acquires:
            direct.setdefault(scope.split(".")[0], set()).add(lock)
        calls: Dict[str, set] = {}
        for scope, callee, _held, _line in owner.selfcalls:
            calls.setdefault(scope.split(".")[0], set()).add(callee)
        total = {m: set(v) for m, v in direct.items()}
        for _ in range(len(calls) + 1):
            changed = False
            for m, callees in calls.items():
                acc = total.setdefault(m, set())
                for c in callees:
                    extra = total.get(c, set()) - acc
                    if extra:
                        acc.update(extra)
                        changed = True
            if not changed:
                break
        for scope, lock, held, line in owner.acquires:
            for h in held:
                edges.append((node(h), node(lock),
                              "%s::%s.%s" % (fa.relpath, owner.name,
                                             scope), line))
        for scope, callee, held, line in owner.selfcalls:
            if not held:
                continue
            for lock in sorted(total.get(callee, set())):
                for h in held:
                    edges.append((node(h), node(lock),
                                  "%s::%s.%s" % (fa.relpath, owner.name,
                                                 scope), line))
    return edges


def _rlock_nodes(fa: _FileAnalysis) -> set:
    out = set()
    for owner in fa.owners.values():
        for lk in owner.rlocks:
            if owner.name == _MODULE:
                out.add("%s::%s" % (fa.relpath, lk))
            else:
                out.add("%s::%s.%s" % (fa.relpath, owner.name, lk))
    return out


def _cycle_findings(analyses: Sequence[_FileAnalysis]) -> List[Finding]:
    graph: Dict[str, Dict[str, Tuple[str, int]]] = {}
    rlocks: set = set()
    for fa in analyses:
        rlocks |= _rlock_nodes(fa)
        for a, b, site, line in _order_edges(fa):
            if a == b and a in rlocks:
                continue  # re-acquiring a reentrant lock is legal
            graph.setdefault(a, {}).setdefault(b, (site, line))

    out: List[Finding] = []
    seen_cycles: set = set()

    # self-edges first (guaranteed deadlock on a non-reentrant lock)
    for a, succs in sorted(graph.items()):
        if a in succs:
            site, line = succs[a]
            path = site.split("::")[0]
            out.append(Finding(
                rule="lock/order-cycle", path=path, line=line,
                context="self:%s" % a.split("::", 1)[1],
                message="lock %s is acquired while already held (via %s) "
                        "— a non-reentrant Lock self-deadlocks the "
                        "thread instantly" % (a.split("::", 1)[1], site)))

    # simple-cycle detection (DFS with an on-stack set)
    def dfs(start: str) -> None:
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for nxt in sorted(graph.get(cur, {})):
                if nxt == start and len(path) > 1:
                    canon = tuple(sorted(path))
                    if canon in seen_cycles:
                        continue
                    seen_cycles.add(canon)
                    site, line = graph[cur][nxt]
                    pretty = " -> ".join(
                        p.split("::", 1)[1] for p in path + [start])
                    out.append(Finding(
                        rule="lock/order-cycle",
                        path=site.split("::")[0], line=line,
                        context="cycle:%s" % "|".join(
                            p.split("::", 1)[1] for p in sorted(path)),
                        message="lock-order cycle %s: two threads taking "
                                "these in opposite order deadlock — pick "
                                "ONE order (interleave.py's AB/BA "
                                "fixture proves the hang on a seeded "
                                "schedule)" % pretty))
                elif nxt != start and nxt not in path:
                    stack.append((nxt, path + [nxt]))

    for n in sorted(graph):
        dfs(n)
    return out


# ---------------------------------------------------------------------------
# entry functions (the graftlint layer-3 API; mirrors ast_rules' lint_source /
# lint_repo so scripts/graftlint.py treats the layers uniformly)


def audit_source(src: str, relpath: str) -> List[Finding]:
    """All lock rules over ONE file (order cycles confined to it)."""
    fa = _FileAnalysis(src, relpath)
    if fa.tree is None:
        return []
    return fa.findings + _lockset_findings(fa) + _cycle_findings([fa])


def audit_files(pairs: Iterable[Tuple[str, str]],
                graph_pairs: Optional[Iterable[Tuple[str, str]]] = None
                ) -> List[Finding]:
    """Per-file rules over `pairs` (relpath, src); the lock-order graph is
    built over `graph_pairs` when given (the full repo in --changed mode:
    an order edge added in an untouched file still closes a cycle)."""
    analyses = [_FileAnalysis(src, rel) for rel, src in pairs]
    out: List[Finding] = []
    for fa in analyses:
        if fa.tree is None:
            continue
        out.extend(fa.findings)
        out.extend(_lockset_findings(fa))
    if graph_pairs is None:
        graph_analyses = analyses
    else:
        graph_analyses = [_FileAnalysis(src, rel)
                          for rel, src in graph_pairs]
    out.extend(_cycle_findings([fa for fa in graph_analyses
                                if fa.tree is not None]))
    return out


def audit_repo(root: str,
               only: Optional[Sequence[str]] = None) -> List[Finding]:
    """The repo-wide layer-3 run. `only` restricts the per-file rules to
    those repo-relative paths (graftlint --changed); the order graph is
    always global."""
    all_pairs = []
    for rel in repo_files(root):
        with open(os.path.join(root, rel)) as f:
            all_pairs.append((rel, f.read()))
    if only is None:
        return audit_files(all_pairs)
    only_set = set(only)
    return audit_files([p for p in all_pairs if p[0] in only_set],
                       graph_pairs=all_pairs)
