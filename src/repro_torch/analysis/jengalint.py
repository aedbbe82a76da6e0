"""jengalint — AST lint for the port's serving invariants (the torch twin
of ``repro/analysis/jengalint.py``).

The engine's correctness rests on properties no single module can see:
deterministic placement/sampling is load-bearing for exactly-once failover,
the async ring forbids host syncs anywhere in the prepare/dispatch path,
and page allocation must stay transactional (everything routes through the
manager). One stray ``.cpu()`` on the dispatch path or ``time.time()`` in
the wrong module silently stalls the in-flight ring or breaks bit-for-bit
replay. These rules encode where each class of call is and is not allowed.

Rules (ids are what pragmas name):

* ``host-sync`` — calls that block the host on the card are forbidden in
  ``serving/runner.py`` (prepare/dispatch phases), ``serving/sampler.py``,
  ``serving/spec_decode.py`` and ``kernels/``: ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``.to("cpu")``, ``.synchronize()``
  (``torch.cuda.synchronize``, a stream's or an event's), ``np.asarray`` /
  ``np.array`` (of a tensor: a copy to the host), ``float()`` / ``bool()``
  of a non-trivial expression, and torch's calls whose output shape
  depends on the data, which sync on CUDA to learn it: ``nonzero``,
  ``argwhere``, ``unique`` (and ``unique_consecutive``), ``masked_select``,
  one-argument ``torch.where``, indexing by a visible boolean mask
  (``x[x > 0]``, ``x[~(a == b)]``, ``x[(a > 0) & m]``) and
  ``repeat_interleave`` by a computed tensor without ``output_size``.
  Fetch-phase code opts out per line with a pragma — every waiver is a
  reviewed sentence.
* ``nondet`` — wall-clock reads, the global ``random`` module, ``id()``
  and direct ``set`` iteration are forbidden in ``serving/scheduler.py``,
  ``serving/router.py``, ``serving/dp_engine.py`` and
  ``core/prefix_cache.py``, where iteration order decides placement and
  replay (copied from the reference).
* ``alloc-direct`` — direct ``TypedPool`` lifecycle calls (``allocate``/
  ``free``/``acquire_cached``/``release_to_cache``) are forbidden outside
  the core allocator modules, and ``allocate_for_batch``/
  ``allocate_for_tokens`` results must be handled (defer/preempt), never
  discarded (copied from the reference).
* ``jit-hygiene`` — inside functions handed to ``torch.compile`` (a call
  or a decorator) or ``torch.cuda.make_graphed_callables``, or called
  inside a ``with torch.cuda.graph(...)`` capture: no ``print``, no host
  sync (the ``host-sync`` calls above: a graph break under
  ``torch.compile``, an error under capture), and no Python ``if``/
  ``while`` branching on a positional parameter, a tensor (branching on
  ``.shape``/``.dtype``/``.ndim``/``.size``/``.device``/``.is_cuda`` is
  static and fine; so are keyword-only parameters, the static-flag idiom).

Waivers: ``# jengalint: allow[<rule>] <reason>`` on the offending line or
the line directly above. A waiver without a reason is itself a violation
(``waiver-reason``), and a waiver that matches nothing is reported as
``stale-waiver`` so dead pragmas cannot accumulate.

The linter is purely syntactic — it cannot prove a value is a tensor on
the card, so the forbidden-call sets are tuned to this package's idioms
(``torch.as_tensor(...).to(device)`` is an upload, never flagged; bare
names as ``float()`` / ``bool()`` arguments or ``repeat_interleave``
counts are taken for host scalars). Precision over recall: anything it
flags is worth a reviewed sentence.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import sys
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# ------------------------------------------------------------------ scopes
HOT_PATH_FILES = {"serving/runner.py", "serving/sampler.py",
                  "serving/spec_decode.py"}
HOT_PATH_PREFIXES = ("kernels/",)
NONDET_FILES = {
    "serving/scheduler.py", "serving/router.py", "serving/dp_engine.py",
    "core/prefix_cache.py",
}
# The only modules allowed to call TypedPool/LargePageAllocator lifecycle
# methods directly; everything else goes through the manager's
# transactional API (allocate_for_batch / rollback_tokens / free_request).
ALLOC_CORE_FILES = {
    "core/manager.py", "core/typed_pool.py", "core/lcm_allocator.py",
}

_NP_NAMES = {"np", "numpy"}
_TIME_FUNCS = {
    "time", "monotonic", "perf_counter", "time_ns", "monotonic_ns",
    "perf_counter_ns",
}
_POOL_LIFECYCLE = {"allocate", "free", "acquire_cached", "release_to_cache"}
_ALLOC_TXN = {"allocate_for_batch", "allocate_for_tokens"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_DATA_SHAPED = {"nonzero", "argwhere", "unique", "unique_consecutive",
                "masked_select"}

PRAGMA_RE = re.compile(
    r"#\s*jengalint:\s*allow\[([a-z0-9_\-, ]+)\]\s*(.*?)\s*$")


@dataclasses.dataclass(frozen=True)
class Violation:
    relpath: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.relpath}:{self.line}:{self.col}: " \
               f"[{self.rule}] {self.message}"


@dataclasses.dataclass
class Waiver:
    line: int
    rules: Tuple[str, ...]
    reason: str
    used: bool = False

    def covers(self, v: Violation) -> bool:
        return v.rule in self.rules and v.line in (self.line, self.line + 1)


def _in_hot_path(relpath: str) -> bool:
    return relpath in HOT_PATH_FILES or relpath.startswith(HOT_PATH_PREFIXES)


# ------------------------------------------------------------- rule: host-sync
def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "device" and len(node.args) == 1
            and _is_cpu(node.args[0]))


def _is_mask(node: ast.AST) -> bool:
    """A visibly boolean index: a comparison, its negation, or an ``&`` /
    ``|`` with a comparison on either side."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_mask(node.operand)
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.BitAnd, ast.BitOr)):
        return _is_mask(node.left) or _is_mask(node.right)
    return False


def _sync_of(node: ast.AST) -> Optional[str]:
    """What blocks the host in ``node``, or None."""
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        return "indexing by a boolean mask" if _is_mask(node.slice) else None
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name):
        # float(x)/bool(x) of an expression (call result, attribute chain,
        # subscript) is where device tensors hide; bare names and literals
        # are overwhelmingly host scalars.
        if f.id in ("float", "bool") and node.args and not isinstance(
                node.args[0], (ast.Constant, ast.Name)):
            return f"{f.id}() of a non-trivial expression"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    on_np = isinstance(f.value, ast.Name) and f.value.id in _NP_NAMES
    on_torch = isinstance(f.value, ast.Name) and f.value.id == "torch"
    if f.attr in _SYNC_METHODS and not node.args and not on_np:
        return f".{f.attr}()"
    if f.attr == "synchronize":
        return ".synchronize()"
    if f.attr == "to" and any(_is_cpu(a) for a in node.args) or \
            f.attr == "to" and any(k.arg == "device" and _is_cpu(k.value)
                                   for k in node.keywords):
        return '.to("cpu")'
    if f.attr in ("asarray", "array") and on_np:
        return f"np.{f.attr}()"
    if f.attr in _DATA_SHAPED and not on_np:
        return f"{f.attr}() (its output shape depends on the data)"
    if f.attr == "where" and on_torch and len(node.args) == 1 \
            and not node.keywords:
        return "one-argument torch.where() (a nonzero)"
    if f.attr == "repeat_interleave" and not any(
            k.arg == "output_size" for k in node.keywords):
        args = node.args[1:] if on_torch else node.args
        reps = args[0] if args else next(
            (k.value for k in node.keywords if k.arg == "repeats"), None)
        if reps is None or not isinstance(reps, (ast.Constant, ast.Name)):
            return "repeat_interleave() by a tensor without output_size"
    return None


def _check_host_sync(tree: ast.AST, relpath: str) -> List[Violation]:
    if not _in_hot_path(relpath):
        return []
    out: List[Violation] = []
    for node in ast.walk(tree):
        what = _sync_of(node)
        if what is not None:
            out.append(Violation(
                relpath, node.lineno, node.col_offset, "host-sync",
                f"{what} blocks the host on the card; the prepare/dispatch "
                f"path must stay sync-free (fetch-phase code waives with a "
                f"reason)"))
    return out


# --------------------------------------------------------------- rule: nondet
def _check_nondet(tree: ast.AST, relpath: str) -> List[Violation]:
    if relpath not in NONDET_FILES:
        return []
    out: List[Violation] = []

    def flag(node: ast.AST, what: str) -> None:
        out.append(Violation(
            relpath, node.lineno, node.col_offset, "nondet",
            f"{what} breaks bit-for-bit replay; placement and scheduling "
            f"here must be deterministic (exactly-once failover recomputes "
            f"from the same decisions)"))

    def is_set_expr(e: ast.AST) -> bool:
        return isinstance(e, ast.Set) or (
            isinstance(e, ast.Call) and isinstance(e.func, ast.Name)
            and e.func.id in ("set", "frozenset"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                if f.value.id == "time" and f.attr in _TIME_FUNCS:
                    flag(node, f"time.{f.attr}()")
                elif f.value.id == "random" and f.attr != "Random":
                    flag(node, f"the global RNG (random.{f.attr})")
            elif isinstance(f, ast.Name):
                if f.id == "id":
                    flag(node, "id() (keys/order vary across runs)")
                elif f.id == "iter" and node.args \
                        and is_set_expr(node.args[0]):
                    flag(node, "iter() over a set")
        elif isinstance(node, ast.For) and is_set_expr(node.iter):
            flag(node, "iteration over a set")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if is_set_expr(gen.iter):
                    flag(node, "comprehension over a set")
    return out


# --------------------------------------------------------- rule: alloc-direct
def _check_alloc(tree: ast.AST, relpath: str) -> List[Violation]:
    out: List[Violation] = []
    core = relpath in ALLOC_CORE_FILES
    for node in ast.walk(tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            f = node.value.func
            if isinstance(f, ast.Attribute) and f.attr in _ALLOC_TXN:
                out.append(Violation(
                    relpath, node.lineno, node.col_offset, "alloc-direct",
                    f"{f.attr}() result discarded — call sites must handle "
                    f"the defer/preempt outcome (False means the plan did "
                    f"NOT commit)"))
        elif isinstance(node, ast.Call) and not core:
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _POOL_LIFECYCLE \
                    and not (isinstance(f.value, ast.Name)
                             and f.value.id == "self"):
                out.append(Violation(
                    relpath, node.lineno, node.col_offset, "alloc-direct",
                    f".{f.attr}() outside the core allocator modules — page "
                    f"lifecycle must route through the manager's "
                    f"transactional API"))
    return out


# --------------------------------------------------------- rule: jit-hygiene
def _is_compile(f: ast.AST) -> bool:
    """``torch.compile`` / ``torch.cuda.make_graphed_callables``."""
    return isinstance(f, ast.Attribute) and f.attr in (
        "compile", "make_graphed_callables")


def _is_graph(f: ast.AST) -> bool:
    """``torch.cuda.graph(...)``, the capture context."""
    return isinstance(f, ast.Call) and isinstance(f.func, ast.Attribute) \
        and f.func.attr == "graph"


def _compiled_names(tree: ast.AST) -> Set[str]:
    """Names of functions this module hands to ``torch.compile`` /
    ``make_graphed_callables`` (directly, via ``partial``, or as a
    decorator) or calls inside a ``torch.cuda.graph`` capture."""
    names: Set[str] = set()

    def harvest(args) -> None:
        for a in args:
            if isinstance(a, ast.Name):
                names.add(a.id)
            elif isinstance(a, ast.Call) and isinstance(a.func, ast.Name) \
                    and a.func.id == "partial":
                harvest(a.args[:1])
            elif isinstance(a, (ast.Tuple, ast.List)):
                harvest(a.elts)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_compile(node.func):
            harvest(node.args[:1])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_compile(dec) or (isinstance(dec, ast.Call)
                                        and _is_compile(dec.func)):
                    names.add(node.name)
        elif isinstance(node, ast.With) and any(
                _is_graph(item.context_expr) for item in node.items):
            for inner in ast.walk(node):
                if isinstance(inner, ast.Call) and \
                        isinstance(inner.func, ast.Name):
                    names.add(inner.func.id)
    return names


def _check_jit_hygiene(tree: ast.AST, relpath: str) -> List[Violation]:
    if not _in_hot_path(relpath):
        return []
    compiled = _compiled_names(tree)
    if not compiled:
        return []
    out: List[Violation] = []

    def flag(node: ast.AST, fn: str, what: str) -> None:
        out.append(Violation(
            relpath, node.lineno, node.col_offset, "jit-hygiene",
            f"{what} inside compiled or captured function '{fn}' — "
            f"dispatch-phase functions must be pure device computation"))

    def check_fn(fn: ast.FunctionDef) -> None:
        # tensor params: positional args minus self; keyword-only args are
        # the static-flag idiom (bound via partial before compiling).
        params = {a.arg for a in fn.args.args + fn.args.posonlyargs
                  if a.arg != "self"}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id == "print":
                flag(node, fn.name, "print()")
                continue
            what = _sync_of(node)
            if what is not None:
                flag(node, fn.name, f"host sync {what}")
            elif isinstance(node, (ast.If, ast.While)):
                static_ok = {
                    id(attr.value) for attr in ast.walk(node.test)
                    if isinstance(attr, ast.Attribute)
                    and attr.attr in _STATIC_ATTRS
                }
                for name in ast.walk(node.test):
                    if isinstance(name, ast.Name) and name.id in params \
                            and id(name) not in static_ok:
                        flag(node, fn.name,
                             f"Python branching on tensor '{name.id}'")
                        break

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in compiled:
            check_fn(node)
    return out


RULES: Dict[str, Callable[[ast.AST, str], List[Violation]]] = {
    "host-sync": _check_host_sync,
    "nondet": _check_nondet,
    "alloc-direct": _check_alloc,
    "jit-hygiene": _check_jit_hygiene,
}


# ------------------------------------------------------------------- engine
def _parse_waivers(src: str, relpath: str) \
        -> Tuple[List[Waiver], List[Violation]]:
    waivers: List[Waiver] = []
    meta: List[Violation] = []
    for i, line in enumerate(src.splitlines(), start=1):
        m = PRAGMA_RE.search(line)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2).strip()
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            meta.append(Violation(
                relpath, i, 0, "waiver-reason",
                f"waiver names unknown rule(s) {unknown}; known: "
                f"{sorted(RULES)}"))
        if not reason:
            meta.append(Violation(
                relpath, i, 0, "waiver-reason",
                "waiver without a reason — every waiver is a reviewed "
                "sentence"))
        waivers.append(Waiver(i, rules, reason))
    return waivers, meta


def lint_source(src: str, relpath: str) -> List[Violation]:
    """Lint one module's source. ``relpath`` is the path relative to the
    ``repro_torch`` package root (posix, e.g. ``serving/runner.py``) — rule
    scoping keys on it. Returns unwaived violations plus waiver-hygiene
    ones (missing reason, stale pragma)."""
    relpath = relpath.replace("\\", "/")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Violation(relpath, e.lineno or 0, e.offset or 0,
                          "syntax", f"unparseable: {e.msg}")]
    waivers, meta = _parse_waivers(src, relpath)
    raw: List[Violation] = []
    for check in RULES.values():
        raw.extend(check(tree, relpath))
    kept: List[Violation] = []
    for v in raw:
        waived = False
        for w in waivers:
            if w.covers(v):
                w.used = True
                waived = True
        if not waived:
            kept.append(v)
    for w in waivers:
        if not w.used:
            kept.append(Violation(
                relpath, w.line, 0, "stale-waiver",
                f"waiver for {list(w.rules)} matches no violation — "
                f"remove it (dead pragmas hide future regressions)"))
    kept.extend(meta)
    return sorted(kept, key=lambda v: (v.line, v.col, v.rule))


def list_waivers(src: str, relpath: str) -> List[Waiver]:
    """All pragmas in one module (used by --list-waivers)."""
    return _parse_waivers(src, relpath)[0]


def _relpath_of(path: pathlib.Path, root: pathlib.Path) -> str:
    return path.relative_to(root).as_posix()


def lint_file(path: pathlib.Path, root: pathlib.Path) -> List[Violation]:
    return lint_source(path.read_text(), _relpath_of(path, root))


def find_package_root(start: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Locate ``src/repro_torch`` from the checkout this module sits in."""
    here = start or pathlib.Path(__file__).resolve()
    for parent in here.parents:
        cand = parent / "src" / "repro_torch"
        if cand.is_dir():
            return cand
    raise FileNotFoundError("src/repro_torch not found above " + str(here))


def lint_tree(root: Optional[pathlib.Path] = None) -> List[Violation]:
    root = root or find_package_root()
    out: List[Violation] = []
    for path in sorted(root.rglob("*.py")):
        out.extend(lint_file(path, root))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    show_waivers = "--list-waivers" in argv
    argv = [a for a in argv if a != "--list-waivers"]
    root = pathlib.Path(argv[0]).resolve() if argv else find_package_root()
    if show_waivers:
        count = 0
        for path in sorted(root.rglob("*.py")):
            rel = _relpath_of(path, root)
            for w in list_waivers(path.read_text(), rel):
                print(f"{rel}:{w.line}: allow[{','.join(w.rules)}] "
                      f"-- {w.reason or '<NO REASON>'}")
                count += 1
        print(f"{count} waiver(s)")
        return 0
    violations = lint_tree(root)
    for v in violations:
        print(v.render())
    n_files = sum(1 for _ in root.rglob("*.py"))
    if violations:
        print(f"jengalint: {len(violations)} violation(s) in {n_files} "
              f"file(s)")
        return 1
    print(f"jengalint: {n_files} file(s) clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
