"""Static AST linter for the port's correctness contracts (the port of
``repro.analysis.lint``).

``python -m repro_torch.analysis lint [--strict] [paths...]`` — stdlib
``ast`` only, no third-party dependencies, so it runs before PyTorch is
even importable. The rules are the reference's (DESIGN.md §9), scoped to
``src/repro_torch`` and ``tests``; R002 is rewritten for what the port
captures (CUDA graphs, not ``jax.jit``), and the R005 table follows the
port's modules:

* **R001** — no direct ``time.time()`` / ``time.monotonic()`` calls in
  ``serving/``: every timestamp must come from the gateway's injectable
  clock or chaos runs under ``VirtualClock`` silently read wall time.
  (References like ``clock: Callable = time.time`` parameter defaults are
  fine — only *calls* and ``field(default_factory=time.time)`` leak.)
* **R002** — nothing a CUDA graph captures reads the host or takes a
  shape from the data (ROADMAP, rule "Graphs"): no ``.item()`` /
  ``.tolist()`` / ``.cpu()`` / ``.numpy()``, no ``int()`` / ``float()``
  / ``bool()`` of a tensor element, no ``np.asarray`` / ``np.array``, no
  ``torch.cuda.synchronize``, and none of ``nonzero``, ``unique``,
  ``masked_select``, boolean-mask indexing, a one-argument
  ``torch.where`` or ``repeat_interleave`` without ``output_size``. The
  captured code is found from its roots — the ``decode_chunk`` closure of
  ``models/registry.make_decode_chunk``, every callable passed to
  ``make_decode_chunk(...)``, the body of each ``with
  torch.cuda.graph(...)`` — and everything they reach across the port's
  modules (:func:`graph_reachable`): names defined, imported (``from
  repro_torch... import f``) or reached through a module (``ops.f``),
  nested functions a reachable one names, and the methods and properties
  of the port's classes an attribute of that name may reach.
* **R003** — ``gateway.py`` / ``benchmarks/`` touch replicas only
  through the ``PrefillClient`` / ``DecodeClient`` / ``Transport``
  seams: no ``.engine`` / ``._engine`` attribute reach-through (an RPC
  realization has no engine attribute to reach). Also: the deleted
  ``Coordinator`` shim stays deleted — no
  ``repro.serving.coordinator`` imports, no ``Coordinator`` class in
  ``serving/`` (``Gateway`` is the one public entry point).
* **R004** — every transition to FAILED / REJECTED carries a ``reason``
  (and request state is never assigned directly — only through
  ``_transition``, which validates the state machine).
* **R005** — wire/page layout lockstep: the quantization group candidates,
  the group-selection rule, and the int4 nibble packing live ONLY in
  ``kernels/kv_layout.py``; ``kv_transfer.py``, ``models/paged.py`` and
  ``kernels/ref.py`` (the port's Python modules that pick a group or pack
  a nibble) must import them. A local copy is a drift waiting to corrupt
  zero-copy page insertion. The kernel wrappers ``kernels/kv_quant.py``
  and ``kernels/paged_attention.py`` derive nothing themselves (the CUDA
  sources pack the nibbles; the group width is read from the shapes of
  the pages ``models/paged.py`` allocated), so they are not in the
  table; the card's byte-for-byte checks hold the CUDA side.
* **R006** — page refcount/free-list mutation lives ONLY in
  ``serving/page_pool.py``: no reaching into ``PagePool`` internals
  (``._free``, ``._owners``, ``._by_owner``, ``._grant``, ``._revoke``)
  from anywhere else. Prefix sharing means a page may have several
  owners; a caller that pokes the maps directly can free a page another
  owner still reads (silent KV corruption). Go through
  ``alloc``/``share``/``free``/``unshare``/``owned_by``/``owners_of``
  (state branching: ``snapshot``/``restore``/``canonicalize``).
* **R007 / R008** — wire-provenance dataflow rules (quantize once over
  the spliced whole; wire layout arithmetic stays in the layout
  modules). Implemented in :mod:`repro.analysis.dataflow`, run and
  scoped here.

Escape hatch: ``# repro: ignore[Rnnn]`` on the offending line (or the
line above) suppresses one rule there; ``--strict`` additionally fails on
pragmas that suppress nothing (so dead pragmas can't rot). A suppressed
R002 finding carries its reason on the pragma's line (ROADMAP C.4 lists
each).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "R001": "no direct wall-clock reads in serving/ (use the injected "
            "clock)",
    "R002": "no host reads or data-dependent shapes in code a CUDA graph "
            "captures",
    "R003": "replicas are reached only through client/transport seams "
            "(and the deleted Coordinator shim stays deleted)",
    "R004": "FAILED/REJECTED transitions must carry a reason",
    "R005": "wire/page quantization layout must not drift (kv_layout is "
            "the single source of truth)",
    "R006": "page refcount/free-list mutation only in serving/page_pool.py "
            "(use the PagePool API, never its internals)",
    "R007": "quantize once, over the spliced whole: no double "
            "quantization, no per-chunk quantization, chunk wires stay "
            "raw until completion",
    "R008": "wire layout arithmetic (KVWire/WireTensor construction, "
            "ppr row math, payload splicing) only in the layout modules",
}

# the ONE module allowed to touch the refcount maps/free list (R006)
POOL_MODULE = "src/repro_torch/serving/page_pool.py"

# the ONE module allowed to define the layout contract (R005)
LAYOUT_MODULE = "src/repro_torch/kernels/kv_layout.py"

# only real rule ids (R001, W001, ...) count as pragmas — prose examples
# like "ignore[Rnnn]" in docstrings must not register as suppressions
_PRAGMA_RE = re.compile(r"#\s*repro:\s*ignore\[((?:\s*[RWE]\d{3}\s*,?)+)\]")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


# -- pragma handling ----------------------------------------------------------


def _pragmas(src: str) -> Dict[int, Set[str]]:
    """line -> set of rule ids suppressed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


# -- R001: wall-clock reads in serving/ ---------------------------------------


def _is_time_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "time"
            and node.attr in ("time", "monotonic", "monotonic_ns",
                              "time_ns"))


class _R001(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call):
        if _is_time_attr(node.func):
            self.findings.append(Finding(
                "R001", self.path, node.lineno, node.col_offset,
                f"direct time.{node.func.attr}() call in serving code",
                "take a `clock` callable (default `time.time` as a "
                "REFERENCE) and call `self.clock()` / the caller-passed "
                "`now` so VirtualClock runs stay deterministic"))
        for kw in node.keywords:
            if kw.arg == "default_factory" and _is_time_attr(kw.value):
                self.findings.append(Finding(
                    "R001", self.path, kw.value.lineno,
                    kw.value.col_offset,
                    "field(default_factory=time.time) stamps wall time at "
                    "construction",
                    "default to 0.0 (or pass the clock reading explicitly "
                    "at the construction site)"))
        self.generic_visit(node)


# -- R002: host reads and data-dependent shapes in captured code -------------

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# the packages whose code a decode chunk's graph can run; serving/,
# launch/ (but the mesh helpers), training/ ... run on the host around it
GRAPH_SCOPES = ("src/repro_torch/models/", "src/repro_torch/kernels/",
                "src/repro_torch/distributed/", "src/repro_torch/configs/",
                "src/repro_torch/launch/mesh.py")
GRAPH_ROOT = "make_decode_chunk"     # returns the captured chunk closure

# calls whose result is a host value or whose output shape is the data's
_HOST_READS = ("item", "tolist", "cpu", "numpy", "synchronize")
_DATA_SHAPES = ("nonzero", "argwhere", "unique", "unique_consecutive",
                "masked_select")


def module_of(path: str) -> Optional[str]:
    """``src/repro_torch/a/b.py`` -> ``repro_torch.a.b`` (a package's
    ``__init__.py`` -> the package)."""
    if not path.startswith("src/") or not path.endswith(".py"):
        return None
    parts = path[len("src/"):-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class _Module:
    """One file's defs, classes and imports, and each node's parent."""

    def __init__(self, path: str, tree: ast.Module, modules: Set[str]):
        self.path, self.tree = path, tree
        self.parent: Dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[id(child)] = node
        self.defs: Dict[str, ast.AST] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
        # alias -> ("module", name) | ("name", module, attr)
        self.imports: Dict[str, Tuple[str, ...]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = ("module", a.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    self.imports[a.asname or a.name] = (
                        ("module", full) if full in modules
                        else ("name", node.module, a.name))

    def enclosing(self, node: ast.AST) -> List[ast.AST]:
        """The functions around ``node``, innermost first."""
        out = []
        cur = self.parent.get(id(node))
        while cur is not None:
            if isinstance(cur, _FuncNode):
                out.append(cur)
            cur = self.parent.get(id(cur))
        return out

    def local_defs(self, fn: ast.AST, name: str) -> List[ast.AST]:
        """Functions named ``name`` defined directly in ``fn``'s body."""
        return [n for n in _own_nodes(fn)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name == name]


def _own_nodes(scope: ast.AST):
    """The nodes of ``scope`` outside the functions nested in it (a nested
    function's own node is yielded, its body is not)."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, _FuncNode):
            todo.extend(ast.iter_child_nodes(node))


class _Graph:
    """The port's modules, for resolving a name across them."""

    def __init__(self, trees: Dict[str, ast.Module]):
        names = {module_of(p): p for p in trees if module_of(p)}
        self.by_module = names
        self.mods = {p: _Module(p, t, set(names)) for p, t in trees.items()}
        # method / property name -> [(path, def)] of the graph scopes'
        # classes
        self.methods: Dict[str, List[Tuple[str, ast.AST]]] = {}
        for p, m in self.mods.items():
            if not p.startswith(GRAPH_SCOPES):
                continue
            for cls in m.classes.values():
                for node in cls.body:
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.methods.setdefault(node.name, []).append(
                            (p, node))

    def _top(self, module: str, name: str) -> List[Tuple[str, ast.AST]]:
        """Top-level def or class ``name`` of ``module`` (a class: its
        methods, which constructing or calling it may run)."""
        path = self.by_module.get(module)
        if path is None:
            return []
        m = self.mods[path]
        if name in m.defs:
            return [(path, m.defs[name])]
        if name in m.classes:
            return [(path, n) for n in m.classes[name].body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if name in m.imports:             # re-exported from a package
            return self._imported(m.imports[name])
        return []

    def _imported(self, imp) -> List[Tuple[str, ast.AST]]:
        return [] if imp[0] == "module" else self._top(imp[1], imp[2])

    def resolve(self, path: str, node: ast.AST) -> List[Tuple[str, ast.AST]]:
        """The port's functions a Name or Attribute at ``node`` may
        denote."""
        m = self.mods[path]
        if isinstance(node, ast.Name):
            for fn in m.enclosing(node):
                got = m.local_defs(fn, node.id)
                if got:
                    return [(path, d) for d in got]
            if node.id in m.defs or node.id in m.classes:
                return self._top(module_of(path), node.id)
            if node.id in m.imports:
                return self._imported(m.imports[node.id])
            return []
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id in m.imports and \
                    m.imports[base.id][0] == "module":
                return self._top(m.imports[base.id][1], node.attr)
            return list(self.methods.get(node.attr, ()))
        if isinstance(node, ast.Lambda):
            return [(path, node)]
        return []

    def roots(self) -> List[Tuple[str, ast.AST]]:
        out: List[Tuple[str, ast.AST]] = []
        for path, m in self.mods.items():
            for node in ast.walk(m.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name == GRAPH_ROOT:
                    out.extend((path, d) for d in _own_nodes(node)
                               if isinstance(d, _FuncNode))
                elif isinstance(node, ast.Call) and _callee_name(
                        node.func) == GRAPH_ROOT:
                    for arg in node.args[:1]:
                        out.extend(self.resolve(path, arg))
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        _is_graph_capture(it.context_expr)
                        for it in node.items):
                    out.append((path, node))
        return out


def _callee_name(f: ast.AST) -> str:
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


def _is_graph_capture(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph``/``graph`` imported)."""
    return isinstance(expr, ast.Call) and _callee_name(expr.func) == "graph"


def graph_reachable(trees: Dict[str, ast.Module]
                    ) -> Dict[str, List[ast.AST]]:
    """path -> the scopes (functions, lambdas, ``with torch.cuda.graph``
    bodies) a CUDA graph may run, from :meth:`_Graph.roots` across the
    modules of ``trees``: every name a reachable scope reads that
    denotes a function of the port within :data:`GRAPH_SCOPES` is
    reachable too."""
    g = _Graph(trees)
    seen: Set[int] = set()
    out: Dict[str, List[ast.AST]] = {}
    work = g.roots()
    while work:
        path, fn = work.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.setdefault(path, []).append(fn)
        for node in _own_nodes(fn):
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    node.ctx, ast.Load):
                work.extend((p, d) for p, d in g.resolve(path, node)
                            if p.startswith(GRAPH_SCOPES))
            elif isinstance(node, ast.Lambda):
                work.append((path, node))
    return out


def _first_line(node: ast.AST) -> int:
    """A function's first line as its code object's ``co_firstlineno``
    counts it: the first decorator's, if any."""
    decos = getattr(node, "decorator_list", [])
    return min([d.lineno for d in decos] + [node.lineno])


def captured_functions(root=".") -> Set[Tuple[str, int]]:
    """``(repo-relative path, first line)`` of every function and lambda
    R002 holds (:func:`graph_reachable` over ``src/repro_torch`` under
    ``root``)."""
    trees = {p: ast.parse(s)
             for p, s in collect_files(root, ["src/repro_torch"]).items()}
    return {(p, _first_line(fn)) for p, fns in graph_reachable(trees).items()
            for fn in fns if isinstance(fn, _FuncNode)}


def trace_calls(fn, *args, root=".", **kw):
    """Run ``fn(*args, **kw)`` under ``sys.setprofile``; returns ``(its
    result, {(repo-relative path, first line, name)})`` of the functions
    of ``src/repro_torch`` under ``root`` that ran (generator
    expressions count as the function around them)."""
    import os
    import sys
    top = os.path.realpath(root)
    base = os.path.join(top, "src", "repro_torch") + os.sep
    seen: Set[Tuple[str, int, str]] = set()
    where: Dict[str, str] = {}          # co_filename -> real path

    def hook(frame, event, _arg):
        if event != "call":
            return
        code = frame.f_code
        name = code.co_filename
        if name not in where:
            where[name] = os.path.realpath(name)
        if where[name].startswith(base) and code.co_name not in (
                "<genexpr>", "<listcomp>", "<dictcomp>", "<setcomp>"):
            rel = os.path.relpath(where[name], top)
            seen.add((rel.replace(os.sep, "/"), code.co_firstlineno,
                      code.co_name))

    old = sys.getprofile()
    sys.setprofile(hook)
    try:
        out = fn(*args, **kw)
    finally:
        sys.setprofile(old)
    return out, seen


def _subscripts_device_data(node: ast.AST) -> bool:
    """True when an int()/float() argument indexes what is plausibly an
    array (any subscript not rooted in a static `.shape` chain)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript):
            base = sub.value
            static = False
            for part in ast.walk(base):
                if isinstance(part, ast.Attribute) and part.attr in (
                        "shape", "ndim", "size"):
                    static = True
            if not static:
                return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)\
                and sub.func.attr == "item":
            return True
    return False


def _bool_mask(idx: ast.AST) -> bool:
    """An index that is a comparison or a logical combination of them."""
    if isinstance(idx, ast.Compare):
        return True
    if isinstance(idx, ast.UnaryOp) and isinstance(idx.op, (ast.Invert,
                                                            ast.Not)):
        return _bool_mask(idx.operand)
    if isinstance(idx, ast.BinOp) and isinstance(idx.op, (ast.BitAnd,
                                                          ast.BitOr)):
        return _bool_mask(idx.left) or _bool_mask(idx.right)
    return False


def _banned(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Subscript) and _bool_mask(node.slice):
        return "boolean-mask indexing (a data-dependent shape)"
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _HOST_READS:
            return f".{f.attr}()"
        if f.attr in _DATA_SHAPES:
            return f"{f.attr} (a data-dependent shape)"
        if f.attr == "repeat_interleave" and not any(
                kw.arg == "output_size" for kw in node.keywords):
            return "repeat_interleave without output_size"
        if f.attr == "where" and len(node.args) == 1 and not node.keywords:
            return "one-argument where (a data-dependent shape)"
        if isinstance(f.value, ast.Name) and f.value.id in (
                "np", "numpy", "onp") and f.attr in (
                "asarray", "array", "frombuffer", "copy"):
            return f"np.{f.attr}"
    if isinstance(f, ast.Name) and f.id in ("int", "float", "bool") and \
            node.args and _subscripts_device_data(node.args[0]):
        return f"{f.id}() on a tensor element"
    return None


def _r002(trees: Dict[str, ast.Module]) -> List[Finding]:
    """Cross-file R002: banned calls in every captured scope."""
    out: List[Finding] = []
    reported: Set[Tuple[str, int, int]] = set()
    for path, scopes in graph_reachable(trees).items():
        for scope in scopes:
            for node in _own_nodes(scope):
                bad = _banned(node)
                key = (path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0))
                if not bad or key in reported:
                    continue
                reported.add(key)
                out.append(Finding(
                    "R002", path, key[1], key[2],
                    f"{bad} in code a CUDA graph captures (reached from "
                    f"the decode chunk) reads the host or takes a shape "
                    f"from the data",
                    "keep values on the device (torch.where, index with "
                    "device tensors, fixed shapes); a branch that only "
                    "runs on the host side of the graph takes an R002 "
                    "ignore pragma with its reason on the line"))
    return out


# -- R003: replica reach-through ----------------------------------------------


class _R003(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in ("engine", "_engine") and not self._allowed(
                node.value):
            self.findings.append(Finding(
                "R003", self.path, node.lineno, node.col_offset,
                f".{node.attr} attribute reach-through bypasses the "
                f"client/transport seams",
                "go through PrefillClient/DecodeClient (e.g. "
                "client.page_stats(), warmup_gateway(gw, ...)) — an RPC "
                "replica has no engine attribute to reach"))
        self.generic_visit(node)

    @staticmethod
    def _allowed(base: ast.AST) -> bool:
        # self.engine (a replica's own engine) and self.replica.engine
        # (the LocalReplicaClient property) are the defining sites
        if isinstance(base, ast.Name) and base.id == "self":
            return True
        return (isinstance(base, ast.Attribute) and base.attr == "replica"
                and isinstance(base.value, ast.Name)
                and base.value.id == "self")


# deleted admission shims: DecodeEngine.admit(AdmissionBatch) is the ONE
# entry point (gateway §"unified admission"); the per-source variants are
# gone and must not come back
_DELETED_ADMIT_SHIMS = ("admit_batch", "admit_prefix", "admit_migrated")


class _R003Coordinator(ast.NodeVisitor):
    """Deleted shims stay deleted. The Coordinator class/module (PR 2)
    and the per-source admission variants (``admit_batch`` /
    ``admit_prefix`` / ``admit_migrated``, folded into
    ``admit(AdmissionBatch)``) each reintroduce a second public entry
    point and fail ``--strict``."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def _flag_admit(self, node: ast.AST, what: str):
        self.findings.append(Finding(
            "R003", self.path, node.lineno, node.col_offset,
            f"{what} reintroduces a deleted admission shim",
            "wrap the items in AdmissionItem/AdmissionBatch and call "
            "admit(batch) — ADMIT_FRESH/CHUNKED/PREFIX_HIT/MIGRATED tag "
            "the source"))

    def visit_Call(self, node: ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _DELETED_ADMIT_SHIMS):
            self._flag_admit(node, f"call to .{node.func.attr}(...)")
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if (node.name in _DELETED_ADMIT_SHIMS
                and self.path.startswith("src/repro_torch/serving/")):
            self._flag_admit(node, f"def {node.name} in serving/")
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _flag(self, node: ast.AST, what: str):
        self.findings.append(Finding(
            "R003", self.path, node.lineno, node.col_offset,
            f"{what} reintroduces the deleted Coordinator shim",
            "port to repro_torch.serving.gateway.Gateway (submit/"
            "run_until_drained accept bare GenRequests)"))

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            if a.name.startswith("repro_torch.serving.coordinator"):
                self._flag(node, f"import {a.name}")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        if mod.startswith("repro_torch.serving.coordinator") or (
                mod.endswith("serving") and any(
                    a.name == "coordinator" for a in node.names)):
            self._flag(node, f"from {mod} import ...")
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef):
        if (node.name == "Coordinator"
                and self.path.startswith("src/repro_torch/serving/")):
            self._flag(node, f"class {node.name} in serving/")
        self.generic_visit(node)


# -- R004: FAILED/REJECTED must carry a reason --------------------------------

_TERMINAL_BAD = ("FAILED", "REJECTED")


def _names_state(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name) and node.id in _TERMINAL_BAD:
        return node.id
    if isinstance(node, ast.Constant) and node.value in _TERMINAL_BAD:
        return str(node.value)
    return None


class _R004(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "_transition" \
                and node.args:
            st = _names_state(node.args[0])
            if st is not None:
                has_reason = len(node.args) >= 3 or any(
                    kw.arg == "reason"
                    and not (isinstance(kw.value, ast.Constant)
                             and kw.value.value is None)
                    for kw in node.keywords)
                if not has_reason:
                    self.findings.append(Finding(
                        "R004", self.path, node.lineno, node.col_offset,
                        f"transition to {st} without a reason",
                        "pass reason=... — operators debug terminal "
                        "states from RequestHandle.reason"))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        st = _names_state(node.value)
        if st is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and tgt.attr == "state":
                    self.findings.append(Finding(
                        "R004", self.path, node.lineno, node.col_offset,
                        f"direct state assignment to {st} bypasses the "
                        f"state machine",
                        "use RequestHandle._transition(..., reason=...) — "
                        "it validates the DESIGN.md §5 transition table"))
        self.generic_visit(node)


# -- R006: pool internals stay in the pool ------------------------------------

_POOL_INTERNALS = ("_free", "_owners", "_by_owner", "_grant", "_revoke")


class _R006(ast.NodeVisitor):
    """No ``PagePool`` internal access outside ``serving/page_pool.py``.

    ``self._owners`` (etc.) is allowed — a subclass extending the pool
    (the sanitizer's site-tracking pool) is still "in" the pool; any
    other base expression is a caller mutating refcount state around the
    share/free API and breaking the multi-owner invariant."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in _POOL_INTERNALS and not (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            self.findings.append(Finding(
                "R006", self.path, node.lineno, node.col_offset,
                f".{node.attr} reaches into PagePool refcount internals",
                "refcount/free-list mutation lives only in "
                "serving/page_pool.py — use alloc/share/free/unshare/"
                "owned_by/owners_of/refcount/pages_in_use"))
        self.generic_visit(node)


# -- R005: layout lockstep ----------------------------------------------------

# the port's Python modules that pick a group or pack a nibble; the
# kernel wrappers kv_quant.py / paged_attention.py derive neither (the
# CUDA sources pack, the pages' shapes carry the group width)
_R005_IMPORT_REQUIREMENTS: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/serving/kv_transfer.py": ("pick_group",),
    "src/repro_torch/models/paged.py": ("pick_group",),
    "src/repro_torch/kernels/ref.py": ("pack_nibbles",),
}


def _imports_from_layout(tree: ast.Module) -> Set[str]:
    got: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("kernels.kv_layout"):
            got.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("kernels"):
            got.update(a.name for a in node.names
                       if a.name == "kv_layout")
        elif isinstance(node, ast.Import):
            got.update(a.name.rsplit(".", 1)[-1] for a in node.names
                       if a.name.endswith("kv_layout"))
    return got


def _r005_file(path: str, tree: ast.Module) -> List[Finding]:
    """Per-file half of R005: no local copies of the layout contract."""
    if path == LAYOUT_MODULE or not path.startswith("src/repro_torch/"):
        return []
    out: List[Finding] = []
    for node in ast.walk(tree):
        # (a) a local candidate-group tuple
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Tuple):
            elts = node.value.elts
            ints = (len(elts) >= 2 and all(
                isinstance(e, ast.Constant) and isinstance(e.value, int)
                for e in elts))
            named = any(isinstance(t, ast.Name) and "GROUPS" in t.id.upper()
                        for t in node.targets)
            if ints and named:
                out.append(Finding(
                    "R005", path, node.lineno, node.col_offset,
                    "local quantization-group candidate tuple can drift "
                    "from kernels/kv_layout.GROUPS",
                    "import GROUPS/pick_group from "
                    "repro_torch.kernels.kv_layout"
                ))
        # (b) a local group-selection expression
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "next" and node.args and isinstance(
                node.args[0], ast.GeneratorExp):
            gen = node.args[0].generators[0]
            over_groups = isinstance(gen.iter, ast.Name) and \
                "GROUPS" in gen.iter.id.upper()
            mod_test = any(
                isinstance(c, ast.Compare)
                and isinstance(c.left, ast.BinOp)
                and isinstance(c.left.op, ast.Mod)
                for c in gen.ifs)
            if over_groups and mod_test:
                out.append(Finding(
                    "R005", path, node.lineno, node.col_offset,
                    "local group-selection logic can drift from "
                    "kv_layout.pick_group",
                    "call repro_torch.kernels.kv_layout.pick_group(span)"))
        # (c) local nibble pack/unpack arithmetic
        if isinstance(node, ast.BinOp) and isinstance(
                node.right, ast.Constant):
            nibble = ((isinstance(node.op, ast.BitAnd)
                       and node.right.value == 0xF)
                      or (isinstance(node.op, (ast.LShift, ast.RShift))
                          and node.right.value == 4))
            if nibble:
                out.append(Finding(
                    "R005", path, node.lineno, node.col_offset,
                    "local int4 nibble arithmetic can drift from the "
                    "kv_layout packing order",
                    "use kv_layout.pack_nibbles / unpack_nibbles / "
                    "interleave_nibbles"))
    return out


def _r005_cross(trees: Dict[str, ast.Module]) -> List[Finding]:
    """Cross-file half: the consumers must actually import the contract."""
    out: List[Finding] = []
    for path, required in _R005_IMPORT_REQUIREMENTS.items():
        tree = trees.get(path)
        if tree is None:
            continue
        got = _imports_from_layout(tree)
        if not any(r in got for r in required):
            out.append(Finding(
                "R005", path, 1, 0,
                f"does not import the layout contract "
                f"({' / '.join(required)}) from kernels/kv_layout",
                "a module in the wire/page path that stops importing "
                "kv_layout has necessarily grown a local copy — move the "
                "logic back"))
    if LAYOUT_MODULE in trees:
        has_groups = any(
            isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "GROUPS"
                for t in n.targets)
            for n in ast.walk(trees[LAYOUT_MODULE]))
        if not has_groups:
            out.append(Finding(
                "R005", LAYOUT_MODULE, 1, 0,
                "layout module no longer defines GROUPS",
                "kv_layout.py owns the candidate tuple; do not move it"))
    return out


# -- rule scoping + entry points ----------------------------------------------


# R008: the modules that OWN the wire row-layout contract (plus the
# runtime auditor, which recomputes it on purpose to audit it)
_R008_BLESSED = ("src/repro_torch/serving/kv_transfer.py",
                 "src/repro_torch/serving/page_pool.py",
                 "src/repro_torch/models/paged.py",
                 "src/repro_torch/analysis/sanitizers.py")


def _in_scope(rule: str, path: str) -> bool:
    """The reference's scopes over the port's tree (no ``benchmarks/``:
    the port has none). R002 has no per-file scope: its closure
    (:func:`graph_reachable`) decides."""
    if rule == "R001":
        # chaos/virtual-clock discipline extends to the suites that drive
        # the gateway: a test reading wall time silently stops exercising
        # VirtualClock paths
        return path.startswith(("src/repro_torch/serving/", "tests/"))
    if rule == "R003":
        return path == "src/repro_torch/serving/gateway.py"
    if rule == "R003ban":
        # the Coordinator ban applies everywhere the linter looks
        return path.startswith(("src/repro_torch/", "tests/"))
    if rule in ("R004", "R006"):
        return path.startswith("src/repro_torch/") and not (
            rule == "R006" and path == POOL_MODULE)
    if rule == "R007":
        return path.startswith(("src/repro_torch/", "tests/"))
    if rule == "R008":
        return (path.startswith("src/repro_torch/")
                and not path.startswith("src/repro_torch/kernels/")
                and path not in _R008_BLESSED)
    return True


def lint_sources(files: Dict[str, str], *,
                 strict: bool = False) -> List[Finding]:
    """Lint a mapping of repo-relative posix paths -> source text.

    This is the testable core: the CLI builds the mapping from the tree,
    unit tests feed synthetic snippets. Returns findings with pragmas
    already applied (plus unused-pragma findings under ``strict``)."""
    from repro_torch.analysis import dataflow  # deferred: imports Finding

    findings: List[Finding] = []
    trees: Dict[str, ast.Module] = {}
    pragmas: Dict[str, Dict[int, Set[str]]] = {}
    for path, src in files.items():
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                "E000", path, e.lineno or 1, 0,
                f"syntax error: {e.msg}", ""))
            continue
        trees[path] = tree
        pragmas[path] = _pragmas(src)
        if _in_scope("R001", path):
            v = _R001(path)
            v.visit(tree)
            findings.extend(v.findings)
        if _in_scope("R003", path):
            v = _R003(path)
            v.visit(tree)
            findings.extend(v.findings)
        if _in_scope("R003ban", path):
            v = _R003Coordinator(path)
            v.visit(tree)
            findings.extend(v.findings)
        if _in_scope("R004", path):
            v = _R004(path)
            v.visit(tree)
            findings.extend(v.findings)
        if _in_scope("R006", path):
            v = _R006(path)
            v.visit(tree)
            findings.extend(v.findings)
        if _in_scope("R007", path):
            v = dataflow._R007(path)
            v.visit(tree)
            findings.extend(v.findings)
        if _in_scope("R008", path):
            v = dataflow._R008(path)
            v.visit(tree)
            findings.extend(v.findings)
        findings.extend(_r005_file(path, tree))
    findings.extend(_r005_cross(trees))
    findings.extend(_r002(trees))
    # apply pragmas (a pragma on the finding's line or the line above)
    used: Set[Tuple[str, int, str]] = set()
    kept: List[Finding] = []
    for f in findings:
        fp = pragmas.get(f.path, {})
        hit = None
        for ln in (f.line, f.line - 1):
            if f.rule in fp.get(ln, ()):
                hit = ln
                break
        if hit is None:
            kept.append(f)
        else:
            used.add((f.path, hit, f.rule))
    if strict:
        for path, per_line in pragmas.items():
            for ln, rules in per_line.items():
                for r in rules:
                    if (path, ln, r) not in used:
                        kept.append(Finding(
                            "W001", path, ln, 0,
                            f"unused `# repro: ignore[{r}]` pragma",
                            "delete it — dead pragmas hide future "
                            "violations"))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


DEFAULT_ROOTS = ("src/repro_torch", "tests")


def collect_files(root, paths: Optional[Sequence[str]] = None
                  ) -> Dict[str, str]:
    """Gather ``*.py`` under ``paths`` (default: the linted roots),
    keyed by repo-relative posix path."""
    import pathlib
    root = pathlib.Path(root)
    out: Dict[str, str] = {}
    for p in (paths or DEFAULT_ROOTS):
        base = root / p
        candidates = [base] if base.is_file() else sorted(
            base.rglob("*.py")) if base.is_dir() else []
        for f in candidates:
            rel = f.relative_to(root).as_posix()
            out[rel] = f.read_text()
    return out


def run_lint(root=".", paths: Optional[Sequence[str]] = None, *,
             strict: bool = False) -> List[Finding]:
    return lint_sources(collect_files(root, paths), strict=strict)
