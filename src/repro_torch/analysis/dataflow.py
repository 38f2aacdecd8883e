"""Wire-provenance dataflow lint: the R007/R008 taint rules.

Stdlib ``ast`` only, same framework as :mod:`repro_torch.analysis.lint` (which
runs these visitors and applies pragmas/scoping). Where R001–R006 are
syntactic pattern rules, these two track *provenance* — what a value IS
(a raw chunk wire, an int4-quantized transport wire, a payload array)
through assignments, loop targets and comprehensions within a function.

* **R007 — quantize once, over the spliced whole.** Chunked prefill
  extracts each chunk RAW (``run(..., compress=False)`` — spelled
  ``compress=protocol.chunk_extract_compress()`` in the engine) and
  accumulates the wires on ``job.wires``; ONLY when the job completes is
  the splice (``concat_wires``) compressed, exactly once. Flagged:
  ``compress_wire`` applied to an already-quantized value (double
  quantization destroys the affine scales), ``compress_wire`` applied to
  a single chunk wire (per-chunk quantization breaks bit-identity with
  one-shot extraction: group statistics differ per chunk), and appending
  a quantized wire to a ``.wires`` chunk list (the resumable prefix must
  stay exact floats).
* **R008 — wire layout arithmetic stays in the layout modules.** The
  position-aligned group-row mapping (row ``t*ppr + r`` holds token
  ``t``'s r-th group, group width from ``kv_layout.pick_group``) is what
  makes wire splices and zero-copy page inserts line up. Outside the
  modules that OWN that contract (``kv_transfer.py``, ``page_pool.py``,
  ``models/paged.py``, ``kernels/``, and the runtime auditor
  ``analysis/sanitizers.py``), code must treat wires as opaque: no
  direct ``KVWire``/``WireTensor`` construction, no ``ppr``/
  ``groups_per_token`` row arithmetic, no manual concatenation of
  ``.payload`` arrays (splice with ``concat_wires``).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.lint import Finding

# taint lattice values
QUANT = "quant"          # int4-quantized wire (compress_wire output)
RAW = "raw"              # raw-float wire (chunk extraction, concat splice)
CHUNK = "chunk"          # one element of a ``.wires`` chunk list
WIRELIST = "wirelist"    # a ``.wires`` attribute itself

_RAW_SOURCES = ("concat_wires", "extract_kv", "extract_resident",
                "extract_slot_wire")


def _callee(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_raw_compress_kw(value: ast.AST) -> bool:
    """``compress=False`` or ``compress=<...>.chunk_extract_compress()``
    — the two sanctioned raw-extraction spellings."""
    if isinstance(value, ast.Constant) and value.value is False:
        return True
    return (isinstance(value, ast.Call)
            and _callee(value) == "chunk_extract_compress")


class _TaintScope:
    def __init__(self):
        self.env: Dict[str, str] = {}


class _R007(ast.NodeVisitor):
    """Function-local wire taint tracking (flow = source order)."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._scopes = [_TaintScope()]

    # -- taint computation ---------------------------------------------------

    def _env(self) -> Dict[str, str]:
        return self._scopes[-1].env

    def taint_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self._env().get(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr == "wires":
                return WIRELIST
            return None
        if isinstance(node, ast.Subscript):
            if self.taint_of(node.value) == WIRELIST:
                return CHUNK
            return None
        if isinstance(node, ast.Call):
            name = _callee(node)
            if name == "compress_wire":
                return QUANT
            if name in _RAW_SOURCES:
                return RAW
            if name == "run":
                return RAW if self._run_is_raw(node) else QUANT
            if name == "materialize" and isinstance(node.func,
                                                    ast.Attribute):
                return self.taint_of(node.func.value)  # wire hop preserves
            return None
        if isinstance(node, ast.IfExp):
            a, b = self.taint_of(node.body), self.taint_of(node.orelse)
            return a if a == b else None
        return None

    @staticmethod
    def _run_is_raw(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg == "compress":
                return _is_raw_compress_kw(kw.value)
        return False                    # run() defaults to compress=True

    # -- scope / binding -----------------------------------------------------

    def visit_FunctionDef(self, node):
        self._scopes.append(_TaintScope())
        self.generic_visit(node)
        self._scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node):
        self.generic_visit(node)
        if len(node.targets) == 1:
            self._bind(node.targets[0], node.value)

    def _bind(self, target: ast.AST, value: ast.AST):
        if isinstance(target, ast.Name):
            t = self.taint_of(value)
            if t is None:
                self._env().pop(target.id, None)
            else:
                self._env()[target.id] = t
        elif (isinstance(target, ast.Tuple)
              and isinstance(value, ast.Tuple)
              and len(target.elts) == len(value.elts)):
            for tgt, val in zip(target.elts, value.elts):
                self._bind(tgt, val)

    def _bind_loop_target(self, target: ast.AST, it: ast.AST):
        if self.taint_of(it) == WIRELIST and isinstance(target, ast.Name):
            self._env()[target.id] = CHUNK
        elif (isinstance(it, ast.Call) and _callee(it) == "run"
              and isinstance(target, ast.Tuple)
              and len(target.elts) == 3
              and isinstance(target.elts[1], ast.Name)):
            # run() yields (req, wire, first_token) triples
            self._env()[target.elts[1].id] = (
                RAW if self._run_is_raw(it) else QUANT)

    def visit_For(self, node):
        self._bind_loop_target(node.target, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node):
        for gen in node.generators:
            self._bind_loop_target(gen.target, gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    # -- violations ----------------------------------------------------------

    def visit_Call(self, node):
        name = _callee(node)
        if name == "compress_wire" and node.args:
            t = self.taint_of(node.args[0])
            if t == QUANT:
                self.findings.append(Finding(
                    "R007", self.path, node.lineno, node.col_offset,
                    "double quantization: compress_wire applied to an "
                    "already-quantized wire",
                    "quantize exactly once — int4 groups re-quantized "
                    "lose their affine scales"))
            elif t == CHUNK:
                self.findings.append(Finding(
                    "R007", self.path, node.lineno, node.col_offset,
                    "quantizing a single chunk wire before the job "
                    "completes",
                    "splice the chunks with concat_wires(job.wires) at "
                    "completion and compress the whole — per-chunk group "
                    "statistics break bit-identity with one-shot "
                    "extraction"))
        elif (name in ("append", "extend")
              and isinstance(node.func, ast.Attribute)
              and self.taint_of(node.func.value) == WIRELIST):
            for arg in node.args:
                if self.taint_of(arg) == QUANT:
                    self.findings.append(Finding(
                        "R007", self.path, node.lineno, node.col_offset,
                        "appending a quantized wire to a chunk list — "
                        "chunk wires must stay RAW until the job "
                        "completes",
                        "extract chunks with compress="
                        "protocol.chunk_extract_compress() (False); the "
                        "resumable prefix must be exact floats"))
        self.generic_visit(node)


# -- R008 ---------------------------------------------------------------------

_SPLICE_CALLS = ("concatenate", "stack", "vstack", "hstack")
_LAYOUT_NAMES = ("ppr", "groups_per_token")


def _mentions_layout_name(node: ast.AST) -> Optional[str]:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in _LAYOUT_NAMES:
            return n.id
        if isinstance(n, ast.Attribute) and n.attr in _LAYOUT_NAMES:
            return n.attr
    return None


def _mentions_payload(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "payload"
               for n in ast.walk(node))


class _R008(ast.NodeVisitor):
    """Wires are opaque outside the layout-owning modules."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def visit_Call(self, node):
        name = _callee(node)
        if name in ("KVWire", "WireTensor"):
            self.findings.append(Finding(
                "R008", self.path, node.lineno, node.col_offset,
                f"constructs {name}(...) outside the wire-layout modules",
                "wires are produced only by kv_transfer (extract_kv / "
                "concat_wires / compress_wire) and page_pool "
                "(extract_slot_wire) — their row layout is a cross-module "
                "contract"))
        elif name == "groups_per_token":
            self.findings.append(Finding(
                "R008", self.path, node.lineno, node.col_offset,
                "computes the wire's groups-per-token layout outside the "
                "layout modules",
                "treat wires as opaque; splice with concat_wires, insert "
                "with page_pool.insert_wires"))
        elif name in _SPLICE_CALLS and any(_mentions_payload(a)
                                           for a in node.args):
            self.findings.append(Finding(
                "R008", self.path, node.lineno, node.col_offset,
                f"manually splices wire payload arrays with {name}()",
                "use kv_transfer.concat_wires — chunk boundaries must "
                "stay group-row aligned, which only the layout modules "
                "guarantee"))
        self.generic_visit(node)

    def visit_BinOp(self, node):
        if isinstance(node.op, (ast.Mult, ast.FloorDiv, ast.Mod)):
            hit = (_mentions_layout_name(node.left)
                   or _mentions_layout_name(node.right))
            if hit:
                self.findings.append(Finding(
                    "R008", self.path, node.lineno, node.col_offset,
                    f"group-row arithmetic over `{hit}` outside the "
                    f"layout modules",
                    "the row `t*ppr + r` mapping belongs to kv_layout / "
                    "kv_transfer / page_pool — go through their APIs"))
                return              # one finding per expression tree
        self.generic_visit(node)
