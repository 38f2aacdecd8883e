"""The port stands alone, and its copies of the reference's jax-free
modules have not drifted.

* ``repro_torch`` imports, serves (``launch.serve`` and
  ``launch.serve_e2e``) and simulates with ``jax`` and ``repro`` blocked
  in ``sys.meta_path`` (a subprocess), and an AST scan finds no import of
  either in ``src/repro_torch/`` or ``chip_smoke.py``; the kernel modules
  hold no ``try`` that could turn a failed build or launch into the plain
  version.
* The copies of ``protocol.py`` (the lifecycle table and every hook over
  small exhaustive ranges), ``PagePool``, ``PrefixCache`` and the
  ``ModelConfig`` behave like the reference's, so the model checker's
  guarantees about the reference's hooks (DESIGN.md §12) hold for the
  copies too.
* The copies of the gateway, transport, faults, profiler, the runtime
  sanitizers, the scheduler core, the serving simulator, the paper's
  baselines, the paper's GPU table, the registered configs, the
  training data pipeline, the sharding rules and the mesh helpers are
  the reference's code: their ASTs are equal,
  definition by definition, once imports and docstrings are set aside,
  except for the definitions listed (with the reason) in
  ``COPY_DIFFERENCES``.
"""
import ast
import dataclasses
import itertools
import os
import pathlib
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS as J_ALL_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.serving import page_pool as j_pp  # noqa: E402
from repro.serving import prefix_cache as j_pc  # noqa: E402
from repro.serving import protocol as j_proto  # noqa: E402
from conftest import jax_block  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.serving import page_pool as t_pp  # noqa: E402
from repro_torch.serving import prefix_cache as t_pc  # noqa: E402
from repro_torch.serving import protocol as t_proto  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_file_of_the_port_imports_jax_or_repro():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_kernel_modules_hold_no_fallback():
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.name}: try at lines {tries}"


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(2)
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import init_params
from repro_torch.serving import engine as E
cfg = get_reduced("llama-30b")
params = init_params(cfg, device="cpu")
pre = E.PrefillEngine(cfg, params, max_seq=32, device="cpu")
dec = E.DecodeEngine(cfg, params, max_slots=2, max_seq=32, page_size=8,
                     device="cpu")
req = E.GenRequest(0, np.arange(1, 12), 5)
(r, w, f), = pre.run([req])
assert not dec.admit(E.AdmissionBatch([E.AdmissionItem(r, f, wire=w)]))
while dec.active:
    dec.step()
assert len(req.out_tokens) == 5
from repro_torch.launch import serve
out = serve.run(["--device", "cpu", "--reduced", "--duration", "1",
                 "--steps", "4"])
assert out["summary"]["n_done"] == out["summary"]["n_submitted"] > 0
from repro_torch.configs import get_config
from repro_torch.core import baselines, simulator
from repro_torch.core.orchestrator import SloSpec
from repro_torch.core.workload import CONVERSATION, generate
slo = SloSpec(2.0, 0.15, 30.0)
bl = baselines.distserve_like(get_config("llama-30b"), CONVERSATION, 2.0,
                              slo)
res = simulator.simulate(bl.cluster, get_config("llama-30b"), bl.replicas,
                         bl.orchestration,
                         generate(CONVERSATION, rate=2.0, duration=10,
                                  seed=0), slo, compress=bl.compress,
                         colocated=bl.colocated)
assert res.requests
from repro_torch.launch import serve_e2e
out = serve_e2e.run(["--device", "cpu", "--reduced", "--requests", "3"])
assert out["summary"]["n_done"] == 3
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print("OK")
"""


def test_port_imports_and_serves_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


# -- configs -------------------------------------------------------------------


# the port's own block options (ROADMAP C.4): their defaults are the
# reference's behaviour, and jamba's config turns them on with a dropless
# capacity factor
PORT_FIELDS = ("moe_renormalize", "mamba_inner_norms")


def test_model_config_copy_matches():
    """The port registers every arch of the reference, in its order, and
    each, full and reduced, has the reference's fields (and the port's
    ``PORT_FIELDS``), parameter count and layer kinds, and the
    reference's values once its block options are the reference's
    (``conftest.jax_block``); only jamba's differ before."""
    assert [f.name for f in dataclasses.fields(ModelConfig)
            if f.name not in PORT_FIELDS] == \
        [f.name for f in dataclasses.fields(JModelConfig)]
    assert ALL_ARCHS == J_ALL_ARCHS and len(ALL_ARCHS) == 11
    for arch in ALL_ARCHS:
        for mine, theirs in ((get_config(arch), j_get_config(arch)),
                             (get_reduced(arch), j_get_reduced(arch))):
            assert (jax_block(mine) == mine) == (arch != "jamba-v0.1-52b")
            d = dataclasses.asdict(jax_block(mine))
            for f in PORT_FIELDS:
                del d[f]
            assert d == dataclasses.asdict(theirs)
            assert mine.param_count() == theirs.param_count()
            assert mine.layer_kinds() == theirs.layer_kinds()


# -- protocol hooks ------------------------------------------------------------


def test_protocol_table_and_states_match():
    assert t_proto.TRANSITIONS == j_proto.TRANSITIONS
    assert t_proto.TERMINAL_STATES == j_proto.TERMINAL_STATES
    states = sorted(j_proto.TRANSITIONS)
    for a, b in itertools.product(states + ["BOGUS"], repeat=2):
        assert t_proto.legal(a, b) == j_proto.legal(a, b)


def test_protocol_hooks_match_exhaustively():
    for donate in (False, True):
        assert t_proto.retire_steps(donate) == j_proto.retire_steps(donate)
    for n, ps, w in itertools.product(range(0, 41), range(1, 9),
                                      range(1, 9)):
        assert t_proto.cow_boundary(n, ps, w) == \
            j_proto.cow_boundary(n, ps, w)
        for chain in range(0, 9):
            assert t_proto.cow_needed(n, ps, w, chain) == \
                j_proto.cow_needed(n, ps, w, chain)
    for rem, left, sup in itertools.product(range(0, 25), range(0, 25),
                                            (False, True)):
        assert t_proto.chunk_take(rem, left, sup) == \
            j_proto.chunk_take(rem, left, sup)
    for a, b in itertools.product(range(0, 25), repeat=2):
        assert t_proto.chunk_complete(a, b) == j_proto.chunk_complete(a, b)
    assert t_proto.chunk_extract_compress() == \
        j_proto.chunk_extract_compress()


# -- PagePool and PrefixCache driven side by side --------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


def _pool_ops(rng, n_pages):
    owners = [0, 1, 2, "pin"]
    pages = list(range(0, n_pages + 1))
    for _ in range(400):
        op = rng.choice(["alloc", "share", "free", "unshare", "free_none"])
        owner = rng.choice(owners)
        sel = rng.sample(pages, rng.randint(0, 3))
        if op == "alloc":
            yield "alloc", (rng.randint(0, 4), owner)
        elif op == "free_none":
            yield "free", (sel, None)
        else:
            yield op, (sel, owner)


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_copy_behaves_like_reference(seed):
    rng = random.Random(seed)
    a, b = j_pp.PagePool(9, 4), t_pp.PagePool(9, 4)
    for op, args in _pool_ops(rng, 9):
        assert _outcome(getattr(a, op), *args) == \
            _outcome(getattr(b, op), *args), (op, args)
        assert a.state_key() == b.state_key()
        assert a.stats() == b.stats()
        a.canonicalize()
        b.canonicalize()
    for n in (0, 1, 4, 5, 8, 9, 17):
        assert t_pp.pages_needed(n, 4) == j_pp.pages_needed(n, 4)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_copy_behaves_like_reference(seed):
    """Donate finished chains, match prompts and evict in the same order
    on both; matches, stats and the pools' states stay equal."""
    rng = random.Random(100 + seed)
    ps = 4
    sides = []
    for pp, pc in ((j_pp, j_pc), (t_pp, t_pc)):
        sides.append((pp.PagePool(40, ps), pc.PrefixCache(ps)))
    vocab = [1, 2, 3]
    for step in range(60):
        kind = rng.choice(["donate", "match", "evict", "donate"])
        if kind == "donate":
            n_prompt = rng.randint(1, 10)
            toks = [rng.choice(vocab) for _ in range(n_prompt + 3)]
            kv_len = rng.randint(1, len(toks))
            need = t_pp.pages_needed(kv_len, ps)
            results = []
            for pool, cache in sides:
                chain = pool.alloc(need, ("slot", step))
                if chain is None:
                    results.append(None)
                    continue
                got = cache.insert(toks, kv_len, chain, n_prompt, pool)
                pool.free(chain, owner=("slot", step))
                results.append(got)
            assert results[0] == results[1]
        elif kind == "match":
            toks = [rng.choice(vocab) for _ in range(rng.randint(1, 12))]
            ms = [cache.match(toks) for _, cache in sides]
            assert (ms[0] is None) == (ms[1] is None)
            if ms[0] is not None:
                assert (ms[0].length, ms[0].pages, ms[0].full,
                        ms[0].next_token) == (ms[1].length, ms[1].pages,
                                              ms[1].full, ms[1].next_token)
        else:
            n = rng.randint(1, 5)
            assert sides[0][1].evict(sides[0][0], n) == \
                sides[1][1].evict(sides[1][0], n)
        assert sides[0][1].stats() == sides[1][1].stats()
        assert sides[0][1].page_set() == sides[1][1].page_set()
        assert sides[0][0].state_key() == sides[1][0].state_key()
    assert sides[0][1].clear(sides[0][0]) == sides[1][1].clear(sides[1][0])
    assert sides[0][0].state_key() == sides[1][0].state_key()


# -- copies held to the reference's AST ----------------------------------------

REF = ROOT / "src" / "repro"

# module -> {definition: how it may differ}. A definition not named here
# must be equal to the reference's (imports and docstrings aside). A named
# one is either ONE_SIDE (on one side only, or rewritten whole), or a
# function that keeps the reference's statements except those whose
# source holds the port's marker where the reference's holds its own, and
# whose arguments may differ only where ``args`` says so.
ONE_SIDE = None


def _stmts(mine, theirs, *, args=False):
    return {"markers": (mine, theirs), "args": args}


COPY_DIFFERENCES = {
    "serving/gateway.py": {
        # Replica(rt=...) -> Replica(device=...)
        "gateway_from_plan": _stmts("device", "rt", args=True),
    },
    "analysis/sanitizers.py": {
        # allocation sites leave out the port's own sanitizer frames
        "_site": _stmts("repro_torch", "repro"),
    },
    "analysis/lint.py": {
        # the R002 rewrite: what a CUDA graph captures, across modules
        **{name: ONE_SIDE for name in (
            "_jit_like", "_loop_body_args", "_JitScopeCollector",
            "_JitScopeCollector.__init__",
            "_JitScopeCollector.visit_FunctionDef",
            "_JitScopeCollector.visit_AsyncFunctionDef",
            "_JitScopeCollector._decorator_jits",
            "_JitScopeCollector.visit_Call", "_JitScopeCollector.reachable",
            "_R002", "_R002.__init__", "_R002.run", "_R002._banned",
            "GRAPH_SCOPES", "GRAPH_ROOT", "_HOST_READS", "_DATA_SHAPES",
            "module_of", "_Module", "_Module.__init__", "_Module.enclosing",
            "_Module.local_defs", "_own_nodes", "_Graph", "_Graph.__init__",
            "_Graph._top", "_Graph._imported", "_Graph.resolve",
            "_Graph.roots", "_callee_name", "_is_graph_capture",
            "graph_reachable", "_bool_mask", "_banned", "_r002", "RULES",
            "_first_line", "captured_functions", "trace_calls")},
        # the path scopes: src/repro_torch/ and tests/, no benchmarks/
        "POOL_MODULE": ONE_SIDE, "LAYOUT_MODULE": ONE_SIDE,
        "_R008_BLESSED": ONE_SIDE, "_in_scope": ONE_SIDE,
        "DEFAULT_ROOTS": ONE_SIDE,
        "_R003Coordinator.visit_FunctionDef": _stmts("repro_torch", "repro"),
        "_R003Coordinator._flag": _stmts("repro_torch", "repro"),
        "_R003Coordinator.visit_Import": _stmts("repro_torch", "repro"),
        "_R003Coordinator.visit_ImportFrom": _stmts("repro_torch", "repro"),
        "_R003Coordinator.visit_ClassDef": _stmts("repro_torch", "repro"),
        # the R005 table of the port's modules; its hints name the port
        "_R005_IMPORT_REQUIREMENTS": ONE_SIDE,
        "_r005_file": _stmts("repro_torch", "repro"),
        # R002 runs across files, after R005's cross-file half
        "lint_sources": ONE_SIDE,
    },
    "analysis/dataflow.py": {},
    "analysis/modelcheck.py": {
        # the replay target: the port's gateway, no jax to wait for
        "run_mutations": ONE_SIDE, "_jax_available": ONE_SIDE,
    },
    "analysis/__main__.py": {
        # the port's name in the CLI's output and help
        "_cmd_lint": _stmts("repro_torch", "repro"),
        "_cmd_check": _stmts("repro_torch", "repro"),
        # and --replay's help: the port's replay needs no jax
        "main": ONE_SIDE,
    },
    "serving/transport.py": {},
    "serving/faults.py": {},
    "serving/profiler.py": {},
    "core/__init__.py": {},
    "core/workload.py": {},
    "core/costmodel.py": {},
    "core/parallel.py": {},
    "core/tabu.py": {},
    "core/orchestrator.py": {},
    "core/scheduler.py": {},
    "core/simulator.py": {},
    "core/baselines.py": {},
    "core/cluster.py": {
        # the TPU fleet is left out: the port states no TPU figure
        "TPU_PROFILES": ONE_SIDE,
        "make_tpu_fleet": ONE_SIDE,
        "_build": _stmts("GPU_SPECS[tname]", "TPU_PROFILES"),
        "make_cluster": ONE_SIDE,          # "tpu_fleet" raises
    },
    # the H100 the port runs on in place of the TPU
    "roofline/hw.py": {"TPU_V5E": ONE_SIDE, "H100": ONE_SIDE,
                       "NVLINK_LINKS": ONE_SIDE},
    # the roofline terms of a counted step (roofline/op_cost.py) for the
    # reference's HLO parsing; Roofline and model_flops_for are copies
    "roofline/analysis.py": {
        **{name: ONE_SIDE for name in (
            "_DTYPE_BYTES", "_COLLECTIVES", "_SHAPE_RE", "_OP_RE",
            "_GROUPS_RE", "_GROUPS_IOTA_RE", "_shape_bytes",
            "CollectiveStats", "CollectiveStats.total_payload",
            "parse_collectives")},
        "wire_bytes": ONE_SIDE,
        "analyze": ONE_SIDE,
    },
    # the port's own records (results/dryrun_torch/)
    "roofline/report.py": {"RESULTS": ONE_SIDE},
    # the reference's get_reduced has no check of the name
    "configs/__init__.py": {"get_reduced": ONE_SIDE},
    "configs/llama_30b.py": {},
    "configs/stablelm_3b.py": {},
    "configs/gemma_2b.py": {},
    "configs/h2o_danube_3_4b.py": {},
    "configs/command_r_35b.py": {},
    "configs/qwen3_moe_235b_a22b.py": {},
    "configs/llama4_maverick_400b_a17b.py": {},
    "configs/llava_next_mistral_7b.py": {},
    # the published block: inner norms, gates as they come, dropless
    "configs/jamba_v01_52b.py": {"CONFIG": ONE_SIDE, "reduced": ONE_SIDE},
    # the dataclass gains PORT_FIELDS (test_model_config_copy_matches)
    "configs/base.py": {"ModelConfig": ONE_SIDE},
    "configs/xlstm_125m.py": {},
    "configs/whisper_base.py": {},
    # a data rank's rows of the global batch (the sharded train step)
    "training/data.py": {"rank_rows": ONE_SIDE},
    "distributed/sharding.py": {
        # a tuple of the port's own for jax's PartitionSpec
        "P": ONE_SIDE,
        "P.__new__": ONE_SIDE,
        # the mesh's {axis: size} (a DeviceMesh's shape is a tuple)
        "_resolve": _stmts("shape_of", "mesh.shape"),
        # explicit SPMD: checks a local shape, moves nothing
        "constrain": ONE_SIDE,
        # the rank-local config and parameters, the refusals
        **{name: ONE_SIDE for name in (
            "_fits", "local_shape", "STEP_TWO", "tp_refusals", "check_tp",
            "rank_cfg", "model_size", "local_cfg", "_split_dim", "_cut",
            "_leaf_specs", "_shard_tree", "shard_params", "RankConfig",
            "RankConfig.mamba_d_inner", "split_of", "kv_replicated",
            "kv_head_of", "_CHUNKED", "_chunks_of", "_rules")},
        # heads the model axis does not split (gathered, the qseq
        # attention) and the kv_seq decode cache
        **{name: ONE_SIDE for name in (
            "heads_split", "gathered", "kv_seq", "whole_heads")},
        # the sharded training step's gradients and checkpoints
        **{name: ONE_SIDE for name in (
            "_PARTIAL", "_KV", "_SLSTM_R", "whole_meta", "_walk",
            "_per_dict",
            "grad_kinds", "sync_grads", "norm_share", "unshard_leaf",
            "unshard_params")},
    },
    "launch/mesh.py": {
        # torch.distributed's DeviceMesh for jax.make_mesh
        "make_production_mesh": ONE_SIDE,
        "make_mesh": ONE_SIDE,
        "data_axes": _stmts("shape_of", "mesh.shape"),
        "shape_of": ONE_SIDE,
        "axis_group": ONE_SIDE,
        # the dry-run's mesh with no process group
        **{name: ONE_SIDE for name in (
            "AbstractMesh", "AbstractMesh.__init__",
            "AbstractMesh.get_local_rank", "abstract_mesh")},
    },
}


class _Strip(ast.NodeTransformer):
    """Drop imports and docstrings; name both packages alike. With
    ``tracer`` (the name the port's module imports
    ``repro_torch.serving.trace`` under; the port's side only) also drop
    the tracer's own statements: a ``with <tracer>.span(...)`` item (a
    ``with`` left with none is replaced by its body) and an expression
    statement calling ``<tracer>.*``, each only where every argument is a
    constant, so no other code hides in them."""

    def __init__(self, tracer=None):
        self.tracer = tracer

    def _is_tracer(self, node):
        return (self.tracer is not None and isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == self.tracer
                and all(isinstance(a, ast.Constant) for a in
                        [*node.args, *(k.value for k in node.keywords)]))

    def visit_With(self, node):
        self.generic_visit(node)
        items = [it for it in node.items
                 if not (self._is_tracer(it.context_expr)
                         and it.context_expr.func.attr == "span")]
        if len(items) == len(node.items):
            return node
        if not items:
            return node.body
        node.items = items
        return node

    def visit_Expr(self, node):
        return None if self._is_tracer(node.value) else node

    def _body(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        node.body = body or [ast.Pass()]
        return node

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _body

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import


def _tracer_name(tree: ast.Module):
    """The name a module imports ``repro_torch.serving.trace`` under, or
    None."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                node.module == "repro_torch.serving":
            for a in node.names:
                if a.name == "trace":
                    return a.asname or a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro_torch.serving.trace" and a.asname:
                    return a.asname
    return None


def _definitions(path: pathlib.Path, *, port: bool = False):
    """{qualified name: ast node} of a module's statements: classes are
    split into their header (bases, decorators, non-method body) and one
    entry per method. ``port``: the tracer's statements are dropped."""
    tree = ast.parse(path.read_text())
    tree = _Strip(_tracer_name(tree) if port else None).visit(tree)
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        body = body[1:]                   # module docstring
    out = {}
    for i, node in enumerate(body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            rest = []
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
                else:
                    rest.append(sub)
            node.body = rest
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out[",".join(ast.unparse(t) for t in targets)] = node
        else:
            out[f"<statement {i}>"] = node
    return out



def _same_but_marked(mine, theirs, rule):
    """A listed function: same decorators and statement count, arguments
    equal unless allowed, and each differing statement carries the
    markers."""
    if rule["args"] is False and ast.dump(mine.args) != ast.dump(theirs.args):
        return False
    if [ast.dump(d) for d in mine.decorator_list] != \
            [ast.dump(d) for d in theirs.decorator_list]:
        return False
    if len(mine.body) != len(theirs.body):
        return False
    mark_mine, mark_theirs = rule["markers"]
    n_diff = 0
    for a, b in zip(mine.body, theirs.body):
        if ast.dump(a) == ast.dump(b):
            continue
        n_diff += 1
        if mark_mine not in ast.unparse(a) or \
                mark_theirs not in ast.unparse(b):
            return False
    return n_diff > 0 or ast.dump(mine.args) != ast.dump(theirs.args)


def _mismatches(module, mine_path, theirs_path):
    """Every way the port's copy departs from the reference beyond
    ``COPY_DIFFERENCES[module]``."""
    mine = _definitions(mine_path, port=True)
    theirs = _definitions(theirs_path)
    allowed = COPY_DIFFERENCES[module]
    bad = []
    for name in sorted(set(mine) | set(theirs)):
        if name in allowed:
            rule = allowed[name]
            if rule is ONE_SIDE:
                # listed, so it must really differ (no stale entries)
                if not (name not in mine or name not in theirs
                        or ast.dump(mine[name]) != ast.dump(theirs[name])):
                    bad.append(f"{module}: {name} listed but equal")
            elif not _same_but_marked(mine[name], theirs[name], rule):
                bad.append(f"{module}: {name} differs beyond its listed "
                           f"change")
        elif name not in mine:
            bad.append(f"{module}: {name} missing from the port")
        elif name not in theirs:
            bad.append(f"{module}: {name} not in the reference")
        elif ast.dump(mine[name]) != ast.dump(theirs[name]):
            bad.append(f"{module}: {name} differs")
    return bad


@pytest.mark.parametrize("module", sorted(COPY_DIFFERENCES))
def test_copies_match_the_reference_ast(module):
    assert not _mismatches(module, PORT / module, REF / module)


def test_the_gateway_imports_the_tracer_and_traces_the_pump():
    tree = ast.parse((PORT / "serving" / "gateway.py").read_text())
    name = _tracer_name(tree)
    assert name is not None
    spans = {n.items[0].context_expr.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.With)
             and _Strip(name)._is_tracer(n.items[0].context_expr)}
    assert {"pump", "pump.housekeeping", "pump.dispatch", "pump.transfers",
            "pump.decode", "pump.deliver"} <= spans


# (old statement in Gateway.pump / _step_decodes, its edit)
_GATEWAY_EDITS = {
    # an edited statement inside a traced span
    "edited_in_span": ("self._flush_retries(now)",
                       "self._flush_retries(now + 1.0)"),
    # a span of another object than the tracer is not stripped
    "other_span": ("with _trace.span('pump.transfers'):",
                   "with self.span('pump.transfers'):"),
    # only expression statements calling the tracer go, not assignments
    "tracer_assignment": ("self._flush_retries(now)",
                          "self._flush_retries(now)\n"
                          "                seen = _trace.spans()"),
    # a call hidden in a span's arguments keeps the span
    "call_in_span_args": ("with _trace.span('pump.housekeeping'):",
                          "with _trace.span('pump.housekeeping', "
                          "n=self._check_heartbeats()):"),
    # a call hidden in a tracer call's arguments keeps the statement
    "call_in_tracer_call": ("self._flush_retries(now)",
                            "self._flush_retries(now)\n"
                            "                _trace.add(n=self._flush_retries(now))"),
}


@pytest.mark.parametrize("edit", sorted(_GATEWAY_EDITS))
def test_a_traced_gateway_with_another_edit_fails_the_comparison(
        edit, tmp_path):
    src = (PORT / "serving" / "gateway.py").read_text()
    old, new = _GATEWAY_EDITS[edit]
    old = old.replace("'", '"')
    new = new.replace("'", '"')
    assert src.count(old) >= 1, old
    edited = tmp_path / "gateway.py"
    edited.write_text(src.replace(old, new, 1))
    ast.parse(edited.read_text())
    bad = _mismatches("serving/gateway.py", edited,
                      REF / "serving" / "gateway.py")
    assert bad == ["serving/gateway.py: Gateway.pump differs"], bad


def test_replica_copy_differs_only_in_its_device_argument():
    mine = _definitions(PORT / "serving" / "engine.py")
    theirs = _definitions(REF / "serving" / "engine.py")
    names = sorted(n for n in theirs if n.split(".")[0] == "Replica")
    assert names == sorted(n for n in mine if n.split(".")[0] == "Replica")
    differ = [n for n in names
              if ast.dump(mine[n]) != ast.dump(theirs[n])]
    assert differ == ["Replica.__init__"]
    # Replica(rt=...) -> Replica(device=...)
    assert _same_but_marked(mine["Replica.__init__"],
                            theirs["Replica.__init__"],
                            _stmts("device", "rt", args=True))
