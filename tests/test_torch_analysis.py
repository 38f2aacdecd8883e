"""repro_torch.analysis: the port's R001-R008 linter, its protocol model
checker and its CLI, against the reference's (``tests/test_analysis.py``;
the sanitizers' tests are ``tests/test_torch_sanitizers.py``).

Each rule fires on a bad snippet and stays quiet on the fixed one, under
the port's paths; the same snippets, paths mapped, give the port's linter
the reference's rules and lines (R001, R003-R008). R002 is the port's
own: code a CUDA graph captures, found across modules from the decode
chunk, must not read the host or take a shape from the data. The real
tree lints clean under ``--strict``, and every function a reduced
model's eager decode chunk runs lies in R002's reachable set. The model
checker visits as many states and transitions as the reference's, and
catches every planted bug with a trace that replays through the port's
real code (the lifecycle's through the port's gateway handle, no jax).
"""
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as j_lint  # noqa: E402
from repro.analysis import modelcheck as j_mc  # noqa: E402
from repro_torch.analysis import lint as t_lint  # noqa: E402
from repro_torch.analysis import modelcheck as mc  # noqa: E402
from repro_torch.analysis.lint import Finding, lint_sources, run_lint  # noqa: E402,E501

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
S = "src/repro_torch/"


def rules_of(files, **kw):
    return [f.rule for f in lint_sources(files, **kw)]


# -- the reference's snippets, under the reference's paths ---------------------
# (name, {path: source}); mapped to the port by ``to_port``

_TIME = "import time\ndef pump(self):\n    now = time.time()\n    return now\n"
_NIB = "def unpack(p):\n    return (p & 0xF), (p >> 4)\n"
SNIPPETS = [
    ("r001_call", {"src/repro/serving/foo.py": _TIME}),
    ("r001_monotonic", {"src/repro/serving/foo.py":
                        _TIME.replace("time.time()", "time.monotonic()")}),
    ("r001_clock_ref", {"src/repro/serving/foo.py": (
        "import time\nclass G:\n    def __init__(self, clock=time.time):\n"
        "        self.clock = clock\n    def pump(self):\n"
        "        return self.clock()\n")}),
    ("r001_out_of_scope", {"src/repro/core/foo.py":
                           "import time\nnow = time.time()\n"}),
    ("r001_test_reads_wall_time", {"tests/test_x.py":
                                   "import time\nnow = time.time()\n"}),
    ("r001_default_factory", {"src/repro/serving/foo.py": (
        "import time\nfrom dataclasses import dataclass, field\n"
        "@dataclass\nclass H:\n"
        "    last: float = field(default_factory=time.time)\n")}),
    ("r003_gateway", {"src/repro/serving/gateway.py":
                      "def peek(gw):\n    return gw.dec[0].engine.params\n"}),
    ("r003_defining_sites", {"src/repro/serving/gateway.py": (
        "class C:\n    @property\n    def engine(self):\n"
        "        return self.replica.engine\n    def use(self):\n"
        "        return self.engine\n")}),
    ("r003_engine_module", {"src/repro/serving/engine.py":
                            "def peek(gw):\n    return gw.dec[0].engine\n"}),
    ("r003_coordinator_test", {"tests/test_old.py":
                               "from repro.serving.coordinator import "
                               "Coordinator\n"}),
    ("r003_coordinator_src", {"src/repro/launchers.py":
                              "import repro.serving.coordinator as co\n"}),
    ("r003_coordinator_class", {"src/repro/serving/coordinator.py":
                                "class Coordinator:\n    pass\n"}),
    ("r003_coordinator_elsewhere", {"src/repro/core/foo.py":
                                    "class Coordinator:\n    pass\n"}),
    ("r003_gateway_import_ok", {"tests/test_new.py":
                                "from repro.serving.gateway import Gateway\n"}),
    ("r003_admit_shim_def", {"src/repro/serving/engine2.py": (
        "class E:\n    def admit_batch(self, x):\n        pass\n")}),
    ("r003_admit_shim_call", {"src/repro/serving/engine2.py": (
        "def f(eng, x):\n    return eng.admit_prefix(x)\n")}),
    ("r004_no_reason", {"src/repro/serving/gateway.py": (
        "def kill(h, now, FAILED='FAILED'):\n    h._transition(FAILED, now)\n")}),
    ("r004_reason", {"src/repro/serving/gateway.py": (
        "def kill(h, now, FAILED='FAILED'):\n"
        "    h._transition(FAILED, now, reason='replica died')\n")}),
    ("r004_assign", {"src/repro/serving/gateway.py": (
        "def hack(h, FAILED='FAILED'):\n    h.state = FAILED\n")}),
    ("r005_group_tuple", {"src/repro/serving/new_wire.py":
                          "MY_GROUPS = (128, 64, 32, 16, 8, 4, 2)\n"}),
    ("r005_device_groups", {"src/repro/serving/new_wire.py":
                            "GROUPS = ((0, 1), (2, 3))\n"}),
    ("r005_selection", {"src/repro/serving/new_wire.py": (
        "from repro.kernels.kv_layout import GROUPS\ndef pick(span):\n"
        "    return next((g for g in GROUPS if span % g == 0), 0)\n")}),
    ("r005_nibbles", {"src/repro/models/new_paged.py": _NIB}),
    ("r005_layout_module", {"src/repro/kernels/kv_layout.py":
                            "GROUPS = (128, 64, 32, 16, 8, 4, 2)\n" + _NIB}),
    ("r005_rogue_consumer", {"src/repro/serving/kv_transfer.py": (
        "_GROUPS2 = [128, 64]\ndef _pick_group(span):\n    return 128\n")}),
    ("r006_reach", {"src/repro/serving/engine.py": (
        "def steal(pool, p):\n    pool._owners.pop(p)\n"
        "    pool._free.append(p)\n")}),
    ("r006_pool_module", {"src/repro/serving/page_pool.py": (
        "def steal(pool, p):\n    pool._owners.pop(p)\n")}),
    ("r006_subclass", {"src/repro/analysis/sanitizers.py": (
        "class SanitizedPagePool:\n    def check_empty(self):\n"
        "        assert not self._owners\n")}),
    ("r006_api", {"src/repro/serving/engine.py": (
        "def audit(pool):\n"
        "    return pool.owned_by(0), pool.owners_of(1), pool.refcount(1)\n")}),
    ("pragma_same_line", {"src/repro/serving/foo.py": (
        "import time\nnow = time.time()  # repro: " "ignore[R001]\n")}),
    ("pragma_line_above", {"src/repro/serving/foo.py": (
        "import time\n# repro: " "ignore[R001]\nnow = time.time()\n")}),
    ("pragma_wrong_rule", {"src/repro/serving/foo.py": (
        "import time\nnow = time.time()  # repro: " "ignore[R003]\n")}),
    ("r007_double", {"src/repro/serving/foo.py": (
        "from repro.serving.kv_transfer import compress_wire\ndef f(x):\n"
        "    w = compress_wire(x)\n    return compress_wire(w)\n")}),
    ("r007_once", {"src/repro/serving/foo.py": (
        "from repro.serving.kv_transfer import compress_wire\ndef f(x):\n"
        "    return compress_wire(x)\n")}),
    ("r007_run_requantized", {"src/repro/serving/foo.py": (
        "def f(pre, reqs):\n"
        "    for r, w, first in pre.run(reqs, backend='ref'):\n"
        "        yield compress_wire(w)\n")}),
    ("r007_run_raw", {"src/repro/serving/foo.py": (
        "def f(pre, reqs):\n"
        "    for r, w, first in pre.run(reqs, compress=False):\n"
        "        yield compress_wire(w)\n")}),
    ("r007_per_chunk", {"src/repro/serving/foo.py": (
        "def f(job):\n    out = []\n    for chunk in job.wires:\n"
        "        out.append(compress_wire(chunk))\n    return out\n")}),
    ("r007_splice", {"src/repro/serving/foo.py": (
        "from repro.serving.kv_transfer import (compress_wire,\n"
        "                                       concat_wires)\n"
        "def f(job):\n    whole = concat_wires(job.wires)\n"
        "    return compress_wire(whole)\n")}),
    ("r007_append_quant", {"src/repro/serving/foo.py": (
        "def f(job, x):\n    job.wires.append(compress_wire(x))\n")}),
    ("r007_append_raw", {"src/repro/serving/foo.py": (
        "def f(job, x):\n"
        "    job.wires.append(extract_kv(x, compress=False))\n")}),
    ("r007_protocol_hook", {"src/repro/serving/engine2.py": (
        "from repro.serving import protocol\ndef f(pre, job, x):\n"
        "    w = extract_kv(x, compress=protocol.chunk_extract_compress())\n"
        "    job.wires.append(w)\n")}),
    ("r008_construct", {"src/repro/serving/gateway2.py": (
        "from repro.serving.kv_transfer import KVWire\ndef f(ln, slots):\n"
        "    return KVWire(request_len=ln, slots=slots)\n")}),
    ("r008_blessed", {"src/repro/models/paged.py": (
        "from repro.kernels.kv_layout import pick_group\n"
        "from repro.serving.kv_transfer import KVWire\ndef f(ln, slots):\n"
        "    return KVWire(request_len=ln, slots=slots)\n")}),
    ("r008_row_math", {"src/repro/serving/foo.py":
                       "def f(L, ln, ppr):\n    return L * ln * ppr\n"}),
    ("r008_splice", {"src/repro/serving/foo.py": (
        "import numpy as np\ndef f(tensors):\n"
        "    return np.concatenate([t.payload for t in tensors])\n")}),
    ("r008_gpt", {"src/repro/serving/foo.py":
                  "def f(cfg):\n    return groups_per_token(cfg)\n"}),
    ("r008_kernels_scope", {"src/repro/kernels/foo.py":
                            "def f(L, ln, ppr):\n    return L * ln * ppr\n"}),
    ("r008_plain_math", {"src/repro/serving/foo.py":
                         "def f(a, b):\n    return a * b + len([a])\n"}),
]


def to_port(files):
    """The reference's snippet under the port's paths and module names
    (the pragma's ``repro:`` spelling stays)."""
    return {k.replace("src/repro/", S): re.sub(r"\brepro\.(?=[a-z])",
                                               "repro_torch.", v)
            for k, v in files.items()}


SNIP = dict(SNIPPETS)


def port_rules(name, **kw):
    return rules_of(to_port(SNIP[name]), **kw)


# -- the reference's rule tests, under the port's paths ------------------------


@pytest.mark.parametrize("name,want", [
    ("r001_call", ["R001"]), ("r001_monotonic", ["R001"]),
    ("r001_clock_ref", []), ("r001_out_of_scope", []),
    ("r001_test_reads_wall_time", ["R001"]),
    ("r001_default_factory", ["R001"]),
    ("r003_gateway", ["R003"]), ("r003_defining_sites", []),
    ("r003_engine_module", []), ("r003_coordinator_test", ["R003"]),
    ("r003_coordinator_src", ["R003"]), ("r003_coordinator_class", ["R003"]),
    ("r003_coordinator_elsewhere", []), ("r003_gateway_import_ok", []),
    ("r003_admit_shim_def", ["R003"]), ("r003_admit_shim_call", ["R003"]),
    ("r004_no_reason", ["R004"]), ("r004_reason", []),
    ("r004_assign", ["R004"]),
    ("r005_group_tuple", ["R005"]), ("r005_device_groups", []),
    ("r005_selection", ["R005"]), ("r005_nibbles", ["R005"] * 2),
    ("r005_layout_module", []),
    ("r006_reach", ["R006", "R006"]), ("r006_pool_module", []),
    ("r006_subclass", []), ("r006_api", []),
    ("pragma_same_line", []), ("pragma_line_above", []),
    ("pragma_wrong_rule", ["R001"]),
    ("r007_double", ["R007"]), ("r007_once", []),
    ("r007_run_requantized", ["R007"]), ("r007_run_raw", []),
    ("r007_per_chunk", ["R007"]), ("r007_splice", []),
    ("r007_append_quant", ["R007"]), ("r007_append_raw", []),
    ("r007_protocol_hook", []),
    ("r008_construct", ["R008"]), ("r008_row_math", ["R008"]),
    ("r008_splice", ["R008"]), ("r008_gpt", ["R008"]),
    ("r008_kernels_scope", []), ("r008_plain_math", []),
])
def test_rule_on_snippet(name, want):
    assert port_rules(name) == want


def test_r005_rogue_consumer_names_the_contract():
    found = lint_sources(to_port(SNIP["r005_rogue_consumer"]))
    assert any(f.rule == "R005" and "import" in f.message for f in found)


def test_r007_per_chunk_hint_names_the_splice():
    fs = lint_sources(to_port(SNIP["r007_per_chunk"]))
    assert [f.rule for f in fs] == ["R007"]
    assert "concat_wires" in fs[0].hint


def test_r008_blessed_module_is_quiet():
    assert "R008" not in port_rules("r008_blessed")


def test_strict_flags_the_unused_pragma():
    assert sorted(port_rules("pragma_wrong_rule", strict=True)) == \
        ["R001", "W001"]


def test_finding_format_carries_hint():
    f = Finding("R001", "a.py", 3, 1, "boom", "fix it")
    assert "a.py:3:1: R001 boom" in f.format() and "fix it" in f.format()


def test_r005_table_is_the_ports():
    """The port's Python modules that pick a group or pack a nibble must
    import the contract; the kernel wrappers, which derive neither, are
    not held (the CUDA side is checked byte for byte on the card)."""
    table = t_lint._R005_IMPORT_REQUIREMENTS
    assert sorted(table) == [S + "kernels/ref.py", S + "models/paged.py",
                             S + "serving/kv_transfer.py"]
    for path in table:
        assert (REPO / path).exists(), path
    for path in (S + "kernels/kv_quant.py", S + "kernels/paged_attention.py"):
        src = (REPO / path).read_text()
        assert "pack_nibbles" not in src and "pick_group" not in src


# -- cross-package parity: the same snippets, the same rules and lines ----------


@pytest.mark.parametrize("strict", [False, True])
def test_rules_and_lines_match_the_reference(strict):
    """Every snippet, paths mapped, gives the port's linter the
    reference's (rule, line) list for R001 and R003-R008 (R002 is
    redefined: it is left out on both sides)."""
    for name, files in SNIPPETS:
        theirs = [(f.rule, f.line) for f in j_lint.lint_sources(
            files, strict=strict) if f.rule != "R002"]
        mine = [(f.rule, f.line) for f in lint_sources(
            to_port(files), strict=strict) if f.rule != "R002"]
        assert mine == theirs, name


# -- R002: what a CUDA graph captures --------------------------------------------

_REG = (
    "from repro_torch.models import helpers\n"
    "from repro_torch.models.helpers import step\n"
    "def make_decode_chunk(decode_fn):\n"
    "    def decode_chunk(params, cache, state):\n"
    "        return decode_fn(params, cache, state)\n"
    "    return decode_chunk\n"
    "def build(cfg):\n"
    "    def decode_fn(params, cache, tokens):\n"
    "        return step(cfg, params, cache, tokens)\n"
    "    def prefill_fn(params, batch):\n"
    "        return helpers.prefill(cfg, batch)\n"
    "    return make_decode_chunk(decode_fn), prefill_fn\n")
_HELP = (
    "import torch\n"
    "from repro_torch.kernels import ops\n"
    "def step(cfg, params, cache, tokens):\n"
    "    return _inner(cache) + ops.attend(tokens)\n"
    "def _inner(cache):\n"
    "    return cache['lengths'].max().item()\n"
    "def prefill(cfg, x):\n"
    "    n = x.sum().item()\n"
    "    return torch.nonzero(x), x[x > 0], int(x[0]), n\n")
_OPS = ("import torch\n"
        "def attend(t):\n"
        "    return torch.nonzero(t)\n")


def _graph_files(**override):
    files = {S + "models/registry.py": _REG, S + "models/helpers.py": _HELP,
             S + "kernels/ops.py": _OPS}
    files.update(override)
    return files


def test_r002_item_reached_through_another_module():
    """``.item()`` two calls away from the chunk, in a module imported by
    name, and ``torch.nonzero`` in a module reached as ``ops.attend``:
    both flagged; the same calls in a prefill-only function stay quiet."""
    fs = lint_sources(_graph_files())
    assert [(f.rule, f.path, f.line) for f in fs] == [
        ("R002", S + "kernels/ops.py", 3),
        ("R002", S + "models/helpers.py", 6)]
    assert ".item()" in fs[1].message and "nonzero" in fs[0].message


def test_r002_graphed_step_banned_calls():
    """Every banned form in a function the graph runs; the static ones
    (a shape's int(), where with three arguments, repeat_interleave with
    output_size) stay quiet."""
    bad = ("import numpy as np\nimport torch\n"
           "def step(cfg, params, cache, tokens):\n"
           "    a = tokens.tolist()\n"
           "    b = tokens.cpu()\n"
           "    c = np.asarray(tokens)\n"
           "    torch.cuda.synchronize()\n"
           "    d = torch.unique(tokens)\n"
           "    e = tokens[tokens != 0]\n"
           "    f = int(tokens[0])\n"
           "    g = torch.where(tokens > 0)\n"
           "    h = tokens.repeat_interleave(tokens)\n"
           "    i = tokens.masked_select(tokens > 0)\n"
           "    j = bool(cache['lengths'][0])\n"
           "    ok = int(tokens.shape[0]) + torch.where(tokens > 0, 1, 0)\n"
           "    ok2 = tokens.repeat_interleave(tokens, output_size=8)\n"
           "    return ok, ok2\n")
    fs = lint_sources(_graph_files(**{S + "models/helpers.py": bad}))
    assert [f.line for f in fs] == list(range(4, 15))
    assert {f.rule for f in fs} == {"R002"}


def test_r002_graph_capture_body_and_pragma():
    """The body of ``with torch.cuda.graph(...)`` is a root; a pragma
    with its reason suppresses a host-side branch, and ``--strict``
    flags one that suppresses nothing."""
    src = ("import torch\n"
           "def capture(g, fn, x):\n"
           "    with torch.cuda.graph(g):\n"
           "        y = fn(x)\n"
           "        n = y.sum().item()\n"
           "    return y, x.item()\n")
    fs = lint_sources({S + "models/registry.py": src})
    assert [(f.rule, f.line) for f in fs] == [("R002", 5)]
    quiet = src.replace(
        "        n = y.sum().item()\n",
        "        # repro: " "ignore[R002] a host-side count, never replayed\n"
        "        n = y.sum().item()\n")
    assert lint_sources({S + "models/registry.py": quiet},
                        strict=True) == []
    dead = ("def f(x):\n"
            "    return x.item()  # repro: " "ignore[R002] not captured\n")
    assert rules_of({S + "models/foo.py": dead}, strict=True) == ["W001"]


def test_r002_follows_nested_functions_and_methods():
    """A nested function passed as an argument, and a port class's
    property read on the captured path, are reached."""
    helpers = ("class Cfg:\n"
               "    @property\n"
               "    def width(self):\n"
               "        return self.x.item()\n"
               "def step(cfg, params, cache, tokens):\n"
               "    def attend(h):\n"
               "        return h.nonzero()\n"
               "    return run(cfg.width, attend)\n"
               "def run(w, fn):\n"
               "    return fn(w)\n")
    fs = lint_sources({S + "models/registry.py": _REG,
                       S + "configs/base.py": helpers.split("def step")[0],
                       S + "models/helpers.py": "def step" + helpers.split(
                           "def step")[1]})
    assert [(f.path, f.line) for f in fs] == [
        (S + "configs/base.py", 4), (S + "models/helpers.py", 3)]


def test_real_tree_is_clean_strict():
    assert run_lint(REPO, strict=True) == []


def _chunk_state(B):
    return {"cur": torch.ones(B, dtype=torch.int32),
            "active": torch.ones(B, dtype=torch.bool),
            "n_out": torch.zeros(B, dtype=torch.int32),
            "max_new": torch.full((B,), 5, dtype=torch.int32)}


@pytest.mark.parametrize("arch,cache", [
    ("llama-30b", "dense"), ("llama-30b", "int4"), ("gemma-2b", "dense"),
    ("jamba-v0.1-52b", "dense"), ("xlstm-125m", "dense"),
    ("qwen3-moe-235b-a22b", "dense"), ("whisper-base", "dense")])
def test_r002_scope_holds_every_function_an_eager_chunk_runs(arch, cache):
    """The CPU form of the card's check: every function of the port a
    reduced model's decode chunk runs (``sys.setprofile``) lies in R002's
    reachable set."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import paged, registry, transformer, whisper
    cfg = get_reduced(arch).replace(dtype="float32",
                                    attn_logit_softcap=30.0 * (
                                        arch == "gemma-2b"))
    api = registry.build(cfg)
    if cfg.family == "audio":
        params = whisper.init_params(cfg, device="cpu", dtype=torch.float32)
        kv = whisper.init_cache(cfg, 2, 16, device="cpu")
        chunk = api.decode_chunk
    else:
        params = transformer.init_params(cfg, device="cpu",
                                         dtype=torch.float32)
        if cache == "int4":
            kv = paged.init_paged_cache(cfg, 2, 16, 5, page_size=8,
                                        device="cpu")
            chunk = api.paged_decode_fns(8)[1]
        else:
            kv = transformer.init_cache(cfg, 2, 16, torch.float32,
                                        device="cpu")
            chunk = api.decode_chunk
    _, ran = t_lint.trace_calls(chunk, params, kv, _chunk_state(2),
                                n_steps=2, eos_id=-1, max_seq=16, root=REPO)
    held = t_lint.captured_functions(REPO)
    assert len(ran) > 20
    missing = sorted(f for f in ran if f[:2] not in held)
    assert not missing, missing


# -- CLI ---------------------------------------------------------------------------


def _violating_repo(tmp_path):
    d = tmp_path / "src" / "repro_torch" / "serving"
    d.mkdir(parents=True)
    (d / "foo.py").write_text("import time\nnow = time.time()\n")
    return tmp_path


def test_cli_format_json(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    rc = main(["lint", "--root", str(_violating_repo(tmp_path)),
               "--format", "json"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out)
    assert len(out) == 1
    f = out[0]
    assert f["rule"] == "R001" and f["line"] == 2
    assert f["path"].endswith("src/repro_torch/serving/foo.py")
    assert set(f) == {"rule", "path", "line", "col", "message", "hint"}


def test_cli_format_github(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    rc = main(["lint", "--root", str(_violating_repo(tmp_path)),
               "--format", "github"])
    assert rc == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("::error file=")
    assert "line=2" in lines[0] and "title=R001" in lines[0]


def test_cli_format_json_clean_is_empty_list(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    rc = main(["lint", "--root", str(tmp_path), "--format", "json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out) == []


def test_cli_list_rules_and_check(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"R00{i}" in out for i in range(1, 9))
    assert main(["check", "--quick", "--mutations", "--replay"]) == 0
    out = capsys.readouterr().out
    assert "all 8 planted bugs caught" in out
    assert out.count("replay confirmed") == 8
    assert "repro_torch.analysis check: clean" in out


# -- model checker -------------------------------------------------------------------


@pytest.mark.parametrize("depth", [6, 8])
def test_run_check_counts_equal_the_reference(depth):
    """The port's models over the port's protocol and pool visit the
    reference's states and transitions at the same depth, all clean."""
    mine = {r.model: r for r in mc.run_check(depth=depth)}
    theirs = {r.model: r for r in j_mc.run_check(depth=depth)}
    assert sorted(mine) == ["chunkedprefill", "lifecycle", "pagepool"]
    for name, r in mine.items():
        assert r.ok, (name, [v.message for v in r.violations])
        assert (r.states, r.transitions, r.depth) == (
            theirs[name].states, theirs[name].transitions,
            theirs[name].depth), name


def test_mutations_caught_and_replayed_through_the_port():
    """Every planted bug is caught, with the reference's trace, and its
    trace replays on the port's real code: the pool and chunk traces on
    a fresh PagePool, the lifecycle traces through the port's
    ``RequestHandle._transition`` (no jax). The tree checks clean
    after."""
    muts = mc.run_mutations(depth=10, lifecycle_replay=True)
    ref = {m.name: m for m in j_mc.run_mutations(depth=10)}
    assert [m.name for m in muts] == list(ref) and len(muts) == 8
    for m in muts:
        assert m.caught and m.message, m.name
        assert m.trace == ref[m.name].trace, m.name
        assert m.replayed is True, m.name
    assert all(r.ok for r in mc.run_check(quick=True))


def test_clean_traces_do_not_reproduce():
    assert mc.replay_trace("pagepool", ["admit_fresh_mid:0", "retire:0"]) \
        is None
    assert mc.replay_trace("chunkedprefill",
                           ["advance", "advance", "advance"]) is None
    assert mc.replay_trace("lifecycle", ["dispatch", "prefill_ok", "admit",
                                         "finish"]) is None


def test_transition_table_drift(monkeypatch):
    from repro_torch.analysis import sanitizers as san
    assert mc.check_table_drift() == []
    pruned = dict(san._LEGAL)
    pruned["DECODING"] = tuple(s for s in pruned["DECODING"]
                               if s != "TRANSFERRING")
    monkeypatch.setattr(san, "_LEGAL", pruned)
    viols = mc.check_table_drift()
    assert len(viols) == 1 and "DECODING" in viols[0].message


def test_explore_reports_counterexample_trace():
    class Toy:
        name = "toy"

        def initial(self):
            return 0

        def events(self, s):
            return ("inc",) if s < 3 else ()

        def apply(self, s, ev):
            return s + 1

        def invariants(self, s):
            return ["hit three"] if s == 3 else []

    res = mc.explore(Toy(), depth=5)
    assert not res.ok and res.violations[0].trace == ("inc",) * 3


def test_package_root_loads_lazily():
    import repro_torch.analysis as an
    assert an.run_lint is run_lint and an.run_check is mc.run_check
    assert an.SanitizerError.__module__ == "repro_torch.analysis.sanitizers"
    with pytest.raises(AttributeError):
        an.no_such_symbol
