"""Tensor, expert and pipeline parallelism of the port (ROADMAP A.9 step
one) against the unsharded port and the JAX package, on the CPU.

Four ranks run over gloo, one spawned process each (``python -c`` with
``src`` and ``tests`` on the path; rendezvous through a ``file://`` store
in the test's tmp dir). ONE spawn makes every multi-rank check and saves
what each rank computed (:func:`worker`); the JAX package's shard_map
references (``moe_apply_shard_map``, ``pipeline_apply``) run in one
subprocess with four host devices, as ``tests/test_moe_shard_map.py``
runs them. Both start together (the ``runs`` fixture) and the tests
read their results.

Tolerances:

* specs: the port's ``params_pspec_tree`` and ``param_spec`` equal the
  reference's, path by path, as tuples;
* tensor parallelism (reduced LLaMA in float32 at TP 2 and TP 4):
  prefill logits and the f32 prefill cache within 1e-5 of the unsharded
  port (the partial products are summed in another order), the logits
  within 1e-4 of the JAX package (``tests/test_torch_models.py``'s
  tolerance); the dense-cache and bf16-page decode tokens equal, their
  bf16 caches within one bf16 ulp (2**-7 relative, that file's rule);
  int4 pages by their tokens (the int4 group follows a rank's span);
* expert parallelism: outputs and aux loss within 1e-5 of the
  reference's ``moe_apply_shard_map`` on the same mesh shape, the drops
  equal (at capacity factor 1.0 the token counts are large enough that
  routes drop: capacity's floor of ``min(T, 32)`` keeps a call of 32
  or fewer tokens from ever dropping);
* pipeline: within 2e-5 of the JAX ``pipeline_apply``, and bit for bit
  the port's sequential apply of the same microbatches;
* model axis size 1: bit for bit the run without a mesh, every config;
* refusals: every config shards at a model axis of 2 and 4 (the other
  nine are held to the unsharded port in
  ``tests/test_torch_distributed_families.py``); only what the axis does
  not divide is refused (52 heads over 8 and 16, an expert count, reduced
  xlstm's 2 heads over 4).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ALL_ARCHS, get_config, get_reduced  # noqa
from repro_torch.distributed import comm, sharding  # noqa: E402
from repro_torch.distributed.pipeline import (pipeline_apply,  # noqa: E402
                                              stage_params_of)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build, convert, moe, registry  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import whisper as t_wh  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402

# the port's CPU tests share the machine with latency-sensitive JAX tests
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
LLAMA = "llama-30b"
QWEN = "qwen3-moe-235b-a22b"
TP_SHAPES = {2: (2, 2), 4: (1, 4)}        # data x model
EP_SHAPES = ((2, 2), (1, 4))
EP_CASES = ((4, 16, 8.0), (4, 128, 1.0), (4, 1, 8.0), (256, 1, 1.0))
PROMPTS = (7, 19, 33)
MODES = {"dense": dict(paged=False), "bf16": dict(kv_resident="bf16"),
         "int4": {}}
BF16_ULP = 2.0 ** -7


def _f32(arch):
    return get_reduced(arch).replace(dtype="float32")


# -- what every rank (and the unsharded run) computes -------------------------


def _serve(cfg, params, rt, mode):
    """The reduced model through a prefill and a decode engine of
    ``mode``: (tokens of each request, the decode cache's K/V). The
    dense cache and bf16 pages take raw wires, int4 pages the int4 wire
    (whose group follows a rank's span)."""
    pre = E.PrefillEngine(cfg, params, max_seq=64, device="cpu", rt=rt)
    dec = E.DecodeEngine(cfg, params, max_slots=4, max_seq=64, page_size=8,
                         chunk_size=4, device="cpu", rt=rt, **MODES[mode])
    rng = np.random.default_rng(0)
    reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 12)
            for i, n in enumerate(PROMPTS)]
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in
         pre.run(reqs, compress=mode == "int4")]))
    while dec.active:
        dec.step()
    assert dec.page_stats() is None or dec.page_stats()["leaked_pages"] == 0
    slot = dec.cache["slot0"]
    kv = {k: slot[k].clone() for k in ("k", "v")} if mode != "int4" else {}
    return [list(r.out_tokens) for r in reqs], kv


def _prefill(cfg, params, rt, toks, lp):
    logits, cache = build(cfg, rt=rt).prefill(
        params, {"tokens": torch.from_numpy(toks).long(),
                 "last_pos": torch.from_numpy(lp),
                 "true_len": torch.from_numpy(lp + 1)})
    return logits, {k: cache["slot0"][k] for k in ("k", "v")}


def _tp_run(tree, toks, lp, mesh):
    """Reduced LLaMA f32 at this mesh's model axis (None: unsharded): the
    JAX weights' prefill and the dense and bf16 engines; the int4
    engines on seeded weights of a head dim of 128, where the int4 group
    is one head on every rank, as at full width (at head dim 16 a rank's
    span of 32 or 16 picks a smaller group than the unsharded 64, and
    the int4 wire's bytes change with the split)."""
    cfg = _f32(LLAMA)
    params = convert.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    rt = None if mesh is None else t_tf.Runtime(mesh)
    logits, cache = _prefill(cfg, params, rt, toks, lp)
    serve = {m: _serve(cfg, params, rt, m) for m in MODES if m != "int4"}
    wide = cfg.replace(head_dim=128)
    serve["int4"] = _serve(wide, t_tf.init_params(
        wide, seed=3, device="cpu", dtype=torch.float32, mesh=mesh), rt,
        "int4")
    return {"logits": logits, "cache": cache, "serve": serve}


def _size1_run(arch, rt):
    """Prefill and three dense decode steps of the reduced ``arch``
    (bf16, seeded weights) under ``rt``: every logit and cache tensor."""
    cfg = get_reduced(arch)
    init = t_wh.init_params if cfg.family == "audio" else t_tf.init_params
    params = init(cfg, seed=1, device="cpu")
    api = build(cfg, rt=rt)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (2, 8), generator=g)
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(
            (2, cfg.encoder_seq, cfg.d_model), generator=g).to(torch.bfloat16)
    logits, cache = api.prefill(params, batch)
    out = [logits] + registry._tensors(cache)
    init = t_wh.init_cache if cfg.family == "audio" else t_tf.init_cache
    dc = init(api.local_cfg, 2, 16, device="cpu")
    for i in range(3):
        lg, dc = api.decode(params, dc, toks[:, i:i + 1])
        out += [lg] + registry._tensors(dc)
    return out


def _ep_run(p, x, mesh, cf):
    cfg = _f32(QWEN)
    mine = sharding.shard_params({"moe": p}, cfg, mesh)["moe"]
    with moe.count_drops() as drops:
        y, aux = moe.moe_apply_shard_map(cfg, mine, x, mesh=mesh,
                                         capacity_factor=cf)
    return y, aux, int(sum(int(d) for d in drops))


def _stage(p, t):
    return torch.tanh(t @ p["w"] + p["b"])


def _pipe_run(W, b, x, mesh):
    """(pipelined, sequential over the same microbatches)."""
    stacked = {"w": torch.from_numpy(W), "b": torch.from_numpy(b)}
    xs = torch.from_numpy(x)
    y = pipeline_apply(_stage, stage_params_of(stacked, mesh), xs,
                       mesh=mesh, axis="pod")
    seq = []
    for m in xs.reshape(WORLD, -1, xs.shape[-1]):
        for s in range(WORLD):
            m = _stage({"w": stacked["w"][s], "b": stacked["b"][s]}, m)
        seq.append(m)
    return y, torch.cat(seq)


def worker(rank: int, world: int, tmp: str):
    """One rank of the spawn: every multi-rank check, saved to
    ``rank{r}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
    out = {"tp": {}, "ep": {}}
    for n, shape in TP_SHAPES.items():
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        out["tp"][n] = _tp_run(inp["llama"], inp["toks"], inp["lp"], mesh)
        if n == 2:
            # constrain checks local shapes under rules, moves nothing
            q = torch.zeros((2, 8, 2, 16))
            with sharding.use_rules(mesh):
                # batch over data (2), heads over model (2)
                sharding.constrain(q, "batch", "seq", "heads", None,
                                   full=(4, 8, 4, 16))
                try:
                    sharding.constrain(q, "batch", "seq", "heads", None,
                                       full=(4, 8, 2, 16))
                    out["constrain_raised"] = False
                except ValueError:
                    out["constrain_raised"] = True
            # refusals that need a mesh
            rt = t_tf.Runtime(mesh)
            out["refusals"] = {}
            for what, fn in (
                    ("moe without moe_shard_map",
                     lambda: t_tf.shard_view(_f32(QWEN), rt)),
                    ("gloo graph",
                     lambda: registry.GraphedDecodeChunk(
                         None, None, None, None, 4, rt.tp))):
                try:
                    fn()
                    out["refusals"][what] = None
                except (ValueError, NotImplementedError) as e:
                    out["refusals"][what] = str(e)
    for shape in EP_SHAPES:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        p = {k: torch.from_numpy(v) for k, v in inp["moe"].items()}
        for i, (_, _, cf) in enumerate(EP_CASES):
            out["ep"][shape, i] = _ep_run(p, torch.from_numpy(
                inp["ep_x"][i]), mesh, cf)
    mesh = make_mesh((world,), ("pod",), device="cpu")
    out["pipe"] = _pipe_run(inp["pipe_w"], inp["pipe_b"], inp["pipe_x"],
                            mesh)
    out["collectives"] = comm.counts()
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def worker_size1(tmp: str):
    """A world of one rank: every config under a model axis of size 1
    against no mesh (``size1.pt``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv1",
                            rank=0, world_size=1)
    mesh = make_mesh((1,), ("model",), device="cpu")
    out = {}
    for arch in ALL_ARCHS:
        runs = [_size1_run(arch, None), _size1_run(arch, t_tf.Runtime(mesh))]
        if get_reduced(arch).moe_num_experts:
            runs.append(_size1_run(arch, t_tf.Runtime(mesh,
                                                      moe_shard_map=True)))
        out[arch] = all(
            len(r) == len(runs[0]) and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(r, runs[0])) for r in runs[1:])
    out["collectives"] = comm.counts()
    torch.save(out, f"{tmp}/size1.pt")
    dist.destroy_process_group()


# -- the JAX package's references ---------------------------------------------

_JAX_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import math
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.models import moe
from repro.distributed.pipeline import pipeline_apply

tmp = sys.argv[1]
inp = np.load(os.path.join(tmp, "jax_in.npz"))
cfg = get_reduced("qwen3-moe-235b-a22b").replace(dtype="float32")
p = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "wi", "wo")}
cases = [tuple(c) for c in inp["ep_cases"]]
out = {}
for shape in ((2, 2), (1, 4)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    n_data, ep = shape
    for i, (B, S, cf) in enumerate(cases):
        B, S = int(B), int(S)
        x = jnp.asarray(inp[f"ep_x{i}"])
        y, aux = jax.jit(lambda p, x: moe.moe_apply_shard_map(
            cfg, p, x, mesh=mesh, capacity_factor=cf))(p, x)
        # the drops: each shard's routes past its capacity
        seq = S % ep == 0 and S >= ep
        b_loc = B // n_data if B % n_data == 0 else B
        rows = n_data if B % n_data == 0 else 1
        T = b_loc * (S // ep if seq else S)
        k, E = cfg.moe_top_k, cfg.moe_num_experts
        cap = max(min(T, 32), int(math.ceil(T * k * cf / E)))
        drops = 0
        for di in range(rows):
            xb = x[di * b_loc:(di + 1) * b_loc]
            for mi in range(ep if seq else 1):
                xs = xb[:, mi * (S // ep):(mi + 1) * (S // ep)] if seq else xb
                keep = moe.route(cfg, p["router"], xs.reshape(-1, x.shape[-1]),
                                 cap)[2]
                drops += int((~keep).sum())
        out[f"y_{shape[0]}{shape[1]}_{i}"] = np.asarray(y)
        out[f"aux_{shape[0]}{shape[1]}_{i}"] = np.asarray(aux)
        out[f"drops_{shape[0]}{shape[1]}_{i}"] = np.asarray(drops)
mesh = jax.make_mesh((4,), ("pod",))
def stage(q, t):
    return jnp.tanh(t @ q["w"] + q["b"])
out["pipe"] = np.asarray(pipeline_apply(
    stage, {"w": jnp.asarray(inp["pipe_w"]), "b": jnp.asarray(inp["pipe_b"])},
    jnp.asarray(inp["pipe_x"]), mesh=mesh, axis="pod"))
np.savez(os.path.join(tmp, "jax_out.npz"), **out)
print("JAX REF OK")
"""


def _inputs(tmp):
    """The numpy inputs of both sides: the reduced LLaMA's and qwen3's
    JAX weights (f32), prompts, MoE activations, pipeline stages."""
    import jax
    from repro.configs import get_reduced as j_get_reduced
    from repro.models import build as j_build
    from repro.models import moe as j_moe
    jcfg = j_get_reduced(LLAMA).replace(dtype="float32")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_build(jcfg).init(jax.random.PRNGKey(0)))
    qcfg = j_get_reduced(QWEN).replace(dtype="float32")
    pm = {k: np.asarray(v, np.float32) for k, v in
          j_moe.moe_init(qcfg, jax.random.PRNGKey(3)).items()}
    rng = np.random.default_rng(5)
    ep_x = [rng.standard_normal((B, S, qcfg.d_model)).astype(np.float32)
            for B, S, _ in EP_CASES]
    d = 16
    pipe_w = (rng.standard_normal((WORLD, d, d)) / np.sqrt(d)).astype(
        np.float32)
    pipe_b = (rng.standard_normal((WORLD, d)) * 0.1).astype(np.float32)
    pipe_x = rng.standard_normal((8, d)).astype(np.float32)
    toks = rng.integers(1, 256, (2, 16)).astype(np.int32)
    lp = np.array([15, 9], np.int32)
    inp = {"llama": tree, "toks": toks, "lp": lp, "moe": pm, "ep_x": ep_x,
           "pipe_w": pipe_w, "pipe_b": pipe_b, "pipe_x": pipe_x}
    torch.save(inp, tmp / "inputs.pt")
    np.savez(tmp / "jax_in.npz", **{f"moe_{k}": v for k, v in pm.items()},
             **{f"ep_x{i}": x for i, x in enumerate(ep_x)},
             ep_cases=np.array(EP_CASES, np.float64), pipe_w=pipe_w,
             pipe_b=pipe_b, pipe_x=pipe_x)
    return jcfg, tree, inp


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks and the JAX references together; wait for
    both. Returns (per-rank results, JAX results, the inputs, the JAX
    config)."""
    tmp = tmp_path_factory.mktemp("dist")
    jcfg, tree, inp = _inputs(tmp)
    env = _child_env()
    ranks = [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_distributed as t; "
         f"t.worker({r}, {WORLD}, {str(tmp)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    ranks.append(subprocess.Popen(
        [sys.executable, "-c", "import test_torch_distributed as t; "
         f"t.worker_size1({str(tmp)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    ref = subprocess.run([sys.executable, "-c", _JAX_REF, str(tmp)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=200)
    logs = []
    for proc in ranks:
        try:
            logs.append(proc.communicate(timeout=200)[0])
        finally:
            proc.kill()
    for r, (proc, log) in enumerate(zip(ranks, logs)):
        assert proc.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    assert "JAX REF OK" in ref.stdout, ref.stderr[-4000:]
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    res.append(torch.load(tmp / "size1.pt", weights_only=False))
    return res, dict(np.load(tmp / "jax_out.npz")), inp, jcfg, logs


@pytest.fixture(scope="module")
def unsharded(runs):
    _, _, inp, _, _ = runs
    return _tp_run(inp["llama"], inp["toks"], inp["lp"], None)


def _model_ranks(n):
    """The global ranks of data row 0 of the TP-n mesh, in model order."""
    return list(range(n))


def _gather_heads(res, n, get):
    return torch.cat([get(res[r]["tp"][n]) for r in _model_ranks(n)],
                     dim=3)


# -- (1) specs ----------------------------------------------------------------


def _spec_leaves(tree, prefix=""):
    """``{path: spec}`` of a spec tree (dicts of specs; a spec is a leaf
    even where it is a tuple)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_spec_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_the_reference(arch):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.distributed import sharding as j_shd
    from repro.models import build as j_build
    cfg = get_config(arch)
    shapes = jax.eval_shape(j_build(j_get_config(arch)).init,
                            jax.random.PRNGKey(0))
    mine = convert.params_to_tree(t_tf.init_params(cfg, device="meta")
                                  if cfg.family != "audio" else
                                  t_wh.init_params(cfg, device="meta"),
                                  cfg, "meta")
    for prefixes in (("blocks",), ("blocks", "enc_layers", "dec_layers")):
        got = _spec_leaves(sharding.params_pspec_tree(
            mine, stacked_prefixes=prefixes))
        want = _spec_leaves(j_shd.params_pspec_tree(
            shapes, stacked_prefixes=prefixes))
        assert sorted(got) == sorted(want)
        for path, spec in want.items():
            assert tuple(got[path]) == tuple(spec), path
    leaves = sharding.tree_paths(mine)
    for path, t in leaves.items():
        for stacked in (0, 1):
            if t.ndim >= stacked:
                assert tuple(sharding.param_spec(path, t.ndim, stacked)) == \
                    tuple(j_shd.param_spec(path, t.ndim, stacked)), path


# -- (2) tensor parallelism ---------------------------------------------------


@pytest.mark.parametrize("n", sorted(TP_SHAPES))
def test_tp_prefill_matches_unsharded_and_jax(runs, unsharded, n):
    import jax.numpy as jnp
    from repro.models import transformer as j_tf
    res, _, inp, jcfg, _ = runs
    for r in _model_ranks(n):
        # every rank of the axis returns the same gathered logits
        assert torch.equal(res[r]["tp"][n]["logits"],
                           res[0]["tp"][n]["logits"])
    got = res[0]["tp"][n]["logits"]
    want = unsharded["logits"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    for key in ("k", "v"):
        cache = _gather_heads(res, n, lambda x: x["cache"][key])
        np.testing.assert_allclose(cache.numpy(),
                                   unsharded["cache"][key].numpy(),
                                   atol=1e-5, rtol=1e-5)
    toks, lp = inp["toks"], inp["lp"]
    jp = {k: v for k, v in inp["llama"].items()}
    import jax
    lj, _ = j_tf.prefill(jcfg, jax.tree.map(jnp.asarray, jp),
                         jnp.asarray(toks), max_seq=toks.shape[1],
                         last_pos=jnp.asarray(lp),
                         true_len=jnp.asarray(lp + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", sorted(TP_SHAPES))
def test_tp_engines_match_unsharded(runs, unsharded, n, mode):
    res, _, _, _, _ = runs
    want_toks, want_kv = unsharded["serve"][mode]
    for r in range(WORLD):       # every replica row decodes the same
        assert res[r]["tp"][n]["serve"][mode][0] == want_toks
    for key, want in want_kv.items():
        got = torch.cat([res[r]["tp"][n]["serve"][mode][1][key]
                         for r in _model_ranks(n)], dim=3)
        assert got.dtype == want.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=BF16_ULP, atol=1e-6)


# -- (3) expert parallelism ---------------------------------------------------


@pytest.mark.parametrize("case", range(len(EP_CASES)))
@pytest.mark.parametrize("shape", EP_SHAPES)
def test_ep_matches_reference_shard_map(runs, shape, case):
    res, ref, _, _, _ = runs
    tag = f"{shape[0]}{shape[1]}_{case}"
    for r in range(WORLD):
        y, aux, _ = res[r]["ep"][shape, case]
        np.testing.assert_allclose(y.numpy(), ref[f"y_{tag}"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(ref[f"aux_{tag}"]),
                                   atol=1e-5, rtol=1e-5)
    # each data row's ranks hold its drops once
    drops = sum(res[r]["ep"][shape, case][2] for r in range(WORLD))
    assert drops == int(ref[f"drops_{tag}"])
    if EP_CASES[case][2] == 1.0:
        assert drops > 0, "the case meant to drop routes dropped none"


# -- (4) pipeline -------------------------------------------------------------


def test_pipeline_matches_sequential_bit_for_bit(runs):
    res, _, _, _, _ = runs
    for r in range(WORLD):
        y, seq = res[r]["pipe"]
        assert torch.equal(y, seq)


def test_pipeline_matches_jax(runs):
    res, ref, _, _, _ = runs
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["pipe"][0].numpy(), ref["pipe"],
                                   atol=2e-5, rtol=2e-5)


# -- (5) model axis size 1 ----------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axis_size_one_is_bit_identical(runs, arch):
    res, _, _, _, _ = runs
    assert res[WORLD][arch] is True
    assert res[WORLD]["collectives"]["all_gather"] > 0


# -- (6) refusals -------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a not in (LLAMA, QWEN)])
def test_unported_configs_are_refused_above_size_one(arch):
    """The nine configs A.9 step one left whole shard at a model axis of
    1, 2 and 4 (full and reduced widths). Heads that the axis does not
    divide are no longer refused (A.9 step two, items 3 and 4): at twice
    the heads, and reduced xlstm's 2 heads at 4, a config runs gathered
    wherever its columns divide (``sharding.rank_cfg``: whole heads, the
    kv_seq cache); what no cut divides is refused, an axis of twice
    ``d_model``."""
    full, small = get_config(arch), get_reduced(arch)
    for n in (1, 2, 4):
        sharding.check_tp(full, n)
        sharding.check_tp(small, n)
        assert sharding.local_cfg(full, None) is full
    for cfg in (full, small):
        n = 2 * cfg.num_heads
        if not sharding.tp_refusals(cfg, n):
            local = sharding.rank_cfg(cfg, n)
            assert sharding.gathered(local) and sharding.kv_seq(local)
            assert local.num_heads == cfg.num_heads
        with pytest.raises(NotImplementedError, match="A.9 step two"):
            sharding.check_tp(cfg, 2 * cfg.d_model)
    if arch == "xlstm-125m":
        assert sharding.gathered(sharding.rank_cfg(small, 4))


def test_sharded_configs_run_at_their_axis_sizes():
    for arch, sizes in ((LLAMA, (1, 2, 4)), (QWEN, (1, 2, 4, 8, 16))):
        for n in sizes:
            sharding.check_tp(get_config(arch), n)
    # 52 heads over 8 and 16 (--mesh single|multi) and reduced xlstm's 2
    # heads over 4 run gathered; an expert count the axis does not divide
    # is refused
    for cfg, n in ((get_config(LLAMA), 8), (get_config(LLAMA), 16),
                   (get_reduced("xlstm-125m"), 4)):
        sharding.check_tp(cfg, n)
        assert sharding.gathered(sharding.rank_cfg(cfg, n))
    for cfg, n, why in ((get_reduced(QWEN).replace(moe_num_experts=6), 4,
                         "6 experts"),):
        with pytest.raises(NotImplementedError, match="A.9 step two"):
            sharding.check_tp(cfg, n)
        assert any(why in w for w in sharding.tp_refusals(cfg, n))
    # replicated KV: more ranks than KV heads, a whole head each
    gemma = sharding.rank_cfg(get_config("gemma-2b"), 4)
    assert (gemma.num_heads, gemma.num_kv_heads, gemma.head_dim) == \
        (2, 1, 256)
    assert sharding.kv_replicated(get_config("gemma-2b"), 4)
    # MoE interleaved with dense layers: both the experts and d_ff divide
    for arch in ("llama4-maverick-400b-a17b", "jamba-v0.1-52b"):
        cfg = get_config(arch)
        mine = sharding.rank_cfg(cfg, 4)
        assert (mine.d_ff, mine.moe_num_experts, mine.moe_d_ff) == \
            (cfg.d_ff // 4, cfg.moe_num_experts // 4, cfg.moe_d_ff)
    assert sharding.rank_cfg(get_config("jamba-v0.1-52b"), 4
                             ).mamba_d_inner == 4096 * 2 // 4


def test_refusals_under_a_mesh(runs):
    res, _, _, _, _ = runs
    got = res[0]["refusals"]
    assert "moe_shard_map=True" in got["moe without moe_shard_map"]
    assert "gloo" in got["gloo graph"]
    assert res[0]["constrain_raised"] is True
    with pytest.raises(ValueError, match="in place"):
        t_tf.Runtime(inplace_decode=False)
    x = torch.zeros(3)
    assert sharding.constrain(x, "batch") is x      # no rules: a no-op


def test_collectives_were_issued(runs):
    res, _, _, _, logs = runs
    for r in range(WORLD):
        c = res[r]["collectives"]
        for name in ("all_reduce", "all_gather", "all_to_all", "send_recv"):
            assert c.get(name, 0) > 0, (name, c)
        assert "through host copies" in logs[r]   # gloo's choice, printed
