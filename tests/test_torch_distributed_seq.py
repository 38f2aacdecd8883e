"""The reference's production-mesh sharding (ROADMAP A.9 step two, items 3
and 4) against the unsharded port and the JAX package, on the CPU: the
``kv_seq`` dense decode cache (``Runtime(kv_seq=True)``: a rank holds its
share of every KV head's positions, a decode step gathers q, k and v to
whole heads and merges the ranks' partial softmaxes) and heads that the
model axis does not divide (``sharding.gathered``: the attention columns
cut inside heads, prefill and training attending the reference's qseq
way, decode over the kv_seq cache; xLSTM's recurrences on every head).

Cases, reduced and in float32 (weights from the JAX package,
``convert.params_from_numpy(mesh=)``):

* ``llama-30b`` (4 heads): the kv_seq cache at a model axis of 2 and 4,
  the heads split;
* ``llama-30b/h6`` (6 heads and KV heads): gathered at 4;
* ``gemma-2b`` (4 heads over one KV head): the kv_seq cache at 4, each
  rank holding the replicated KV head its heads read;
* ``gemma-2b/h2`` (2 heads over the one KV head): gathered at 4, the KV
  head's 16 columns cut 4 a rank, inside the head;
* ``xlstm-125m`` (2 heads): gathered at 4, its states whole;
* ``whisper-base/h6`` (6 heads, 24 frames): gathered at 4, the cross
  cache's frames split with the self cache's positions; and
  ``whisper-base/h6f26`` (26 frames, which 4 does not divide: the cross
  cache whole on every rank).

Four ranks run over gloo, one spawned process each (``python -c`` with
``src`` and ``tests`` on the path, a ``file://`` store in the tmp dir);
ONE spawn makes every multi-rank run (:func:`worker`) and saves it, and
the unsharded runs are made meanwhile. Tolerances, as
``tests/test_torch_distributed.py`` states them:

* the prefill logits and every teacher-fed decode step's logits (f32
  decode caches) within 1e-5 of the unsharded port's, and within 1e-4 of
  the JAX package's unsharded prefill and decode steps on the same
  weights; the ranks' shares of the decode cache, put end to end, within
  1e-5 of the unsharded cache; whisper, whose caches are bf16 whatever
  the model's type (the reference's), holds its decode steps by greedy
  token where the top-2 margin clears 1e-3 and its caches within one
  bf16 ulp;
* the engines (a prefill engine into a dense decode engine) decode the
  unsharded engines' greedy tokens; a suffix prefill over a 4-token
  prefix (the partial-hit and chunked path) within 1e-5; the paged
  engines refuse the kv_seq layout, naming the ROADMAP;
* one train step of each gathered case: the loss within 1e-5 and each
  leaf's step-1 gradient within 1e-4 relative L2 of the unsharded one cut
  to the rank, or within 1e-6 of its largest value where the whole
  gradient is ~0 (a key bias, which the softmax does not see);
* at axis size 1 the kv_seq runtime is the unmeshed run bit for bit.
"""
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.distributed import comm, sharding  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import whisper as t_wh  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving import kv_transfer  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TOL, JAX_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4
BF16_ULP, MARGIN = 2.0 ** -7, 1e-3
B, S, MAX_SEQ, STEPS = 2, 8, 32, 5
# case -> (arch, config overrides, model axes, Runtime(kv_seq=))
CASES = {
    "llama-30b": ("llama-30b", {}, (2, 4), True),
    "llama-30b/h6": ("llama-30b", {"num_heads": 6, "num_kv_heads": 6}, (4,),
                     False),
    "gemma-2b": ("gemma-2b", {}, (4,), True),
    "gemma-2b/h2": ("gemma-2b", {"num_heads": 2}, (4,), False),
    "xlstm-125m": ("xlstm-125m", {}, (4,), False),
    "whisper-base/h6": ("whisper-base",
                        {"num_heads": 6, "num_kv_heads": 6}, (4,), False),
    "whisper-base/h6f26": ("whisper-base",
                           {"num_heads": 6, "num_kv_heads": 6,
                            "encoder_seq": 26}, (4,), False),
}
GATHERED = tuple(c for c in CASES if not CASES[c][3])
RUNS = [(c, n) for c, v in CASES.items() for n in v[2]]


def _cfg(case):
    arch, over, _, _ = CASES[case]
    return get_reduced(arch).replace(dtype="float32", **over)


def _jax_cfg(case):
    from repro.configs import get_reduced as j_get_reduced
    arch, over, _, _ = CASES[case]
    return j_get_reduced(arch).replace(dtype="float32", **over)


def _audio(case):
    return CASES[case][0] == "whisper-base"


def _batch(cfg):
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (B, S))).long()}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(
            torch.bfloat16).float()
    return batch


def _params(case, mesh, trees):
    return convert.params_from_numpy(trees[case], _cfg(case), "cpu",
                                     mesh=mesh)


def _init_cache(cfg, local):
    init = t_wh.init_cache if cfg.family == "audio" else t_tf.init_cache
    return init(local, B, MAX_SEQ, torch.float32, device="cpu")


def _wire_cache(api, rt, cache):
    """A prefill's cache as wires are extracted from it: a kv_seq rank's
    share of the positions gathered whole (``kv_transfer.gather_seq``)."""
    if rt is None or not sharding.kv_seq(api.local_cfg):
        return cache
    return kv_transfer.gather_seq(cache, rt.tp,
                                  frames=api.local_cfg.encoder_seq)


def _decode(case, params, rt, teacher=None):
    """Prefill, then STEPS decode steps on an f32 dense decode cache (the
    kv_seq one under a mesh), the prefill's raw wires inserted as a dense
    engine inserts them, fed ``teacher``'s tokens (their own greedy ones
    without). Returns the prefill logits, each step's logits, the tokens
    fed, the prefill cache and the final decode cache."""
    cfg = _cfg(case)
    api = build(cfg, rt=rt)
    logits, pc = api.prefill(params, _batch(cfg), max_seq=MAX_SEQ)
    cache = _init_cache(cfg, api.local_cfg)
    part = (rt.tp.rank, rt.tp.size) if rt is not None and \
        sharding.kv_seq(api.local_cfg) else None
    wires = kv_transfer.extract_batch(_wire_cache(api, rt, pc),
                                      [(b, S) for b in range(B)],
                                      compress=False)
    kv_transfer.insert_batch(cache, [(w, b) for b, w in enumerate(wires)],
                             seq_part=part)
    steps, fed = [], []
    cur = logits[:, -1].argmax(-1)
    for t in range(STEPS):
        tok = cur if teacher is None else teacher[t]
        lg, cache = api.decode(params, cache, tok[:, None].int())
        steps.append(lg[:, -1].clone())
        fed.append(tok.clone())
        cur = lg[:, -1].argmax(-1)
    return {"prefill": logits[:, -1].clone(), "steps": steps, "fed": fed,
            "pcache": _flat(pc), "cache": _flat(cache)}


def _flat(cache):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": t.clone() for kk, t in v.items()})
        elif k != "lengths":
            out[k] = v.clone()
    return out


def _serve(case, params, rt):
    """Two requests through a prefill engine (whisper: the model API
    over frames) into a dense decode engine: their greedy tokens."""
    cfg = _cfg(case)
    rng = np.random.default_rng(0)
    reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n), 6)
            for i, n in enumerate((7, 13))]
    if cfg.family == "audio":
        api = build(cfg, rt=rt)
        done = []
        for r in reqs:
            batch = _batch(cfg)
            logits, cache = api.prefill(params, {
                "tokens": torch.as_tensor(r.tokens[None]).long(),
                "frame_embeds": batch["frame_embeds"][:1]})
            done.append((r, kv_transfer.extract(
                _wire_cache(api, rt, cache), 0, len(r.tokens),
                compress=False), int(torch.argmax(logits[0, -1]))))
    else:
        pre = E.PrefillEngine(cfg, params, max_seq=MAX_SEQ, device="cpu",
                              rt=rt)
        done = pre.run(reqs, compress=False)
    dec = E.DecodeEngine(cfg, params, max_slots=2, max_seq=MAX_SEQ,
                         chunk_size=3, device="cpu", rt=rt, paged=False)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in done]))
    while dec.active:
        dec.step()
    return [list(r.out_tokens) for r in reqs]


def _suffix(case, params, rt):
    """A prompt's last S - 4 tokens prefilled over its first 4 (the
    partial-hit and chunked path, ``prefill_suffix``): the prefix's
    cache, gathered whole under kv_seq, is the suffix call's prefix K/V.
    Returns the suffix's last logits."""
    api = build(_cfg(case), rt=rt)
    toks = _batch(_cfg(case))["tokens"]
    _, pc = api.prefill(params, {"tokens": toks[:, :4]})
    pc = _wire_cache(api, rt, pc)
    plen = torch.full((B,), 4, dtype=torch.int32)
    logits, _ = api.prefill_suffix(params, {
        "tokens": toks[:, 4:], "prefix_kv": {"slot0": (
            pc["slot0"]["k"], pc["slot0"]["v"])}, "prefix_len": plen})
    return logits[:, -1]


def _train(case, params, rt):
    cfg = _cfg(case)
    batch = _batch(cfg)
    batch["targets"] = (batch["tokens"] * 7 + 3) % cfg.vocab_size
    loss, grads = opt.loss_and_grads(build(cfg, rt=rt), params, batch)
    return float(loss), opt.tree_map(lambda g: g.detach(), grads)


def _run(case, mesh, trees, teacher=None):
    cfg = _cfg(case)
    rt = None if mesh is None else t_tf.Runtime(mesh, kv_seq=CASES[case][3])
    params = _params(case, mesh, trees)
    out = {"decode": _decode(case, params, rt, teacher),
           "serve": _serve(case, params, rt)}
    if build(cfg).prefill_suffix is not None:
        out["suffix"] = _suffix(case, params, rt)
    if case in GATHERED and cfg.family != "audio":
        out["train"] = _train(case, params, rt)
    return out


def worker(rank: int, world: int, tmp: str):
    """One rank of the spawn: each case at each of its model axes (a
    ``1 x n`` mesh of the first n ranks; the others sit it out), fed the
    unsharded run's tokens, the paged engine's refusal, and the merge of
    partials; saved to ``rank{r}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    trees = torch.load(f"{tmp}/trees.pt", weights_only=False)
    teachers = torch.load(f"{tmp}/teachers.pt", weights_only=False)
    out = {}
    for n in (2, 4):
        mesh = make_mesh((world // n, n), ("data", "model"), device="cpu")
        for case in CASES:
            if n in CASES[case][2]:
                out[case, n] = _run(case, mesh, trees, teachers[case])
    mesh = make_mesh((1, world), ("data", "model"), device="cpu")
    cfg = _cfg("llama-30b/h6")
    try:
        E.DecodeEngine(cfg, _params("llama-30b/h6", mesh, trees),
                       max_slots=2, max_seq=MAX_SEQ, device="cpu",
                       rt=t_tf.Runtime(mesh))
    except NotImplementedError as e:
        out["paged refusal"] = str(e)
    # the merge: rank r holds keys [8 r, 8 r + 8) of 32; slot 1 has 12
    # keys (ranks 2 and 3 hold none of them), slot 0 all 32
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 2, 3, 16, generator=g)
    k, v = (torch.randn(2, 2, 32, 16, generator=g) for _ in range(2))
    kl = torch.tensor([32, 12])
    tp = t_tf.Runtime(mesh).tp
    lo = 8 * tp.rank
    o, lse = ref.decode_attention_ref(
        q, k[:, :, lo:lo + 8], v[:, :, lo:lo + 8],
        kv_len=torch.clamp(kl - lo, 0, 8), return_lse=True)
    out["merge"] = (comm.merge_partials(tp, o, lse),
                    ref.decode_attention_ref(q, k, v, kv_len=kl))
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def world1_worker(tmp: str):
    """A world of one rank: the kv_seq runtime at axis size 1 against no
    mesh, each case, bit for bit."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv1",
                            rank=0, world_size=1)
    trees = torch.load(f"{tmp}/trees.pt", weights_only=False)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    out = {}
    for case in ("llama-30b", "gemma-2b", "whisper-base/h6"):
        cfg = _cfg(case)
        params = _params(case, None, trees)
        rt = t_tf.Runtime(mesh, kv_seq=True)
        out[case] = (_decode(case, params, None), _decode(case, params, rt),
                     sharding.local_cfg(cfg, mesh, True) == cfg)
    torch.save(out, f"{tmp}/world1.pt")
    dist.destroy_process_group()


# -- the spawn and the unsharded runs -----------------------------------------


def _jax_trees():
    import jax
    from repro.models import build as j_build
    return {case: jax.tree.map(lambda a: np.asarray(a, np.float32),
                               jax.jit(j_build(_jax_cfg(case)).init)(
                                   jax.random.PRNGKey(0)))
            for case in CASES}


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(tmp, what, n):
    return [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_distributed_seq as t; "
         f"t.{what.format(r=r)}"], cwd=ROOT, env=_child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded runs first (their greedy tokens feed the ranks),
    then the four ranks and the one-rank world. Returns (per-rank
    results, unsharded results, world-1 results, the JAX trees)."""
    tmp = tmp_path_factory.mktemp("dist_seq")
    trees = _jax_trees()
    torch.save(trees, tmp / "trees.pt")
    whole = {case: _run(case, None, trees) for case in CASES}
    torch.save({c: w["decode"]["fed"] for c, w in whole.items()},
               tmp / "teachers.pt")
    procs = _spawn(tmp, f"worker({{r}}, {WORLD}, {str(tmp)!r})", WORLD) + \
        _spawn(tmp, f"world1_worker({str(tmp)!r})", 1)
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}:\n{log[-4000:]}"
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return res, whole, torch.load(tmp / "world1.pt", weights_only=False), \
        trees


def _has_suffix(case):
    """Whether the case's stack has a suffix prefill (full attention
    only: not xLSTM, not whisper)."""
    return CASES[case][0] in ("llama-30b", "gemma-2b")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                               rtol=tol)


# -- the rank configs ------------------------------------------------------------


def test_rank_configs_at_the_production_axis():
    """At a model axis of 16 the five configs A.9 refused run gathered:
    whole head counts, the columns cut (LLaMA-30B's 6656 q columns, 416
    a rank, a quarter of a head past three), the kv_seq cache; the
    others split their heads as before; what no cut divides is still
    refused, with the ROADMAP's words."""
    for arch in ("llama-30b", "llama4-maverick-400b-a17b", "gemma-2b",
                 "whisper-base", "xlstm-125m"):
        cfg = get_config(arch)
        sharding.check_tp(cfg, 16)
        mine = sharding.rank_cfg(cfg, 16)
        assert sharding.gathered(mine) and sharding.kv_seq(mine)
        assert (mine.num_heads, mine.num_kv_heads) == (cfg.num_heads,
                                                       cfg.num_kv_heads)
        assert not sharding.kv_replicated(cfg, 16)
    llama = get_config("llama-30b")
    assert sharding.tp_refusals(llama, 8) == []
    assert not sharding.heads_split(llama, 8)
    assert sharding.heads_split(get_config("command-r-35b"), 16)
    assert sharding.kv_replicated(get_config("command-r-35b"), 16)
    split = sharding.rank_cfg(get_config("stablelm-3b"), 16, True)
    assert not sharding.gathered(split) and sharding.kv_seq(split)
    assert sharding.whole_heads(split) == (32, 32)
    with pytest.raises(NotImplementedError, match="A.9 step two"):
        sharding.check_tp(llama, 5 * 13 * 2)   # d_model 6656 % 130
    meta = t_tf.init_params(llama.replace(num_layers=1), device="meta",
                            mesh=_abstract(16))
    attn = meta["layers"][0]["attn"]
    assert attn["wq"].shape == (6656, 416) and attn["wo"].shape == (416,
                                                                     6656)
    cache = t_tf.init_cache(sharding.rank_cfg(llama, 16), 2, 32768,
                            device="meta")
    assert cache["slot0"]["k"].shape == (60, 2, 2048, 52, 128)


def _abstract(n):
    from repro_torch.launch.mesh import abstract_mesh
    return abstract_mesh((1, n), ("data", "model"))


# -- the partial mode's plain version ---------------------------------------------


@pytest.mark.parametrize("splits", [2, 4])
def test_partial_mode_merges_to_the_whole(splits):
    """The plain partial mode over disjoint key ranges, merged as
    ``comm.merge_partials`` merges them, is the softmax over every key;
    a range holding no key of a slot gives o 0 and lse -inf and weighs
    0."""
    g = torch.Generator().manual_seed(splits)
    q = torch.randn(3, 2, 4, 16, generator=g)
    k, v = (torch.randn(3, 2, 40, 16, generator=g) for _ in range(2))
    kl = torch.tensor([40, 9, 1])
    R = 40 // splits
    parts = [ref.decode_attention_ref(
        q, k[:, :, r * R:(r + 1) * R], v[:, :, r * R:(r + 1) * R],
        kv_len=torch.clamp(kl - r * R, 0, R), return_lse=True)
        for r in range(splits)]
    o_last, lse_last = parts[-1]
    assert torch.equal(lse_last[1:], torch.full_like(lse_last[1:],
                                                     -math.inf))
    assert not o_last[1:].any()
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.amax(0))
    o = sum(p[0] * (w[r] / w.sum(0))[..., None]
            for r, p in enumerate(parts))
    _close(o, ref.decode_attention_ref(q, k, v, kv_len=kl))
    whole = ref.decode_attention_ref(q, k, v, kv_len=kl, return_lse=True)[1]
    _close(torch.logsumexp(lse, 0), whole)


def test_merge_over_ranks_matches_the_whole(runs):
    res = runs[0]
    for r in range(WORLD):
        got, want = res[r]["merge"]
        _close(got, want)
        assert torch.equal(got, res[0]["merge"][0])


# -- prefill and decode ------------------------------------------------------------


def _jax_decode(case, trees, fed):
    """The JAX package's unsharded prefill and decode steps (its in-place
    step, the only one that runs an f32 recurrent stack) on the same
    weights and tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as j_tf
    jcfg = _jax_cfg(case)
    jp = jax.tree.map(jnp.asarray, trees[case])
    toks = jnp.asarray(_batch(_cfg(case))["tokens"].numpy())
    logits, cache = jax.jit(lambda p, t: j_tf.prefill(
        jcfg, p, t, max_seq=MAX_SEQ))(jp, toks)
    rt = j_tf.Runtime(inplace_decode=True)
    step = jax.jit(lambda p, c, t: j_tf.decode_step(jcfg, p, c, t, rt=rt))
    out = [np.asarray(logits[:, -1], np.float32)]
    for tok in fed:
        lg, cache = step(jp, cache, jnp.asarray(tok.numpy()[:, None]))
        out.append(np.asarray(lg[:, -1], np.float32))
    return out


def _whole(res, case, n, which, key, like):
    """The ranks' tensors of a cache put back whole, as the unsharded
    ``like``: split ones end to end along the dim where they are shorter
    (a kv_seq cache's positions, a cross cache's frames where the axis
    divides them, a conv state's channels); whole ones every rank's
    alike."""
    parts = [res[r][case, n]["decode"][which][key] for r in range(n)]
    if parts[0].shape == like.shape:
        for p in parts[1:]:
            assert torch.equal(p, parts[0]), key
        return parts[0]
    dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, like.shape))
               if a != b)
    return torch.cat(parts, dim=dim)


@pytest.mark.parametrize("case,n", RUNS)
def test_prefill_and_decode_match_unsharded_and_jax(runs, case, n):
    res, whole, _, trees = runs
    want = whole[case]["decode"]
    for which in ("pcache", "cache"):
        # a kv_seq prefill's cache, as the decode cache, holds the rank's
        # share of every head's positions
        for key, w in want[which].items():
            got = _whole(res, case, n, which, key, w)
            if w.dtype == torch.bfloat16 or _audio(case):
                np.testing.assert_allclose(got.float().numpy(),
                                           w.float().numpy(), rtol=BF16_ULP,
                                           atol=1e-6)
            else:
                _close(got, w)
    for r in range(n):
        got = res[r][case, n]["decode"]
        _close(got["prefill"], want["prefill"])
        for t, w in enumerate(want["steps"]):
            if _audio(case):       # bf16 caches: tokens where they clear
                top2 = torch.sort(w, -1).values[:, -2:]
                clear = (top2[:, 1] - top2[:, 0]) > MARGIN
                assert torch.equal(got["steps"][t].argmax(-1)[clear],
                                   w.argmax(-1)[clear])
            else:
                _close(got["steps"][t], w)
    if _audio(case):
        return
    for got, w in zip([res[0][case, n]["decode"]["prefill"]]
                      + res[0][case, n]["decode"]["steps"],
                      _jax_decode(case, trees, want["fed"])):
        np.testing.assert_allclose(got.numpy(), w, atol=JAX_TOL)


@pytest.mark.parametrize("case,n", RUNS)
def test_dense_engines_match_unsharded(runs, case, n):
    res, whole, _, _ = runs
    for r in range(n):
        assert res[r][case, n]["serve"] == whole[case]["serve"]


@pytest.mark.parametrize("case,n", [(c, n) for c, n in RUNS
                                    if _has_suffix(c)])
def test_suffix_prefill_matches_unsharded(runs, case, n):
    res, whole, _, _ = runs
    for r in range(n):
        _close(res[r][case, n]["suffix"], whole[case]["suffix"])


def test_paged_engines_refuse_kv_seq(runs):
    msg = runs[0][0]["paged refusal"]
    assert "kv_seq" in msg and "ROADMAP C.4" in msg


@pytest.mark.parametrize("case", ("llama-30b", "gemma-2b", "whisper-base/h6"))
def test_axis_size_one_is_bit_identical(runs, case):
    a, b, same_cfg = runs[2][case]
    assert same_cfg
    assert torch.equal(a["prefill"], b["prefill"])
    assert all(torch.equal(x, y) for x, y in zip(a["steps"], b["steps"]))
    assert all(torch.equal(a["cache"][k], b["cache"][k]) for k in a["cache"])


# -- training -----------------------------------------------------------------------


@pytest.mark.parametrize("case", [c for c in GATHERED if not _audio(c)])
def test_gathered_train_step_matches_unsharded(runs, case):
    res, whole, _, _ = runs
    loss, g0 = whole[case]["train"]
    n = CASES[case][2][0]
    cfg = _cfg(case)
    for r in range(n):
        got_loss, g1 = res[r][case, n]["train"]
        assert abs(got_loss - loss) <= TOL * abs(loss)
        mesh = _RankOf(n, r)
        want = sharding.shard_params(g0, cfg, mesh)
        for a, b in zip(opt.tree_leaves(g1), opt.tree_leaves(want)):
            err = float((a - b).norm())
            assert err <= GRAD_TOL * float(b.norm()) or \
                float((a - b).abs().max()) <= 1e-6 * max(
                    1.0, float(b.abs().max())), (case, r, err)


class _RankOf:
    """A ``1 x n`` mesh's shape and rank r's place in it, for
    ``sharding.shard_params`` with no process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n, r):
        import types
        self.mesh = types.SimpleNamespace(shape=(1, n))
        self.r = r

    def get_local_rank(self, name):
        return self.r if name == "model" else 0
