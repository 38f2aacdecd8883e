"""Tensor and expert parallelism of every other family (ROADMAP A.9 step
two, serving) against the unsharded port and the JAX package, on the CPU.

The nine configs that ``tests/test_torch_distributed.py`` does not shard
(stablelm-3b, gemma-2b, h2o-danube-3-4b, command-r-35b,
llava-next-mistral-7b, llama4-maverick, jamba, xlstm-125m, whisper-base),
reduced and in float32, run at a model axis of 2 (a ``data 2 x model 2``
mesh) and of 4 (``1 x 4``) where their heads divide it (reduced xlstm's 2
heads: 2 only), plus whisper with a vocabulary of 257, which no axis
divides (``unembed`` stays whole, every rank computes every logit), and
jamba with the port's published block (``/published``: the Mamba
mixer's dt/B/C norms on the all-reduced ``x_proj`` output, the gates not
renormalised, dropless routing; every other case takes the JAX
package's block, ``conftest.jax_block``).
Four ranks run over gloo, one spawned process each (``python -c`` with
``src`` and ``tests`` on the path, a ``file://`` store in the tmp dir);
ONE spawn makes every multi-rank run (:func:`worker`) and saves it, and
the tests read the results. jamba's (both cases') and whisper's
weights come from the JAX package (``convert.params_from_numpy(mesh=)``),
the others' from ``init_params(mesh=)``, each rank keeping its shard of
tensors drawn whole.

Tolerances:

* prefill (the model API; llava with patch embeddings, whisper with
  frame embeddings): every rank of the model axis returns the same
  logits, within 1e-5 of the unsharded port's, and the prefill cache
  gathered over the ranks (attention K/V by heads, Mamba states by
  channels, xLSTM states by heads) within 1e-5 (the partial products are
  summed in another order), or one bf16 ulp where it is bf16 (whisper's
  cache is bf16 whatever the model's type, as the reference's);
* replicated KV (gemma-2b's one KV head at 2 and 4; two KV heads at 4):
  each rank holds the whole KV head its query heads read, and the ranks
  that share one hold the same bytes;
* engines (a prefill engine, or whisper's model-API prefill, into a
  decode engine): the dense-cache and bf16-page decode tokens equal the
  unsharded engines', their bf16 caches within one bf16 ulp (2**-7
  relative), and their f32 recurrent states within one bf16 ulp of the
  tensor's largest magnitude (each step reads the bf16 conv states and
  attention caches, whose one-ulp flips they carry: jamba's Mamba ``ssm``
  at TP 2 differs by 5.5e-4 where its largest value is 0.53); int4 pages
  (head dim 128, where the int4 group is one head on every rank) by
  their tokens;
* the JAX package: the sharded jamba and whisper prefill logits within
  1e-4 of the JAX package's unsharded prefill on the same weights
  (whisper's frames are bf16 values, so the reference's bf16 cast of
  them is exact, and its encoder runs in f32 through ``_F32Frames``, as
  ``tests/test_torch_whisper.py`` runs it).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from conftest import jax_block  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build, convert  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import whisper as t_wh  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving import kv_transfer  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TP_SHAPES = {2: (2, 2), 4: (1, 4)}        # data x model
ARCHS = ("stablelm-3b", "gemma-2b", "h2o-danube-3-4b", "command-r-35b",
         "llava-next-mistral-7b", "llama4-maverick-400b-a17b",
         "jamba-v0.1-52b", "xlstm-125m", "whisper-base")
JAX_WEIGHTS = ("jamba-v0.1-52b", "whisper-base")
WIDE_VOCAB = "whisper-base/v257"          # no axis divides 257
PUBLISHED = "jamba-v0.1-52b/published"  # the port's own block (ROADMAP C.4)
CASES = ARCHS + (WIDE_VOCAB, PUBLISHED)
B, S = 2, 12                              # the prefill batch
PROMPTS, MAX_NEW, MAX_SEQ = (7, 13), 6, 32
BF16_ULP = 2.0 ** -7
TOL = 1e-5
# the dim each cache tensor splits its heads or channels on
HEADS_DIM = {"k": 3, "v": 3, "self_k": 3, "self_v": 3, "cross_k": 3,
             "cross_v": 3, "conv": -1, "ssm": 2, "C": 2, "n": 2, "m": 2,
             "c": 2, "h": 2}


def _cfg(case):
    arch, _, variant = case.partition("/")
    cfg = get_reduced(arch).replace(dtype="float32")
    if variant == "published":
        return cfg
    cfg = jax_block(cfg)
    return cfg.replace(vocab_size=int(variant[1:])) if variant else cfg


def _sizes(case):
    """The model axes the case's heads divide (the gathered ones are
    tests/test_torch_distributed_seq.py's)."""
    cfg = _cfg(case)
    return [n for n in TP_SHAPES if not sharding.tp_refusals(cfg, n)
            and sharding.heads_split(cfg, n)]


def _modes(cfg):
    """The decode caches of ``cfg``'s engines."""
    return ("dense", "bf16", "int4") if build(cfg).paged_decode_fns \
        else ("dense",)


def _init(cfg, mesh, seed=1):
    init = t_wh.init_params if cfg.family == "audio" else t_tf.init_params
    return init(cfg, seed=seed, device="cpu", dtype=torch.float32,
                mesh=mesh)


def _params(case, mesh, trees):
    cfg = _cfg(case)
    tree = trees.get(PUBLISHED.split("/")[0] if case == PUBLISHED else case)
    if tree is not None:
        return convert.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    return _init(cfg, mesh)


def _frames(cfg, rows):
    """Frame embeddings of bf16 values (exact under the reference's cast),
    one block a row."""
    out = [np.random.default_rng(100 + r).standard_normal(
        (cfg.encoder_seq, cfg.d_model)).astype(np.float32) for r in rows]
    return torch.from_numpy(np.stack(out)).to(torch.bfloat16).float()


def _batch(cfg):
    toks = np.random.default_rng(7).integers(1, 256, (B, S))
    batch = {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            np.random.default_rng(8).standard_normal(
                (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frame_embeds"] = _frames(cfg, range(B))
    return batch


def _flat_cache(cache):
    """``{name: tensor}`` of a cache, ``slot{s}/key`` for slotted ones,
    lengths and page tables left out."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": t for kk, t in v.items()})
        elif k not in ("lengths", "page_table"):
            out[k] = v
    return out


def _prefill_run(cfg, params, rt):
    logits, cache = build(cfg, rt=rt).prefill(params, _batch(cfg))
    return logits, {k: t.clone() for k, t in _flat_cache(cache).items()}


def _serve(cfg, params, rt, mode):
    """Two requests through a prefill (whisper: the model API over
    frames) and a decode engine of ``mode``: (their tokens, the decode
    cache's tensors). The dense cache and bf16 pages take raw wires,
    int4 pages the int4 wire."""
    rng = np.random.default_rng(0)
    reqs = [E.GenRequest(i, rng.integers(1, 256, n), MAX_NEW)
            for i, n in enumerate(PROMPTS)]
    compress = mode == "int4"
    if cfg.family == "audio":
        api = build(cfg, rt=rt)
        done = []
        for r in reqs:
            logits, cache = api.prefill(params, {
                "tokens": torch.as_tensor(r.tokens[None]).long(),
                "frame_embeds": _frames(cfg, [r.rid])})
            done.append((r, kv_transfer.extract(cache, 0, len(r.tokens),
                                                compress=compress),
                         int(torch.argmax(logits[0, -1]))))
    else:
        pre = E.PrefillEngine(cfg, params, max_seq=MAX_SEQ, device="cpu",
                              rt=rt)
        done = pre.run(reqs, compress=compress)
    kw = {"dense": dict(paged=False), "bf16": dict(kv_resident="bf16"),
          "int4": {}}[mode]
    dec = E.DecodeEngine(cfg, params, max_slots=2, max_seq=MAX_SEQ,
                         page_size=8, chunk_size=3, device="cpu", rt=rt,
                         **kw)
    assert not dec.admit(E.AdmissionBatch(
        [E.AdmissionItem(r, f, wire=w) for r, w, f in done]))
    while dec.active:
        dec.step()
    assert dec.page_stats() is None or dec.page_stats()["leaked_pages"] == 0
    kv = {} if mode == "int4" else {
        k: t.clone() for k, t in _flat_cache(dec.cache).items()}
    return [list(r.out_tokens) for r in reqs], kv


def _run(case, mesh, trees):
    """What a rank (or, without a mesh, the unsharded port) computes for
    ``case``: prefill logits and cache, and each engine's run."""
    cfg = _cfg(case)
    rt = None if mesh is None else t_tf.Runtime(
        mesh, moe_shard_map=bool(cfg.moe_num_experts))
    params = _params(case, mesh, trees)
    logits, cache = _prefill_run(cfg, params, rt)
    out = {"logits": logits, "cache": cache, "serve": {}}
    for mode in _modes(cfg):
        if mode == "int4":
            wide = cfg.replace(head_dim=128)
            out["serve"][mode] = _serve(wide, _init(wide, mesh, seed=3), rt,
                                        mode)
        else:
            out["serve"][mode] = _serve(cfg, params, rt, mode)
    return out


def worker(rank: int, world: int, tmp: str):
    """One rank of the spawn: every case at each model axis its heads
    divide, saved to ``rank{r}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            rank=rank, world_size=world)
    trees = torch.load(f"{tmp}/trees.pt", weights_only=False)
    out = {}
    for n, shape in TP_SHAPES.items():
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for case in CASES:
            if n in _sizes(case):
                out[case, n] = _run(case, mesh, trees)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


# -- the spawn and the unsharded runs -----------------------------------------


def _jax_trees():
    """The JAX package's f32 weights of jamba and whisper (numpy)."""
    import jax
    from repro.configs import get_reduced as j_get_reduced
    from repro.models import build as j_build
    out = {}
    for arch in JAX_WEIGHTS:
        jcfg = j_get_reduced(arch).replace(dtype="float32")
        out[arch] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                 jax.jit(j_build(jcfg).init)(
                                     jax.random.PRNGKey(0)))
    return out


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, make the unsharded runs meanwhile, wait.
    Returns (per-rank results, unsharded results, the JAX trees)."""
    tmp = tmp_path_factory.mktemp("dist_families")
    trees = _jax_trees()
    torch.save(trees, tmp / "trees.pt")
    ranks = [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_distributed_families as t;"
         f" t.worker({r}, {WORLD}, {str(tmp)!r})"],
        cwd=ROOT, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        whole = {case: _run(case, None, trees) for case in CASES}
        logs = [proc.communicate(timeout=300)[0] for proc in ranks]
    finally:
        for proc in ranks:
            proc.kill()
    for r, (proc, log) in enumerate(zip(ranks, logs)):
        assert proc.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return res, whole, trees


def _owners(cfg, n):
    """For each head of the unsharded cache, the first rank of the model
    axis that holds it (replicated KV: the rank of each KV head)."""
    if sharding.kv_replicated(cfg, n):
        return [h * (n // cfg.num_kv_heads) for h in range(cfg.num_kv_heads)]
    return list(range(n))


def _gathered(res, case, n, get, name):
    """A cache tensor gathered over data row 0's model ranks (global
    ranks 0..n-1), each head once."""
    cfg = _cfg(case)
    key = name.rsplit("/", 1)[-1]
    kv = key in ("k", "v") and sharding.kv_replicated(cfg, n)
    ranks = _owners(cfg, n) if kv else range(n)
    return torch.cat([get(res[r][case, n])[name] for r in ranks],
                     dim=HEADS_DIM[key])


def _close(got, want, name, decoded=False):
    """Within 1e-5, or one bf16 ulp for a bf16 tensor; an f32 state a
    decode engine stepped (``decoded``) within one bf16 ulp of the
    tensor's largest magnitude."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    bf16 = want.dtype == torch.bfloat16
    atol = BF16_ULP * float(want.abs().max()) if decoded and not bf16 \
        else TOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=BF16_ULP if bf16 else TOL, atol=atol,
                               err_msg=name)


TP_CASES = [(case, n) for case in CASES for n in _sizes(case)]


# -- (1) prefill --------------------------------------------------------------


@pytest.mark.parametrize("case,n", TP_CASES)
def test_family_prefill_matches_unsharded(runs, case, n):
    res, whole, _ = runs
    got = res[0][case, n]
    for r in range(WORLD):      # every rank returns the same logits
        assert torch.equal(res[r][case, n]["logits"], got["logits"])
    _close(got["logits"], whole[case]["logits"], "logits")
    assert got["logits"].shape[-1] == _cfg(case).vocab_size
    for name, want in whole[case]["cache"].items():
        _close(_gathered(res, case, n, lambda x: x["cache"], name), want,
               name)


@pytest.mark.parametrize("case,n", [(c, n) for c, n in TP_CASES
                                    if sharding.kv_replicated(_cfg(c), n)])
def test_replicated_kv_heads_are_whole_and_shared(runs, case, n):
    res, whole, _ = runs
    cfg = _cfg(case)
    per = n // cfg.num_kv_heads
    for name, want in whole[case]["cache"].items():
        if name.rsplit("/", 1)[-1] not in ("k", "v"):
            continue
        for r in range(n):
            mine = res[r][case, n]["cache"][name]
            assert mine.shape[3] == 1 and mine.shape[4] == cfg.head_dim
            assert torch.equal(mine, res[r - r % per][case, n]["cache"][name])


# -- (2) engines --------------------------------------------------------------

ENGINE_CASES = [(case, n, mode) for case, n in TP_CASES
                for mode in _modes(_cfg(case))]


@pytest.mark.parametrize("case,n,mode", ENGINE_CASES)
def test_family_engines_match_unsharded(runs, case, n, mode):
    res, whole, _ = runs
    want_toks, want_kv = whole[case]["serve"][mode]
    for r in range(WORLD):       # every replica row decodes the same
        assert res[r][case, n]["serve"][mode][0] == want_toks
    for name, want in want_kv.items():
        got = _gathered(res, case, n, lambda x: x["serve"][mode][1], name)
        _close(got, want, name, decoded=True)


# -- (3) the JAX package ------------------------------------------------------


class _F32Frames:
    """``jax.numpy`` with ``bfloat16`` naming float32 (see
    ``tests/test_torch_whisper.py``)."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(self._jnp, name)


@pytest.mark.parametrize("arch,n", [(a, n) for a in JAX_WEIGHTS
                                    for n in _sizes(a)])
def test_sharded_prefill_matches_jax(runs, monkeypatch, arch, n):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_get_reduced
    from repro.models import build as j_build
    from repro.models import whisper as j_whisper
    res, _, trees = runs
    monkeypatch.setattr(j_whisper, "jnp", _F32Frames(jnp))
    jcfg = j_get_reduced(arch).replace(dtype="float32")
    batch = {k: jnp.asarray(v.numpy().astype(
        np.int32 if k == "tokens" else np.float32))
        for k, v in _batch(_cfg(arch)).items()}
    jl, _ = j_build(jcfg).prefill(jax.tree.map(jnp.asarray, trees[arch]),
                                  batch, max_seq=S)
    np.testing.assert_allclose(res[0][arch, n]["logits"].numpy(),
                               np.asarray(jl, np.float32), atol=1e-4,
                               rtol=1e-4)
