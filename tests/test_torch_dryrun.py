"""The port's dry-run (``launch/dryrun.py``) and what it runs on
``meta`` tensors, against the JAX package's (CPU).

* ``input_specs`` are the reference's batch for every cell (shapes and
  types); ``cache_specs`` the reference's decode cache wherever ROADMAP
  C.4 records no difference (a multi-slot pure-attention stack keeps one
  layer-ordered stack in the port).
* The meta pass and the CPU pass of the reduced LLaMA prefill and paged
  decode step make the same ``ops.*`` calls, in order, with the same
  output shapes and types; an ``ops.*`` call on meta outside a counter
  raises.
* An abstract ``(1, 4)`` mesh counts 2L all-reduces and 2 all-gathers
  for a reduced LLaMA tensor-parallel decode step (what phase 12 of
  ``chip_smoke.py`` captured at L = 60), their wire bytes the ring
  model's.
* The same mesh counts a rank's collectives in a recurrent and an audio
  cell at a reduced shape (full widths, 2 x 64 tokens): xlstm-125m's
  prefill (an all-gather of the embedding, of each mLSTM's ``xc`` and
  ``xm`` and of each sLSTM's ``y``, of the logits; two all-reduces an
  mLSTM, its norm's mean squares and ``w_down``, one an sLSTM) and
  whisper-base's prefill (three all-reduces a decoder layer, two an
  encoder layer; its vocabulary of 51865 leaves ``unembed`` whole, so no
  logits are gathered) and its decode step in the reference's kv_seq
  layout (each self and cross attention gathers q, k and v, or q, and
  merges its ranks' partial softmaxes: an all-gather of their
  log-sum-exps and an all-reduce of the weighted outputs).
* The jamba decode step with a sliding window (the reference's
  long_500k cell, a ring of ``window`` rows in its attention layers)
  matches the reference's in-place step on the reduced config in f32,
  fed the same tokens past the window: logits within 1e-4 of the
  largest, tokens equal where the top-2 margin clears 1e-3.
* ``run_cell`` at full width on meta: llama-30b x decode_32k @ one,
  qwen3-moe x decode_32k @ four, jamba x long_500k @ one and
  whisper-base x train_4k @ one are ``ok`` with the reference's keys;
  llama-30b x decode_32k @ single (52 heads over 16, which A.9 step two
  refused before items 3 and 4) is ``ok`` too, its cache a rank's
  sixteenth of the whole cache at its batch, its collectives the q/k/v
  gathers and the partial softmaxes' merge (two all-gathers and an
  all-reduce a layer beside the row-parallel sums); and
  ``report.table`` over those records is the reference's text.
* The five archs the production meshes could not count before count
  ``ok`` at ``single`` (decode_32k, and train_4k for LLaMA-30B, 52 heads
  over 16 the qseq way), and a ``multi`` cell too.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_reduced as j_get_reduced  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.roofline import report as j_report  # noqa: E402
from conftest import jax_block  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, SHAPES, all_cells,  # noqa: E402
                                 get_config, get_reduced)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import build, convert, paged, registry  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.roofline import analysis, report  # noqa: E402
from repro_torch.roofline.op_cost import OpCounter  # noqa: E402

torch.set_num_threads(2)

MODEL_TOL, MARGIN = 1e-4, 1e-3    # tests/test_torch_recurrent.py


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a nest of dicts of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace(
        "torch.", ""))}


# -- (b) the specs -------------------------------------------------------------


def test_input_specs_match_reference():
    cells = all_cells()[0] + [("llama-30b", s)
                              for s in get_config("llama-30b").shape_cells()]
    for arch, shape in cells:
        mine = build(get_config(arch)).input_specs(SHAPES[shape])
        theirs = j_build(j_get_config(arch)).input_specs(J_SHAPES[shape])
        assert all(t.device.type == "meta" for t in mine.values())
        assert _flat(mine) == _flat(theirs), (arch, shape)


# pure-attention stacks of several slots: the port keeps one stack
MULTI_SLOT = {"llama4-maverick-400b-a17b"}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch):
    cfg = get_config(arch)
    for shape in (s for s in cfg.shape_cells() if "decode" in s
                  or s == "long_500k"):
        mine = _flat(build(cfg).cache_specs(SHAPES[shape]))
        theirs = _flat(j_build(j_get_config(arch)).cache_specs(
            J_SHAPES[shape]))
        if arch not in MULTI_SLOT:
            assert mine == theirs, (arch, shape)
            continue
        # C.4: one layer-ordered stack of every layer for the reference's
        # slots, each (L / period, ...)
        assert set(mine) == {"/slot0/k", "/slot0/v", "/lengths"}
        for key in ("k", "v"):
            parts = [v for p, v in theirs.items() if p.endswith(f"/{key}")]
            assert sum(s[0] for s, _ in parts) == mine[f"/slot0/{key}"][0][0]
            assert {(s[1:], d) for s, d in parts} == \
                {(mine[f"/slot0/{key}"][0][1:], mine[f"/slot0/{key}"][1])}


# -- (f) meta and CPU passes make the same kernel calls ------------------------

_OPS = ("kv_quant", "kv_dequant", "kv_quant_append", "decode_attention",
        "paged_decode_attention", "flash_attention", "rmsnorm", "add_rmsnorm")


def _record(monkeypatch):
    calls = []
    for name in _OPS:
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((_name, [None if o is None else _spec(o)
                                  for o in outs]))
            return out
        monkeypatch.setattr(ops, name, wrapped)
    return calls


def test_meta_and_cpu_passes_make_the_same_kernel_calls(monkeypatch):
    calls = _record(monkeypatch)
    cfg = get_reduced("llama-30b").replace(dtype="float32")
    api = build(cfg)
    step_fn, _ = api.paged_decode_fns(8)
    runs = {}
    for dev in ("cpu", "meta"):
        params = t_tf.init_params(cfg, device=dev, dtype=torch.float32)
        cache = paged.init_paged_cache(cfg, 2, 32, 9, page_size=8,
                                       device=dev)
        toks = torch.zeros((2, 16), dtype=torch.int64, device=dev)
        calls.clear()
        with OpCounter() as c:
            api.prefill(params, {"tokens": toks}, max_seq=32)
            step_fn(params, cache, toks[:, :1])
        runs[dev] = (list(calls), c.result()["kernels"])
    assert runs["cpu"] == runs["meta"]
    names = [n for n, _ in runs["meta"][0]]
    assert names.count("flash_attention") == 2
    assert names.count("kv_quant_append") == 2
    assert runs["meta"][1]["paged_decode_attention_int4"] == 2


def test_meta_kernel_call_outside_a_counter_raises():
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(RuntimeError, match="outside an op counter"):
        ops.rmsnorm(x, torch.empty((64,), device="meta"))
    with pytest.raises(RuntimeError, match="outside an op counter"):
        ops.kv_quant(x)


# -- (h) the abstract mesh's collectives ---------------------------------------


def test_abstract_mesh_counts_a_tp_decode_steps_collectives():
    cfg = get_reduced("llama-30b")
    mesh = abstract_mesh((1, 4), ("data", "model"))
    api = build(cfg, rt=t_tf.Runtime(mesh))
    params = t_tf.init_params(cfg, device="meta", mesh=mesh)
    assert params["layers"][0]["attn"]["wq"].shape == (64, 16)
    cache = t_tf.init_cache(api.local_cfg, 2, 32, device="meta")
    tok = torch.empty((2, 1), dtype=torch.int32, device="meta")
    with OpCounter() as c:
        logits, _ = api.decode(params, cache, tok)
    r = c.result()
    L = cfg.num_layers
    assert r["coll_counts"] == {"all_reduce": 2 * L, "all_gather": 2}
    assert logits.shape == (2, 1, cfg.vocab_size)
    # payloads: the (2, 1, d) partial sums, f32 above axis size 1
    # (layers.row_proj), the gathered (2, 1, d) bf16 embedding rows and
    # (2, 1, V) bf16 logits
    d, V = cfg.d_model, cfg.vocab_size
    ar, ag = 2 * d * 4, 2 * d * 2 + 2 * V * 2
    assert r["coll_payload"] == 2 * L * ar + ag
    assert r["coll_wire"] == 2 * L * analysis.wire_bytes(
        "all_reduce", ar, 4) + analysis.wire_bytes("all_gather", ag, 4)
    with pytest.raises(RuntimeError, match="outside an op counter"):
        api.decode(params, cache, tok)


@pytest.mark.parametrize("arch,kind,want", [
    ("xlstm-125m", "prefill", {"all_gather": 1 + 10 + 2 + 1,
                               "all_reduce": 2 * 10 + 2}),
    ("whisper-base", "prefill", {"all_gather": 1,
                                 "all_reduce": 2 * 6 + 3 * 6}),
    ("whisper-base", "decode", {"all_gather": 1 + 4 * 6,
                                "all_reduce": 3 * 6 + 2 * 6})])
def test_abstract_mesh_counts_a_recurrent_and_an_audio_cell(
        monkeypatch, arch, kind, want):
    name = f"{kind}_64"
    monkeypatch.setitem(dryrun.SHAPES, name, ShapeSpec(name, 64, 2, kind))
    counted, info = dryrun.trace_cell(arch, name, dryrun.make_mesh("four"))
    assert counted["coll_counts"] == want
    cfg = get_config(arch)
    assert info["batch"] == 2 and info["cfg"] == cfg
    if arch == "xlstm-125m":
        # each mLSTM gathers (2, B, S, 2d / 4) bf16 into (2, B, S, 2d)
        assert counted["coll_payload"] >= 10 * 2 * 2 * 64 * 2 * 768 * 2
        assert counted["kernels"] == {"rmsnorm": 2}    # the sLSTM norms
    else:   # a decode step's attention: the kv_seq partial mode
        assert counted["kernels"]["flash_attention" if kind == "prefill"
                                  else "decode_attention_lse"] > 0


# -- (i) the jamba window in the dense decode step ------------------------------


def test_jamba_windowed_decode_matches_reference():
    window, B, max_seq, steps = 6, 2, 24, 14
    jcfg = j_get_reduced("jamba-v0.1-52b").replace(
        dtype="float32", sliding_window=window)
    tcfg = jax_block(get_reduced("jamba-v0.1-52b").replace(
        dtype="float32", sliding_window=window))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.jit(
        j_build(jcfg).init)(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    jd = j_tf.init_cache(jcfg, B, max_seq, jnp.float32)
    td = t_tf.init_cache(tcfg, B, max_seq, torch.float32, device="cpu")
    attn = [s for s, k in enumerate(t_tf.slot_kinds(tcfg))
            if k.startswith("attn")]
    assert attn and td[f"slot{attn[0]}"]["k"].shape[2] == window
    rt = j_tf.Runtime(inplace_decode=True)
    j_step = jax.jit(lambda p, c, t: j_tf.decode_step(jcfg, p, c, t, rt=rt))
    cur = np.array([[3], [17]], np.int32)
    for _ in range(steps):
        jl, jd = j_step(jp, jd, jnp.asarray(cur))
        tl, td = t_tf.decode_step(tcfg, tp, td, torch.from_numpy(cur))
        want, got = np.asarray(jl, np.float32), tl.numpy()
        assert np.abs(got - want).max() <= MODEL_TOL * max(
            1.0, float(np.abs(want).max()))
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > MARGIN
        assert (got[:, -1].argmax(-1)[clear]
                == want[:, -1].argmax(-1)[clear]).all()
        cur = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert td["lengths"].tolist() == [steps] * B
    # its prefill (refused here until ROADMAP A.15): a 15-token prompt
    # over the 6-token window, the ring rotated as the reference's
    toks = np.random.default_rng(6).integers(1, 256, (B, 15)).astype(
        np.int32)
    jl, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=max_seq)
    tl, tc = build(tcfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                 max_seq=max_seq)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= MODEL_TOL * max(
        1.0, float(np.abs(np.asarray(jl)).max()))
    for s in attn:
        for key in ("k", "v"):
            want = np.asarray(jc[f"slot{s}"][key])
            assert tc[f"slot{s}"][key].shape[2] == window
            assert np.abs(tc[f"slot{s}"][key].numpy() - want).max() <= \
                MODEL_TOL * max(1.0, float(np.abs(want).max()))


# -- (j), (k) the cells and the report ------------------------------------------

CELLS = (("llama-30b", "decode_32k", "one"),
         ("qwen3-moe-235b-a22b", "decode_32k", "four"),
         ("jamba-v0.1-52b", "long_500k", "one"),
         ("whisper-base", "train_4k", "one"))
# the reference's record of an ok cell, but its lower_s / compile_s
REF_KEYS = {"status", "arch", "shape", "mesh", "tag", "n_chips",
            "memory_analysis", "arch", "shape", "mesh", "n_chips",
            "hlo_flops", "hlo_bytes", "collective_payload", "collective_wire",
            "collective_counts", "compute_s", "memory_s", "collective_s",
            "bottleneck", "model_flops", "useful_ratio", "step_s",
            "roofline_frac", "per_device_output_bytes",
            "memory_estimate_bytes"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_torch")
    old = dryrun.RESULTS
    dryrun.RESULTS = tmp
    try:
        recs = [dryrun.run_cell(a, s, m, force=True) for a, s, m in CELLS]
        bad = dryrun.run_cell("llama-30b", "decode_32k", "single",
                              force=True)
    finally:
        dryrun.RESULTS = old
    return tmp, recs, bad


def test_run_cell_at_full_width(records):
    tmp, recs, bad = records
    for (arch, shape, mesh), r in zip(CELLS, recs):
        assert r["status"] == "ok", r.get("error")
        assert REF_KEYS <= set(r) and "trace_s" in r
        assert set(r["memory_analysis"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"}
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
        assert r["model_flops"] == analysis.model_flops_for(
            registry._effective_cfg(get_config(arch), SHAPES[shape]),
            SHAPES[shape])
        on_disk = json.loads((tmp / f"{mesh}_{arch}_{shape}_baseline.json"
                              ).read_text())
        assert on_disk == r
    llama, qwen, jamba, whisper = recs
    # one card: every layer's dense decode attention and norms, no wire;
    # the kv_seq layout at one rank is the whole cache
    assert llama["kernel_calls"] == {"rmsnorm": 1, "add_rmsnorm": 120,
                                     "decode_attention": 60}
    assert llama["collective_wire"] == 0 and not llama["fits_hbm"]
    cfg = get_config("llama-30b")
    whole = 2 * cfg.num_layers * 128 * 32768 * cfg.kv_dim * 2
    assert llama["cache_bytes"] == whole + 4 * 128      # and the lengths
    # four cards: the kv_seq partial mode over a rank's quarter of the
    # positions of every KV head; experts exchanged
    assert qwen["n_chips"] == 4 and qwen["collective_wire"] > 0
    assert qwen["kernel_calls"]["decode_attention_lse"] == 94
    # jamba's 4 attention layers read a 4096-row ring
    assert jamba["kernel_calls"]["decode_attention"] == 4
    assert whisper["kernel_calls"] == {} and whisper["bottleneck"]
    # the production mesh: 52 heads over 16, a rank's share of the cache
    # of its 8 rows of the batch; each layer gathers q, k and v and
    # merges the partials (lse all-gather, output all-reduce) beside its
    # two row-parallel sums; the embedding and the logits gathered
    L = cfg.num_layers
    assert bad["status"] == "ok" and bad["rank_batch"] == 128 // 16
    assert bad["cache_bytes"] == whole // 16 // 16 + 4 * 8
    assert bad["kernel_calls"] == {"rmsnorm": 1, "add_rmsnorm": 2 * L,
                                   "decode_attention_lse": L}
    assert bad["collective_counts"] == {"all_gather": 2 * L + 2,
                                        "all_reduce": 3 * L}


@pytest.mark.parametrize("arch,shape,mesh", [
    ("llama-30b", "decode_32k", "single"), ("llama-30b", "train_4k", "single"),
    ("llama4-maverick-400b-a17b", "decode_32k", "single"),
    ("gemma-2b", "decode_32k", "single"), ("whisper-base", "decode_32k",
                                           "single"),
    ("xlstm-125m", "decode_32k", "single"), ("gemma-2b", "decode_32k",
                                             "multi")])
def test_production_mesh_cells_count(tmp_path, monkeypatch, arch, shape,
                                     mesh):
    """The archs whose heads 16 does not divide count at the reference's
    production meshes: gathered heads (whole head counts on a rank, the
    columns cut), decode in the kv_seq layout (a rank's sixteenth of the
    positions, the partial mode, its merge's collectives)."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    r = dryrun.run_cell(arch, shape, mesh, force=True)
    assert r["status"] == "ok", r.get("error")
    assert r["n_chips"] == (256 if mesh == "single" else 512)
    assert r["hlo_flops"] > 0 and r["collective_wire"] > 0
    if shape == "train_4k":
        assert r["collective_counts"]["all_to_all"] > 0  # qseq's exchange
        return
    cfg = get_config(arch)
    if cfg.family != "ssm":
        assert r["kernel_calls"]["decode_attention_lse"] > 0
        assert r["collective_counts"]["all_gather"] >= 2 * cfg.num_layers


def test_gathered_prefill_cell_keeps_its_share_on_the_critical_rank():
    """A gathered prefill cell at ``single`` (gemma-2b's 8 heads over 16,
    2 rows of the batch a rank): its cache is the rank's sixteenth of the
    positions of the one KV head, as the reference's kv_seq-sharded
    prefill output, beside the gathered logits; and it counts the model
    axis's last rank, whose qseq query rows attend every key before them
    (the flash kernel's suffix call over all 32768), where rank 0's
    attend their own 2048: about 2n - 1 = 31 times the attention."""
    from repro_torch.launch.mesh import abstract_mesh
    cfg = get_config("gemma-2b")
    last, info = dryrun.trace_cell("gemma-2b", "prefill_32k",
                                   dryrun.make_mesh("single"))
    first, _ = dryrun.trace_cell("gemma-2b", "prefill_32k", abstract_mesh(
        (16, 16), ("data", "model")))
    b, S = info["batch"], 32768
    whole = 2 * cfg.num_layers * b * S * cfg.num_kv_heads * cfg.head_dim * 2
    assert info["out"] == whole // 16 + b * cfg.vocab_size * 4 + 4 * b
    fl = [c["kernel_cost"]["flash_attention"]["flops"]
          for c in (first, last)]
    assert 30 < fl[1] / fl[0] < 32


def test_report_table_is_the_reference_text(records, monkeypatch):
    tmp, _, _ = records
    monkeypatch.setattr(report, "RESULTS", tmp)
    monkeypatch.setattr(j_report, "RESULTS", tmp)
    for mesh in ("one", "four", "single"):
        assert report.table(mesh) == j_report.table(mesh)
        assert report.summarize(mesh) == j_report.summarize(mesh)
    assert len(report.table("one").splitlines()) == 2 + 3
    assert report.pick_hillclimb_cells("one") == \
        j_report.pick_hillclimb_cells("one")
