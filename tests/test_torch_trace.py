"""The port's host tracer (``repro_torch.serving.trace``) on the CPU: off it
hands out one shared no-op and records nothing; on, spans nest with their
depth through a reduced command-r gateway's pump and engines, and
``prefill.call`` counts the prompts' tokens and the padding the engine
ran; under ``torch.profiler`` alone every span is also a user annotation
of the profile; the ring of records stays bounded."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving import faults as F  # noqa: E402
from repro_torch.serving import gateway as G  # noqa: E402
from repro_torch.serving import trace  # noqa: E402

torch.set_num_threads(2)

PUMP = ("pump.housekeeping", "pump.dispatch", "pump.transfers",
        "pump.decode")
DECODE = ("decode.stage", "decode.replay", "decode.readback",
          "decode.retire")
PREFILL = ("prefill.model", "prefill.first_token", "prefill.wire")


@pytest.fixture(autouse=True)
def _fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("command-r-35b")
    torch.manual_seed(0)
    return cfg, init_params(cfg, device="cpu")


def _gateway(cfg, params):
    pre = E.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    dec = E.DecodeEngine(cfg, params, max_slots=8, max_seq=64, page_size=8,
                         chunk_size=2, device="cpu")
    return G.Gateway([pre], [dec], clock=F.VirtualClock()), pre


def _serve(gw, cfg, lens, max_new=4):
    rng = np.random.default_rng(1)
    hs = [gw.submit(G.ServeRequest(
        i, rng.integers(1, cfg.vocab_size, n).astype(np.int32), max_new))
        for i, n in enumerate(lens)]
    gw.run_until_drained(max_iters=200)
    assert all(h.state == G.DONE for h in hs)


def _within(inner, outer):
    return outer.t0 <= inner.t0 and inner.t1 <= outer.t1 \
        and inner.depth > outer.depth


def _pad_by_hand(pre, lens):
    """(rows, tokens, padded tokens) of one bucketed prefill call."""
    by_bucket = collections.defaultdict(list)
    for n in lens:
        by_bucket[pre._bucket_of(n)].append(n)
    rows = padded = 0
    for Lb, group in by_bucket.items():
        for lo in range(0, len(group), pre.max_batch):
            sub = group[lo:lo + pre.max_batch]
            b = min(1 << (len(sub) - 1).bit_length(), pre.max_batch)
            rows += b
            padded += b * Lb - sum(sub)
    return rows, sum(lens), padded


def test_off_hands_out_the_shared_noop_and_records_nothing():
    sp = trace.span("pump", rows=3)
    assert sp is trace.NOOP and trace.span("decode.chunk") is sp
    with sp as got:
        assert not got
        got.set(steps=8)
        trace.add(tokens=5)
    assert trace.spans() == []


def test_spans_nest_with_their_depth_and_attributes(monkeypatch):
    t = iter(range(100))
    monkeypatch.setattr(trace, "_clock", lambda: float(next(t)))
    trace.enable()
    with trace.span("a", k=1) as a:
        assert a
        with trace.span("b"):
            trace.add(tokens=3)
            trace.add(tokens=4, padded_tokens=1)
        a.set(m=2)
    trace.disable()
    with trace.span("c"):
        pass
    b, a = trace.spans()
    assert (b.name, b.depth, b.attrs) == \
        ("b", 1, {"tokens": 7, "padded_tokens": 1})
    assert (a.name, a.depth, a.attrs) == ("a", 0, {"k": 1, "m": 2})
    assert (a.t0, b.t0, b.t1, a.t1) == (0.0, 1.0, 2.0, 3.0)
    assert trace.spans(0.5, 3.0) == [b]


def test_gateway_spans_nest(model):
    cfg, params = model
    gw, _ = _gateway(cfg, params)
    trace.enable()
    _serve(gw, cfg, [5, 12, 20, 33, 9])
    recs = trace.spans()
    names = collections.Counter(r.name for r in recs)
    assert set(names) >= {"pump", "pump.deliver", "prefill.call",
                          "decode.admit", "decode.chunk",
                          *PUMP, *DECODE, *PREFILL}
    pumps = [r for r in recs if r.name == "pump"]
    assert all(r.depth == 0 for r in pumps)
    for r in recs:
        if r.name.startswith("pump."):
            assert any(_within(r, p) for p in pumps), r
    assert names["pump.housekeeping"] == names["pump"]
    chunks = [r for r in recs if r.name == "decode.chunk"]
    for r in recs:
        if r.name in DECODE:
            assert any(_within(r, c) for c in chunks), r
    for c in chunks:
        assert c.attrs["steps"] == 2 and 1 <= c.attrs["residents"] <= 5
        assert c.attrs["reserved_pages"] >= c.attrs["residents"]
        assert any(_within(c, p) for p in pumps if p.name == "pump")
    calls = [r for r in recs if r.name == "prefill.call"]
    for r in recs:
        if r.name in PREFILL:
            assert any(_within(r, c) for c in calls), r


@pytest.mark.parametrize("bucketed", [True, False])
def test_prefill_call_counts_tokens_and_padding_by_hand(model, bucketed):
    """Seven prompts at once: the first pump prefills four (the batch
    cap), the next three, so a padding row is counted whole."""
    cfg, params = model
    gw, pre = _gateway(cfg, params)
    pre.bucketed = bucketed          # False: the exact-length path
    lens = [5, 12, 20, 33, 9, 17, 40]
    trace.enable()
    _serve(gw, cfg, lens)
    calls = [r for r in trace.spans() if r.name == "prefill.call"]
    assert len(calls) == 2
    for r, part in zip(calls, (lens[:4], lens[4:])):
        want = _pad_by_hand(pre, part) if bucketed else \
            (len(part), sum(part), 0)
        assert (r.attrs["rows"], r.attrs["tokens"],
                r.attrs["padded_tokens"]) == want
    if bucketed:
        assert calls[1].attrs["padded_tokens"] > 0


def test_a_profiler_alone_turns_spans_on_as_user_annotations(model):
    cfg, params = model
    gw, _ = _gateway(cfg, params)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("pump") is not trace.NOOP
        _serve(gw, cfg, [7, 30, 12])
    assert trace.span("pump") is trace.NOOP
    got = collections.Counter(r.name for r in trace.spans())
    assert got["pump"] > 0 and got["decode.chunk"] > 0
    seen = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation() and e.name() in got)
    assert seen == got


def test_the_ring_stays_bounded():
    trace.enable()
    for i in range(trace.RING + 10):
        with trace.span("s", i=i):
            pass
    got = trace.spans()
    assert len(got) == trace.RING
    assert got[0].attrs["i"] == 10 and got[-1].attrs["i"] == trace.RING + 9


def test_recurrent_prefill_spans_and_moe_counts():
    """jamba's exact-length prefill: a ``prefill.mamba`` span around each
    Mamba mixer and a ``prefill.moe`` span around each expert layer,
    nested in the call's ``prefill.call``, which counts the routes
    (tokens x k) and the expert products' rows (experts x capacity) of
    every expert layer from the shapes; ``mamba_ms`` (CUDA events) is
    left out on the CPU."""
    from repro_torch.models import moe
    cfg = get_reduced("jamba-v0.1-52b")
    params = init_params(cfg, device="cpu")
    pre = E.PrefillEngine(cfg, params, max_seq=64, device="cpu")
    kinds = [k.split("+") for k in cfg.layer_kinds()]
    n_mamba = sum(mix == "mamba" for mix, _ in kinds)
    n_moe = sum(ffn == "moe" for _, ffn in kinds)
    assert n_mamba and n_moe
    rng = np.random.default_rng(2)
    lens = [9, 40]
    reqs = [E.GenRequest(i, rng.integers(1, cfg.vocab_size, n)
                         .astype(np.int32), 4) for i, n in enumerate(lens)]
    trace.enable()
    pre.run(reqs)
    call, = [r for r in trace.spans() if r.name == "prefill.call"]
    got = collections.Counter(r.name for r in trace.spans()
                              if call.t0 <= r.t0 and r.t1 <= call.t1)
    assert got["prefill.mamba"] == n_mamba * len(lens)
    assert got["prefill.moe"] == n_moe * len(lens)
    k, E_ = cfg.moe_top_k, cfg.moe_num_experts
    assert call.attrs["moe_routes"] == n_moe * k * sum(lens)
    assert call.attrs["moe_rows"] == n_moe * E_ * sum(
        moe.capacity_of(cfg, n) for n in lens)
    assert "mamba_ms" not in call.attrs


def test_add_to_and_device_ms_find_their_span():
    """``add_to`` sums into the innermost open span of its name and does
    nothing with none open; ``device_ms`` is the no-op off the card, with
    the tracer off, or with no such span open."""
    trace.enable()
    trace.add_to("outer", n=1)
    with trace.span("outer") as o:
        with trace.span("inner") as i:
            trace.add_to("outer", n=2)
            trace.add_to("outer", n=3)
            assert trace.device_ms("outer", "ms", "cpu") is trace.NOOP
        assert "n" not in i.attrs
    assert o.attrs["n"] == 5
    assert trace.device_ms("outer", "ms", "cuda") is trace.NOOP
    trace.disable()
    with trace.span("outer"):
        assert trace.device_ms("outer", "ms", "cuda") is trace.NOOP
