"""attn_roofline.decode (kernels): the least time of the decode
attention the traced decode calls needed (``pbench.flops``: each step's
resident requests at their served lengths, every attention layer, through
the frozen ``kernel_cost``, at the H100's published peaks) over the
profiler's time of the kernels ``ops/decode_attention.json`` names."""
from pbench import flops


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.time_of(run.op_patterns("decode_attention"))
    calls = run.window_calls("decode", profiled=True)
    if not spent or not calls:
        return None
    s = run.serve
    need = sum(flops.decode_attention_bound_s(
        run.m, lens, paged_int4=run.paged_int4,
        page_size=s.get("page_size", 16), max_seq=s["max_seq"])
        for c in calls for lens in flops.decode_step_lens(c, s["max_seq"]))
    return 100.0 * need / spent
