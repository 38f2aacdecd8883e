"""attn_roofline.prefill (kernels): the least time of the causal
attention the traced prefill calls needed (``pbench.flops``: each prompt
at its own length, every attention layer, through the frozen
``kernel_cost``, at the H100's published peaks) over the profiler's time
of the kernels ``ops/prefill_attention.json`` names."""
from pbench import flops


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.time_of(run.op_patterns("prefill_attention"))
    calls = run.window_calls("prefill", profiled=True)
    if not spent or not calls:
        return None
    need = sum(flops.prefill_attention_bound_s(run.m, n)
               for c in calls for n in c.lens)
    return 100.0 * need / spent
