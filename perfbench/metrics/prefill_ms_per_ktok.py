"""prefill_ms_per_ktok (engines, prefill): device time of the window's
prefill calls (CUDA events around each call of the harness's prefill
client: the model, the first token's copy, the int4 wire) per 1,000
prompt tokens they prefilled."""


def read(run):
    calls = [c for c in run.window_calls("prefill") if c.ms is not None]
    toks = sum(sum(c.lens) for c in calls)
    return sum(c.ms for c in calls) / toks * 1e3 if toks else None
