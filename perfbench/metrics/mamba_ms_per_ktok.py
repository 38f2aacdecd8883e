"""mamba_ms_per_ktok (model step, Mamba): device time of the prefill
calls' Mamba mixers per 1,000 prompt tokens, 1000 x the summed
``mamba_ms`` over the summed ``tokens`` of the program's ``prefill.call``
spans in the traced seconds that carry it (CUDA events around each mixer
of the recurrent prefill, read once the call has copied its first tokens
back). None where the program records no ``mamba_ms``."""
from pbench import spans


def read(run):
    calls = [r for r in spans.named(run, "prefill.call")
             if "mamba_ms" in r.attrs]
    tokens = sum(r.attrs.get("tokens", 0) for r in calls)
    if not tokens:
        return None
    return 1e3 * sum(r.attrs["mamba_ms"] for r in calls) / tokens
