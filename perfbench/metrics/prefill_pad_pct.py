"""prefill_pad_pct (engines, prefill): the padding the prefill engine ran
as a share of the prompts' own tokens, 100 x the summed ``padded_tokens``
over the summed ``tokens`` of the program's ``prefill.call`` spans in the
traced seconds. A call's padding is its rows x bucket less the prompts'
tokens, a padding row counted whole; exact-length prefill pads nothing."""
from pbench import spans


def read(run):
    calls = spans.named(run, "prefill.call")
    tokens = sum(r.attrs.get("tokens", 0) for r in calls)
    if not tokens:
        return None
    return 100.0 * sum(r.attrs.get("padded_tokens", 0)
                       for r in calls) / tokens
