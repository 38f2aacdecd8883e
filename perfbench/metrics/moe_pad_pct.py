"""moe_pad_pct (model step, MoE): the share of the rows the prefill
calls' expert products compute that hold no route, 100 x (1 - the summed
``moe_routes`` over the summed ``moe_rows`` of the program's
``prefill.call`` spans in the traced seconds). ``moe_routes`` is a call's
tokens x experts per token, ``moe_rows`` its experts x capacity, over its
expert layers: host numbers from the shapes. None where the program
records neither."""
from pbench import spans


def read(run):
    calls = spans.named(run, "prefill.call")
    rows = sum(r.attrs.get("moe_rows", 0) for r in calls)
    if not rows:
        return None
    return 100.0 * (1.0 - sum(r.attrs.get("moe_routes", 0)
                              for r in calls) / rows)
