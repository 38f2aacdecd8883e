"""pump_host_ms (gateway): mean host milliseconds of a gateway pump outside
the engines' calls and the harness's decode client: each of the program's
``pump`` spans in the traced seconds less the ``prefill.call`` and
``decode.admit`` spans inside it and less its ``pump.decode`` but for the
``pump.deliver`` spans in that. So it holds the gateway's housekeeping,
dispatch, transfers and token delivery; it leaves out the harness's
decode client (``pbench/clients.py``: its CUDA events, range and the
paged ``page_stats()``, which sit in ``pump.decode`` before the engine's
``decode.chunk``) with the gateway's few lines around it. The harness's
prefill and admit clients (events and ranges only) stay inside it."""
from pbench import spans


def read(run):
    got = spans.exclusive_s(run, "pump", ("pump.decode", "prefill.call",
                                          "decode.admit"),
                            plus=("pump.deliver",))
    return 1e3 * sum(got) / len(got) if got else None
