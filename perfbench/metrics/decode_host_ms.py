"""decode_host_ms (engines, decode): mean host milliseconds of a decode
chunk outside the device's own time: each of the program's
``decode.chunk`` spans in the traced seconds less its ``decode.readback``
(which waits for the chunk on the device) and its ``decode.replay`` (the
graph's launch, which the profiler holds up many times over): the host
state's staging and the capture check, reading the tokens out and
releasing finished slots (``decode.stage``, ``decode.retire``)."""
from pbench import spans


def read(run):
    got = spans.exclusive_s(run, "decode.chunk",
                            ("decode.readback", "decode.replay"))
    return 1e3 * sum(got) / len(got) if got else None
