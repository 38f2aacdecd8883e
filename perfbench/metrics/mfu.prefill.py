"""mfu.prefill (model step, whole step): model FLOPs of the window's
prefill calls (``pbench.flops``: each prompt at its own length, no
padding) over their device time (CUDA events around each prefill call) at
the H100's 989 TFLOP/s in bf16."""
from pbench import flops, peaks


def read(run):
    calls = [c for c in run.window_calls("prefill") if c.ms is not None]
    if not calls:
        return None
    work = sum(flops.prefill_flops(run.m, n) for c in calls for n in c.lens)
    secs = sum(c.ms for c in calls) * 1e-3
    return 100.0 * work / (secs * peaks.BF16_FLOPS)
