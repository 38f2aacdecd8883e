"""mfu.decode (model step, whole step): model FLOPs of the window's
decode steps (``pbench.flops``: each resident request's token at its
context length, until its request is done) over their device time (CUDA
events around each decode call) at the H100's 989 TFLOP/s in bf16."""
from pbench import flops, peaks


def read(run):
    calls = [c for c in run.window_calls("decode") if c.ms is not None]
    if not calls:
        return None
    work = sum(flops.decode_flops(run.m, lens) for c in calls
               for lens in flops.decode_step_lens(c, run.serve["max_seq"]))
    secs = sum(c.ms for c in calls) * 1e-3
    return 100.0 * work / (secs * peaks.BF16_FLOPS)
