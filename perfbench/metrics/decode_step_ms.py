"""decode_step_ms (engines, decode): device time of the window's decode
calls (CUDA events around each call of the harness's decode client: one
graphed chunk and its host copies) over the steps they ran."""


def read(run):
    calls = [c for c in run.window_calls("decode") if c.ms is not None]
    steps = sum(c.n_steps for c in calls)
    return sum(c.ms for c in calls) / steps if steps else None
