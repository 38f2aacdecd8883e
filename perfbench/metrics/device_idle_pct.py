"""device_idle_pct (device): share of the traced part of the window in
which no kernel, copy or set ran on the card (the profiler's device
events, their union against the traced seconds on the host clock)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * max(t.window_s - t.busy_s, 0.0) / t.window_s
