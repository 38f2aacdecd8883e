"""decode_batch_mean (engines, decode): mean resident requests a decode
step served in the window, each call's residents weighted by its steps."""


def read(run):
    calls = run.window_calls("decode")
    steps = sum(c.n_steps for c in calls)
    return sum(len(c.rids) * c.n_steps for c in calls) / steps \
        if steps else None
