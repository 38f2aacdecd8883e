"""output_tokens_per_s: every output token delivered inside the window,
whatever request it belongs to, over the window's length (host clock)."""


def read(run):
    w = run.window
    n = sum(1 for r in w.reqs for s in r.stamps if w.start <= s <= w.end)
    return n / w.seconds
