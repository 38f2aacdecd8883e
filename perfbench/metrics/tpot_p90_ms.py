"""tpot_p90_ms: the 90th percentile, over the window's requests that had a
first token by its close, of the time a further token took (host clock):
(last - first) / (tokens - 1) for one done by then; for one still
decoding, (close - first) / tokens so far, the gap it is waiting in
counted. A request done with a single token has no gap and is left out."""
from pbench import stats


def read(run):
    end, vals = run.window.end, []
    for r, st in run.counted():
        if st["first"] is None:
            continue
        if st["done"]:
            if st["n"] > 1:
                vals.append((st["last"] - st["first"]) / (st["n"] - 1))
        else:
            vals.append((end - st["first"]) / st["n"])
    v = stats.pct(vals, 90)
    return None if v is None else v * 1e3
