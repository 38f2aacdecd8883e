"""ttft_p90_s: the 90th percentile of time to first token over every request
due in the window, from its due time (host clock). A request with no first
token when the window closes counts with the time it has waited, so it
misses any limit its wait has passed; a failed one waits to the close."""
from pbench import stats


def read(run):
    end = run.window.end
    vals = [(st["first"] if st["first"] is not None else end) - r.due
            for r, st in run.counted()]
    return stats.pct(vals, 90)
