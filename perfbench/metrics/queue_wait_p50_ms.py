"""queue_wait_p50_ms (gateway): median over the window's requests of the
time from the due time to the request's first leaving of QUEUED
(``RequestHandle.history``), or to the window's close for one still
queued then."""
from pbench import stats


def read(run):
    end = run.window.end
    vals = [((st["left_queue"] if st["left_queue"] is not None else end)
             - r.due) * 1e3 for r, st in run.counted()]
    return stats.pct(vals, 50)
