"""kv_pages_peak_pct (wire + pages): the most pages the resident requests
held reserved at any decode call of the window (``page_stats()``'s
``reserved_tokens``: prompt plus output budget a request), as a share of
the pool's pages. Pages the prefix index keeps for reuse are not in it.
Nothing to read on a dense decode cache."""


def read(run):
    got = [c.reserved_pages for c in run.window_calls("decode")
           if c.reserved_pages is not None]
    if not got or not run.pages:
        return None
    return 100.0 * max(got) / run.pages
