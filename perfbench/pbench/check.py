"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the program finished
is drawn from the run's seed, the one with the most served tokens always
in it, until it holds ``check_tokens`` served tokens. For each, the plain
reference (``reference/<config>.py``, float32) runs once over the prompt
and the served tokens and gives the logits at every served position
(its ``logits_many``: independent rows, several a forward). A
served token's gap is how far its reference logit lies below the
reference's best at that position, in units of the position's logit
standard deviation (so that a limit reads the same at every width): 0
where the greedy token is the reference's choice. Rounding moves a token
only where the reference's top two lie within rounding of each other, so a
sound program's gaps stay small; a wrong token, cache entry or state shows
as gaps of a few standard deviations.

Read over the sample: ``max_gap``, the widest gap; ``mean_gap``, the mean
over every served token; ``mismatch_share``, the share of served tokens
that are not the reference's choice. The configuration file names which
of them are compared, each with its limit (``correct``).

The control (``control=True``) puts the reference itself, in the next
precision below the configuration's (``plain.Prec(fp8=True)``), in the
program's place: at each of the same positions it reads the gap of the
token that the lower precision puts first, and the same three numbers of
those gaps.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# positions a forward of the reference takes at most (padded rows counted)
BATCH_TOKENS = 8192


def sample(done: List[dict], seed: int, want_tokens: int,
           want_requests: int = 1) -> List[dict]:
    """Finished requests to check: the longest, then others drawn from
    ``seed`` until ``want_tokens`` served tokens and ``want_requests``
    requests are in."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % 2 ** 63, 17])
    order = sorted(done, key=lambda r: (-len(r["tokens"]), r["rid"]))
    picked, rest = [order[0]], order[1:]
    got = len(order[0]["tokens"])
    for i in rng.permutation(len(rest)):
        if got >= want_tokens and len(picked) >= want_requests:
            break
        picked.append(rest[int(i)])
        got += len(rest[int(i)]["tokens"])
    return picked


def gaps_of(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """Per position: (reference best - reference logit of ``tokens``) / the
    position's logit standard deviation."""
    t = torch.as_tensor(tokens, dtype=torch.long, device=ref_logits.device)
    best = ref_logits.max(-1).values
    got = ref_logits.gather(1, t[:, None])[:, 0]
    return (best - got) / ref_logits.std(-1)


def request_row(r: dict, prompts: Dict[int, np.ndarray]):
    """The reference's input for request ``r``: its prompt followed by its
    served tokens but the last, with the prompt's length and the number
    of positions to read."""
    p = prompts[r["rid"]]
    return (np.concatenate([p, np.asarray(r["tokens"][:-1], np.int64)]),
            len(p), len(r["tokens"]))


def summarize(gaps: torch.Tensor, prefix: str = "") -> Dict[str, float]:
    return {prefix + "max_gap": float(gaps.max()),
            prefix + "mean_gap": float(gaps.mean()),
            prefix + "mismatch_share": float((gaps > 0).float().mean())}


def _reference(ref_mod, m, params, picked, prompts, fp8):
    """The reference's logits at every served position of each request of
    ``picked``, several requests a forward (``logits_many``), up to
    :data:`BATCH_TOKENS` positions."""
    items = [request_row(r, prompts) for r in picked]
    out, batch = [], []
    for it in items + [None]:
        if it is not None and (not batch or (len(batch) + 1) * max(
                len(s) for s, _, _ in batch + [it]) <= BATCH_TOKENS):
            batch.append(it)
            continue
        if batch:
            out.extend(ref_mod.logits_many(m, params, batch, fp8=fp8))
        batch = [it] if it is not None else []
    return out


def compare(ref_mod, m: dict, params, picked: List[dict], prompts, *,
            control: bool = False, log=None) -> Dict[str, float]:
    """The program's served tokens over ``picked`` against the reference;
    with ``control`` the control's too, at the same positions."""
    all_g, all_c = [], []
    refs = _reference(ref_mod, m, params, picked, prompts, False)
    lows = _reference(ref_mod, m, params, picked, prompts, True) \
        if control else [None] * len(picked)
    for r, ref, low in zip(picked, refs, lows):
        k = len(r["tokens"])
        g = gaps_of(ref, r["tokens"])
        all_g.append(g)
        line = (f"rid {r['rid']}: prompt {len(prompts[r['rid']])}, {k} "
                f"served; first gap {float(g[0]):.4f}, widest {float(g.max()):.4f} at "
                f"{int(g.argmax())}, mean {float(g.mean()):.4f}")
        if low is not None:
            gc_ = gaps_of(ref, low.argmax(-1))
            all_c.append(gc_)
            line += (f"; control widest {float(gc_.max()):.4f}, mean "
                     f"{float(gc_.mean()):.4f}")
        if log is not None:
            log(line)
    del refs, lows
    out = {"tokens_checked": sum(len(r["tokens"]) for r in picked),
           "requests_checked": len(picked)}
    if all_g:
        out.update(summarize(torch.cat(all_g)))
    if all_c:
        out.update(summarize(torch.cat(all_c), "control_"))
    return out
