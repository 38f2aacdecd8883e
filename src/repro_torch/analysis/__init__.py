"""Static analysis, model checking and runtime sanitizers of the port
(the port of ``repro.analysis``).

Three halves:

* ``repro_torch.analysis.lint`` (+ ``repro_torch.analysis.dataflow``) —
  stdlib-``ast`` rules R001–R008 over ``src/repro_torch`` and ``tests``
  (``python -m repro_torch.analysis lint``); R002 holds the code a CUDA
  graph captures. Pure stdlib: runnable without PyTorch.
* ``repro_torch.analysis.modelcheck`` — explicit-state model checker for
  the request-lifecycle / page-pool / chunked-prefill protocols
  (``python -m repro_torch.analysis check``), with a mutation harness
  that proves the checker catches planted protocol bugs, each replayed
  through the port's real code.
* ``repro_torch.analysis.sanitizers`` — opt-in runtime audits gated on
  ``REPRO_SANITIZE=1``: page leak/double-free/use-after-free tracking,
  request state-machine audits, decode-graph recapture counters,
  migration-wire alignment.

This package root imports nothing heavy; symbols load lazily.
"""
from __future__ import annotations

_SANITIZER_SYMBOLS = (
    "SanitizerError", "sanitize_enabled", "make_sanitized_pool",
    "audit_paged_engine", "TransitionAuditor", "RetraceMonitor",
    "check_wire_alignment", "GatewaySanitizer",
)

_MODELCHECK_SYMBOLS = (
    "explore", "run_check", "run_mutations", "replay_trace",
    "check_table_drift", "Violation", "CheckResult", "MutationResult",
    "LifecycleModel", "PoolModel", "ChunkModel", "MUTATIONS",
)

__all__ = ("lint_sources", "run_lint", "Finding", "RULES",
           ) + _SANITIZER_SYMBOLS + _MODELCHECK_SYMBOLS


def __getattr__(name):
    if name in ("lint_sources", "run_lint", "Finding", "RULES",
                "collect_files"):
        from repro_torch.analysis import lint as _lint
        return getattr(_lint, name)
    if name in _SANITIZER_SYMBOLS:
        from repro_torch.analysis import sanitizers as _san
        return getattr(_san, name)
    if name in _MODELCHECK_SYMBOLS:
        from repro_torch.analysis import modelcheck as _mc
        return getattr(_mc, name)
    raise AttributeError(name)
