import os
import sys

# NOTE: deliberately NO XLA_FLAGS here — tests must see the real (1-device)
# CPU topology; only launch/dryrun.py forces 512 host devices.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def admit_one(eng, req, token, *, wire=None, pages=None, source=None,
              backend="auto"):
    """Admit a single request through the unified ``admit(AdmissionBatch)``
    entry point; True when it was placed (the rejected tail is empty)."""
    from repro.serving.engine import (ADMIT_FRESH, AdmissionBatch,
                                      AdmissionItem)
    item = AdmissionItem(req, token, source or ADMIT_FRESH, wire=wire,
                         pages=pages)
    return not eng.admit(AdmissionBatch([item]), backend=backend)


def admit_many(eng, triples, *, backend="auto"):
    """Admit ``(req, wire, first_token)`` triples (a prefill result list)
    as one FIFO batch; returns the rejected tail ``AdmissionBatch``."""
    from repro.serving.engine import AdmissionBatch, AdmissionItem
    return eng.admit(AdmissionBatch(
        [AdmissionItem(r, f, wire=w) for r, w, f in triples]),
        backend=backend)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped (by a fixture) without "
        "one")


def jax_block(cfg):
    """``cfg`` with the block options at the JAX package's behaviour. The
    port's jamba runs the published block (unit-gain RMSNorms of dt, B and
    C; the top-k gates as the softmax gives them; dropless routing at a
    capacity factor of E / k), which the JAX package does not (ROADMAP
    C.4): tests that hold the port to it set these back. A no-op for the
    other configs, whose options are the defaults."""
    return cfg.replace(mamba_inner_norms=False, moe_renormalize=True,
                       moe_capacity_factor=1.25)
