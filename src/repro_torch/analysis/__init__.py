"""Runtime checks of the port (``sanitizers``); the reference's
static analyses (lint, model checker, dataflow) read JAX source and
are not ported."""
