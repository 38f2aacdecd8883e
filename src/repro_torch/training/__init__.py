"""Training substrate of the port (``repro.training``): the packed
synthetic data pipeline and AdamW."""
