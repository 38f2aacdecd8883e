"""Hardware constants of the paper's GPUs (the scheduler's inputs)."""
