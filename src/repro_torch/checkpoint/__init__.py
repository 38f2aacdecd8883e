"""Checkpoints in the reference's layout (``repro.checkpoint``)."""
from repro_torch.checkpoint.sharded import (AsyncCheckpointer,  # noqa: F401
                                            latest_step, load_checkpoint,
                                            save_checkpoint)
