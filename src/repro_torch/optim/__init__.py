"""AdamW with fp32 moments, global-norm clipping and LR schedules."""
