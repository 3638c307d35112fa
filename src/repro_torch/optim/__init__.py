"""Optimizers: AdamW with an fp32 master copy and global-norm clipping."""
