"""Batch layouts: the packed (cu_seqlens) cohorts of packed training."""
