"""PyTorch/CUDA port of the JAX package ``repro``: the generation path
(prefill + decode through ``launch.serve.BatchServer``) on hand-written
Hopper attention kernels.  Imports nothing of JAX or of ``repro``."""
