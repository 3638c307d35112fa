#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc (one nvcc per source, started together);
  2. hold each kernel against its plain PyTorch version on the card at this
     slice's shapes (bf16; grouped_ffn and flash_mha_varlen also in fp32,
     flash_mha_varlen also windowed, on equal segments against flash_mha,
     under a perturbation of another sequence, and its gradient; a decode
     kernel (no backward) refusing an input that requires grad;
     flash_mha and flash_decode also at recurrentgemma-9b's D = 256 and
     llama-7b's D = 128, flash_mha at gemma3-1b's prefill (D 256, window
     512 at S 1,000 and 2,048), flash_decode on its 512-slot ring,
     paged_flash_decode at qwen3-1.7b's, gemma3-1b's and qwen2.5-14b's
     heads (D 128 G 2, D 256 G 4, D 128 G 5),
     ssd_scan at mamba2-1.3b's widths, rglru_scan at recurrentgemma-9b's in
     fp32 (4 x 512, 1 x 256, a ragged shape) and bf16; paged_flash_decode
     also bit for bit against flash_decode on the gathered cache in bf16
     and fp32; flash_mha also at the speculative verify's shape, alone and
     behind the table gather) and time kernel (inputs warm in L2 as
     ``ms``, L2 flushed before each call as ``cold_ms``), plain version,
     bound and one PyTorch library call where one computes the same
     function (every kernel and library call from CUDA-graph replays: the
     wrappers' host work outlasts most kernels, so a loop of eager calls,
     kept as ``eager_ms``, reads the host; ssd_scan and rglru_scan also at
     a 1-row admission, rglru_scan in bf16 too and beside ``copy_ms``, one
     torch.mul of its bytes); print the registers, spill bytes, shared
     memory and blocks per SM of the tensor-core bodies (the prefill
     attention tile body csrc/attn_tile.cuh, the split-KV body
     csrc/decode_split.cuh of flash_decode and paged_flash_decode,
     grouped_ffn's two wgmma launches, ssd_scan's bf16 body at each P
     split) and of rglru_scan's chunk body at its chunks, the decode
     kernels' splits, ssd_scan's P splits and rglru_scan's chunk, grid and
     windows at the main path's shapes; grouped_ffn's rows are also held
     bit-exact between an 8192-row and a 64-row cohort, and timed over N
     beside torch._grouped_mm;
  3. full-width qwen2-0.5b and granite-moe-1b-a400m (24 layers each), then
     mamba2-1.3b (48 SSD layers) and recurrentgemma-9b (26 RG-LRU and 12
     local-attention layers), all at full depth, bf16, seeded random
     weights (the recurrent mixers' constant init leaves drawn at random):
     prefill last-position logits and 8
     teacher-forced decode steps under impl="cuda" against
     impl="reference" (for granite also the share of (token, layer) pairs
     whose top-k expert set agrees); then the same prompts admitted through
     ``paged_insert`` into a shuffled block table and 8 teacher-forced paged
     decode steps against the dense decode;
  4. ``BatchServer.serve`` on qwen2-0.5b: 8 ragged requests (prompts 16-400
     tokens), 64 new tokens, greedy then sampled, with the kernels' launch
     counts held to what the shapes predict;
  5. ``ContinuousBatchServer.serve``: 16 ragged requests (prompts 16-400
     tokens, 8-64 new tokens each), 8 slots, blocks of 16, greedy, sampled,
     then (qwen2-0.5b only) greedy on a pool too small for all rows
     (preemption), with the launch counts held to the prediction; then the
     bucketed server on the same traffic, its launches held too; qwen2-0.5b
     first, then granite-moe-1b-a400m, mamba2-1.3b and recurrentgemma-9b
     (one ssd_scan per SSM layer and one rglru_scan per RG-LRU layer per
     prefill, one flash_decode per local-attention layer per decode step);
  6. packed PPO training of full-width qwen2-0.5b: actor and reference, critic
     and reward models, two iterations of the executors (16 prompts of 128
     tokens, 256 new, each row's gen_mask cut at a seeded length, reference,
     critic and reward inference, then the packed actor and critic train
     steps with AdamW over 2 minibatches); on the first, the first
     minibatch's losses, grad norms, clip_frac and per-leaf gradients under
     impl="cuda" against impl="reference" (also in fp32 on 2 layers); the
     parameters finite and changed after each step, flash_mha_varlen's
     launches held to the prediction, no other kernel launched by the train
     steps;
  7. padded PPO training, and the training of every served model: two
     padded iterations of full qwen2-0.5b on phase 6's traffic (flash_mha
     under grad; the same checks, and in fp32 on 2 layers the packed step
     against the padded one on one rollout); then, on 8 prompts of 128
     tokens and 128 new, granite-moe-1b-a400m (12 of 24 layers) one packed
     and one padded iteration (grouped_ffn under grad), mamba2-1.3b (24 of
     48 layers, ssd_scan under grad) and recurrentgemma-9b (5 of 38 layers, rglru_scan
     and flash_mha under grad) one padded iteration each; their bf16
     comparisons of the tiers printed, their fp32 2-layer ones held (where
     an MoE route parts between the runs, its near-tie held instead); each
     iteration's train launches held to the prediction; peak memory.
  8. the paper's runtime on the card: ``profile_model`` of qwen2-0.5b
     into a ``ProfileStore``; an ``RLHFExperiment`` of full qwen2-0.5b as
     actor and critic on ``Cluster(1, 1, chip=hw.H100)`` and phase 7's
     padded traffic, calibrated from that store, its plan searched (MCMC,
     300 iterations); one ``run_iteration`` through ``RuntimeEngine``
     against two hand-driven iterations of phase 7's loop on the same
     prompts and weights (rollout and inference outputs bit for bit, train
     stats within a limit set from the two hand runs' spread); each call's
     measured seconds beside the cost model's estimate, analytic, profiled
     and recalibrated from the records (read against a second
     iteration); ``run(steps=2)`` at pipeline depth 2 against depth 1
     (iteration 1 bit for bit, iteration 2's difference printed); launches
     per iteration held to the prediction; ``engine.stats()``; peak memory.
  9. speculative decoding: full qwen2-0.5b (24 layers, bf16) with a
     2-layer draft made of its own embedding and first two layers, on 16
     prompts of 128 tokens and 256 new: ``spec_generate`` with the adaptive
     controller, greedy then sampled (temperature 0.8, top-k 16), beside
     plain ``generate`` (accept rate, tokens per verify, the k trace,
     seconds; flash_mha's verify and paged_flash_decode's draft launches
     held to the cycles' prediction); the greedy rows that part from
     ``generate`` held to a near-tie (``SPEC_TIE_TOL``), greedy and
     sampled logprobs to a teacher-forced forward and greedy ones to
     ``generate``'s where the rows agree (``SPEC_LOGPROB_TOL``); the paged
     and ragged verify layers cuda vs reference; the speculative
     ``ContinuousBatchServer`` against the plain one on phase 5's traffic
     (near-ties and logprobs held the same way);
     the same rollout in fp32 on 2 layers, greedy tokens bit for bit
     (``FP32_LOGIT_TOL`` on logprobs); granite-moe-1b-a400m with a 2-layer
     draft, greedy (grouped_ffn in the verify); two ``run_iteration``s of an
     ``RLHFExperiment`` with the 2-layer draft through ``RuntimeEngine``
     (spec_stats, the cost model's accept rate, the draft's parameters bit
     for bit after, finite losses, launches, peak memory).
 10. physical parameter reallocation and the paper's llama-7b: (a)
     llama-7b at full width (32 layers, d_model 4096, 32/8 heads of 128,
     d_ff 14336, vocabulary 128,256, untied; 8.03B parameters, 16.06 GB in
     bf16, drawn on the card): phase 3's cuda vs reference logits and paged
     decode, one greedy ``BatchServer.serve`` of phase 4's 8 requests, 64
     new tokens each, launches held to the prediction; (b) its tree laid
     out on 4 logical devices (``parallel/layout.py``; on one card all four
     map to it, each block its own buffer) and moved by
     ``parallel/realloc_exec.py``: a clone and then donating moves from the
     generation layout (tp 4) to the training layout (fsdp 2 x tp 2), back,
     onto devices {0, 1} and across to {2, 3}; every leaf bit-equal after
     ``gather()``, the replicated norms aliased by identity, each move's
     split equal to the JAX executor's on the same spec trees
     (``LLAMA_MOVE_COUNTS``), the donating move's peak memory below the
     clone's, seconds beside the copy bound and the cost model's schedule
     time; (c) ``RuntimeEngine`` with ``sharding_for`` and
     ``opt_sharding_for``: ``test_realloc_fastpath.py``'s prefetch-hit toy
     on llama-7b's tree and ``benchmarks/pipeline_bench.py``'s toy with
     llama-7b as the actor and qwen2-0.5b's value model and AdamW state as
     the critic, at depth 1 and 2, held to the same toys run logically.
 11. compute on sharded layouts, on 4 logical devices of the card (each
     rank's block its own buffer, collectives real copies and sums between
     them, their bytes counted): (b) llama-7b at phase 10's generation
     layout (TP 4): a sharded prefill of 4 x 256 tokens and 8 sharded
     decode steps against the single-device ones (logits at LOGIT_TOL,
     greedy agreement and the gathered caches printed, flash_mha and
     flash_decode launches held to 4 ranks x 32 layers per call); (a)
     full qwen2-0.5b, one sharded train step on (data 2, model 2) with
     FSDP and TP on phase 6's traffic against the single-device step
     (loss, grad_norm and first moment at TRAIN_TOL, each leaf at
     TRAIN_LEAF_TOL; in fp32 on 2 layers at FP32_GRAD_TOL; every replica
     bit-equal; launches held); (c) granite-moe-1b-a400m's forward with
     its experts over 2 ranks against the single-device forward (LOGIT_TOL,
     route agreement printed, the ranks' replicated routers alike); (d)
     qwen's 24 layers in 4 GPipe stages on 8 microbatches, bit-equal to
     the unpipelined stack; (e) ``compressed_psum`` of 4 ranks' qwen
     gradient trees over 3 steps, each step's error held to its
     quantization bound; each part's seconds, peak memory and bytes.
 12. the dense decoder configs and the paper's other algorithms (§8.3), at
     full width, bf16, seeded weights with biases and norm scales drawn:
     (a) qwen3-1.7b (28 layers, qk-norm, tied 151,936 vocabulary) and
     gemma3-1b (26 layers, 5 local of window 512 to 1 global, D 256, q_dim
     1,024 of d_model 1,152, tied 262,144 vocabulary): phase 3's checks
     (gemma3 on 600-token prompts, past its window), the same in fp32 on 4
     layers, each attention kind's layer against a plain transcription of
     the published layer (qk-norm before RoPE), phases 4 and 5 on each
     config's first quarter of layers (gemma3's prompts 16-1,000 tokens;
     where the engines' greedy outputs part, a near-tie); (c) three DPO
     steps of qwen3-1.7b (8 pairs of 512, the
     step-0 gradient cuda vs reference in bf16 and on 2 layers in fp32) and
     of gemma3-1b (4 pairs of 1,024), the reference a frozen copy: step 0's
     loss ln 2, dpo_acc 0, the loss falling; (d) a GRPO step of qwen3-1.7b
     on 4 prompts x 8 sampled rows of 128 + 128 tokens, rewards from a
     qwen2-0.5b value-head trunk, each group's advantages of mean 0 and
     population std 1; (e) a ReMax step on 16 prompts, a sampled and a
     greedy rollout; each step's gradient cuda vs reference; then (a)
     qwen2.5-14b (48 layers, 14.7B parameters) last, alone on the card.
     Launches held to the prediction throughout.
 13. the encoder-decoder and prefix-embedding paths, bf16, seeded weights
     with norm scales drawn: (a) seamless-m4t-medium at full width and
     depth (12 encoder and 12 decoder layers with cross-attention, 16
     heads of 64, 512 frames, untied 256,206 vocabulary): forward,
     prefill and 8 teacher-forced decode steps cuda vs reference on 4 x
     128 tokens, the logits moved by the frames, greedy ``generate`` and
     ``BucketedGenerator`` on 8 requests of 32-200 tokens (64 new each;
     equal tokens where the bucket pads nothing), 3 ``make_train_step``
     steps on 4 x 256 tokens, the fp32 2-layer gradient cuda vs reference
     at FP32_GRAD_TOL; (b) internvl2-76b at full width on 8 of its 80
     layers (64 / 8 heads of 128, a 256-embedding prefix over 512
     positions): the tiers, the logits moved by the prefix and unmoved by
     the token ids under it, greedy ``generate`` of 32 tokens, one bf16
     ``lm_loss`` with its backward whose loss keeps its bits when the
     labels under the prefix change.  Phase 2 runs ``flash_mha`` at their
     shapes (non-causal at Sq != Skv, Sq 1 in decode; causal D 128 G 8)
     and ``flash_decode`` at D 64 G 1 and D 128 G 8.
 14. Snowflake Arctic's MoE: arctic-480b at full width on 2 of its 35
     layers (128 experts top-2 of d_ff 4,864 beside a dense residual MLP of
     d_ff 4,864, 56 / 8 heads of 128, untied 32,000 vocabulary; 27.2 GB a
     layer), bf16, seeded weights with norm scales drawn: (a) layer 0's FFN
     under both dispatches against a plain fp32 transcription, phase 3's
     tiers with the route agreement and the paged decode bit-equal to the
     dense one, peak memory; (b) phases 4 and 5, greedy, launches held;
     (c) the capacity dispatch: the share of the prefill's assignments it
     drops at 4 x 256 tokens, cuda vs reference, and equal to the
     dropless dispatch on 4-token cohorts (within the capacity floor);
     grouped_ffn on layer 0's weights at N 2,048 and N 16 against the
     plain version, timed beside its bound and torch._grouped_mm; then on
     layer 0 alone (d) one bf16 ``lm_loss`` with its backward cuda vs
     reference, the gradients waiting on the host between the tiers, and
     (e) the 128 experts over 4 ranks (32 each) and the dense residual
     over its d_ff against the single-device forward.  Phase 2 runs the
     attention kernels at its heads (D 128 G 7).
 15. sharded compute of the recurrent mixers and of the capacity dispatch,
     on 4 logical devices of the card, bf16 and fp32: (a) mamba2-1.3b (SSD
     split by head: the ``in_proj`` product gathered over the model axis,
     the norm's sum of squares all-reduced) trained one step on 8 layers
     on (data 2, model 2) against one device (TRAIN_TOL, TRAIN_LEAF_TOL;
     replicas bit-equal), the trained tree moved to (1, 4) by
     ``prefetch_reshard`` and served there at full depth behind the
     trained layers: a prefill of 4 x 256 tokens and 8 decode steps
     against one device (LOGIT_TOL), then the same on 2 fp32 layers
     (FP32_GRAD_TOL, FP32_LOGIT_TOL); (b) recurrentgemma-9b (RG-LRU split
     by channel, its one KV head on every rank for a quarter of each
     local-attention cache's slots, the ranks' decode partials merged by
     log-sum-exp) the same
     on 5 of 38 layers and 3 fp32 ones, served at the trained depth; (c)
     arctic-480b's capacity dispatch on 1 layer on (2, 2) with FSDP off:
     the single-device forward first, its tree placed leaf by leaf after,
     the kept experts equal before the first route parting and every
     parting a near-tie (BF16_ROUTE_TIE_TOL); each part's seconds beside
     one device's, its collectives' bytes held to a prediction from the
     shapes, peak memory, launches held.
 16. sharded compute of the encoder-decoder and prefix configs, on 4
     logical devices of the card: (a) seamless-m4t-medium (its encoder
     non-causal per rank, each decoder layer's cross-attention split by
     head, the "xkv" cache by KV head) trained one step at full width and
     depth on (data 2, model 2) on 4 x 256 tokens over 512 frames against
     one device (TRAIN_TOL, TRAIN_LEAF_TOL; replicas bit-equal), moved to
     (1, 4) by ``prefetch_reshard`` and served there, 4 x 128 tokens and 8
     decode steps against one device (LOGIT_TOL), then the same on 2 + 2
     fp32 layers (FP32_GRAD_TOL, FP32_LOGIT_TOL, the gathered caches too);
     (b) internvl2-76b on 8 of 80 layers served on (1, 4), 2 x 512
     positions whose first 256 are patch embeddings spliced after the
     vocabulary-parallel sum, and its loss with the backward on 2 layers
     on (2, 2) against one device (TRAIN_TOL, TRAIN_LEAF_TOL), the loss's
     bits kept under a changed prefix; seconds, bytes against their
     prediction, peak memory, launches held as in phase 15.
 17. a tensor axis that splits query heads, ZeRO-1, and the dry run held
     to the card, on logical devices of the card: (a) qwen2-0.5b at full
     width and depth on (1, 4) (14 query heads over 4 ranks: every rank
     gathers wq, wk, wv, computes every head and takes its 224 columns
     into its wo rows) served (4 x 256 tokens, 8 decode steps; LOGIT_TOL,
     bytes and launches to their prediction) and trained one step
     against one device (TRAIN_TOL, TRAIN_LEAF_TOL; 2 fp32 layers to
     FP32_GRAD_TOL), gemma3-1b on (1, 8) (4 query heads over 8 ranks)
     served past its 512-slot rings (600-token prompts); (b) qwen2-0.5b's
     step with the AdamW state ZeRO-1 over the pod axis of (pod 2, data
     1, model 2) bit-equal to the same step with the state on the
     parameters' layouts, replicas bit-equal; (c) the dry run
     (``launch/dryrun.py``) of qwen2-0.5b's train step on 2 layers on (2,
     2) on ``meta``, then the same step on the card: the collectives
     recorded (kind, payload, group, count) equal, the argument bytes equal
     the placed blocks' bytes, the reckoned peak x 4 beside the card's
     ``max_memory_allocated`` rise within DRY_PEAK_BAND; the same for
     gemma3-1b's 2 layers on (1, 4) at 2 x 4,096 tokens, where the LM head
     runs in chunks; then one production cell through the dry run's CLI
     (qwen2-0.5b decode_32k on the 256-card mesh).
 18. decode caches split by slot (where the tensor axis does not divide
     the KV heads, every rank holds every KV head for a ceil-sized block of
     each cache's slots, attends it with flash_decode(return_lse=True) and
     the ranks merge by log-sum-exp; phases 15b, 16b and 17a run the same
     layout): (a) the lse variant against its plain version at phase 2's
     decode shapes in bf16 (KERNEL_TOL) and fp32 (LSE_FP32_TOL), a row of
     length 0 coming back 0 with lse -inf, its rows rounded to the input
     dtype equal to the no-lse output bit for bit, and flash_decode and
     paged_flash_decode without lse held to their digests from before the
     lse variant (DECODE_DIGESTS), the variant timed beside its bound and
     SDPA; (b) internvl2-76b at full width on 2 of 80 layers on (1, 16):
     2 x 636 positions in a cache of 1,024 slots (64 a rank; ranks 10-15
     hold no valid slot after the prefill) and 8 decode steps crossing into
     rank 10's block, bf16 (LOGIT_TOL) and fp32 (SPLIT_FP32_TOL); (c)
     gemma3-1b on (1, 8), all 26 layers, 4 x 600 tokens and 8 steps (each
     512-slot ring 64 a rank, the global layers' 608 slots 76 a rank), and
     one local and one global layer in fp32; bytes, launches and each
     rank's k/v bytes to their predictions from the shapes, the cache bytes
     on the card printed beside the replicated layout's.
 19. packed training on sharded layouts: a cohort of 16 sequences of
     64-384 tokens (``PromptDataset.packed_batch_at``, bucketed to a
     multiple of 64 with phantoms) dealt to the batch replicas as runs of
     whole sequences (``packing.split_packed``), one packed
     ``make_train_step`` on the mesh against the single-device packed step
     from the same weights: (a) qwen2-0.5b at full width and depth in bf16
     (TRAIN_TOL, TRAIN_LEAF_TOL) and on 2 fp32 layers (FP32_GRAD_TOL) on
     (data 2, model 2) and on (1, 4), where its 14 query heads split; (b)
     granite-moe-1b-a400m the same on (1, 4), 8 of its 32 experts a rank
     (dropless: grouped_ffn on each rank's experts), the routes against one
     device's printed (an fp32 parting held to ROUTE_TIE_TOL in place of
     the gradients); replicas bit-equal, flash_mha_varlen and grouped_ffn
     launches to the prediction (ranks x layers x 2 with remat).
 20. the JAX train step's chunked LM head (``layers.chunked_lm_head_loss``:
     from 4,096 positions on, the head and the cross-entropy in
     checkpointed chunks of 512): (a) gemma3-1b at full width and depth
     (26 layers, tied 262,144 vocabulary), bf16, one ``make_train_step``
     of 4 x 4,096 tokens with remat against the same step with the head
     taken whole (``forward``, ``logits_of``, ``cross_entropy``; where that
     does not fit on the card, both at the largest batch where it does):
     loss, grad_norm and first moment within TRAIN_TOL, each leaf within
     TRAIN_LEAF_TOL, then on one local and one global layer in fp32
     within FP32_GRAD_TOL; (b) each step's peak memory beside its
     reckoning from the shapes, the chunked step's below the whole head's;
     (c) the same step on (1, 4) on 2 layers at 2 x 4,096 against one
     device, bf16 and fp32, the loss's collective bytes and all-reduce
     calls (each chunk's recomputed in the backward) equal to the
     prediction; (d) each step's seconds; (e) flash_mha at the step's
     shapes (B 4, S 4,096, 4 query heads on 1 KV head, D 256), causal and
     with the window of 512, against its plain version, timed beside its
     bound and SDPA, both in the kernel line.
Each model's parameters are freed before the next is built.
Then one JSON line of kernel numbers, and last {"ok": true, "device": ...}.

Phases 3 to 20 are functions of (config, params or experiment, impl) so the
CPU tests rehearse them at the reduced size with impl="reference".
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import hw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN, LRU, SSM  # noqa: E402
from repro_torch.core import profiler as PROF  # noqa: E402
from repro_torch.core import simulator as SIM  # noqa: E402
from repro_torch.core import dfg as DFG  # noqa: E402
from repro_torch.core import realloc as REALLOC  # noqa: E402
from repro_torch.core import runtime as RT  # noqa: E402
from repro_torch.core.estimator import CostModel  # noqa: E402
from repro_torch.core.plan import (Assignment, Cluster, DeviceMesh, ExecutionPlan,  # noqa: E402
                                   ParallelStrategy)
from repro_torch.kernels import (build, decode_attention, flash_attention,  # noqa: E402
                                 grouped_expert, paged_decode_attention, ref, varlen_attention)
from repro_torch.kernels import ops as OPS  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_scan_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_scan_mod  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode  # noqa: E402
from repro_torch.kernels.flash_attention import flash_mha  # noqa: E402
from repro_torch.kernels.grouped_expert import grouped_ffn  # noqa: E402
from repro_torch.kernels.paged_decode_attention import paged_flash_decode  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.varlen_attention import flash_mha_varlen  # noqa: E402
from repro_torch.launch.serve import (BatchServer, ContinuousBatchServer,  # noqa: E402
                                      bucket_of)
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import paged_cache as PC  # noqa: E402
from repro_torch.models import spec as SPEC  # noqa: E402
from repro_torch.data import packing  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import grad as GRAD  # noqa: E402
from repro_torch.parallel import collectives as COLL  # noqa: E402
from repro_torch.parallel import ctx as CTX  # noqa: E402
from repro_torch.parallel import pipeline as PIPE  # noqa: E402
from repro_torch.parallel import realloc_exec as RX  # noqa: E402
from repro_torch.parallel import sharding as SHD  # noqa: E402
from repro_torch.parallel import steps as PSTEPS  # noqa: E402
from repro_torch.parallel.layout import (Layout, Mesh, ShardedTensor, axes_of,  # noqa: E402
                                         place_tree, tree_at, tree_leaves, tree_map,
                                         tree_map_with_path)
from repro_torch.data.synth import PreferenceDataset, PromptDataset  # noqa: E402
from repro_torch.rlhf import dpo as DPO  # noqa: E402
from repro_torch.rlhf import experiment as EXP  # noqa: E402
from repro_torch.rlhf import grpo as GRPO  # noqa: E402
from repro_torch.rlhf import ppo as PPO  # noqa: E402
from repro_torch.rlhf import remax as REMAX  # noqa: E402
from repro_torch.rlhf import reward as RWD  # noqa: E402

# Published H100 SXM peaks: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version, bf16 inputs, |err| <= KERNEL_TOL * (1 + |plain|):
# the plain version rounds the scores and probabilities to bf16 before its
# second product (as the JAX reference does), the decode kernels keep
# scores in fp32 and probabilities to ~2^-17 (fp32, or two bf16 terms), the
# prefill kernels keep scores in fp32 and round their unnormalised
# probabilities; 2e-2 is the JAX package's own bf16 tolerance for its
# kernels.
KERNEL_TOL = 2e-2
# grouped_ffn vs its plain version: both take fp32 products of the same
# values and differ in summation order (and, in bf16, in the kernel's
# intermediate H carried as two bf16 terms, ~2^-17 of |H|), so bf16 inputs
# are held to GROUPED_TOL (between the H100's reading, <= 1.1e-5 scaled, and
# the ~1e-3 that an intermediate rounded to bf16 once would cost) and fp32
# ones to FP32_TOL.
GROUPED_TOL = 1e-4
FP32_TOL = 1e-5
# ssd_scan vs its plain version run in fp32 on the same values: the fp32
# products are the same, summed in another order over other spans (the
# fp32 kernel's 64-row pieces against the plain version's 128-row chunks;
# the bf16 body's 128-row pieces take M, the state and X w as two bf16
# terms, ~2^-17 of each).
# FP32_SCAN_TOL lies between the H100's reading (5.7e-6 scaled) and that of
# the plain version with a bf16 state or a bf16 x * dt (1.1e-2, 2.0e-2;
# scripts/limit_controls.py, PERF.md).
FP32_SCAN_TOL = 1e-4
# In bf16 the kernel also rounds y once: bf16's unit roundoff 2^-8 of |y|
# more (H100: 3.4e-3; a bf16 state 1.2e-2).
SSD_BF16_TOL = 2.0 ** -8 + FP32_SCAN_TOL
# rglru_scan vs its plain version in fp32 (the model's gates are fp32):
# both carry fp32 and differ only in the scan's association order
# (FP32_TOL).  In bf16 the kernel also rounds h once: bf16's unit roundoff
# 2^-8 of |h| more.
RGLRU_BF16_TOL = 2.0 ** -8 + FP32_TOL
# Where greedy continuous and bucketed outputs of a model with recurrent
# mixers part, the larger of both tokens' distances below the top logit,
# over the top |logit|: between the H100's largest sound reading (1.5e-2)
# and the largest with the last recurrent layer of each admitted slot fed
# the next slot's state (4.9e-2 mamba2, 6.8e-2 recurrentgemma; > 1 with
# every layer so fed; scripts/limit_controls.py, PERF.md).  Phase 12
# holds its dense configs' partings to it too (``report_continuous``).
RECURRENT_TIE_TOL = 3e-2
# Full model, impl="cuda" vs impl="reference": max |logit difference| over
# max |reference logit|.  Both run bf16 through every layer and differ only
# in where attention rounds to bf16, in the order of the expert FFN's fp32
# sums (MoE) and of the scans' fp32 sums (SSD, RG-LRU).
LOGIT_TOL = 5e-2
# The same comparison in fp32 at full width and a few layers, for the models
# with recurrent mixers: both tiers then round nowhere to bf16, so what is
# left is summation order (the kernels' fp32 FMAs against cuBLAS and the
# plain versions), ~1e-6 of the largest logit; 1e-4 leaves room for the
# SSD's chunked decays (see FP32_SCAN_TOL).
FP32_LOGIT_TOL = 1e-4
# Packed PPO train step, first minibatch, impl="cuda" vs impl="reference" at
# full depth in bf16: the loss (over the mean |advantage| for the actor,
# whose loss is a sum of ratio * advantage terms near zero; over the loss
# for the critic), grad_norm and the whole gradient (Frobenius norm of the
# difference over that of the reference) within TRAIN_TOL, each parameter's
# gradient within TRAIN_LEAF_TOL.  Both tiers run the same bf16 ops and the
# same plain backward and part only where the forward attention rounds to
# bf16 (as LOGIT_TOL), which each gradient carries through 24 layers.  The
# H100 reads (scripts/train_controls.py, PERF.md): whole gradient 2.8e-2 /
# 2.1e-2 (actor / critic), worst leaf 4.3e-2 / 6.3e-2 (the k/v biases),
# loss and grad_norm <= 1e-3; the reference tier's own spread (query chunks
# of 64 against 128) 6.4e-3 and 1.7e-2; planted faults: every sequence
# boundary one token late in every layer 1.2 / 4.6 (whole gradient), a
# window of 64 keys 1.9 / 4.3.  A fault in one layer of 24 reads like the
# sound run here (2.8e-2, worst leaf 1.1e-1): FP32_GRAD_TOL's check is the
# tight one.  clip_frac may differ by CLIP_FRAC_TOL (a token whose ratio
# lies at a clip edge within that rounding falls either way; sound 0, the
# boundary fault 0.32).
TRAIN_TOL = 5e-2
TRAIN_LEAF_TOL = 2e-1
CLIP_FRAC_TOL = 1e-2
# The same comparison in fp32 at full width and 2 layers, for every number
# and every leaf: both tiers round nowhere to bf16, so only summation order
# is left (H100: 3.3e-6 worst; the boundaries one token late in the last
# layer only: 1.5e-2 whole gradient, 4.6e-2 worst leaf).
# For an MoE model both tiers take grouped_ffn's one backward
# (``grouped_ffn_bwd_ref``; the reference tier's ``grouped_ffn_plain``), so
# these checks see the expert FFN's forward only; the readings above were
# taken while the reference tier differentiated the plain per-expert loop
# by autograd.  tests/test_torch_cuda.py's
# test_grouped_ffn_gradient_at_128_experts holds that backward against
# autograd through the plain loop on the card.
FP32_GRAD_TOL = 1e-4
# Where a route of an MoE model parts between two fp32 runs (tiers or
# layouts), the larger of both runs' gaps between the token's k-th and
# (k+1)-th router probabilities.  The runs' hidden states differ in
# summation order only (a few 1e-6 relative, FP32_GRAD_TOL's readings), so
# the probabilities move by less than that and a route may part only at
# such a near-tie; one expert swapped for a token moves the gradients past
# FP32_GRAD_TOL, so phase 7 holds the gap in place of the gradients where
# a route parts.
ROUTE_TIE_TOL = 1e-5
# The same gap where two bf16 runs of arctic-480b part (tiers, dispatches,
# layouts, engines), at each parting that no earlier one reaches
# (``first_partings``): only the runs' bf16 rounding lies behind such a
# parting, so it must be a near-tie.  Between the H100's largest sound
# reading (6.973e-4, the capacity dispatch's tiers; the others 9.3e-5 to
# 6.4e-4) and its planted faults' (the cuda run's last router column 0
# x 1.5: 4.040e-2; layer 0's dense residual left out: 5.068e-2; the
# continuous engine's own key left out of the paged decode in every
# layer: 1.102e-2, in the last: 2.367e-3; every router weight x 1.05 reads
# 1.031e-3 and passes; scripts/limit_controls.py routes, PERF.md).
BF16_ROUTE_TIE_TOL = 1.5e-3
# The raw init (embedding std 1.0, tied unembedding) makes every next-token
# distribution almost one-hot; scaled by 0.05 the logits' spread is ~1.5.
EMBED_SCALE = 0.05
ITERS = 50
# gemma3-1b's continuous server in phase 12: its table's blocks of 16 per
# row (a prompt bucket of 1,024, up to 56 new tokens and the sync slack)
# and ragged lengths up to M * bs, so phase 2 holds its D 256 G 4 paged
# decode on the split grid that table gives
PAGED_GEMMA3 = dict(m=68, lens=(0, 1, 17, 100, 513, 777, 1000))
# Rewritten between timed calls to evict the inputs from L2 (50 MB on H100).
FLUSH_BYTES = 64 << 20


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


KERNELS = (flash_mha, flash_decode, paged_flash_decode, grouped_ffn, ssd_scan, rglru_scan,
           flash_mha_varlen)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def launches():
    return {k.__name__: k.launches for k in KERNELS}


def make_params(cfg, *, seed, device):
    """``init_params`` with the embedding scaled by EMBED_SCALE and the
    recurrent mixers' constant leaves drawn at random (``randomize_mixers``)."""
    params = MDL.init_params(cfg, seed=seed, device=device)
    params["embed"]["table"].mul_(EMBED_SCALE)
    randomize_mixers(params, seed=seed)
    return params


def randomize_mixers(params, *, seed):
    """The JAX init gives every SSD head A = -1, D = 1, dt_bias = 0 and every
    RG-LRU channel lam = -1 with zero gates, so all heads and channels decay
    alike.  Draw them instead, in place: A = -exp(a_log) in [-16, -1],
    dt = softplus(dt_bias) in [1e-3, 1e-1] (log-uniform), D in [0.5, 1.5],
    conv biases at std 0.1, lam in [-2, 2], gate weights and biases at std
    0.5."""
    dev = params["embed"]["table"].device
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(t, lo, hi):
        return torch.rand(t.shape, generator=g, device=dev) * (hi - lo) + lo

    def normal(t, std):
        return torch.randn(t.shape, generator=g, device=dev) * std
    for p in params["layers"]:
        m = p["mixer"]
        if "a_log" not in m and "lam" not in m:
            continue
        m["conv_b"].copy_(normal(m["conv_b"], 0.1))
        if "a_log" in m:
            m["a_log"].copy_(uniform(m["a_log"], 0.0, math.log(16.0)))
            dt = torch.exp(uniform(m["dt_bias"], math.log(1e-3), math.log(1e-1)))
            m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1(dt)
            m["d"].copy_(uniform(m["d"], 0.5, 1.5))
        else:
            m["lam"].copy_(uniform(m["lam"], -2.0, 2.0))
            for name in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
                m[name].copy_(normal(m[name], 0.5))


# ------------------------------------------------------------------ phase 2

def time_ms(fn, iters=ITERS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _replay_ms(calls, iters):
    """Milliseconds of one replay of a CUDA graph of ``iters`` calls."""
    for _ in range(3):
        calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            calls()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def graph_ms(fn, iters=ITERS):
    """Mean device time of one call, the calls replayed from a CUDA graph:
    no host time lies between them, where ``time_ms`` of a call shorter
    than its wrapper's host work reads the host."""
    return _replay_ms(fn, iters) / iters


def graph_cold_ms(fn, iters=ITERS):
    """``graph_ms`` with L2 flushed before each call: the graph of (flush,
    call) pairs less the graph of the flushes alone."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        fn()
    return (_replay_ms(flushed, iters) - _replay_ms(flush.zero_, iters)) / iters


def decode_splits(b, hkv, cap):
    """flash_decode's bf16 blocks per (row, KV head) at these shapes on
    this card."""
    return decode_attention.decode_splits(
        b, hkv, cap, torch.cuda.get_device_properties(0).multi_processor_count)


def ssd_p_splits(b, h=64):
    """ssd_scan's bf16 blocks per (row, head) at these shapes on this card."""
    return ssd_scan_mod.ssd_splits(b, h, build.sm_count(0))


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _max_err(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    return err.max().item(), (err / (1 + want.abs())).max().item()


def phase_kernels(device):
    g = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(bf16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}

    # flash_mha: the prefill shape of this slice, then a window, explicit
    # arange positions (the no-skip path) and verify-style positions with a
    # row that has no valid key
    b, s, hq, hkv, d = 4, 512, 14, 2, 64
    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    pos = torch.arange(s, device=device)[None]
    kv_pos = torch.stack([torch.randperm(s, generator=g, device=device)
                          for _ in range(2)])
    q_pos = torch.tensor([[500, 501, 502, 503], [-1, 100, 200, 300]], device=device)
    cases = [
        ("causal", (q, k, v), dict(causal=True)),
        ("window128", (q, k, v), dict(causal=True, window=128)),
        ("arange-positions", (q, k, v), dict(causal=True, q_positions=pos, kv_positions=pos)),
        ("verify-positions", (randn(2, 4, hq, d), k[:2].contiguous(), v[:2].contiguous()),
         dict(causal=True, q_positions=q_pos, kv_positions=kv_pos)),
    ]
    errs = []
    for name, args, kw in cases:
        got = flash_mha(*args, **kw)
        want = ref.mha_ref(*args, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] flash_mha {name}: max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")
        check(rel_err <= KERNEL_TOL, f"flash_mha {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    bms, by = bound_ms(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    out["flash_mha"] = dict(
        max_abs_err=max(errs), library="scaled_dot_product_attention",
        ms=graph_ms(lambda: flash_mha(q, k, v, causal=True)),
        cold_ms=graph_cold_ms(lambda: flash_mha(q, k, v, causal=True)),
        eager_ms=time_ms(lambda: flash_mha(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=True)),
        bound_ms=bms, bound_by=by,
        library_ms=graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)))
    out["flash_mha"]["d256"] = mha_d256_case(randn, device)
    out["flash_mha"]["d128"] = mha_case(randn, device, "d128 (llama-7b)", 4, 512, 512, 32, 8,
                                        128, True)
    out["flash_mha"]["verify"] = verify_kernel_case(randn, device, hq, hkv, d)

    # flash_decode: 8 rows over a 1088-slot linear cache with ragged
    # lengths, then a ring cache (window 256) with a row of length 0
    b, c = 8, 1088
    q, kc, vc = randn(b, hq, d), randn(b, c, hkv, d), randn(b, c, hkv, d)
    lens = torch.tensor([1, 17, 64, 65, 400, 777, 1000, 1088], dtype=torch.int32,
                        device=device)
    ring_k, ring_v = randn(b, 256, hkv, d), randn(b, 256, hkv, d)
    ring_lens = torch.tensor([0, 1, 100, 255, 256, 257, 1000, 3000], dtype=torch.int32,
                             device=device)
    cases = [("linear", (q, kc, vc), dict(cache_len=lens)),
             ("ring256", (q, ring_k, ring_v), dict(cache_len=ring_lens, window=256))]
    errs = []
    for name, args, kw in cases:
        got = flash_decode(*args, **kw)
        want = ref.decode_mha_ref(*args, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] flash_decode {name}: max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e}")
        check(rel_err <= KERNEL_TOL, f"flash_decode {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
    n_keys = int(lens.sum())
    bms, by = bound_ms(4 * d * hq * n_keys, 2 * (2 * q.numel() + 2 * n_keys * hkv * d))
    qs = q[:, :, None]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(c, device=device)[None] < lens[:, None])[:, None, None]
    out["flash_decode"] = dict(
        max_abs_err=max(errs), library="scaled_dot_product_attention",
        ms=graph_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        cold_ms=graph_cold_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        eager_ms=time_ms(lambda: flash_decode(q, kc, vc, cache_len=lens)),
        plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens)),
        bound_ms=bms, bound_by=by, splits=decode_splits(b, hkv, c),
        library_ms=graph_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)))
    out["flash_decode"]["d256"] = decode_d256_case(randn, device)
    out["flash_decode"]["d128"] = decode_case(randn, device, "d128 linear (llama-7b)", 8, 32, 8,
                                              128, [1, 17, 64, 65, 400, 777, 1000, 1088])
    out["paged_flash_decode"] = paged_kernel_case(randn, device, hq, hkv, d)
    # phase 12's configs at their continuous servers' tables: (name, label,
    # Hq, Hkv, D, table); qwen3-1.7b's and qwen2.5-14b's are 36 blocks
    for key, label, phq, phkv, pd, kw in (("d128_g2", "qwen3-1.7b", 16, 8, 128, {}),
                                          ("d256_g4", "gemma3-1b", 4, 1, 256, PAGED_GEMMA3),
                                          ("d128_g5", "qwen2.5-14b", 40, 8, 128, {})):
        out["paged_flash_decode"][key] = paged_kernel_case(
            randn, device, phq, phkv, pd, tag=f" {key} ({label})", **kw)
    out["flash_mha"]["gemma3_s1000"] = mha_window_case(randn, device, 1000)
    out["flash_mha"]["gemma3_s2048"] = mha_window_case(randn, device, 2048)
    out["flash_decode"]["ring512_d256_g4"] = decode_ring512_case(randn, device)
    for key, *shape in MODAL_MHA:
        out["flash_mha"][key] = mha_case(randn, device, *shape)
    # the decoders' self-attention at phase 13's decode: seamless's 4 rows
    # at a 128-token prompt, internvl2's 2 rows at 512 (prefix and tokens)
    out["flash_decode"]["seamless_d64_g1"] = decode_case(
        randn, device, "seamless-m4t-medium", 4, 16, 16, 64, [129, 131, 133, 136])
    out["flash_decode"]["internvl2_d128_g8"] = decode_case(
        randn, device, "internvl2-76b", 2, 64, 8, 128, [513, 520])
    # phase 14's heads: arctic-480b's 56 query on 8 KV heads of 128 (G 7)
    # at its prefill, the BatchServer's ragged linear cache and the
    # continuous server's 36-block table
    out["flash_mha"]["arctic_d128_g7"] = mha_case(randn, device, "arctic-480b prefill", 4, 512,
                                                  512, 56, 8, 128, True)
    out["flash_decode"]["arctic_d128_g7"] = decode_case(
        randn, device, "arctic-480b", 8, 56, 8, 128, [1, 17, 64, 65, 400, 777, 1000, 1088])
    out["paged_flash_decode"]["arctic_d128_g7"] = paged_kernel_case(
        randn, device, 56, 8, 128, tag=" arctic_d128_g7 (arctic-480b)")
    out["grouped_ffn"] = grouped_kernel_case(device)
    out["ssd_scan"] = ssd_kernel_case(device)
    out["rglru_scan"] = rglru_kernel_case(device)
    out["flash_mha_varlen"] = varlen_kernel_case(device)
    for name, info in (("flash_mha D64 bf16 tile body", flash_attention.kernel_info(64)),
                       ("flash_mha D128 bf16 tile body", flash_attention.kernel_info(128)),
                       ("flash_mha D256 bf16 tile body", flash_attention.kernel_info(256)),
                       ("flash_mha_varlen D64 bf16 tile body", varlen_attention.kernel_info(64)),
                       ("flash_decode D64 bf16 split body", decode_attention.kernel_info(64)),
                       ("flash_decode D128 bf16 split body", decode_attention.kernel_info(128)),
                       ("flash_decode D256 bf16 split body", decode_attention.kernel_info(256)),
                       ("grouped_ffn bf16 launch A (H)", grouped_expert.kernel_info(0)),
                       ("grouped_ffn bf16 launch B (out)", grouped_expert.kernel_info(1)),
                       *((f"paged_flash_decode D{pd} bf16 split body",
                          paged_decode_attention.kernel_info(pd)) for pd in (64, 128, 256)),
                       *((f"ssd_scan bf16 tensor-core body, p_splits {ps}",
                          ssd_scan_mod.kernel_info(ps)) for ps in ssd_scan_mod.P_SPLITS),
                       *((f"rglru_scan {t} chunk body at chunk {c} (one stage)",
                          rglru_scan_mod.kernel_info(dt, c))
                         for t, dt, c in (("fp32", torch.float32, out["rglru_scan"]["chunk"]),
                                          ("fp32", torch.float32,
                                           out["rglru_scan"]["b1_s256"]["chunk"]),
                                          ("bf16", torch.bfloat16,
                                           out["rglru_scan"]["bf16"]["chunk"])))):
        print(f"[kernels] {name}: {info['registers']} registers, "
              f"{info['spill_bytes']} spill bytes, {info['smem_bytes']} bytes of shared "
              f"memory, {info['blocks_per_sm']} blocks per SM")
    for name, shape in (("qwen2-0.5b BatchServer (B 8, Hkv 2, C 1088)", (8, 2, 1088)),
                        ("llama-7b / arctic-480b BatchServer (B 8, Hkv 8, C 1088)",
                         (8, 8, 1088)),
                        ("qwen2-0.5b PPO rollout (B 16, Hkv 2, C 384)", (16, 2, 384)),
                        ("recurrentgemma-9b (B 8, Hkv 1, ring 576)", (8, 1, 576)),
                        ("gemma3-1b local layers (B 8, Hkv 1, ring 512)", (8, 1, 512))):
        print(f"[kernels] flash_decode splits at {name}: {decode_splits(*shape)} blocks per "
              "(row, KV head)")
    for name, shape in (("qwen2-0.5b continuous (B 8, Hkv 2, M 36 x bs 16)", (8, 2, 576)),
                        ("granite-moe-1b-a400m continuous (B 8, Hkv 8, M 36 x bs 16)",
                         (8, 8, 576)),
                        ("qwen3-1.7b / qwen2.5-14b / arctic-480b continuous (B 8, Hkv 8, "
                         "M 36 x bs 16)",
                         (8, 8, 576)),
                        ("gemma3-1b continuous (B 8, Hkv 1, M 68 x bs 16)",
                         (8, 1, PAGED_GEMMA3["m"] * 16))):
        print(f"[kernels] paged_flash_decode splits at {name}: {decode_splits(*shape)} blocks "
              "per (row, KV head)")
    print("[kernels] ssd_scan p_splits at mamba2-1.3b's admissions (H 64): "
          + ", ".join(f"B {b}: {ssd_p_splits(b)}" for b in (1, 2, 4, 8)))
    guard_case(device)
    for name, r in out.items():
        for shape, t in [("", r)] + [(f" {k}", v) for k, v in r.items() if isinstance(v, dict)]:
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ({t['library']})")
            eager = (f" eager_ms={t['eager_ms']:.4f} (host-paced loop)" if "eager_ms" in t
                     else "")
            eager += f" splits={t['splits']}" if "splits" in t else ""
            eager += f" p_splits={t['p_splits']}" if "p_splits" in t else ""
            eager += (f" chunk={t['chunk']} grid={t['grid']} windows={t['windows']} "
                      f"copy_ms={t['copy_ms']:.4f} (torch.mul, graph)" if "chunk" in t else "")
            print(f"[kernels] {name}{shape}: ms={t['ms']:.4f} (warm L2) cold_ms="
                  f"{t['cold_ms']:.4f} (L2 flushed){eager} plain_ms={t['plain_ms']:.4f} "
                  f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) library_ms={lib}")
    return out


def held(name, got, want, tol=KERNEL_TOL):
    """Synchronise, print and check one kernel-vs-plain comparison; returns
    the max absolute error."""
    torch.cuda.synchronize()
    abs_err, rel_err = _max_err(got, want)
    print(f"[kernels] {name}: max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} (tol {tol})")
    check(rel_err <= tol, f"{name}: err {rel_err} > {tol}")
    return abs_err


def verify_kernel_case(randn, device, hq, hkv, d, *, b=16, bs=16, m=26):
    """flash_mha at the speculative verify's shape (phase 9's rollout: k + 1
    = 5 queries per row at ragged positions over the B x (M * bs) cache
    gathered from a shuffled block table, M 26 blocks of 16 for 128 + 256
    tokens), against the plain version; timed alone and with the table
    gather in front (``ops.paged_verify_mha``); SDPA over the same gathered
    cache with the position mask as the library call."""
    kk = SPEC_K + 1
    n = 1 + b * m
    g = torch.Generator(device=device).manual_seed(5)
    q = randn(b, kk, hq, d)
    k_pool, v_pool = randn(n, bs, hkv, d), randn(n, bs, hkv, d)
    tbl = (torch.randperm(n - 1, generator=g, device=device) + 1).reshape(b, m).to(torch.int32)
    starts = torch.randint(128, m * bs - kk, (b,), generator=g, device=device)
    qpos = (starts[:, None] + torch.arange(kk, device=device)[None]).to(torch.int32)
    kg, vg = ref.gather_pool(k_pool, tbl), ref.gather_pool(v_pool, tbl)
    kvpos = torch.arange(m * bs, device=device)[None]

    def kern():
        return flash_mha(q, kg, vg, causal=True, q_positions=qpos, kv_positions=kvpos)

    def gathered():
        return OPS.paged_verify_mha(q, k_pool, v_pool, tbl, q_positions=qpos, impl="cuda")

    def plain():
        return ref.paged_verify_mha_ref(q, k_pool, v_pool, tbl, q_positions=qpos)
    err = held(f"flash_mha verify shape (B{b} Sq{kk} over {m * bs} gathered keys)",
               kern(), plain())
    held("ops.paged_verify_mha (gather + flash_mha)", gathered(), plain())
    keys = int((qpos.long() + 1).sum())  # query j attends positions 0 .. qpos[j]
    n_keys = int((qpos.long().max(dim=1).values + 1).sum())  # the keys a row's queries need
    bms, by = bound_ms(4 * d * hq * keys, 2 * (2 * q.numel() + 2 * n_keys * hkv * d))
    mask = kvpos[:, None, None, :] <= qpos[:, None, :, None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kg, vg))
    case = dict(max_abs_err=err, library="scaled_dot_product_attention",
                ms=graph_ms(kern), cold_ms=graph_cold_ms(kern), eager_ms=time_ms(kern),
                with_gather_ms=graph_ms(gathered), with_gather_eager_ms=time_ms(gathered),
                plain_ms=time_ms(plain), bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    print(f"[kernels] flash_mha verify shape with the table gather in front: "
          f"{case['with_gather_ms']:.4f} ms (graph), {case['with_gather_eager_ms']:.4f} "
          f"(eager) against the kernel's {case['ms']:.4f} (graph)")
    return case


def mha_d256_case(randn, device):
    """flash_mha at recurrentgemma-9b's prefill shape: B 4, S 512, 16 query
    heads on 1 KV head, D 256, the model's window 2048 (wider than S) and a
    window of 128; timed with the model's window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, s, hq, hkv, d = 4, 512, 16, 1, 256
    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    errs = [held(f"flash_mha d256 window{w}", flash_mha(q, k, v, causal=True, window=w),
                 ref.mha_ref(q, k, v, causal=True, window=w)) for w in (2048, 128)]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    bms, by = bound_ms(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    return dict(max_abs_err=max(errs), library="scaled_dot_product_attention",
                ms=graph_ms(lambda: flash_mha(q, k, v, causal=True, window=2048)),
                cold_ms=graph_cold_ms(lambda: flash_mha(q, k, v, causal=True, window=2048)),
                eager_ms=time_ms(lambda: flash_mha(q, k, v, causal=True, window=2048)),
                plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=True, window=2048)),
                bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)))


def decode_d256_case(randn, device):
    """flash_decode at recurrentgemma-9b's decode shape: 8 rows of 16 query
    heads on 1 KV head (G = 16), D 256, over the 576-slot ring of a
    576-token budget (window 2048), ragged lengths with a row of 0 and rows
    past the ring's length."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, c, hq, d = 8, 576, 16, 256
    q, kc, vc = randn(b, hq, d), randn(b, c, 1, d), randn(b, c, 1, d)
    lens = torch.tensor([0, 1, 64, 200, 333, 575, 576, 900], dtype=torch.int32,
                        device=device)
    err = held("flash_decode d256 ring576", flash_decode(q, kc, vc, cache_len=lens, window=2048),
               ref.decode_mha_ref(q, kc, vc, cache_len=lens, window=2048))
    n_keys = int(torch.where(lens > 0, lens.clamp(max=c), c).sum())
    bms, by = bound_ms(4 * d * hq * n_keys, 2 * (2 * q.numel() + 2 * n_keys * d))
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    valid = torch.arange(c, device=device)[None] < lens.clamp(max=c)[:, None]
    mask = (valid | (lens[:, None] == 0))[:, None, None]

    def kernel():
        return flash_decode(q, kc, vc, cache_len=lens, window=2048)
    return dict(max_abs_err=err, library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens,
                                                            window=2048)),
                bound_ms=bms, bound_by=by, splits=decode_splits(b, 1, c),
                library_ms=graph_ms(lambda: sdpa(q[:, :, None], ks, vs, attn_mask=mask,
                                                 enable_gqa=True)))


def mha_window_case(randn, device, s, *, b=2):
    """flash_mha at gemma3-1b's prefill shape: B ``b``, S ``s``, 4 query heads on
    1 KV head, D 256, its window of 512, which bites at S > 512 (S 1000
    starts most rows' windows off a 64-key tile boundary), and causal
    without a window (its global layers); timed windowed.  Bound and
    library call count the window's pairs: SDPA with the window's boolean
    mask."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv, d, w = 4, 1, 256, 512
    q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    errs = [held(f"flash_mha gemma3-1b B{b} S{s} window {win}",
                 flash_mha(q, k, v, causal=True, window=win),
                 ref.mha_ref(q, k, v, causal=True, window=win)) for win in (w, None)]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * hq * sum(min(i + 1, w) for i in range(s))
    bms, by = bound_ms(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    i, j = torch.arange(s, device=device)[:, None], torch.arange(s, device=device)[None]
    mask = (j <= i) & (i - j < w)

    def kernel():
        return flash_mha(q, k, v, causal=True, window=w)
    return dict(max_abs_err=max(errs), library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=True, window=w)),
                bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)))


def decode_ring512_case(randn, device):
    """flash_decode at gemma3-1b's local-layer decode shape: 8 rows of 4
    query heads on 1 KV head (G 4), D 256, over a ring of 512 slots, window
    512, lengths from 1 to past the ring (wrapped)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, c, hq, d = 8, 512, 4, 256
    q, kc, vc = randn(b, hq, d), randn(b, c, 1, d), randn(b, c, 1, d)
    lens = torch.tensor([1, 100, 511, 512, 513, 700, 1000, 2048], dtype=torch.int32,
                        device=device)
    err = held("flash_decode ring512 D256 G4 (gemma3-1b)",
               flash_decode(q, kc, vc, cache_len=lens, window=c),
               ref.decode_mha_ref(q, kc, vc, cache_len=lens, window=c))
    n_keys = int(lens.clamp(max=c).sum())
    bms, by = bound_ms(4 * d * hq * n_keys, 2 * (2 * q.numel() + 2 * n_keys * d))
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(c, device=device)[None] < lens.clamp(max=c)[:, None])[:, None, None]

    def kernel():
        return flash_decode(q, kc, vc, cache_len=lens, window=c)
    return dict(max_abs_err=err, library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens,
                                                            window=c)),
                bound_ms=bms, bound_by=by, splits=decode_splits(b, 1, c),
                library_ms=graph_ms(lambda: sdpa(q[:, :, None], ks, vs, attn_mask=mask,
                                                 enable_gqa=True)))


# phase 13's flash_mha shapes: (key, label, B, Sq, Skv, Hq, Hkv, D, causal)
MODAL_MHA = (
    ("seamless_encoder", "seamless-m4t-medium encoder", 4, 512, 512, 16, 16, 64, False),
    ("seamless_cross_prefill", "seamless-m4t-medium cross-attention, prefill", 4, 128, 512,
     16, 16, 64, False),
    ("seamless_cross_decode", "seamless-m4t-medium cross-attention, decode", 4, 1, 512,
     16, 16, 64, False),
    ("internvl2_prefill", "internvl2-76b prefill", 2, 512, 512, 64, 8, 128, True),
)


def mha_case(randn, device, label, b, sq, skv, hq, hkv, d, causal):
    """flash_mha at a model's shape (causal at Sq = Skv, or non-causal at
    any Sq, Skv: phase 13's encoder and its cross-attention over 512
    encoder frames, in decode one live query row of the kernel's 64-row
    tile) against the plain version, SDPA as the library call.  The bound
    counts the pairs the mask keeps."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)
    err = held(f"flash_mha {label} (B{b} Sq{sq} Skv{skv} Hq{hq} Hkv{hkv} D{d}"
               f"{' causal' if causal else ' non-causal'})",
               flash_mha(q, k, v, causal=causal), ref.mha_ref(q, k, v, causal=causal))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
    bms, by = bound_ms(4 * d * pairs, 2 * (2 * q.numel() + 2 * k.numel()))

    def kernel():
        return flash_mha(q, k, v, causal=causal)
    return dict(max_abs_err=err, library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.mha_ref(q, k, v, causal=causal)),
                bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)))


def decode_case(randn, device, label, b, hq, hkv, d, lens):
    """flash_decode at a model's decode shape: ``b`` rows of ``hq`` query
    heads on ``hkv`` KV heads over a linear cache of max(lens) slots, row i
    at length lens[i]."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    c = max(lens)
    q, kc, vc = randn(b, hq, d), randn(b, c, hkv, d), randn(b, c, hkv, d)
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    err = held(f"flash_decode {label} (B{b} Hq{hq} Hkv{hkv} D{d} cache {c})",
               flash_decode(q, kc, vc, cache_len=lens),
               ref.decode_mha_ref(q, kc, vc, cache_len=lens))
    n_keys = int(lens.sum())
    bms, by = bound_ms(4 * d * hq * n_keys, 2 * (2 * q.numel() + 2 * n_keys * hkv * d))
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(c, device=device)[None] < lens[:, None])[:, None, None]

    def kernel():
        return flash_decode(q, kc, vc, cache_len=lens)
    return dict(max_abs_err=err, library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=lens)),
                bound_ms=bms, bound_by=by, splits=decode_splits(b, hkv, c),
                library_ms=graph_ms(lambda: sdpa(q[:, :, None], ks, vs, attn_mask=mask,
                                                 enable_gqa=True)))


SSD_H, SSD_P, SSD_N, SSD_CHUNK = 64, 64, 128, 128  # mamba2-1.3b
# (name, B, S, dtype): an admission of 4 rows of 512 tokens; 1 row of 200
# tokens padded to 256 (a ragged last piece); fp32
SSD_CASES = (("bf16-B4-S512", 4, 512, torch.bfloat16), ("bf16-B1-S256", 1, 256, torch.bfloat16),
             ("fp32-B2-S384", 2, 384, torch.float32))


def ssd_inputs(g, b, s, dtype, device):
    """ssd_scan's inputs at mamba2-1.3b's widths with the layer's
    distributions: dt log-uniform in [1e-3, 1e-1], A in [-16, -1]."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)
    dt = torch.exp(torch.rand((b, s, SSD_H), generator=g, device=device)
                   * math.log(100.0) + math.log(1e-3))
    a_log = torch.rand((SSD_H,), generator=g, device=device) * math.log(16.0)
    return (randn(b, s, SSD_H, SSD_P).to(dtype), dt, a_log, randn(b, s, SSD_N).to(dtype),
            randn(b, s, SSD_N).to(dtype),
            torch.rand((SSD_H,), generator=g, device=device) + 0.5)


def ssd_cases(device):
    """SSD_CASES' inputs, drawn in order from one seed; rows past 200 of the
    ragged case are the pad's exact no-ops (dt = 0)."""
    g = torch.Generator(device=device).manual_seed(3)
    out = {}
    for name, b, s, dtype in SSD_CASES:
        args = ssd_inputs(g, b, s, dtype, device)
        if name == "bf16-B1-S256":
            args = (args[0], torch.where(torch.arange(s, device=device)[None, :, None] < 200,
                                         args[1], 0.0)) + args[2:]
        out[name] = args
    return out, g


def ssd_kernel_case(device):
    """ssd_scan at mamba2-1.3b's widths on SSD_CASES, each held against the
    plain version in fp32 on the same values: y within SSD_BF16_TOL in bf16
    (it rounds once) and FP32_SCAN_TOL in fp32, the state within
    FP32_SCAN_TOL.  Timed at an admission of 4 rows of 512 tokens and, as
    ``b1_s256``, of 1 row of 256, kernel from CUDA-graph replays (the
    eager loop kept as ``eager_ms``).  Bound: the bytes of x, dt, B, C, y
    and the final state, against the flops of the chunked algorithm at the
    model's chunk (C.B^T, its product with x, C.state and the state update
    per chunk)."""
    cases, g = ssd_cases(device)
    errs = []
    for name, args in cases.items():
        y, st = ssd_scan(*args, chunk=SSD_CHUNK, return_state=True)
        want_y, want_st = ref.ssd_ref(*(t.float() for t in args), chunk=SSD_CHUNK,
                                      return_state=True)
        tol = SSD_BF16_TOL if args[0].dtype == torch.bfloat16 else FP32_SCAN_TOL
        errs.append(held(f"ssd_scan {name} y", y, want_y, tol))
        held(f"ssd_scan {name} state", st, want_st, FP32_SCAN_TOL)

    def timed(b, s):
        h, p, n, chunk = SSD_H, SSD_P, SSD_N, SSD_CHUNK
        args = ssd_inputs(g, b, s, torch.bfloat16, device)
        nc = s // chunk
        flops = 2 * b * nc * h * (chunk * chunk * n + chunk * chunk * p + 2 * chunk * n * p)
        nbytes = (2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * n + 4 * 2 * h
                  + 4 * b * h * p * n)
        bms, by = bound_ms(flops, nbytes)

        def kernel():
            return ssd_scan(*args, chunk=chunk, return_state=True)
        return dict(library=None, library_ms=None, ms=graph_ms(kernel),
                    cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                    plain_ms=time_ms(lambda: ref.ssd_ref(*args, chunk=chunk,
                                                         return_state=True)),
                    bound_ms=bms, bound_by=by, p_splits=ssd_p_splits(b))
    out = dict(max_abs_err=max(errs), **timed(4, 512))
    out["b1_s256"] = timed(1, 256)
    return out


def rglru_kernel_case(device):
    """rglru_scan at recurrentgemma-9b's width (W 4096), fp32 (the model's
    gates are fp32) with decays drawn as the layer draws them: an admission
    of 4 rows of 512 tokens, a 1-row admission of 256, a ragged 3 x 77 x
    1000, and 4 x 512 in bf16, each held against the plain version in fp32
    on the same values (FP32_TOL; in bf16 h rounds once, RGLRU_BF16_TOL).
    Timed at 4 x 512 and, as ``b1_s256`` and ``bf16``, at the other two
    admissions, kernel from CUDA-graph replays (the eager loop kept as
    ``eager_ms``), beside ``copy_ms``: one torch.mul of the two inputs into
    a third, the scan's bytes as an attainable-bandwidth yardstick (not the
    same function, so not ``library_ms``).  Bound: a, bx read and h written
    once, plus the final state."""
    g = torch.Generator(device=device).manual_seed(4)

    def inputs(b, s, w, dtype=torch.float32):
        a = torch.exp(-8.0 * torch.rand((b, s, w), generator=g, device=device)
                      * math.log1p(math.e ** 2))  # log a = -8 r softplus(lam), lam <= 2
        return a.to(dtype), torch.randn((b, s, w), generator=g, device=device).to(dtype)

    errs = []
    for name, shape, dtype in (("fp32-B4-S512", (4, 512, 4096), torch.float32),
                               ("fp32-B1-S256", (1, 256, 4096), torch.float32),
                               ("fp32-B3-S77-W1000", (3, 77, 1000), torch.float32),
                               ("bf16-B4-S512", (4, 512, 4096), torch.bfloat16)):
        a, bx = inputs(*shape, dtype)
        h, final = rglru_scan(a, bx)
        want_h, want_final = ref.rglru_scan_ref(a.float(), bx.float())
        tol = RGLRU_BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        errs.append(held(f"rglru_scan {name} h", h, want_h, tol))
        held(f"rglru_scan {name} final", final, want_final, FP32_TOL)

    def timed(b, s, dtype=torch.float32):
        w = 4096
        a, bx = inputs(b, s, w, dtype)
        prod = torch.empty_like(bx)
        size = a.element_size()
        bms, by = bound_ms(2 * b * s * w, 3 * size * b * s * w + 4 * b * w)
        chunk = rglru_scan_mod.rglru_chunks(b, s, w, build.sm_count(0))
        cluster, windows = rglru_scan_mod.rglru_grid(s, chunk)

        def kernel():
            return rglru_scan(a, bx)
        return dict(library=None, library_ms=None, ms=graph_ms(kernel),
                    cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                    plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, bx)),
                    copy_ms=graph_ms(lambda: torch.mul(a, bx, out=prod)),
                    bound_ms=bms, bound_by=by, chunk=chunk,
                    grid=[-(-w // rglru_scan_mod.TILE), cluster, b], windows=windows)
    out = dict(max_abs_err=max(errs), **timed(4, 512))
    out["b1_s256"] = timed(1, 256)
    out["bf16"] = timed(4, 512, torch.bfloat16)
    return out


def varlen_lengths(rng, n=8, longest=512, bucket=64):
    """``n`` seeded sequence lengths in [1, longest], one of them 1 and all
    but that one off the 64-row grid, and the bucketed token total with a
    phantom tail, as ``pack_minibatches`` makes it."""
    lens = rng.integers(2, longest + 1, n)
    lens[rng.integers(n)] = 1
    lens = np.where((lens % 64 == 0) & (lens > 1), lens - 1, lens)
    t = packing.bucket_total(int(lens.sum()), bucket)
    return lens, t if t > lens.sum() else t + bucket


def varlen_kernel_case(device):
    """flash_mha_varlen at qwen2-0.5b's attention shapes (Hq 14, Hkv 2, D
    64) on a packed minibatch of 8 seeded sequences of 1-512 tokens with a
    phantom tail: causal and window 128 in bf16 (KERNEL_TOL) and fp32
    (FP32_TOL) against the plain version; equal segments against flash_mha
    on the (B, S) layout (the same bits); one sequence perturbed, every
    other row the same bits; the Function's dq, dk, dv against autograd of
    the plain version (FP32_TOL in fp32, KERNEL_TOL in bf16).  Timed on the
    bf16 causal case.  Bound: 4 D Hq flops per causal pair of every segment
    (the phantom segment too), q, k, v read and o written once.  Library:
    SDPA with the dense (T, T) block-diagonal causal boolean mask."""
    g = torch.Generator(device=device).manual_seed(5)
    hq, hkv, d = 14, 2, 64
    lens, t = varlen_lengths(np.random.default_rng(5))
    longest = int(max(lens.max(), t - lens.sum()))
    cu = torch.from_numpy(packing.cu_seqlens_of(lens)).to(device)
    print(f"[kernels] flash_mha_varlen lengths {lens.tolist()} in T {t} "
          f"({t - int(lens.sum())} phantom tokens)")

    def inputs(dtype, tokens=t):
        return tuple(torch.randn((tokens, h, d), generator=g, device=device).to(dtype)
                     for h in (hq, hkv, hkv))

    qkv = {dt: inputs(dt) for dt in (torch.bfloat16, torch.float32)}
    errs = []
    for dt, tol in ((torch.bfloat16, KERNEL_TOL), (torch.float32, FP32_TOL)):
        for window in (None, 128):
            got = flash_mha_varlen(*qkv[dt], cu, window=window)
            want = ref.mha_varlen_ref(*qkv[dt], cu, window=window, max_seqlen=longest)
            errs.append(held(f"flash_mha_varlen {str(dt)[6:]} window{window}", got, want, tol))

    b, s = 4, 512  # equal segments: the tiles flash_mha walks on (B, S)
    q, k, v = inputs(torch.bfloat16, b * s)
    cu_eq = torch.arange(0, b * s + 1, s, dtype=torch.int32, device=device)
    diff = (flash_mha_varlen(q, k, v, cu_eq).view(b, s, hq, d).float()
            - flash_mha(q.view(b, s, hq, d), k.view(b, s, hkv, d), v.view(b, s, hkv, d),
                        causal=True).float()).abs().max().item()
    print(f"[kernels] flash_mha_varlen 4 equal segments of 512 vs flash_mha on (4, 512): "
          f"max_abs_diff={diff:.3e}")
    check(diff == 0.0, "flash_mha_varlen: equal segments differ from flash_mha")

    q, k, v = qkv[torch.bfloat16]
    j = 2
    sl = slice(int(cu[j]), int(cu[j + 1]))
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[sl] += 3.0
    k2[sl] -= 2.0
    v2[sl] *= 5.0
    base, pert = flash_mha_varlen(q, k, v, cu), flash_mha_varlen(q2, k2, v2, cu)
    keep = torch.ones(t, dtype=torch.bool, device=device)
    keep[sl] = False
    torch.cuda.synchronize()
    same = bool(torch.equal(base[keep], pert[keep]))
    print(f"[kernels] flash_mha_varlen leakage: sequence {j} ({sl.stop - sl.start} tokens) "
          f"perturbed, the other {int(keep.sum())} rows bit-identical: {same}")
    check(same and not torch.equal(base[sl], pert[sl]), "flash_mha_varlen leaks across "
          "sequences")

    w = torch.randn((t, hq, d), generator=g, device=device)
    for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, KERNEL_TOL)):
        grads = []
        for fn in (flash_mha_varlen, ref.mha_varlen_ref):
            leaves = [x.clone().requires_grad_(True) for x in qkv[dt]]
            (fn(*leaves, cu, max_seqlen=longest).float() * w).sum().backward()
            grads.append([x.grad for x in leaves])
        for name, got, want in zip("qkv", *grads):
            held(f"flash_mha_varlen {str(dt)[6:]} d{name} (the Function vs autograd of the "
                 "plain version)", got, want, tol)

    q, k, v = qkv[torch.bfloat16]
    seg = packing.segment_ids_of(cu, t)
    pos = torch.arange(t, device=device)
    pairs = sum(n * (n + 1) // 2 for n in lens.tolist() + [t - int(lens.sum())])
    bms, by = bound_ms(4 * d * hq * pairs, 2 * (2 * q.numel() + 2 * k.numel()))
    mask = (seg[:, None] == seg[None, :]) & (pos[None, :] <= pos[:, None])
    qt, kt, vt = (x.transpose(0, 1)[None].contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(max_abs_err=max(errs), equal_segment_max_abs_diff=diff,
                library="scaled_dot_product_attention, dense (T, T) block-diagonal causal mask",
                ms=graph_ms(lambda: flash_mha_varlen(q, k, v, cu)),
                cold_ms=graph_cold_ms(lambda: flash_mha_varlen(q, k, v, cu)),
                eager_ms=time_ms(lambda: flash_mha_varlen(q, k, v, cu)),
                plain_ms=time_ms(lambda: ref.mha_varlen_ref(q, k, v, cu, max_seqlen=longest)),
                bound_ms=bms, bound_by=by,
                library_ms=graph_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                tokens=t, causal_pairs=pairs)


def guard_case(device):
    """A kernel without a backward (flash_decode) refuses an input that
    requires grad under grad mode (NotImplementedError), and runs under
    no_grad."""
    x = torch.randn((1, 14, 64), device=device, requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=device)
    cl = torch.tensor([64], dtype=torch.int32, device=device)
    before = flash_decode.launches
    try:
        flash_decode(x, kv, kv, cache_len=cl)
        raised = False
    except NotImplementedError as exc:
        raised = True
        print(f"[kernels] guard: flash_decode under grad raises NotImplementedError: {exc}")
    with torch.no_grad():
        flash_decode(x, kv, kv, cache_len=cl)
    check(raised and flash_decode.launches == before + 1,
          "flash_decode launched on an input that requires grad")


def paged_kernel_case(randn, device, hq, hkv, d, *, m=36, lens=(0, 1, 17, 64, 100, 333, 500),
                      tag=""):
    """paged_flash_decode at the continuous engine's decode shapes: 8 rows,
    blocks of 16, an ``m``-block table into a shuffled pool of 1 + 8 * m
    blocks, the cache lengths ``lens`` and one of M * bs; then
    the table past each live prefix pointed at a poisoned block 0, and
    blocks of 8.  Each held against the plain version (KERNEL_TOL) and, in
    bf16 and on the same values in fp32, bit for bit against flash_decode
    on the gathered cache: with M * bs == C both run the same body (bf16:
    the split-KV grid with the same splits; fp32: the FMA walk) on the same
    key values.  Kernel and library call timed from CUDA-graph replays (the
    eager loop kept as ``eager_ms``).  ``tag`` names the shape in the
    printed lines."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=device).manual_seed(1)
    b, bs = 8, 16
    name0 = f"paged_flash_decode{tag}"
    q = randn(b, hq, d)
    lens = torch.tensor([*lens, m * bs], dtype=torch.int32, device=device)
    splits = decode_splits(b, hkv, m * bs)
    print(f"[kernels] {name0}: B {b}, Hq {hq}, Hkv {hkv}, D {d}, M {m} x bs {bs} (C {m * bs}), "
          f"{splits} splits per (row, KV head)")

    def pool(bs, m):
        n = 1 + b * m
        table = (torch.randperm(n - 1, generator=g, device=device) + 1).reshape(b, m)
        return randn(n, bs, hkv, d), randn(n, bs, hkv, d), table.to(torch.int32)

    k_pool, v_pool, table = pool(bs, m)
    live = torch.arange(m, device=device)[None] < (lens[:, None] + bs - 1) // bs
    k_poison, v_poison = k_pool.clone(), v_pool.clone()
    k_poison[0], v_poison[0] = 1e4, -1e4
    k8, v8, table8 = pool(8, 2 * m)
    cases = [("shuffled", (q, k_pool, v_pool, table)),
             ("poisoned-block0", (q, k_poison, v_poison,
                                  torch.where(live, table, 0).to(torch.int32))),
             ("bs8", (q, k8, v8, table8))]
    errs = []
    for name, args in cases:
        got = paged_flash_decode(*args, cache_len=lens)
        want = ref.paged_decode_mha_ref(*args, cache_len=lens)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] {name0} {name}: max_abs_err={abs_err:.3e} "
              f"scaled_err={rel_err:.3e} (tol {KERNEL_TOL})")
        check(rel_err <= KERNEL_TOL, f"{name0} {name}: err {rel_err} > {KERNEL_TOL}")
        errs.append(abs_err)
        qq, kp, vp, tbl = args
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd = (t.to(dtype) for t in (qq, kp, vp))
            paged = got if dtype == torch.bfloat16 else paged_flash_decode(qd, kd, vd, tbl,
                                                                           cache_len=lens)
            gathered = [p[tbl.long()].reshape(b, -1, hkv, d) for p in (kd, vd)]
            dense = flash_decode(qd, *gathered, cache_len=lens)
            torch.cuda.synchronize()
            diff = (paged.float() - dense.float()).abs().max().item()
            print(f"[kernels] {name0} {name} {str(dtype)[6:]} vs flash_decode on "
                  f"the gathered cache: max_abs_diff={diff:.3e} (must be 0: the same bits)")
            check(torch.equal(paged, dense), f"{name0} {name} {dtype}: not "
                  "flash_decode's bits on the gathered cache")
    # keys walked: a row of length 0 averages all M * bs slots
    n_keys = int(torch.where(lens > 0, lens, m * bs).sum())
    nbytes = (2 * (2 * q.numel() + 2 * n_keys * hkv * d)
              + 4 * (table.numel() + lens.numel()))
    bms, by = bound_ms(4 * d * hq * n_keys, nbytes)
    mask = (torch.arange(m * bs, device=device)[None] < lens[:, None])[:, None, None]
    tl = table.long()

    def library():  # gather the table's blocks, then SDPA with a length mask
        kg = k_pool[tl].reshape(b, m * bs, hkv, d).transpose(1, 2)
        vg = v_pool[tl].reshape(b, m * bs, hkv, d).transpose(1, 2)
        return sdpa(q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)

    def kernel():
        return paged_flash_decode(q, k_pool, v_pool, table, cache_len=lens)
    return dict(
        max_abs_err=max(errs), library="table gather + scaled_dot_product_attention",
        ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: ref.paged_decode_mha_ref(q, k_pool, v_pool, table,
                                                          cache_len=lens)),
        bound_ms=bms, bound_by=by, splits=splits, library_ms=graph_ms(library))


def routed_rows(x, router_w, k):
    """Tokens ``x`` (T, D) under a top-``k`` router ``router_w`` (D, E),
    fp32: (expert-sorted rows (T*k, D), group_sizes (E,) int32, the token
    of each sorted row), as the dropless dispatch builds them."""
    top_i = torch.topk(x.float() @ router_w, k, dim=-1).indices
    _, st = MOE._sort_by_expert(top_i, k)
    return x[st].contiguous(), MOE._group_sizes(top_i, router_w.shape[1]), st


def grouped_library(xs, gs, wg, wi, wo):
    """The closest PyTorch yardstick of grouped_ffn (no single call computes
    the fused function): ``torch._grouped_mm`` for the three products with
    silu between, in bf16, where this torch has it and takes these inputs;
    else a loop of per-expert bf16 matmuls.  Timed only.  Returns (fn,
    name)."""
    silu = torch.nn.functional.silu
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(gs, 0, dtype=torch.int32)

        def fn():
            h = (silu(torch._grouped_mm(xs, wg, offs=offs))
                 * torch._grouped_mm(xs, wi, offs=offs))
            return torch._grouped_mm(h, wo, offs=offs)
        try:
            fn()
            torch.cuda.synchronize()
            return fn, "torch._grouped_mm x3 + silu, bf16"
        except RuntimeError as exc:
            print(f"[kernels] torch._grouped_mm refuses the inputs: "
                  f"{str(exc).splitlines()[0][:120]}")
    sizes = gs.tolist()

    def loop():
        outs, lo = [], 0
        for e, n in enumerate(sizes):
            if n:
                x = xs[lo:lo + n]
                outs.append((silu(x @ wg[e]) * (x @ wi[e])) @ wo[e])
            lo += n
        return torch.cat(outs)
    return loop, "per-expert torch.matmul loop + silu, bf16"


def grouped_kernel_case(device):
    """grouped_ffn at granite-moe-1b-a400m's widths (32 experts, D 1024,
    F 512, silu) with rows routed by a random fp32 router, top-8: a decode
    step of 8 slots (N 64) and an admission prefill of 4 x 256 tokens
    (N 8192) in bf16, the decode step in fp32, and edge cases (all rows to
    one expert, groups straddling 64-row tiles with empty experts, N not a
    multiple of the tile, rows past the total).  Then rows of the prefill
    cohort alone in a 64-row cohort: their outputs must be the same bits.
    Times the decode shape (the JSON row) and the prefill shape, then the
    sweep over N."""
    g = torch.Generator(device=device).manual_seed(2)
    bf16 = torch.bfloat16
    e, d, f, k = 32, 1024, 512, 8

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    w32 = (randn(e, d, f, scale=d ** -0.5), randn(e, d, f, scale=d ** -0.5),
           randn(e, f, d, scale=f ** -0.5))
    wb = tuple(w.to(bf16) for w in w32)
    router = randn(d, e, scale=d ** -0.5)
    x_dec, x_pre = randn(8, d), randn(4 * 256, d)
    xs_dec, gs_dec, _ = routed_rows(x_dec.to(bf16), router, k)
    xs_pre, gs_pre, st_pre = routed_rows(x_pre.to(bf16), router, k)
    xs_dec32, gs_dec32, _ = routed_rows(x_dec, router, k)

    def sizes(n, parts):
        gs = torch.zeros(e, dtype=torch.int32, device=device)
        for i, m in parts.items():
            gs[i] = m
        return randn(n, d).to(bf16), gs

    spread = {i: 0 if i % 5 == 2 else 11 + 13 * (i % 7) for i in range(e)}
    straddle = sizes(sum(spread.values()), spread)  # 64-row tiles, empty experts
    tail = sizes(100, {0: 15, 3: 50, 31: 30})       # 100 rows, 95 in groups
    cases = [("decode-N64", xs_dec, gs_dec, wb, GROUPED_TOL),
             ("prefill-N8192", xs_pre, gs_pre, wb, GROUPED_TOL),
             ("decode-N64-fp32", xs_dec32, gs_dec32, w32, FP32_TOL),
             ("all-to-one-N40", *sizes(40, {17: 40}), wb, GROUPED_TOL),
             (f"straddle-N{int(straddle[1].sum())}", *straddle, wb, GROUPED_TOL),
             ("tail-N100", *tail, wb, GROUPED_TOL)]
    errs, outs = [], {}
    for name, xs, gs, ws, tol in cases:
        got = grouped_ffn(xs, gs, *ws)
        want = ref.grouped_ffn_ref(xs, gs, *ws)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_err(got, want)
        print(f"[kernels] grouped_ffn {name} (empty experts {int((gs == 0).sum())}): "
              f"max_abs_err={abs_err:.3e} scaled_err={rel_err:.3e} (tol {tol})")
        check(rel_err <= tol, f"grouped_ffn {name}: err {rel_err} > {tol}")
        errs.append(abs_err)
        outs[name] = got
    total = int(tail[1].sum())
    check(bool((outs["tail-N100"][total:] == 0).all()), "grouped_ffn: rows past the total "
          "are not zero")

    # the rows of the prefill cohort's first 8 tokens, alone
    rows = torch.nonzero(st_pre < 8)[:, 0]
    eid = ref.expert_ids_of(gs_pre, xs_pre.shape[0])[rows].long()
    gs_sub = torch.zeros(e, dtype=torch.int32, device=device).scatter_add_(
        0, eid, torch.ones_like(eid, dtype=torch.int32))
    alone = grouped_ffn(xs_pre[rows].contiguous(), gs_sub, *wb)
    cohort_diff = (alone - outs["prefill-N8192"][rows]).abs().max().item()
    print(f"[kernels] grouped_ffn cohort independence: {rows.numel()} rows in the "
          f"{xs_pre.shape[0]}-row cohort vs alone, max_abs_diff={cohort_diff:.3e}")
    check(cohort_diff == 0.0, "grouped_ffn: a row's output depends on its cohort")

    out = grouped_times(xs_dec, gs_dec, wb)
    out["prefill"] = grouped_times(xs_pre, gs_pre, wb)
    out.update(max_abs_err=max(errs), cohort_max_abs_diff=cohort_diff)
    n_sweep(x_pre, router, k, wb)
    return out


def grouped_times(xs, gs, wb, plain_iters=ITERS):
    """grouped_ffn on (xs, gs) and the bf16 weights ``wb``: its time warm
    and cold from CUDA-graph replays and from an eager loop, the plain
    version's, the library call's, and the bound (the hit experts' weights
    read once, the rows read and the fp32 output written once, 6 N D F
    operations)."""
    e, d, f = wb[0].shape
    hit = int((gs > 0).sum())
    n = xs.shape[0]
    nbytes = hit * 3 * d * f * 2 + n * d * 2 + n * d * 4 + e * 4
    bms, by = bound_ms(6 * n * d * f, nbytes)
    lib, lib_name = grouped_library(xs, gs, *wb)

    def kernel():
        return grouped_ffn(xs, gs, *wb)
    return dict(ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.grouped_ffn_ref(xs, gs, *wb), plain_iters),
                bound_ms=bms, bound_by=by, library_ms=graph_ms(lib), library=lib_name,
                n_rows=n, experts_hit=hit)


def n_sweep(x, router, k, wb):
    """Print grouped_ffn's time over the first t tokens' routed rows (N = k
    * t, 8 to 1,024 tokens) beside the library call's, both from CUDA-graph
    replays, with the rate at which the kernel reads the hit experts'
    weights (each read once: the bound's bytes)."""
    e, d, f = wb[0].shape
    for t in (8, 32, 128, 256, 512, 1024):
        xs, gs, _ = routed_rows(x[:t].to(torch.bfloat16), router, k)
        hit = int((gs > 0).sum())
        lib, lib_name = grouped_library(xs, gs, *wb)
        ms = graph_ms(lambda: grouped_ffn(xs, gs, *wb))
        print(f"[kernels] grouped_ffn at N {xs.shape[0]} ({t} tokens, {hit} experts hit): "
              f"{ms:.4f} ms, {hit * 3 * d * f * 2 / ms / 1e9:.3f} TB/s of weights; "
              f"{lib_name} {graph_ms(lib):.4f} ms")


# ------------------------------------------------------------------ phase 3

def phase_slice(cfg, params, *, impl, batch=4, prompt_len=256, steps=8, seed=0):
    """Prefill last-position logits and ``steps`` teacher-forced decode
    steps under ``impl`` and under "reference", on the same tokens:
    ``compare_routed``'s errors, argmax agreement and, for an MoE model,
    how the routes compare."""
    toks, feed = slice_tokens(cfg, params, batch, prompt_len, steps, seed)
    return compare_routed(params, toks, feed, (cfg, impl), (cfg, "reference"))


def slice_tokens(cfg, params, batch, prompt_len, steps, seed):
    """Random prompts (B, prompt_len) and teacher-forced tokens (B, steps)."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, steps))).to(device)
    return toks, feed


def forced_logits(cfg, params, toks, feed, *, impl):
    """The prefill's last-position logits of ``toks``, then one decode
    step per column of ``feed``: (B, steps + 1, V)."""
    prompt_len, steps = toks.shape[1], feed.shape[1]
    last, caches = MDL.prefill(params, cfg, {"tokens": toks}, prompt_len + steps, impl=impl)
    out = [MDL.logits_of(params, cfg, last[:, None])[:, 0]]
    for i in range(steps):
        lg, caches = MDL.decode_step(params, cfg, feed[:, i], caches, prompt_len + i,
                                     impl=impl)
        out.append(lg)
    return torch.stack(out, dim=1)


def logit_errors(got, want):
    """Prefill (column 0) and decode errors over the largest |logit| of
    ``want``, and the argmax agreement."""
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    scale = want.abs().amax().item()
    err = (got - want).abs()
    return {"prefill_err": err[:, 0].max().item() / scale,
            "decode_err": err[:, 1:].max().item() / scale,
            "logit_scale": scale,
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item()}


def phase_paged_slice(cfg, params, *, impl, batch=4, prompt_len=256, steps=8,
                      block_size=16, seed=0):
    """Prompts admitted through ``paged_insert`` into a shuffled block
    table, then ``steps`` teacher-forced paged decode steps under ``impl``
    against the dense ``decode_step`` under ``impl`` on the same tokens.
    Returns the scaled error, the argmax agreement and whether the table's
    M * bs slots and the dense cache's length span as many 64-key tiles
    (then the bf16 kernels walk the same split grid)."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, steps))).to(device)
    max_len = prompt_len + steps
    _, dense = MDL.prefill(params, cfg, {"tokens": toks}, max_len, impl=impl)
    m = PC.needed_blocks(max_len, block_size)
    n_blocks = PC.RESERVED_BLOCKS + batch * m
    table = (rng.permutation(n_blocks - PC.RESERVED_BLOCKS) + PC.RESERVED_BLOCKS)
    table = table.reshape(batch, m).astype(np.int32)
    pools = PC.paged_cache_init(cfg, batch, n_blocks, block_size, max_len,
                                L.dtype_of(cfg), device)
    PC.paged_insert(cfg, pools, dense, np.arange(batch), table[:, :PC.needed_blocks(
        prompt_len, block_size)], prompt_len, n_slots=batch)
    tbl = torch.from_numpy(table).to(device)
    paged, want = [], []
    for i in range(steps):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.int32, device=device)
        lg, _ = MDL.paged_decode_step(params, cfg, feed[:, i], pools, tbl, pos, impl=impl)
        paged.append(lg)
        lg, _ = MDL.decode_step(params, cfg, feed[:, i], dense, prompt_len + i, impl=impl)
        want.append(lg)
    got, want = torch.stack(paged, dim=1), torch.stack(want, dim=1)
    check(bool(torch.isfinite(got).all()), "non-finite paged logits")
    scale = want.abs().amax().item()
    tiles = decode_attention.SPLIT_TILE
    return {"paged_err": (got - want).abs().max().item() / scale, "logit_scale": scale,
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
            "same_grid": -(-max_len // tiles) == -(-m * block_size // tiles)}


@contextlib.contextmanager
def recorded_routes():
    """Record every router call while the block runs: its top-k expert set
    (sorted) and the gap between its k-th and (k+1)-th router
    probabilities, per row, into the yielded list."""
    calls = []
    router = MOE._router

    def recording(p, cfg, xf):
        out = router(p, cfg, xf)
        with torch.no_grad():
            probs = torch.softmax(L.dense_apply(p["router"], xf.float()), dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        calls.append((torch.sort(out[1], dim=-1).values,
                      top[:, cfg.top_k - 1] - top[:, cfg.top_k]))
        return out
    MOE._router = recording
    try:
        yield calls
    finally:
        MOE._router = router


def route_diff(got, want, got_rows=None, want_rows=None):
    """Two runs' ``recorded_routes`` call by call, over ``got_rows`` and
    ``want_rows`` of each call (the same tokens in the same order; None:
    all rows): per call, on the host, whether each row's expert set agrees
    ("agree") and the larger of both runs' probability gaps there ("gap");
    the share of (token, call) pairs that agree, the count that part and
    the largest gap among them."""
    check(len(got) == len(want) and got, "router calls differ between the runs")
    agree, gap = [], []
    for (ga, gg), (wa, wg) in zip(got, want):
        if got_rows is not None:
            ga, gg = (t[got_rows.to(t.device)] for t in (ga, gg))
            wa, wg = (t[want_rows.to(t.device)] for t in (wa, wg))
        agree.append((ga.cpu() == wa.cpu()).all(dim=-1))
        gap.append(torch.maximum(gg.cpu(), wg.cpu()))
    parted = torch.cat(gap)[~torch.cat(agree)]
    return {"agree": agree, "gap": gap,
            "agreement": torch.cat(agree).float().mean().item(), "flips": parted.numel(),
            "worst_gap": parted.max().item() if parted.numel() else 0.0}


def token_grid(per_call, batch, prompt_len, steps=0):
    """Per-call (rows,) tensors of one prefill (or forward) over ``batch``
    x ``prompt_len`` tokens, then of ``steps`` decode steps over ``batch``
    rows, one call per MoE layer each: (batch, prompt_len + steps,
    layers)."""
    n = len(per_call) // (1 + steps)
    grid = torch.stack(per_call[:n], -1).view(batch, prompt_len, n)
    if steps:
        grid = torch.cat([grid, torch.stack(per_call[n:], -1).view(batch, steps, n)], 1)
    return grid


def first_partings(parted):
    """(B, T, layers) partings of two runs' routes: those that no earlier
    parting reaches.  Layer l's router at position t reads what the
    layers below l made of positions up to t, so a parting there may
    follow from one at such a place by any probability gap; any other
    parting has only the runs' rounding behind it, so it must be a
    near-tie."""
    seen = parted.int().cummax(dim=1).values
    below = torch.zeros_like(seen)
    below[..., 1:] = seen[..., :-1].cummax(dim=-1).values
    return parted & (below == 0)


def parted_grid(d, batch, prompt_len, steps=0, kept=None):
    """``route_diff`` ``d`` of one prefill (or forward) and ``steps``
    decode steps (``token_grid``), per token: (B, T) whether the token's
    expert set parted in some layer (or, with ``kept``, the same diff of
    the experts the capacity dispatch kept, those), and the largest
    probability gap at a parted expert set that no earlier parting reaches
    (``first_partings``; 0 with none)."""
    topk = ~token_grid(d["agree"], batch, prompt_len, steps)
    parted = topk if kept is None else topk | ~token_grid(kept["agree"], batch, prompt_len,
                                                          steps)
    gaps = token_grid(d["gap"], batch, prompt_len, steps)[first_partings(parted) & topk]
    return parted.any(dim=-1), gaps.max().item() if gaps.numel() else 0.0


@contextlib.contextmanager
def recorded_capacity():
    """Record every ``capacity_route`` call while the block runs: (dropped
    assignments, assignments, each row's kept experts (T, K) sorted, -1
    for a dropped one), into the yielded list."""
    calls = []
    route = MOE.capacity_route

    def recording(cfg, top_w, top_i, t):
        out = route(cfg, top_w, top_i, t)
        order, keep = out[0], out[3]
        kept = torch.empty_like(keep).scatter_(0, order, keep).view(t, -1)
        calls.append((int((~keep).sum()), keep.numel(),
                      torch.sort(torch.where(kept, top_i, -1), dim=-1).values))
        return out
    MOE.capacity_route = recording
    try:
        yield calls
    finally:
        MOE.capacity_route = route


def routed_logits(cfg, params, toks, feed, *, impl):
    """``forced_logits`` with every router call recorded: (logits, routes,
    capacity calls) as ``recorded_routes`` and ``recorded_capacity`` give
    them."""
    with recorded_routes() as routes, recorded_capacity() as caps:
        logits = forced_logits(cfg, params, toks, feed, impl=impl)
    return logits, routes, caps


def compare_routed(params, toks, feed, got_run, want_run):
    """``forced_logits`` of two (config, impl) runs on the same tokens:
    ``logit_errors`` over every compared token (each prefill row's last,
    every decode step's) and the first run's capacity calls.  For an MoE
    model also "agreed_err", the error over the compared tokens that every
    layer routed alike in both runs (their top-k expert sets and, where
    both runs take the capacity dispatch, the experts kept), the count of
    the others, the route agreement over every (token, layer) pair and
    ``parted_grid``'s largest gap at a first parting ("held_gap")."""
    (got, groutes, gcaps), (want, wroutes, wcaps) = (
        routed_logits(c, params, toks, feed, impl=i) for c, i in (got_run, want_run))
    out = logit_errors(got, want)
    out.update(capacity=gcaps, route_agreement=None)
    if not groutes:  # no MoE layer
        return out
    batch, prompt_len = toks.shape
    d = route_diff(groutes, wroutes)
    kept = None
    if gcaps and wcaps:
        kept = route_diff(*([(c[2], g) for c, (_, g) in zip(caps, routes)]
                            for caps, routes in ((gcaps, groutes), (wcaps, wroutes))))
    parted, held_gap = parted_grid(d, batch, prompt_len, feed.shape[1], kept)
    parted = parted[:, prompt_len - 1:]
    err = (got - want).abs().amax(dim=-1).cpu()
    out.update(agreed_err=err.masked_fill(parted, 0.0).max().item() / out["logit_scale"],
               parted=int(parted.sum()), entries=parted.numel(),
               route_agreement=d["agreement"], held_gap=held_gap)
    return out


# ------------------------------------------------------------------ phase 4

def serve_prompts(cfg, *, requests=8, min_prompt=16, max_prompt=400, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n)
            for n in rng.integers(min_prompt, max_prompt + 1, requests)]


def moe_layers(cfg):
    """Layers whose FFN is a dropless MoE: one grouped_ffn per forward (the
    capacity dispatch launches none)."""
    if cfg.ffn_kind != "moe" or cfg.moe_dispatch != "dropless":
        return 0
    return sum(s.has_ffn for s in cfg.layers)


def attn_layers(cfg, *, local=None):
    """Attention layers; ``local`` True/False counts only window/full ones."""
    return sum(s.kind == ATTN and (local is None or (s.window is not None) == local)
               for s in cfg.layers)


def scan_launches(cfg, prefills):
    """One ssd_scan per SSM layer and one rglru_scan per RG-LRU layer per
    prefill (decode steps the recurrent states in plain PyTorch).  A scan
    kernel's key is present only for a model with that mixer."""
    out = {}
    for name, kind in (("ssd_scan", SSM), ("rglru_scan", LRU)):
        n = sum(s.kind == kind for s in cfg.layers)
        if n:
            out[name] = n * prefills
    return out


def same_launches(got, want):
    """Counts equal kernel by kernel, a kernel missing from either side
    counting 0."""
    return all(got.get(k, 0) == want.get(k, 0) for k in set(got) | set(want))


def predicted_launches(cfg, prompts, new):
    """One flash_mha per attention layer per bucket (the prefill), one
    flash_decode per attention layer per decode step (new - 1 steps per
    bucket), no paged decode; one grouped_ffn per MoE layer per prefill and
    per decode step; the scans of ``scan_launches`` per bucket."""
    n_buckets = len({bucket_of(len(p)) for p in prompts})
    return {"flash_mha": attn_layers(cfg) * n_buckets,
            "flash_decode": attn_layers(cfg) * (new - 1) * n_buckets,
            "paged_flash_decode": 0,
            "grouped_ffn": moe_layers(cfg) * new * n_buckets,
            **scan_launches(cfg, n_buckets)}


def phase_serve(cfg, params, prompts, *, impl, new=64, seed=0, modes=("greedy", "sampled")):
    """Serve ``prompts`` greedy, then sampled (those of ``modes``).  Returns
    per run the wall time, tokens/s, the kernels' launch counts and the
    outputs."""
    device = params["embed"]["table"].device
    server = BatchServer(cfg, params, max_new=new, impl=impl)
    runs = {}
    for mode, s in (("greedy", None), ("sampled", seed + 1)):
        if mode not in modes:
            continue
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        outs = server.serve(prompts, s)
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        for o in outs:
            check(o.shape == (new,), f"output shape {tuple(o.shape)} != ({new},)")
            check(bool(((o >= 0) & (o < cfg.vocab_size)).all()), "token out of range")
        runs[mode] = {"seconds": dt, "tokens_per_s": len(outs) * new / dt,
                      "launches": counts, "outputs": outs}
    return runs


# ------------------------------------------------------------------ phase 5

def continuous_traffic(cfg, *, requests=16, min_prompt=16, max_prompt=400, min_new=8,
                       max_new=64, seed=0):
    """Ragged prompts and a per-request number of new tokens, from ``seed``."""
    rng = np.random.default_rng(seed + 100)
    prompts = [rng.integers(1, cfg.vocab_size, n)
               for n in rng.integers(min_prompt, max_prompt + 1, requests)]
    return prompts, [int(n) for n in rng.integers(min_new, max_new + 1, requests)]


def phase_continuous(cfg, params, prompts, new, *, impl, n_slots=8, block_size=16,
                     sync_every=4, seed=0, modes=("greedy", "sampled", "preempt")):
    """Serve with ``ContinuousBatchServer`` in each of ``modes``: greedy,
    sampled, greedy on a pool of room for two full-length rows (preemption;
    after a greedy run).  Each run counts its admission dispatches by
    wrapping the server's ``_admit``, and the kernels' launches from just
    before ``serve`` to just after.  Returns per run the server's numbers,
    the launches and their prediction."""
    device = params["embed"]["table"].device
    kw = dict(n_slots=n_slots, kv_block_size=block_size, max_prompt=max(map(len, prompts)),
              max_new=max(new), impl=impl, sync_every=sync_every)
    runs, full_row = {}, None
    seeds = {"greedy": None, "sampled": seed + 1, "preempt": None}
    for mode in modes:
        s = seeds[mode]
        pool = PC.RESERVED_BLOCKS + 2 * full_row if mode == "preempt" else 0
        server = ContinuousBatchServer(cfg, params, max_kv_blocks=pool, **kw)
        full_row = server.max_blocks
        admits = [0]

        def counted(*a, _admit=server._admit, **k):
            admits[0] += 1
            return _admit(*a, **k)
        server._admit = counted
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        toks, lps = server.serve(prompts, seed=s, max_new=new)
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        st = server.stats()
        for t, lp, n in zip(toks, lps, new):
            check(t.shape == (n,), f"{mode}: {t.shape} tokens for max_new {n}")
            check(bool(((t >= 0) & (t < cfg.vocab_size)).all()), "token out of range")
            check(bool(np.isfinite(lp).all() and (lp <= 1e-4).all()), "bad logprob")
        runs[mode] = dict(
            seconds=dt, tokens_per_s=sum(new) / dt, p50_s=st["latency_s"]["p50"],
            p99_s=st["latency_s"]["p99"], steps=st["steps"],
            preemptions=st["preemptions"], peak_blocks=st["peak_blocks"],
            pool_blocks=server.alloc.n_blocks, admissions=admits[0],
            kv_peak_bytes=server.kv_peak_bytes(),
            full_buffer_bytes=PC.full_buffer_bytes(cfg, len(prompts), server.max_len),
            launches=counts,
            predicted={"flash_mha": attn_layers(cfg) * admits[0],
                       "flash_decode": attn_layers(cfg, local=True) * sync_every * st["steps"],
                       "paged_flash_decode": (attn_layers(cfg, local=False) * sync_every
                                              * st["steps"]),
                       "grouped_ffn": moe_layers(cfg) * (admits[0] + sync_every * st["steps"]),
                       **scan_launches(cfg, admits[0])},
            outputs=toks)
    return runs


def tie_gaps(cfg, params, prompts, outs_a, outs_b, impl="cuda"):
    """For each request whose greedy outputs ``outs_a`` and ``outs_b``
    part, the logits at the first step where they part, recomputed from the
    prompt (left-padded to its bucket, as both engines run it) and the
    common prefix: returns {request: (the larger distance of the two
    chosen tokens below the top logit, max |logit|)}."""
    device = params["embed"]["table"].device
    out = {}
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        a, b = np.asarray(a), np.asarray(b)
        if np.array_equal(a, b):
            continue
        j = int(np.argmax(a != b))
        pr = np.asarray(prompts[i])
        seq = np.zeros(bucket_of(len(pr)) + j, np.int64)
        seq[bucket_of(len(pr)) - len(pr):bucket_of(len(pr))] = pr
        seq[bucket_of(len(pr)):] = a[:j]
        toks = torch.from_numpy(seq)[None].to(device)
        last, _ = MDL.prefill(params, cfg, {"tokens": toks}, len(seq), impl=impl)
        lg = MDL.logits_of(params, cfg, last[:, None])[0, 0]
        top = lg.max()
        out[i] = (max(float(top - lg[a[j]]), float(top - lg[b[j]])), float(lg.abs().max()))
    return out


@contextlib.contextmanager
def engine_routes(prompts, new):
    """Every router call of the ``BatchServer`` or ``ContinuousBatchServer``
    that serves ``prompts`` (``new`` tokens each) in the block, filed by
    request and by position in its prompt left-padded to its bucket, as
    both engines lay it out: yields {request: (expert sets (T, layers, K),
    probability gaps (T, layers))}, T the bucket plus ``new``; -1 and nan
    where no call covered a position."""
    key = {(bucket_of(len(p)), tuple(int(t) for t in p)): i for i, p in enumerate(prompts)}
    check(len(key) == len(prompts), "two requests share a prompt")
    recs, slot_req, n_layers = {}, {}, [0]
    generate, admit, decode = MDL.generate, SPEC._admit_run, SPEC._decode_run

    def file(i, layer, t0, ex, gp):
        t = bucket_of(len(prompts[i])) + new[i]
        if i not in recs:
            recs[i] = (np.full((t, n_layers[0], ex.shape[-1]), -1),
                       np.full((t, n_layers[0]), np.nan))
        m = max(0, min(len(ex), t - t0))
        recs[i][0][t0:t0 + m, layer] = ex[:m]
        recs[i][1][t0:t0 + m, layer] = gp[:m]

    def file_prefill(toks, new_calls):  # one call per layer over (W, P) rows
        toks = toks.cpu().numpy()
        n_layers[0] = len(new_calls)
        reqs = [key.get((len(r), tuple(np.trim_zeros(r, "f").tolist()))) for r in toks]
        for layer, (ex, gp) in enumerate(new_calls):
            ex = ex.cpu().numpy().reshape(*toks.shape, -1)
            gp = gp.cpu().numpy().reshape(toks.shape)
            for r, i in enumerate(reqs):
                if i is not None:
                    file(i, layer, 0, ex[r], gp[r])
        return reqs

    def file_decode(reqs, pos, new_calls):  # steps x layers calls over the rows
        for c, (ex, gp) in enumerate(new_calls):
            step, layer = divmod(c, n_layers[0])
            ex, gp = ex.cpu().numpy(), gp.cpu().numpy()
            for r, i in enumerate(reqs):
                if i is not None and pos[r] + step >= bucket_of(len(prompts[i])):
                    file(i, layer, int(pos[r]) + step, ex[r:r + 1], gp[r:r + 1])

    def gen(params, cfg, batch, **kw):
        c0 = len(calls)
        out = generate(params, cfg, batch, **kw)
        w, plen = batch["tokens"].shape
        n = next((k for k, (ex, _) in enumerate(calls[c0:]) if len(ex) != w * plen),
                 len(calls) - c0)
        reqs = file_prefill(batch["tokens"], calls[c0:c0 + n])
        file_decode(reqs, [plen] * w, calls[c0 + n:])
        del calls[c0:]
        return out

    def adm(params, cfg, tokens, caches, slots, *a, **kw):
        c0 = len(calls)
        out = admit(params, cfg, tokens, caches, slots, *a, **kw)
        for slot, i in zip(slots, file_prefill(tokens, calls[c0:])):
            if i is not None:
                slot_req[int(slot)] = i
        del calls[c0:]
        return out

    def dec(params, cfg, caches, table, tok, pos, *a):
        c0, p0 = len(calls), pos.cpu().numpy()
        out = decode(params, cfg, caches, table, tok, pos, *a)
        file_decode([slot_req.get(s) for s in range(len(p0))], p0, calls[c0:])
        del calls[c0:]
        return out

    with recorded_routes() as calls:
        MDL.generate, SPEC._admit_run, SPEC._decode_run = gen, adm, dec
        try:
            yield recs
        finally:
            MDL.generate, SPEC._admit_run, SPEC._decode_run = generate, admit, decode


def engine_partings(cfg, params, prompts, new, *, impl="cuda"):
    """Greedy ``ContinuousBatchServer`` and ``BatchServer`` runs of an MoE
    model on the same traffic, each router call recorded
    (``engine_routes``).  Returns ``tie_gaps``' distances over the top
    |logit| where the outputs part, and per request, over its prompt and
    the tokens both engines fed alike (up to where their outputs part):
    the (token, layer) pairs whose expert set parts, and the largest
    probability gap at one that no earlier parting reaches
    (``first_partings``)."""
    runs = []
    for serve in (lambda: phase_continuous(cfg, params, prompts, new, impl=impl,
                                           modes=("greedy",))["greedy"]["outputs"],
                  lambda: bucketed_on(cfg, params, prompts, new, impl=impl)["outputs"]):
        with engine_routes(prompts, new) as rec:
            outs = serve()
        runs.append((outs, rec))
    (outs_a, rec_a), (outs_b, rec_b) = runs
    ties = {i: g / sc for i, (g, sc) in tie_gaps(cfg, params, prompts, outs_a, outs_b,
                                                 impl=impl).items()}
    routes = {}
    for i, (p, a, b) in enumerate(zip(prompts, outs_a, outs_b)):
        a, b = np.asarray(a), np.asarray(b)
        j = len(a) - 1 if np.array_equal(a, b) else int(np.argmax(a != b))
        lo, hi = bucket_of(len(p)) - len(p), bucket_of(len(p)) + j
        check(i in rec_a and i in rec_b, f"request {i}: no route recorded")
        (ea, ga), (eb, gb) = (r[i] for r in (rec_a, rec_b))
        ea, eb = ea[lo:hi], eb[lo:hi]
        check(bool((ea >= 0).all() and (eb >= 0).all()), f"request {i}: a route went unrecorded")
        parted = torch.from_numpy((ea != eb).any(-1))
        gaps = np.maximum(ga, gb)[lo:hi][first_partings(parted[None])[0].numpy()]
        routes[i] = (int(parted.sum()), float(gaps.max()) if gaps.size else 0.0)
    return ties, routes


def bucketed_on(cfg, params, prompts, new, *, impl):
    """The bucketed server on the same traffic: it generates max(new) tokens
    for every request; useful tokens/s counts only each request's own.
    Returns also its launches and their prediction."""
    device = params["embed"]["table"].device
    server = BatchServer(cfg, params, max_new=max(new), impl=impl)
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    outs = server.serve(prompts)
    sync(device)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "useful_tokens_per_s": sum(new) / dt, "launches": launches(),
            "predicted": predicted_launches(cfg, prompts, max(new)),
            "outputs": [o[:n].cpu().numpy() for o, n in zip(outs, new)]}


# ------------------------------------------------------------------ phase 6

def train_experiment(*, batch=16, prompt_len=128, new=256, n_minibatches=2, impl="cuda",
                     seed=0, packed=True, opt=None):
    """The PPO experiment of phase 6 (packed) and phase 7 (padded, or
    packed); ``opt`` the AdamW config (None: the default)."""
    return EXP.ExperimentConfig(batch=batch, prompt_len=prompt_len, gen_len=new, seed=seed,
                                ppo=PPO.PPOHyperparameters(n_minibatches=n_minibatches),
                                opt=opt or adamw.AdamWConfig(), impl=impl,
                                packed_training=packed)


def train_models(cfg, exp, device):
    """``build_models`` with every embedding scaled by EMBED_SCALE (and the
    recurrent mixers' constant leaves drawn), ``scale_models``."""
    return scale_models(EXP.build_models(cfg, cfg, exp, device=device), exp)


def scale_models(models, exp):
    """Scale every model's embedding by EMBED_SCALE and draw the recurrent
    mixers' constant leaves (``randomize_mixers``), in place; the trained
    models' AdamW state is taken after.  Returns ``models``."""
    # the reference is the actor; the draft's seed is build_models'
    seeds = {"actor": 0, "ref": 0, "critic": 2, "reward": 3, "draft": 17}
    for name, ms in models.items():
        with torch.no_grad():
            ms.params["embed"]["table"].mul_(EMBED_SCALE)
            randomize_mixers(ms.params, seed=exp.seed + seeds[name])
        if ms.opt_state is not None:
            ms.opt_state = adamw.init(exp.opt, ms.params)
    return models


def train_rollout(cfg, exp, ex, models, rng, *, min_valid=16):
    """One rollout: seeded prompts through ``actor_gen``, each row's
    gen_mask cut at a seeded valid length in [min_valid, gen_len] (as an
    EOS there would cut it), then reference, critic and reward inference.
    Returns the rollout and the valid lengths."""
    device = models["actor"].params["embed"]["table"].device
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (exp.batch, exp.prompt_len))).to(device)
    roll = ex["actor_gen"](models["actor"], {"prompts": {"tokens": prompts}})
    valid = rng.integers(min_valid, exp.gen_len + 1, exp.batch)
    roll["gen_mask"] = (torch.arange(exp.gen_len, device=device)[None]
                        < torch.from_numpy(valid).to(device)[:, None]).float()
    for name in ("ref", "critic", "reward"):
        roll |= ex[f"{name}_inf"](models[name], roll)
    return roll, valid


def leaf_names(tree, prefix=""):
    """Names of ``adamw.leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def first_rows(exp, roll):
    """The first minibatch's real tokens (each sequence's prompt, valid
    generated tokens and one bootstrap token, as ``_packed_prep`` keeps
    them), in sequence order, as rows of its train forward: the packed
    cohort's first sum(lens) rows, or the first lens[i] of padded row i's S.
    No other row reaches a loss."""
    b = exp.batch // exp.ppo.n_minibatches
    g_valid = roll["gen_mask"][:b].sum(-1).long().cpu()
    lens = (exp.prompt_len + torch.clamp(g_valid + 1, max=exp.gen_len)).tolist()
    if exp.packed_training:
        return torch.arange(sum(lens))
    s = exp.prompt_len + exp.gen_len
    return torch.cat([i * s + torch.arange(n) for i, n in enumerate(lens)])


def model_minibatch(cfg, exp, ms, roll, name, *, impl):
    """Model ``name``'s ("actor" or "critic") loss, stats, grad_norm and
    gradients on the first minibatch of ``roll`` in ``exp``'s layout
    (padded or packed) under ``impl``, from its current state (no update);
    for an MoE model also every router call's ``recorded_routes`` and the
    rows of the minibatch's real tokens (``first_rows``)."""
    make = EXP.actor_train_batch if name == "actor" else EXP.critic_train_batch
    batch = make(exp, roll)
    if exp.packed_training:
        fn = PPO.packed_actor_grads if name == "actor" else PPO.packed_critic_grads
        kw = dict(max_seqlen=EXP.max_seqlen(exp))
    else:
        batch = PPO.split_minibatches(batch, exp.ppo.n_minibatches)
        fn = PPO.actor_grads if name == "actor" else PPO.critic_grads
        kw = dict(gen_start=exp.prompt_len)
    mb = {k: v[0] for k, v in batch.items()}
    with recorded_routes() as routes:
        loss, st, grads = fn(ms.params, cfg, exp.ppo, mb, impl=impl, **kw)
    n = max(mb["mask"].sum().item(), 1.0)
    return dict(loss=loss.item(), grad_norm=adamw.global_norm(grads).item(), grads=grads,
                names=leaf_names(ms.params),
                clip_frac=st["clip_frac"].item() if "clip_frac" in st else 0.0,
                adv_scale=(mb["adv"].abs() * mb["mask"]).sum().item() / n
                if name == "actor" else None,
                routes=routes, rows=first_rows(exp, roll))


def first_minibatch(cfg, exp, models, roll, *, impl):
    """``model_minibatch`` of the actor and the critic."""
    return {name: model_minibatch(cfg, exp, models[name], roll, name, impl=impl)
            for name in ("actor", "critic")}


def square_norms(a, b):
    """(|a - b|^2, |b|^2) in fp32, slice by slice along the first axis: a
    whole fp32 copy of recurrentgemma's embedding gradient is 4.2 GB."""
    d2 = r2 = 0.0
    rows = max(1, (1 << 24) * b.shape[0] // b.numel()) if b.dim() else 1
    for x, y in zip(a.split(rows) if a.dim() else [a], b.split(rows) if b.dim() else [b]):
        y = y.float()
        d2 += (x.float() - y).square().sum().item()
        r2 += y.square().sum().item()
    return d2, r2


def all_finite(t) -> bool:
    """Whether every element of ``t`` is finite, slice by slice along the
    first axis: ``torch.isfinite`` of a whole Arctic expert gradient
    (4.46e9 bf16 elements) takes 22 GB of temporaries."""
    rows = max(1, (1 << 24) * t.shape[0] // t.numel()) if t.dim() else 1
    return all(bool(torch.isfinite(x).all()) for x in (t.split(rows) if t.dim() else [t]))


def agreement(name, g, w):
    """Model ``name``'s ``model_minibatch`` result ``g`` against a reference
    run's ``w``.  A leaf's error is |g - g_ref| / |g_ref| (Frobenius);
    "global" the same over all leaves; the loss's error is over the
    reference's ``adv_scale`` where it has one (the actor's mean
    |advantage|: its loss is a sum of ratio * advantage terms near zero
    after whitening), else over its loss (the critic's).
    For an MoE model, "routes" is ``route_diff`` over the real tokens (else
    None)."""
    sq = [square_norms(a, b) for a, b in zip(g["grads"], w["grads"])]
    errs = [math.sqrt(d2 / max(r2, 1e-60)) for d2, r2 in sq]
    diff2 = sum(d2 for d2, _ in sq)
    worst = sorted(zip(errs, g["names"]), reverse=True)[:3]
    scale = w["adv_scale"] if w.get("adv_scale") is not None else abs(w["loss"])
    routes = (route_diff(g["routes"], w["routes"], g["rows"], w["rows"])
              if g.get("routes") else None)
    return dict(loss=g["loss"], ref_loss=w["loss"],
                loss_err=abs(g["loss"] - w["loss"]) / max(scale, 1e-12),
                grad_norm=g["grad_norm"], ref_grad_norm=w["grad_norm"],
                grad_norm_err=abs(g["grad_norm"] - w["grad_norm"]) / max(w["grad_norm"], 1e-12),
                global_err=math.sqrt(diff2) / max(w["grad_norm"], 1e-30),
                clip_frac=g["clip_frac"], ref_clip_frac=w["clip_frac"],
                worst_leaf_err=worst[0][0], worst_leaves=worst, n_leaves=len(errs),
                routes=routes)


def grad_agreement(got, want):
    """``agreement`` of each model in two ``first_minibatch`` results."""
    return {name: agreement(name, g, want[name]) for name, g in got.items()}


def compare_runs(cfg, models, roll, run, ref_run):
    """``agreement`` of each trained model's first minibatch under ``run``
    against ``ref_run``, each an (experiment, impl) pair, from one state and
    one rollout; one model at a time, so two sets of gradients are alive at
    once.  Equal runs compute once."""
    out = {}
    for name in ("actor", "critic"):
        got = model_minibatch(cfg, run[0], models[name], roll, name, impl=run[1])
        want = got if run == ref_run else model_minibatch(cfg, ref_run[0], models[name], roll,
                                                          name, impl=ref_run[1])
        out[name] = agreement(name, got, want)
        del got, want
    return out


def compare_tiers(cfg, exp, models, roll, *, impl):
    """``compare_runs`` of ``impl`` against "reference" in ``exp``'s layout,
    before any update."""
    return compare_runs(cfg, models, roll, (exp, impl), (exp, "reference"))


def compare_layouts(cfg, exp, models, roll):
    """``compare_runs`` of the packed train step against the padded one on
    the same rollout, both under ``exp.impl``: the first minibatch's losses
    and gradients are one function of the same tokens (the JAX package's
    ``test_packed_ppo_loss_and_grads_match_padded``)."""
    packed, padded = (dataclasses.replace(exp, packed_training=p) for p in (True, False))
    return compare_runs(cfg, models, roll, (packed, exp.impl), (padded, exp.impl))


def fp32_train_models(cfg, device, layers=2):
    """An fp32 actor and critic of ``cfg`` at full width and ``layers``
    layers (``shallow``), embeddings scaled by EMBED_SCALE and the recurrent
    mixers' constant leaves drawn."""
    small = shallow(cfg, layers, dtype="float32")
    models = {}
    for name, head, seed in (("actor", "lm", 1), ("critic", "value", 2)):
        params = MDL.init_params(small, seed=seed, device=device, head=head)
        with torch.no_grad():
            params["embed"]["table"].mul_(EMBED_SCALE)
            randomize_mixers(params, seed=seed)
        models[name] = EXP.ModelState(params)
    return small, models


def train_step_predicted(cfg, exp):
    """Launches of one PPO iteration's two train calls: per minibatch, the
    actor's and the critic's train forward and its recompute (remat) run
    flash_mha_varlen (packed) or flash_mha (padded) in every attention
    layer, grouped_ffn in every MoE layer and one scan in every recurrent
    layer (padded only); the plain backwards launch nothing."""
    per_layer = exp.ppo.n_minibatches * 2 * 2
    attn = "flash_mha_varlen" if exp.packed_training else "flash_mha"
    out = {attn: attn_layers(cfg) * per_layer, "grouped_ffn": moe_layers(cfg) * per_layer,
           **scan_launches(cfg, per_layer)}
    return {k: v for k, v in out.items() if v}


def train_predicted(cfg, exp):
    """Launches of one PPO iteration: the rollout's (flash_mha in the prefill
    of generation and the three padded inference forwards, flash_decode in
    each of the gen_len - 1 decode steps, grouped_ffn in the prefill, each
    decode step and the three forwards, one scan per recurrent layer in the
    prefill and the three forwards) and ``train_step_predicted``."""
    n = attn_layers(cfg)
    out = {"flash_mha": 4 * n, "flash_decode": n * (exp.gen_len - 1)}
    if moe_layers(cfg):
        out["grouped_ffn"] = moe_layers(cfg) * (exp.gen_len + 3)
    out.update(scan_launches(cfg, 4))
    for k, v in train_step_predicted(cfg, exp).items():
        out[k] = out.get(k, 0) + v
    return out


def phase_train(cfg, exp, device, *, iters=2, min_valid=16, seed=0, fp32_layers=2,
                layouts=False, models=None):
    """``iters`` PPO iterations of ``build_executors`` (padded or packed as
    ``exp`` says): rollout (``train_rollout``), then the actor and critic
    train steps.  On the first, before training, ``compare_tiers`` on this
    state and rollout; after the last, with the models freed (unless the
    caller gave ``models``), on fp32 models of ``fp32_layers`` layers on
    the first rollout, and with ``layouts`` ``compare_layouts`` on them.
    The comparisons' launches are not counted.  Returns per iteration the
    times, real train tokens, stats, the kernels launched during the train
    calls, and whether every trained parameter is finite and some changed;
    the comparisons; and the run's launches beside their prediction."""
    own = models is None
    if own:
        models = train_models(cfg, exp, device)
    ex = EXP.build_executors(cfg, cfg, exp)
    rng = np.random.default_rng(seed + 300)
    trained = ("actor", "critic")
    out = {"iters": [], "compare": None, "compare_fp32": None, "compare_layouts": None}
    sync(device)
    reset_launches()
    for it in range(iters):
        t0 = time.perf_counter()
        roll, valid = train_rollout(cfg, exp, ex, models, rng, min_valid=min_valid)
        sync(device)
        rollout_s = time.perf_counter() - t0
        if it == 0:
            first_roll = roll
            held_counts = launches()
            out["compare"] = compare_tiers(cfg, exp, models, roll, impl=exp.impl)
            for kern in KERNELS:  # the comparisons' launches do not count
                kern.launches = held_counts[kern.__name__]
        # on the host: on the card these copies would add two models' bytes
        before = {n: [p.detach().to("cpu", copy=True) for p in adamw.leaves(models[n].params)]
                  for n in trained}
        counts0 = launches()
        t0 = time.perf_counter()
        stats = ex["actor_train"](models["actor"], roll)
        sync(device)
        actor_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats |= ex["critic_train"](models["critic"], roll)
        sync(device)
        critic_s = time.perf_counter() - t0
        counts1 = launches()
        state = {}
        for n in trained:
            now = adamw.leaves(models[n].params)
            state[n] = dict(finite=all(bool(torch.isfinite(p).all()) for p in now),
                            changed=sum(bool((p.cpu() != q).any())
                                        for p, q in zip(now, before[n])),
                            leaves=len(now))
        del before
        lens = exp.prompt_len + np.minimum(valid + 1, exp.gen_len)
        out["iters"].append(dict(
            rollout_s=rollout_s, actor_s=actor_s, critic_s=critic_s, tokens=int(lens.sum()),
            padded_tokens=exp.batch * (exp.prompt_len + exp.gen_len), state=state, **stats,
            train_launches={k: counts1[k] - counts0[k] for k in counts1
                            if counts1[k] != counts0[k]}))
    out["launches"] = launches()
    if own:
        del models, ex
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if fp32_layers:
        small, m32 = fp32_train_models(cfg, device, fp32_layers)
        out["fp32_layers"] = small.num_layers
        out["compare_fp32"] = compare_tiers(small, exp, m32, first_roll, impl=exp.impl)
        if layouts:
            out["compare_layouts"] = compare_layouts(small, exp, m32, first_roll)
        del m32
        for kern in KERNELS:
            kern.launches = out["launches"][kern.__name__]
    out["predicted"] = {k: v * iters for k, v in train_predicted(cfg, exp).items()}
    out["per_iter"] = train_predicted(cfg, exp)
    out["train_per_iter"] = train_step_predicted(cfg, exp)
    return out


def report_compare(tag, label, cmp, tol, leaf_tol, *, gate=True):
    """Print ``grad_agreement``'s result and, with ``gate``, fail past the
    limits: loss, grad_norm and whole gradient within ``tol``, each leaf
    within ``leaf_tol``, clip_frac within CLIP_FRAC_TOL.  Where an MoE
    model's routes part between the runs, the gap of each parting pair is
    held to ROUTE_TIE_TOL in place of the gradients (one token's expert
    swapped moves them past any summation-order limit)."""
    for name, c in cmp.items():
        r = c["routes"]
        routes = ("" if r is None else f"; routes agree on {r['agreement']:.6f} of (token, "
                  f"router call) pairs, {r['flips']} part (largest probability gap "
                  f"{r['worst_gap']:.3e}, tol {ROUTE_TIE_TOL})")
        print(f"{tag} {name} {label}: loss {c['loss']:.6e} vs {c['ref_loss']:.6e} (err "
              f"{c['loss_err']:.3e}), grad_norm {c['grad_norm']:.6e} vs "
              f"{c['ref_grad_norm']:.6e} (err {c['grad_norm_err']:.3e}), clip_frac "
              f"{c['clip_frac']:.4f} vs {c['ref_clip_frac']:.4f}, gradient err "
              f"{c['global_err']:.3e}, worst leaves "
              + ", ".join(f"{n} {e:.3e}" for e, n in c["worst_leaves"])
              + f" of {c['n_leaves']}"
              + (f" (tol {tol}, per leaf {leaf_tol})" if gate else " (not gated)") + routes)
        if not gate:
            continue
        if r is not None and r["flips"]:
            check(r["worst_gap"] <= ROUTE_TIE_TOL,
                  f"{tag} {name} {label}: a route parts {r['worst_gap']:.3e} from a tie")
            continue
        check(max(c["loss_err"], c["grad_norm_err"], c["global_err"]) <= tol
              and c["worst_leaf_err"] <= leaf_tol, f"{tag} {name} {label}: runs disagree")
        check(abs(c["clip_frac"] - c["ref_clip_frac"]) <= CLIP_FRAC_TOL,
              f"{tag} {name} {label}: clip_frac disagrees")


def report_train(cfg, exp, device, total, *, tag="[train]", gate_bf16=True, **kw):
    """One ``phase_train`` run on the card and every check of its results:
    the bf16 comparison of the tiers (gated with ``gate_bf16``, else
    printed), the fp32 ones (and the layouts'), finite and changed
    parameters, each iteration's train launches and the run's launches
    against the prediction; adds the run's launches to ``total``."""
    layers = f"{cfg.num_layers} layers" + ("" if cfg.num_layers == get_config(
        cfg.name).num_layers else f" (cut from {get_config(cfg.name).num_layers})")
    layout = "packed" if exp.packed_training else "padded"
    print(f"{tag} {cfg.name} {layers}, {layout}: {exp.batch} prompts of {exp.prompt_len} "
          f"tokens, {exp.gen_len} new, {exp.ppo.n_minibatches} minibatches, AdamW m/v "
          f"{exp.opt.state_dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = phase_train(cfg, exp, device, **kw)
    wall = time.perf_counter() - t0
    report_compare(tag, f"bf16, {cfg.num_layers} layers, first minibatch cuda vs reference",
                   tr["compare"], TRAIN_TOL, TRAIN_LEAF_TOL, gate=gate_bf16)
    if tr["compare_fp32"] is not None:
        report_compare(tag, f"fp32, {tr['fp32_layers']} layers, first minibatch cuda vs "
                       "reference", tr["compare_fp32"], FP32_GRAD_TOL, FP32_GRAD_TOL)
    if tr["compare_layouts"] is not None:
        report_compare(tag, f"fp32, {tr['fp32_layers']} layers, first minibatch packed vs "
                       "padded, both cuda", tr["compare_layouts"], FP32_GRAD_TOL,
                       FP32_GRAD_TOL)
    for i, r in enumerate(tr["iters"]):
        a, c = r["actor_stats"], r["critic_stats"]
        print(f"{tag} {cfg.name} {layout} iteration {i}: rollout {r['rollout_s']:.3f}s; "
              f"actor step {r['actor_s']:.3f}s, critic step {r['critic_s']:.3f}s on "
              f"{r['tokens']} real tokens ({r['padded_tokens']} padded): "
              f"{r['tokens'] / r['actor_s']:.1f} / {r['tokens'] / r['critic_s']:.1f} train "
              f"tokens/s; actor {a}; critic {c}; launches during the train steps "
              f"{r['train_launches']} (predicted {tr['train_per_iter']}); parameters "
              f"{r['state']}")
        check(all(math.isfinite(v) for v in (*a.values(), *c.values())), "non-finite train stats")
        for n, st in r["state"].items():
            check(st["finite"] and st["changed"] > 0, f"iteration {i}: {n} parameters "
                  f"{'not finite' if not st['finite'] else 'unchanged'}")
        # the differentiable kernels ran in every train forward and its
        # recompute, and the decode kernels (no backward) never
        check(same_launches(r["train_launches"], tr["train_per_iter"])
              and all(v > 0 for v in tr["train_per_iter"].values()),
              f"iteration {i}: train launches {r['train_launches']}")
    print(f"{tag} {cfg.name} {layout}: launches {tr['launches']} (predicted "
          f"{tr['predicted']}); phase wall {wall:.1f}s; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} bytes")
    check(same_launches(tr["launches"], tr["predicted"]),
          f"train: launches {tr['launches']} != {tr['predicted']}")
    for k in total:
        total[k] += tr["launches"][k]


# Phase 7's models beside qwen2-0.5b: (config name, layers kept, AdamW m/v
# dtype).  8 prompts of 128 tokens, 128 new (S 256, two of mamba2's
# 128-token chunks), 2 minibatches.  recurrentgemma-9b keeps one
# superblock and the tail (5 of 38 layers) and bf16 m/v: four 9B models
# do not fit on one card, and at 5 layers its 256,000-row tied embedding
# is half of each model.  granite-moe-1b-a400m keeps 12 of 24 layers and
# mamba2-1.3b 24 of 48, so that the script stays near 10 minutes with
# phase 12: their bf16 comparisons are printed, not gated, and the gated
# fp32 ones run on 2 layers whatever the depth.
PHASE7_MODELS = (("granite-moe-1b-a400m", 12, "float32"), ("mamba2-1.3b", 24, "float32"),
                 ("recurrentgemma-9b", 5, "bfloat16"))


def report_phase7(device, total):
    """Phase 7: two padded PPO iterations of full qwen2-0.5b (phase 6's
    traffic; bf16 comparison gated as phase 6's, fp32 on 2 layers, packed
    against padded in fp32); granite-moe-1b-a400m one packed and one padded
    iteration on one set of models; mamba2-1.3b and recurrentgemma-9b one
    padded iteration each, at ``PHASE7_MODELS``' depths.  The extra models'
    bf16 comparisons are printed, their fp32 ones gated."""
    report_train(get_config("qwen2-0.5b"), train_experiment(packed=False), device, total,
                 tag="[train7]", layouts=True)
    for name, layers, state_dtype in PHASE7_MODELS:
        cfg = get_config(name)
        if layers is not None:
            cfg = shallow(cfg, layers)
        t0 = time.perf_counter()
        kw = dict(batch=8, new=128, opt=adamw.AdamWConfig(state_dtype=state_dtype))
        runs = [train_experiment(packed=False, **kw)]
        if all(s.kind == ATTN for s in cfg.layers):
            runs.insert(0, train_experiment(packed=True, **kw))
        models = train_models(cfg, runs[0], device) if len(runs) > 1 else None
        for exp in runs:
            report_train(cfg, exp, device, total, tag="[train7]", gate_bf16=False, iters=1,
                         layouts=not exp.packed_training and len(runs) > 1, models=models)
        del models
        torch.cuda.empty_cache()
        print(f"[train7] {name}: {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 8

# The engine's train stats against the hand-driven loop's: each stat's
# |a - b| / max(|a|, |b|), its largest over the actor's and the critic's
# stats, within ENGINE_SPREAD_FACTOR times the same reading between two
# identical hand-driven runs in this script, plus ENGINE_STATS_FLOOR (so a
# deterministic pair of hand runs, spread 0, still leaves room for one
# reordered fp32 sum in the engine's run).
ENGINE_SPREAD_FACTOR = 4.0
ENGINE_STATS_FLOOR = 1e-6
# The rollout and inference outputs of a PPO iteration, held bit for bit.
POOL_KEYS = ("seq", "logp", "gen_mask", "ref_logp", "values", "rewards")
STAT_KEYS = ("actor_stats", "critic_stats")


def host_pool(pool):
    """A data pool's tensors on the host (the prompts left out)."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in pool.items() if k != "prompts"}


def free(device):
    """Collect what a dropped ``RLHFExperiment`` still holds (its engine
    keeps bound methods of it, a reference cycle that only ``gc`` breaks),
    then return the cached blocks."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def hand_iteration(cfg, exp, device, prompts):
    """Phase 7's loop without its gen_mask cut, on fresh models
    (``train_models``) and executors: one PPO iteration in dataflow order on
    ``prompts``.  Returns (pool on the host, seconds, launches)."""
    models = train_models(cfg, exp, device)
    ex = EXP.build_executors(cfg, cfg, exp)
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    roll = ex["actor_gen"](models["actor"], {"prompts": {"tokens": prompts}})
    for name in ("ref", "critic", "reward"):
        roll |= ex[f"{name}_inf"](models[name], roll)
    for name in ("actor", "critic"):
        roll |= ex[f"{name}_train"](models[name], roll)
    sync(device)
    secs, counts = time.perf_counter() - t0, launches()
    out = host_pool(roll)
    del models, ex, roll
    free(device)
    return out, secs, counts


def engine_experiment(cfg, exp, device, **kw):
    """``RLHFExperiment`` of ``cfg`` as actor and critic on one H100
    (``Cluster(1, 1, chip=hw.H100)``), ``exp`` with the fields ``kw``
    replaced, its models scaled as ``train_models`` scales them before any
    call."""
    e = EXP.RLHFExperiment(cfg, cfg, Cluster(1, 1, chip=hw.H100),
                           dataclasses.replace(exp, **kw), device=device)
    scale_models(e.models, e.exp)
    return e


def pools_equal(a, b):
    """The keys of POOL_KEYS on which two host pools differ."""
    return [k for k in POOL_KEYS if not torch.equal(a[k], b[k])]


def stats_spread(a, b):
    """The largest |x - y| / max(|x|, |y|) over both trained models' stats
    of two pools."""
    worst = 0.0
    for key in STAT_KEYS:
        for name, x in a[key].items():
            y = b[key][name]
            worst = max(worst, abs(x - y) / max(abs(x), abs(y), 1e-30))
    return worst


def phase_engine(cfg, exp, device, *, profile_batches=(4, 16), profile_seqs=(128, 384),
                 search_iters=300, seed=0):
    """Phase 8: ``profile_model`` into a ``ProfileStore``; an
    ``RLHFExperiment`` calibrated from it, its plan searched, one
    ``run_iteration`` held against two hand-driven iterations on the same
    prompts and weights, the cost model recalibrated from that iteration's
    records and a second iteration read against it; then ``run(steps=2)``
    at pipeline depth 2 and at depth 1 from the same seeds.  Each
    experiment is freed before the next is built.  Returns the readings."""
    out = {}
    cluster = Cluster(1, 1, chip=hw.H100)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        entry = PROF.profile_and_store(cfg, PROF.ProfileStore(path), cluster,
                                       batches=profile_batches, seqs=profile_seqs,
                                       device=device)
        free(device)
        out["profile"] = dict(fingerprint=entry.fingerprint, entries=dict(entry.table.entries),
                              scales=dict(entry.type_scales), profile=entry.profile,
                              seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        e = engine_experiment(cfg, exp, device, search_iters=search_iters, profile_path=path)
    out["search_s"] = time.perf_counter() - t0  # the plan search and the models' build
    out["plan"] = str(e.plan)
    out["estimated_s"] = SIM.simulate(e.graph, e.plan, e.cost).total_time
    prompts = e.make_prompts(seed)["tokens"]

    hands = [hand_iteration(cfg, exp, device, prompts) for _ in range(2)]
    out["hand_s"] = [h[1] for h in hands]
    out["hand_launches"] = [h[2] for h in hands]
    out["hand_parts"] = pools_equal(hands[0][0], hands[1][0])
    out["spread"] = stats_spread(hands[0][0], hands[1][0])
    out["limit"] = ENGINE_SPREAD_FACTOR * out["spread"] + ENGINE_STATS_FLOOR

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    analytic = CostModel(cluster)
    profiled = {c.name: e.cost.call_time(c, e.plan.assignments[c.name]) for c in e.graph.calls}
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    pool = host_pool(e.run_iteration(seed))
    out["engine_s"] = [time.perf_counter() - t0]
    out["engine_launches"] = launches()
    out["engine_parts"] = pools_equal(pool, hands[0][0])
    out["engine_spread"] = stats_spread(pool, hands[0][0])
    first = {r.name: r.end - r.start for r in e.engine.records}
    e.engine.recalibrate()
    recal = {c.name: e.cost.call_time(c, e.plan.assignments[c.name]) for c in e.graph.calls}
    n = len(e.engine.records)
    reset_launches()
    t0 = time.perf_counter()
    e.run_iteration(seed + 1)
    out["engine_s"].append(time.perf_counter() - t0)
    out["engine_launches_2"] = launches()
    second = {r.name: r.end - r.start for r in e.engine.records[n:]}
    out["calls"] = {c.name: dict(measured=first[c.name], analytic=analytic.call_time(
        c, e.plan.assignments[c.name]), profiled=profiled[c.name], held_out=second[c.name],
        recalibrated=recal[c.name]) for c in e.graph.calls}
    out["stats"] = e.engine.stats()
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.device(device).type == "cuda" else 0)
    del e, pool
    free(device)

    runs = {}
    for depth in (2, 1):
        e = engine_experiment(cfg, exp, device, search_iters=search_iters,
                              pipeline_depth=depth)
        reset_launches()
        t0 = time.perf_counter()
        runs[depth] = [host_pool(p) for p in e.run(seed + 2, steps=2)]
        out[f"depth{depth}_s"] = time.perf_counter() - t0
        out[f"depth{depth}_launches"] = launches()
        out[f"depth{depth}_stats"] = e.engine.stats()
        del e
        free(device)
    out["pipelined_parts"] = pools_equal(runs[2][0], runs[1][0])
    out["pipelined_spread"] = stats_spread(runs[2][0], runs[1][0])
    out["pipelined_2"] = {k: (runs[2][1][k].float() - runs[1][1][k].float()).abs().max().item()
                          for k in POOL_KEYS}
    out["pipelined_2_spread"] = stats_spread(runs[2][1], runs[1][1])
    return out


def report_engine(device, total):
    """Phase 8 on the card: print and check ``phase_engine``'s readings of
    full-depth qwen2-0.5b on phase 7's padded traffic; adds its launches to
    ``total``."""
    cfg = get_config("qwen2-0.5b")
    exp = train_experiment(packed=False)
    t_phase = time.perf_counter()
    r = phase_engine(cfg, exp, device)
    pr = r["profile"]
    print(f"[engine] profile of {cfg.name} on {pr['fingerprint']} in {pr['seconds']:.1f}s: "
          + ", ".join(f"{k} b{b} s{s} {t:.4f}s" for (k, b, s), t in sorted(pr["entries"].items()))
          + f"; fitted {pr['profile']}, type scales {pr['scales']}")
    print(f"[engine] {r['plan']}; search and build {r['search_s']:.2f}s, estimated iteration "
          f"{r['estimated_s']:.4f}s")
    print(f"[engine] two hand-driven iterations: {r['hand_s'][0]:.3f}s, {r['hand_s'][1]:.3f}s; "
          f"pools part on {r['hand_parts'] or 'nothing'}; stats spread {r['spread']:.3e}")
    check(not r["hand_parts"], f"two identical hand-driven iterations part on {r['hand_parts']}")
    print(f"[engine] run_iteration {r['engine_s'][0]:.3f}s (then {r['engine_s'][1]:.3f}s) vs "
          f"the hand-driven loop {r['hand_s'][0]:.3f}s; rollout and inference outputs part "
          f"from the hand-driven loop's on {r['engine_parts'] or 'nothing'}; stats "
          f"{r['engine_spread']:.3e} (limit {r['limit']:.3e} = {ENGINE_SPREAD_FACTOR} x "
          f"spread {r['spread']:.3e} + {ENGINE_STATS_FLOOR})")
    check(not r["engine_parts"], f"engine iteration parts from the hand-driven loop on "
          f"{r['engine_parts']}")
    check(r["engine_spread"] <= r["limit"], "engine train stats disagree with the hand loop")
    for name, c in r["calls"].items():
        print(f"[engine] {name}: measured {c['measured']:.4f}s; estimated analytic "
              f"{c['analytic']:.4f}s ({c['measured'] / c['analytic']:.3f}x), profiled "
              f"{c['profiled']:.4f}s ({c['measured'] / c['profiled']:.3f}x); after "
              f"recalibration {c['recalibrated']:.4f}s against the next iteration's "
              f"{c['held_out']:.4f}s ({c['held_out'] / c['recalibrated']:.3f}x)")
        check(all(math.isfinite(v) and v > 0 for v in c.values()), f"{name}: bad times")
    print(f"[engine] stats {r['stats']}")
    print(f"[engine] run(steps=2) at depth 2 {r['depth2_s']:.3f}s, depth 1 {r['depth1_s']:.3f}s; "
          f"iteration 1 parts on {r['pipelined_parts'] or 'nothing'} (stats "
          f"{r['pipelined_spread']:.3e}); iteration 2 largest differences "
          f"{r['pipelined_2']} (stats {r['pipelined_2_spread']:.3e}); depth 2 stats "
          f"{r['depth2_stats']}")
    check(not r["pipelined_parts"], f"depth 2's iteration 1 parts from depth 1's on "
          f"{r['pipelined_parts']}")
    check(r["pipelined_spread"] <= r["limit"], "depth 2's iteration 1 stats disagree")
    want = train_predicted(cfg, exp)
    for key, got in (("hand", r["hand_launches"][0]), ("hand", r["hand_launches"][1]),
                     ("engine", r["engine_launches"]), ("engine", r["engine_launches_2"])):
        check(same_launches(got, want), f"{key} iteration: launches {got} != {want}")
    for depth in (2, 1):
        got, want2 = r[f"depth{depth}_launches"], {k: 2 * v for k, v in want.items()}
        check(same_launches(got, want2), f"depth {depth}: launches {got} != {want2}")
    print(f"[engine] launches per engine iteration {r['engine_launches']} (predicted {want}); "
          f"max_memory_allocated={r['peak_bytes']} bytes; phase 8 "
          f"{time.perf_counter() - t_phase:.1f}s")
    for counts in (*r["hand_launches"], r["engine_launches"], r["engine_launches_2"],
                   r["depth2_launches"], r["depth1_launches"]):
        for k in total:
            total[k] += counts[k]


# ------------------------------------------------------------------ phase 9

SPEC_K = 4  # the draft length the adaptive controller starts from
# Where greedy speculative and plain bf16 outputs of qwen2-0.5b part, the
# larger of both tokens' distances below the top logit, over the top
# |logit| (as RECURRENT_TIE_TOL): the two paths differ in where attention
# rounds to bf16 (the verify runs flash_mha's tile body, generate the
# split-KV decode body) and in the projections' M (B (k + 1) rows against
# B), so a row may part only at such a near-tie: on the H100 (16 x 256
# greedy tokens, 2-layer draft) 14 of 16 rows part, the largest at 1.587e-2
# (about 3 bf16 units of the top logit); a verify one position late reads
# 4.737e-2, one without positions 8.856e-1 (scripts/spec_controls.py,
# PERF.md).  In fp32 the late verify parts 13 of 16 rows, which the fp32
# check's bit-for-bit agreement catches.
SPEC_TIE_TOL = 3e-2
# Speculative logprobs against a teacher-forced forward of the target over
# the committed tokens, and against the plain run's where the tokens agree:
# max |difference| over max |logit|, for the bf16 rollout (greedy and
# sampled) and the spec server.  On the H100 the sound readings are
# 7.682e-3 to 8.489e-3; a verify one position late reads 2.296e-2 (server)
# and 3.378e-2 (rollout), which LOGIT_TOL (5e-2) lets pass, one without
# positions 9.671e-1 (scripts/spec_controls.py, PERF.md); 1.4e-2 sits 1.6x
# from each.
SPEC_LOGPROB_TOL = 1.4e-2


def spec_draft(cfg, layers=2):
    """``cfg`` at full width cut to ``layers`` layers: the draft.  Seeded
    like the target, its weights are the target's embedding and first
    ``layers`` layers (``init_params`` draws them in that order)."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-draft", num_layers=layers,
                               n_superblocks=layers)


def spec_prompts(cfg, device, *, batch=16, prompt_len=128, seed=0):
    """Phase 7's prompt shape: ``batch`` seeded prompts of ``prompt_len``."""
    g = torch.Generator().manual_seed(seed + 900)
    return torch.randint(1, cfg.vocab_size, (batch, prompt_len), generator=g).to(device)


def spec_predicted(cfg, dcfg, k_trace, *, admissions=1):
    """Launches of speculative decoding: per admission, flash_mha in every
    attention layer of the target's and the draft's prefill; per cycle,
    flash_mha in every target layer (the verify over the gathered pool) and
    paged_flash_decode in every draft layer of each of the k + 1 draft
    steps; grouped_ffn in every MoE layer of each of those forwards."""
    cycles, steps = len(k_trace), sum(k + 1 for k in k_trace)
    ta, da = attn_layers(cfg), attn_layers(dcfg)
    out = {"flash_mha": (ta + da) * admissions + ta * cycles, "paged_flash_decode": da * steps}
    if moe_layers(cfg):
        out["grouped_ffn"] = ((moe_layers(cfg) + moe_layers(dcfg)) * admissions
                              + moe_layers(cfg) * cycles + moe_layers(dcfg) * steps)
    return out


def generate_predicted(cfg, new):
    """Launches of one ``generate``: flash_mha in every attention layer of
    the prefill, flash_decode in each of the new - 1 decode steps,
    grouped_ffn in every MoE layer of each."""
    out = {"flash_mha": attn_layers(cfg), "flash_decode": attn_layers(cfg) * (new - 1)}
    if moe_layers(cfg):
        out["grouped_ffn"] = moe_layers(cfg) * new
    return out


def check_outputs(cfg, toks, lps, shape, tag):
    toks, lps = torch.as_tensor(toks), torch.as_tensor(lps)
    check(tuple(toks.shape) == shape, f"{tag}: tokens {tuple(toks.shape)} != {shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"{tag}: token out of range")
    check(bool(torch.isfinite(lps).all() and (lps <= 1e-4).all()), f"{tag}: bad logprob")


def phase_spec(cfg, params, dcfg, dparams, prompts, *, new, impl, modes=("greedy", "sampled"),
               seed=0, temperature=0.8, top_k=16):
    """``spec_generate`` (the adaptive controller from SPEC_K) and then plain
    ``generate`` on the same prompts, greedy and sampled (temperature 0.8,
    top-k 16).  Returns per mode both runs' seconds, launches and outputs,
    the spec stats and the launches' prediction."""
    device = params["embed"]["table"].device
    runs = {}
    for mode in modes:
        kw = {} if mode == "greedy" else dict(temperature=temperature, top_k=top_k)

        def rng():
            return (None if mode == "greedy"
                    else torch.Generator(device=device).manual_seed(seed + 1))
        r = {}
        for name in ("spec", "plain"):
            sync(device)
            reset_launches()
            t0 = time.perf_counter()
            if name == "spec":
                out = SPEC.spec_generate(params, cfg, dparams, dcfg, {"tokens": prompts},
                                         num_new_tokens=new, spec_k=SPEC_K, rng=rng(),
                                         impl=impl, controller=SPEC.SpecController(
                                             init_k=SPEC_K), **kw)
            else:
                out = MDL.generate(params, cfg, {"tokens": prompts}, num_new_tokens=new,
                                   rng=rng(), impl=impl, **kw)
            sync(device)
            r[f"{name}_s"] = time.perf_counter() - t0
            r[f"{name}_launches"] = launches()
            check_outputs(cfg, out["tokens"], out["logprobs"], (len(prompts), new),
                          f"{cfg.name} {name} {mode}")
            r[name] = (out["tokens"].cpu(), out["logprobs"].cpu())
            r.setdefault("stats", out.get("stats"))
        r["predicted"] = spec_predicted(cfg, dcfg, r["stats"]["k_trace"])
        r["plain_predicted"] = generate_predicted(cfg, new)
        runs[mode] = r
    return runs


def teacher_forced(cfg, params, prompts, toks, *, impl, bucketed=False):
    """The logprob of each request's ``toks`` under a teacher-forced
    ``forward`` over its prompt (left-padded with 0 to its bucket when
    ``bucketed``, as the servers prefill it) and ``toks``, one request at a
    time; and the largest |logit| at those positions."""
    device = params["embed"]["table"].device
    lps, scale = [], 0.0
    for pr, t in zip(prompts, toks):
        pr, t = (torch.as_tensor(x).cpu().long() for x in (pr, t))
        if bucketed:
            pr = torch.cat([pr.new_zeros(bucket_of(len(pr)) - len(pr)), pr])
        seq = torch.cat([pr, t])[None].to(device)
        with torch.no_grad():
            h = MDL.forward(params, cfg, {"tokens": seq}, impl=impl)[:, len(pr) - 1:-1]
            lg = MDL.logits_of(params, cfg, h).float()[0]
        scale = max(scale, lg.abs().max().item())
        lps.append(torch.log_softmax(lg, dim=-1).gather(-1, t.to(device)[:, None])[:, 0].cpu())
        del h, lg
    return lps, scale


def logprob_errors(cfg, params, prompts, spec, plain, *, impl, bucketed=False):
    """Speculative outputs ``spec`` = (tokens, logprobs) per request against
    a teacher-forced forward over every request's own tokens
    (``teacher_forced``), and against the plain outputs ``plain`` on the
    requests whose tokens agree: the largest |difference| of each, over the
    largest |logit| of the forward."""
    want, scale = teacher_forced(cfg, params, prompts, spec[0], impl=impl, bucketed=bucketed)

    def worst(pairs):
        return max((float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())
                    for a, b in pairs), default=0.0) / scale
    agree = [(a, b) for a, b, x, y in zip(spec[1], plain[1], spec[0], plain[0])
             if np.array_equal(np.asarray(x), np.asarray(y))]
    return dict(teacher_forced=worst(zip(spec[1], want)), agree=worst(agree),
                n_agree=len(agree), scale=scale)


def spec_partings(cfg, params, prompts, spec_toks, plain_toks):
    """Rows where greedy spec and plain outputs agree, and for the others
    the near-tie at the first parting step (``tie_gaps``), over the top
    |logit|."""
    a, b = spec_toks.numpy(), plain_toks.numpy()
    same = sum(bool((x == y).all()) for x, y in zip(a, b))
    gaps = tie_gaps(cfg, params, [p.cpu().numpy() for p in prompts], a, b)
    return same, {i: g / sc for i, (g, sc) in gaps.items()}


def phase_spec_server(cfg, params, dcfg, dparams, prompts, new, *, impl, n_slots=8,
                      block_size=16, sync_every=4):
    """Phase 5's traffic through ``ContinuousBatchServer`` greedy, plain and
    speculative (the adaptive controller from SPEC_K), admissions counted
    by wrapping ``_admit``.  Returns per run the seconds, stats, launches,
    their prediction and the outputs."""
    device = params["embed"]["table"].device
    kw = dict(n_slots=n_slots, kv_block_size=block_size, max_prompt=max(map(len, prompts)),
              max_new=max(new), impl=impl, sync_every=sync_every)
    runs = {}
    for mode in ("plain", "spec"):
        spec_kw = {} if mode == "plain" else dict(
            draft_params=dparams, draft_cfg=dcfg, spec_k=SPEC_K,
            spec_controller=SPEC.SpecController(init_k=SPEC_K))
        server = ContinuousBatchServer(cfg, params, **kw, **spec_kw)
        admits = [0]

        def counted(*a, _admit=server._admit, **k):
            admits[0] += 1
            return _admit(*a, **k)
        server._admit = counted
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        toks, lps = server.serve(prompts, max_new=new)
        sync(device)
        dt = time.perf_counter() - t0
        st = server.stats()
        for t, lp, n in zip(toks, lps, new):
            check_outputs(cfg, t, lp, (n,), f"{cfg.name} {mode} server")
        if mode == "plain":
            pred = {"flash_mha": attn_layers(cfg) * admits[0],
                    "paged_flash_decode": attn_layers(cfg) * sync_every * st["steps"]}
        else:
            pred = spec_predicted(cfg, dcfg, st["spec_k_trace"], admissions=admits[0])
        runs[mode] = dict(seconds=dt, tokens_per_s=sum(new) / dt, stats=st, launches=launches(),
                          predicted=pred, admissions=admits[0], outputs=toks, logprobs=lps)
    return runs


def spec_iteration_predicted(cfg, dcfg, exp, k_trace):
    """Launches of one PPO iteration with a draft: ``train_predicted`` with
    the rollout's ``generate`` replaced by ``spec_predicted``."""
    out = dict(train_predicted(cfg, exp))
    for k, v in generate_predicted(cfg, exp.gen_len).items():
        out[k] -= v
    for k, v in spec_predicted(cfg, dcfg, k_trace).items():
        out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def phase_spec_engine(cfg, dcfg, exp, device, *, search_iters=300, seed=0, iters=2):
    """An ``RLHFExperiment`` of ``cfg`` as actor and critic with ``dcfg`` as
    its draft on ``Cluster(1, 1, chip=hw.H100)`` (models scaled as
    ``scale_models`` scales them), ``iters`` ``run_iteration``s through
    ``RuntimeEngine``.  Returns per iteration the pool's spec stats and
    train stats, the accept rate the cost model recorded, the launches and
    their prediction, the seconds and each call's, the memory allocated
    before and after it and its peak; whether the draft's parameters are
    bit-equal after the last."""
    cuda = torch.device(device).type == "cuda"
    out = dict(before_bytes=torch.cuda.memory_allocated() if cuda else 0, iters=[])
    e = engine_experiment(cfg, exp, device, search_iters=search_iters, draft_model=dcfg)
    draft0 = [p.detach().clone() for p in adamw.leaves(e.models["draft"].params)]
    out["plan"] = str(e.plan)
    for it in range(iters):
        n = len(e.engine.records)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        held_bytes = torch.cuda.memory_allocated() if cuda else 0
        reset_launches()
        t0 = time.perf_counter()
        pool = e.run_iteration(seed + it)
        sync(device)
        r = dict(seconds=time.perf_counter() - t0, launches=launches(), held_bytes=held_bytes,
                 peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
                 spec_stats=pool.get("spec_stats"), stats={k: pool[k] for k in STAT_KEYS},
                 accept_rate=e.cost.accept_rate("actor", default=-1.0),
                 calls={r.name: r.end - r.start for r in e.engine.records[n:]})
        check_outputs(cfg, pool["seq"][:, exp.prompt_len:], pool["logp"],
                      (exp.batch, exp.gen_len), "engine spec rollout")
        if r["spec_stats"] is not None:
            r["predicted"] = spec_iteration_predicted(cfg, dcfg, exp,
                                                      r["spec_stats"]["k_trace"])
        del pool
        r["after_bytes"] = torch.cuda.memory_allocated() if cuda else 0
        out["iters"].append(r)
    out["draft_equal"] = all(torch.equal(a, b) for a, b in
                             zip(adamw.leaves(e.models["draft"].params), draft0))
    del e, draft0
    free(device)
    return out


def verify_layer_errors(cfg, params, device, *, batch=16, k=SPEC_K, block_size=16,
                        blocks=26, window=64, seed=0):
    """The paged verify attention (``ops.paged_verify_mha``: k + 1 queries
    per row at ragged positions over a shuffled table) and the ragged
    verify layer (``ragged_attn_verify_apply`` with ``window``, rows before
    and after their ring wraps) at ``cfg``'s widths and dtype, impl="cuda"
    against impl="reference": the largest |difference| / (1 + |reference|)
    of each."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = L.dtype_of(cfg)
    hkv, d, kk = cfg.n_kv_heads, cfg.head_dim, k + 1

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dt)
    n = 1 + batch * blocks
    q = randn(batch, kk, cfg.n_heads, d)
    pools = randn(n, block_size, hkv, d), randn(n, block_size, hkv, d)
    tbl = (torch.randperm(n - 1, generator=g, device=device) + 1).reshape(
        batch, blocks).to(torch.int32)
    starts = torch.randint(0, blocks * block_size - kk, (batch,), generator=g, device=device)
    qpos = (starts[:, None] + torch.arange(kk, device=device)[None]).to(torch.int32)
    got, want = (OPS.paged_verify_mha(q, *pools, tbl, q_positions=qpos, impl=impl)
                 for impl in ("cuda", "reference"))
    out = {"paged_verify_mha": _max_err(got, want)[1]}
    spec = dataclasses.replace(cfg.layers[0], window=window)
    p = params["layers"][0]["mixer"]
    x = randn(batch, kk, cfg.d_model)
    ring = randn(batch, window, hkv, d), randn(batch, window, hkv, d)
    starts = torch.randint(0, 3 * window, (batch,), generator=g, device=device)
    qpos = (starts[:, None] + torch.arange(kk, device=device)[None]).to(torch.int32)
    rope = L.rope_tables(qpos, d, cfg.rope_theta)
    ys = [ATT.ragged_attn_verify_apply(p, cfg, spec, x, {"k": ring[0].clone(),
                                                         "v": ring[1].clone()},
                                       rope, qpos, impl=impl) for impl in ("cuda", "reference")]
    out["ragged_attn_verify_apply"] = _max_err(*ys)[1]
    return out


def report_spec(device, total):
    """Phase 9 on the card: a-e of the module docstring; adds the spec
    paths' launches to ``total``."""
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    dcfg = spec_draft(cfg)
    params = make_params(cfg, seed=0, device=device)
    dparams = make_params(dcfg, seed=0, device=device)
    prompts = spec_prompts(cfg, device)
    new = 256

    # a. spec_generate at full depth, bf16, greedy then sampled
    runs = phase_spec(cfg, params, dcfg, dparams, prompts, new=new, impl="cuda")
    for mode, r in runs.items():
        st = r["stats"]
        print(f"[spec] {cfg.name} {mode} spec_generate (draft {dcfg.num_layers} layers, "
              f"{len(prompts)} x {prompts.shape[1]} + {new}): accept_rate="
              f"{st['accept_rate']:.4f} ({st['accepted']}/{st['proposed']}), cycles="
              f"{st['cycles']}, tokens per verify {len(prompts) * new / st['cycles']:.3f} "
              f"({new / st['cycles']:.3f} per row), k_trace {st['k_trace']}; "
              f"{r['spec_s']:.3f}s against generate's {r['plain_s']:.3f}s; launches "
              f"{r['spec_launches']} (predicted {r['predicted']})")
        check(same_launches(r["spec_launches"], r["predicted"]),
              f"spec {mode}: launches {r['spec_launches']} != {r['predicted']}")
        check(same_launches(r["plain_launches"], r["plain_predicted"]),
              f"generate {mode}: launches {r['plain_launches']} != {r['plain_predicted']}")
        check(r["spec_launches"]["flash_mha"] > 0 and r["spec_launches"]["paged_flash_decode"] > 0,
              "spec path launched no verify or draft kernel")
        for k in total:
            total[k] += r["spec_launches"][k]
    same, gaps = spec_partings(cfg, params, prompts, runs["greedy"]["spec"][0],
                               runs["greedy"]["plain"][0])
    worst = max(gaps.values(), default=0.0)
    lp = logprob_errors(cfg, params, prompts, runs["greedy"]["spec"], runs["greedy"]["plain"],
                        impl="cuda")
    print(f"[spec] {cfg.name} bf16 greedy: spec equals generate on {same}/{len(prompts)} "
          f"rows; where they part, the near-tie over the top |logit|: "
          + (", ".join(f"row {i} {g:.3e}" for i, g in gaps.items()) or "none")
          + f" (tol {SPEC_TIE_TOL}); spec logprobs against a teacher-forced forward "
          f"{lp['teacher_forced']:.3e}, against generate's on the rows that agree "
          f"{lp['agree']:.3e}, of max |logit| {lp['scale']:.3f} (tol {SPEC_LOGPROB_TOL})")
    check(worst <= SPEC_TIE_TOL, f"greedy spec parts from generate at {worst:.3e} below the "
          f"top logit, past a near-tie ({SPEC_TIE_TOL})")
    check(lp["teacher_forced"] <= SPEC_LOGPROB_TOL and lp["agree"] <= SPEC_LOGPROB_TOL,
          "greedy spec logprobs disagree with a teacher-forced forward or with generate")
    toks, lps = runs["sampled"]["spec"]
    want, scale = teacher_forced(cfg, params, prompts, toks, impl="cuda")
    err = max(float((a - b).abs().max()) for a, b in zip(lps, want)) / scale
    print(f"[spec] {cfg.name} bf16 sampled: spec logprobs against a teacher-forced forward "
          f"{err:.3e} of max |logit| {scale:.3f} (tol {SPEC_LOGPROB_TOL}, under LOGIT_TOL "
          f"{LOGIT_TOL}); equals greedy on "
          f"{sum(bool((a == b).all()) for a, b in zip(toks, runs['greedy']['spec'][0]))}"
          f"/{len(prompts)} rows")
    check(err <= SPEC_LOGPROB_TOL, "sampled spec logprobs disagree with a teacher-forced forward")

    # e. the verify layers, cuda against reference, at qwen's widths
    errs = verify_layer_errors(cfg, params, device)
    print("[spec] verify layers cuda vs reference (bf16, B 16, k + 1 = 5): "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (tol {KERNEL_TOL})")
    check(all(e <= KERNEL_TOL for e in errs.values()), "a verify layer disagrees")

    # b. the spec server on phase 5's traffic, greedy, against the plain one
    sprompts, snew = continuous_traffic(cfg)
    sr = phase_spec_server(cfg, params, dcfg, dparams, sprompts, snew, impl="cuda")
    for mode, r in sr.items():
        st = {k: v for k, v in r["stats"].items() if k != "completion_order"}
        print(f"[spec] {cfg.name} {mode} ContinuousBatchServer: {r['tokens_per_s']:.1f} tokens/s "
              f"in {r['seconds']:.3f}s, admissions {r['admissions']}, stats {st}; launches "
              f"{r['launches']} (predicted {r['predicted']})")
        check(same_launches(r["launches"], r["predicted"]),
              f"{mode} server: launches {r['launches']} != {r['predicted']}")
        for k in total:
            total[k] += r["launches"][k]
    outs_s, outs_p = sr["spec"]["outputs"], sr["plain"]["outputs"]
    same = sum(bool((a == b).all()) for a, b in zip(outs_s, outs_p))
    gaps = tie_gaps(cfg, params, sprompts, outs_s, outs_p)
    gaps = {i: g / sc for i, (g, sc) in gaps.items()}
    lp = logprob_errors(cfg, params, sprompts, (outs_s, sr["spec"]["logprobs"]),
                        (outs_p, sr["plain"]["logprobs"]), impl="cuda", bucketed=True)
    print(f"[spec] spec server equals the plain server on {same}/{len(sprompts)} requests; "
          "near-ties where they part: " + (", ".join(f"request {i} {g:.3e}"
                                                     for i, g in gaps.items()) or "none")
          + f" (tol {SPEC_TIE_TOL}); spec server logprobs against a teacher-forced forward "
          f"{lp['teacher_forced']:.3e}, against the plain server's on the requests that "
          f"agree {lp['agree']:.3e}, of max |logit| {lp['scale']:.3f} (tol {SPEC_LOGPROB_TOL})")
    check(max(gaps.values(), default=0.0) <= SPEC_TIE_TOL,
          "spec and plain servers part past a near-tie")
    check(lp["teacher_forced"] <= SPEC_LOGPROB_TOL and lp["agree"] <= SPEC_LOGPROB_TOL,
          "spec server logprobs disagree with a teacher-forced forward or the plain server")
    del params, dparams
    free(device)

    # the fp32 check: 2 layers at full width, the draft the target's first
    small = shallow(cfg, 2, dtype="float32")
    dsmall = spec_draft(small, 1)
    p32, d32 = make_params(small, seed=1, device=device), make_params(dsmall, seed=1,
                                                                      device=device)
    r32 = phase_spec(small, p32, dsmall, d32, prompts, new=64, impl="cuda",
                     modes=("greedy",))["greedy"]
    same32 = sum(bool((a == b).all()) for a, b in zip(r32["spec"][0], r32["plain"][0]))
    lp32 = float((r32["spec"][1] - r32["plain"][1]).abs().max())
    print(f"[spec] fp32 {small.num_layers} layers, draft {dsmall.num_layers}: greedy spec "
          f"equals generate on {same32}/{len(prompts)} rows, logprobs within {lp32:.3e} "
          f"(tol {FP32_LOGIT_TOL}); accept_rate {r32['stats']['accept_rate']:.4f}, cycles "
          f"{r32['stats']['cycles']}")
    check(same32 == len(prompts), "fp32 greedy spec tokens differ from generate")
    check(lp32 <= FP32_LOGIT_TOL, "fp32 greedy spec logprobs differ from generate")
    check(same_launches(r32["spec_launches"], r32["predicted"]), "fp32 spec launches")
    for k in total:
        total[k] += r32["spec_launches"][k]
    del p32, d32
    free(device)

    # c. granite-moe-1b-a400m as target with a 2-layer granite draft, greedy
    gcfg = get_config("granite-moe-1b-a400m")
    gd = spec_draft(gcfg)
    gp, gdp = make_params(gcfg, seed=0, device=device), make_params(gd, seed=0, device=device)
    gprompts = spec_prompts(gcfg, device)
    gr = phase_spec(gcfg, gp, gd, gdp, gprompts, new=64, impl="cuda", modes=("greedy",))
    r = gr["greedy"]
    same, gaps = spec_partings(gcfg, gp, gprompts, r["spec"][0], r["plain"][0])
    print(f"[spec] {gcfg.name} greedy spec_generate: accept_rate "
          f"{r['stats']['accept_rate']:.4f}, cycles {r['stats']['cycles']}, k_trace "
          f"{r['stats']['k_trace']}; {r['spec_s']:.3f}s against generate's {r['plain_s']:.3f}s; "
          f"equals generate on {same}/{len(gprompts)} rows (near-ties where they part, "
          "printed: " + (", ".join(f"row {i} {g:.3e}" for i, g in gaps.items()) or "none")
          + f"); launches {r['spec_launches']} (predicted {r['predicted']})")
    check(same_launches(r["spec_launches"], r["predicted"]), "granite spec launches")
    check(r["spec_launches"].get("grouped_ffn", 0) > 0, "granite's verify ran no grouped_ffn")
    for k in total:
        total[k] += r["spec_launches"][k]
    del gp, gdp
    free(device)

    # d. RLHFExperiment with the draft, one iteration through RuntimeEngine
    exp = train_experiment(packed=False)
    en = phase_spec_engine(cfg, dcfg, exp, device)
    print(f"[spec] RLHFExperiment with a {dcfg.num_layers}-layer draft, {en['plan']}")
    for it, r in enumerate(en["iters"]):
        check(r["spec_stats"] is not None, "the engine iteration has no spec_stats")
        st = r["spec_stats"]
        print(f"[spec] run_iteration {it}: {r['seconds']:.3f}s (calls " + ", ".join(
                  f"{n} {s:.3f}s" for n, s in r["calls"].items())
              + f"); spec_stats accept_rate {st['accept_rate']:.4f}, cycles {st['cycles']}, "
              f"k_trace[:8] {st['k_trace'][:8]}; the cost model's accept rate "
              f"{r['accept_rate']:.4f}; actor {r['stats']['actor_stats']}; critic "
              f"{r['stats']['critic_stats']}; launches {r['launches']} (predicted "
              f"{r['predicted']})")
        check(r["accept_rate"] >= 0.0, "the cost model recorded no accept rate")
        check(all(math.isfinite(v) for s in r["stats"].values() for v in s.values()),
              "non-finite train stats")
        check(same_launches(r["launches"], r["predicted"]),
              f"engine spec iteration: launches {r['launches']} != {r['predicted']}")
        for k in total:
            total[k] += r["launches"][k]
        print(f"[spec] run_iteration {it} memory: memory_allocated {r['held_bytes']} bytes "
              f"before, {r['after_bytes']} after (its pool dropped), max_memory_allocated "
              f"{r['peak_bytes']} bytes during it")
    print(f"[spec] draft unchanged after {len(en['iters'])} iterations: {en['draft_equal']}; "
          f"memory_allocated before the experiment was built {en['before_bytes']} bytes")
    check(en["draft_equal"], "the draft's parameters changed")
    print(f"[spec] phase 9 {time.perf_counter() - t_phase:.1f}s")


# ------------------------------------------------------------------ phase 10

LLAMA = "llama-7b"
ALL4 = (0, 1, 2, 3)
# 10b: llama-7b's tree on 4 logical devices, moved in this order; each
# move's source is the previous move's destination (the clone leaves it):
# (name, source (dp, tp, logical ids), destination (dp, tp, ids), clone)
REALLOC_MOVES = (
    ("clone gen->train", (1, 4, ALL4), (2, 2, ALL4), True),
    ("gen->train", (1, 4, ALL4), (2, 2, ALL4), False),
    ("train->gen", (2, 2, ALL4), (1, 4, ALL4), False),
    ("gen->tp2 {0,1}", (1, 4, ALL4), (1, 2, (0, 1)), False),
    ("cross {0,1}->{2,3}", (1, 2, (0, 1)), (1, 2, (2, 3)), False),
)
# 10c's prefetch toy moves the actor from d4 (gen) to d2t2 (train)
PREFETCH_MOVE = ("d4->d2t2", (4, 1, ALL4), (2, 2, ALL4))
# (n_moved, n_aliased, moved_bytes, total_bytes) of each move on llama-7b's
# bf16 tree (291 leaves, 16,060,522,496 bytes; the 65 norms are replicated
# in every layout and alias where the device list stays): the JAX
# executor's split of the same spec trees, held by
# tests/test_torch_realloc_exec.py.
_SAME_DEVICES = (226, 65, 16_059_990_016, 16_060_522_496)
_OTHER_DEVICES = (291, 0, 16_060_522_496, 16_060_522_496)
LLAMA_MOVE_COUNTS = {"clone gen->train": _SAME_DEVICES, "gen->train": _SAME_DEVICES,
                     "train->gen": _SAME_DEVICES, "gen->tp2 {0,1}": _OTHER_DEVICES,
                     "cross {0,1}->{2,3}": _OTHER_DEVICES, "d4->d2t2": _SAME_DEVICES}


def strategy_layouts(params, dp, tp, ids, device):
    """``params``' layout tree for a (dp, tp) strategy over the logical
    devices ``ids``: a (data, model) mesh, ``ShardingRules``' specs (FSDP
    over data, TP over model) sanitized for it."""
    mesh = Mesh(np.reshape(ids, (dp, tp)), ("data", "model"), device=device)
    specs = SHD.sanitize_specs(SHD.param_specs(params, SHD.ShardingRules()), params, mesh)
    return tree_map(lambda s: Layout(mesh, s), specs)


def strategy_assignment(dp, tp, ids):
    """The planner's ``Assignment`` of a strategy over consecutive ids."""
    return Assignment(DeviceMesh(0, 1, ids[0], len(ids)), ParallelStrategy(dp, tp, 1, 1))


def report_llama(device, total):
    """10a: llama-7b at full width on the card (seeded random bf16 weights
    drawn on the card, embedding scaled by EMBED_SCALE): phase 3's cuda vs
    reference logits and paged decode, then one greedy ``BatchServer.serve``
    of phase 4's 8 requests, 64 new tokens each, its launches held to the
    prediction and added to ``total``.  Returns the parameters."""
    cfg = get_config(LLAMA)
    t0 = time.perf_counter()
    params = make_params(cfg, seed=0, device=device)
    sync(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[llama] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {n_params} parameters (param_count() {cfg.param_count()} also "
          f"counts a third norm per layer) drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s; memory_allocated={torch.cuda.memory_allocated()}")
    report_slice(cfg, params)
    prompts = serve_prompts(cfg)
    want = predicted_launches(cfg, prompts, 64)
    r = phase_serve(cfg, params, prompts, impl="cuda", new=64, modes=("greedy",))["greedy"]
    print(f"[llama] serve greedy: {len(prompts)} requests (prompt lengths "
          f"{sorted(len(p) for p in prompts)}), {r['tokens_per_s']:.1f} tokens/s in "
          f"{r['seconds']:.3f}s; launches {r['launches']} (predicted {want})")
    check(same_launches(r["launches"], want), f"llama serve: launches {r['launches']} != {want}")
    for k in total:
        total[k] += r["launches"][k]
    return params


def phase_realloc(params, device, moves=REALLOC_MOVES):
    """10b: ``params`` placed on the first move's source layout, then the
    moves in order.  Per move: the task's split, whether ``done()`` was
    already true before ``wait()``, the seconds, the memory the move added
    at its peak over what it started with (summed over the cards), the
    leaves gathered bit-equal to ``params``, the replicated norms aliased
    by identity, and for the clone the source still valid."""
    cards = range(torch.cuda.device_count()) if torch.device(device).type == "cuda" else ()
    norms = [path for path, _ in flat_paths(params) if path[-1] == "scale"]
    lay = {}

    def layouts(s):
        if s not in lay:
            lay[s] = strategy_layouts(params, *s, device)
        return lay[s]
    current = place_tree(params, layouts(moves[0][1]))
    out = []
    for name, s, d, clone in moves:
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        start = sum(torch.cuda.memory_allocated(c) for c in cards)
        t0 = time.perf_counter()
        task = RX.prefetch_reshard(current, layouts(d), donate=not clone)
        polled = task.done()
        res = task.wait()
        seconds = time.perf_counter() - t0
        peak = sum(torch.cuda.max_memory_allocated(c) for c in cards) - start
        same = all(torch.equal(x.gather(p.device), p) for x, p in zip(tree_leaves(res),
                                                                     tree_leaves(params)))
        src_leaves, dst_leaves = dict(flat_paths(current)), dict(flat_paths(res))
        norms_aliased = all(dst_leaves[p] is src_leaves[p] for p in norms)
        r = dict(name=name, n_moved=task.n_moved, n_aliased=task.n_aliased,
                 moved_bytes=task.moved_bytes, total_bytes=task.total_bytes,
                 elapsed_s=task.elapsed_s, seconds=seconds, done_before_wait=polled,
                 peak_added=peak, bit_equal=same, norms_aliased=norms_aliased,
                 src=s, dst=d, clone=clone)
        if clone:
            r["source_valid"] = all(torch.equal(x.gather(p.device), p) for x, p in
                                    zip(tree_leaves(current), tree_leaves(params)))
            del res
        else:
            current = res
        out.append(r)
    return out


def flat_paths(tree, path=()):
    """(path, leaf) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def report_realloc(cfg, params, device):
    """10b on the card: print and check ``phase_realloc``'s moves of
    llama-7b's tree; the seconds beside the copy bound and the cost
    model's schedule time for the move on one 4-card H100 node, folded by
    ``record_realloc``."""
    cluster = Cluster(1, 4, chip=hw.H100, intra_node_bw=450e9, inter_node_bw=50e9)
    cost = CostModel(cluster)
    peaks = {}
    for r in phase_realloc(params, device):
        want = LLAMA_MOVE_COUNTS[r["name"]]
        got = (r["n_moved"], r["n_aliased"], r["moved_bytes"], r["total_bytes"])
        sched = REALLOC.remap_schedule(cfg, strategy_assignment(*r["src"]),
                                       strategy_assignment(*r["dst"]), cluster)
        cost.record_realloc(sched.time, r["elapsed_s"], r["moved_bytes"])
        bound_s = 2 * r["moved_bytes"] / PEAK_BYTES
        print(f"[realloc] {r['name']}: moved {r['n_moved']} leaves, aliased "
              f"{r['n_aliased']}, {r['moved_bytes']} of {r['total_bytes']} bytes (the JAX "
              f"executor's split: {want}); elapsed_s={r['elapsed_s']:.4f} "
              f"({r['moved_bytes'] / r['elapsed_s'] / 1e9:.1f} GB/s moved; copy bound "
              f"{bound_s:.4f}s = 2 x moved bytes / {PEAK_BYTES / 1e12} TB/s); done() before "
              f"wait(): {r['done_before_wait']}; remap_schedule time on a 4-card H100 node "
              f"{sched.time:.4f}s ({sched.total_bytes:.0f} bytes); peak added "
              f"{r['peak_added']} bytes; bit-equal {r['bit_equal']}; norms aliased "
              f"{r['norms_aliased']}" + (f"; source valid {r['source_valid']}"
                                         if r["clone"] else ""))
        check(got == want, f"{r['name']}: split {got} != {want}")
        check(r["bit_equal"], f"{r['name']}: a gathered leaf differs from the source")
        check(r["clone"] or r["n_aliased"] == 0 or r["norms_aliased"],
              f"{r['name']}: a replicated norm was copied")
        check(not r["clone"] or r["source_valid"], f"{r['name']}: the clone's source changed")
        peaks[r["name"]] = r["peak_added"]
    cost.refit()
    print(f"[realloc] peak memory added: donating gen->train {peaks['gen->train']} bytes, "
          f"cloning it {peaks['clone gen->train']} bytes; the cost model's realloc scale "
          f"refit from the moves (measured / schedule, median): {cost.realloc_scale:.3f}")
    check(peaks["gen->train"] < peaks["clone gen->train"],
          "donation did not lower the move's peak memory below the clone's")


# 10c's engine toys -------------------------------------------------------

# The prefetch toy's other call waits at most this long for the engine to
# dispatch the actor's prefetch: the deadline only bounds a run in which the
# engine never prefetches, which the toy's prefetch_hits check then reports.
PREFETCH_WAIT_S = 60.0


def layout_prefetch_toy(actor, device, *, physical=True):
    """``test_realloc_fastpath.py``'s prefetch-hit toy with ``actor`` as the
    actor's tree: gen and other on 4 devices data-parallel (d4, FSDP over
    data), train on d2t2 of the same devices; other stays open until the
    actor's move to train is dispatched (``PREFETCH_WAIT_S`` at most; 0.3 s
    logically, where nothing is prefetched), so that train, which waits
    for other's output, finds the move prefetched however loaded the host
    is (a fixed sleep left it to the host's timing).  ``ex_train`` checks
    that every leaf it receives is a ``ShardedTensor`` on (a layout
    equivalent to) the train layout and computes the largest value over
    the blocks.  With ``physical=False``
    the same toy runs with ``sharding_for=None`` on plain tensors."""
    cluster = Cluster(n_nodes=1, devs_per_node=4)
    w = DFG.Workload(batch=4, prompt_len=8, gen_len=8)
    calls = [DFG.FunctionCall("gen", "actor", DFG.GENERATE, None, w, inputs=("prompts",),
                              outputs=("seq",)),
             DFG.FunctionCall("other", "aux", DFG.INFERENCE, None, w, inputs=("seq",),
                              outputs=("x",)),
             DFG.FunctionCall("train", "actor", DFG.INFERENCE, None, w, inputs=("x",),
                              outputs=("y",))]
    dfg = DFG.DataflowGraph(calls, "toy")
    (_, gen, trn) = PREFETCH_MOVE
    plan = ExecutionPlan({"gen": strategy_assignment(*gen), "other": strategy_assignment(*gen),
                          "train": strategy_assignment(*trn)}, cluster)
    gen_l = strategy_layouts(actor, *gen, device)
    trn_l = strategy_layouts(actor, *trn, device)
    seen = []

    def sharding_for(model_name, asg):
        if model_name != "actor":
            return None
        return trn_l if asg.strategy.tp == 2 else gen_l

    def ex_train(ms, inputs):
        if physical:
            seen.append(all(isinstance(x, ShardedTensor) and x.layout.is_equivalent_to(lay, x.ndim)
                            for x, lay in zip(tree_leaves(ms.params), tree_leaves(trn_l))))
            return {"y": max(float(b.max()) for x in tree_leaves(ms.params)
                             for _, _, b in x.shards)}
        return {"y": max(float(x.max()) for x in tree_leaves(ms.params))}

    params = place_tree(actor, gen_l) if physical else actor
    models = {"actor": RT.ModelState(params, assignment=plan.assignments["gen"]),
              "aux": RT.ModelState({})}

    def ex_other(ms, inputs):
        if not physical:
            time.sleep(0.3)
            return {"x": 2}
        deadline = time.monotonic() + PREFETCH_WAIT_S
        while models["actor"].prefetch is None and time.monotonic() < deadline:
            time.sleep(0.01)
        return {"x": 2}
    executors = {"gen": lambda ms, i: {"seq": 1}, "other": ex_other, "train": ex_train}
    eng = RT.RuntimeEngine(dfg, plan, executors, models,
                           sharding_for=sharding_for if physical else None)
    t0 = time.perf_counter()
    out = eng.run_iteration({"prompts": 0})
    seconds = time.perf_counter() - t0
    expected = moved_bytes_between(actor, gen_l, trn_l)
    return dict(y=out["y"], seconds=seconds, layouts_seen=seen,
                prefetch_hits=eng.stats()["prefetch_hits"],
                records={r.name: r.realloc_bytes for r in eng.records},
                realloc_s={r.name: r.realloc_s for r in eng.records},
                expected_bytes=expected if physical else 0)


def moved_bytes_between(tree, src, dst):
    """The global bytes of ``tree``'s leaves whose two layouts differ: the
    bytes a reshard between them moves."""
    return sum(x.numel() * x.element_size() for x, a, b in
               zip(tree_leaves(tree), tree_leaves(src), tree_leaves(dst))
               if not a.is_equivalent_to(b, x.ndim))


def layout_pipeline_toy(actor, critic_cfg, device, *, depth, physical=True, steps=2):
    """``benchmarks/pipeline_bench.py``'s toy with real trees: the actor
    (``actor``) on devices 0-1, generating d2 and training t2, where its
    first half of layers (with the embedding) changes layout and the rest
    stays on the gen layout; reward and critic on devices 2-3; the critic
    is ``critic_cfg``'s value model with its AdamW state (fp32 master, m,
    v) on ``opt_sharding_for``, placed at start on the t2 layout of devices
    2-3 so that its first train call moves it onto d2.  The executors
    compute on the blocks: actor_train moves the final norm, critic_train
    takes an AdamW-shaped elementwise step of every leaf.  Returns the
    pools, the records' moved bytes, the expected ones and the final
    values (gathered)."""
    cluster = Cluster(n_nodes=1, devs_per_node=4)
    w = DFG.Workload(batch=4, prompt_len=8, gen_len=8)
    calls = [DFG.FunctionCall("gen", "actor", DFG.GENERATE, None, w, ("prompts",), ("seq",),
                              trainable=True),
             DFG.FunctionCall("rew", "reward", DFG.INFERENCE, None, w, ("seq",), ("r",)),
             DFG.FunctionCall("atrain", "actor", DFG.TRAIN, None, w, ("r",), ("a_out",),
                              trainable=True),
             DFG.FunctionCall("ctrain", "critic", DFG.TRAIN, None, w, ("r",), ("c_out",),
                              trainable=True)]
    dfg = DFG.DataflowGraph(calls, "toy")
    a_gen, a_trn, b_asg = (2, 1, (0, 1)), (1, 2, (0, 1)), (2, 1, (2, 3))
    plan = ExecutionPlan({"gen": strategy_assignment(*a_gen), "rew": strategy_assignment(*b_asg),
                          "atrain": strategy_assignment(*a_trn),
                          "ctrain": strategy_assignment(*b_asg)}, cluster)
    half = len(actor["layers"]) // 2

    def actor_layouts(s):
        moving, staying = strategy_layouts(actor, *s, device), strategy_layouts(actor, *a_gen,
                                                                                 device)
        out = dict(staying, layers=moving["layers"][:half] + staying["layers"][half:])
        out["embed"] = moving["embed"]
        return out
    gen_l, trn_l = actor_layouts(a_gen), actor_layouts(a_trn)
    critic = MDL.init_params(critic_cfg, seed=1, device=device, head="value")
    opt = adamw.init(adamw.AdamWConfig(), critic)
    c_l = strategy_layouts(critic, *b_asg, device)
    c_start = strategy_layouts(critic, 1, 2, (2, 3), device)
    expected_opt = 3 * moved_bytes_between(opt["m"], c_start, c_l)  # m, v, master: fp32

    def opt_layouts(lay):
        return {"step": None, "m": lay, "v": lay, "master": lay}

    def sharding_for(model_name, asg):
        if model_name == "actor":
            return trn_l if asg == plan.assignments["atrain"] else gen_l
        return c_l if model_name == "critic" else None

    def opt_sharding_for(model_name, asg):
        return opt_layouts(c_l) if model_name == "critic" else None

    if physical:
        a_params = place_tree(actor, gen_l)
        critic, opt = place_tree(critic, c_l), place_tree(opt, opt_layouts(c_start))
    else:
        a_params = dict(actor, final_norm={"scale": actor["final_norm"]["scale"].clone()})
    models = {"actor": RT.ModelState(a_params, assignment=plan.assignments["gen"]),
              "reward": RT.ModelState({}),
              "critic": RT.ModelState(critic, opt, assignment=plan.assignments["ctrain"])}

    def each(x, fn, *others):
        """``fn`` on a tensor, or block by block on a ShardedTensor (the
        others on the same layout)."""
        if isinstance(x, ShardedTensor):
            blocks = {d: fn(b, *(o.blocks[d] for o in others)) for d, b in x.blocks.items()}
            return ShardedTensor(x.shape, next(iter(blocks.values())).dtype, x.layout, blocks)
        return fn(x, *others)

    def mk(name, outs, update=None):
        def ex(ms, inputs):
            if update is not None:
                update(ms, inputs)
            return {k: (name, tuple(sorted((kk, vv) for kk, vv in inputs.items()
                                           if isinstance(vv, (int, tuple, str)))))
                    for k in outs}
        return ex

    def atrain(ms, inputs):
        if physical:
            check(all(x.layout.is_equivalent_to(lay, x.ndim)
                      for x, lay in zip(tree_leaves(ms.params), tree_leaves(trn_l))),
                  "actor_train received a leaf off its train layout")
        scale = ms.params["final_norm"]["scale"]
        ms.params = dict(ms.params, final_norm={"scale": each(scale, lambda s: s * 0.5 + 0.25)})

    def ctrain(ms, inputs):
        if physical:
            check(all(x.layout.is_equivalent_to(lay, x.ndim)
                      for x, lay in zip(tree_leaves(ms.opt_state["m"]), tree_leaves(c_l))),
                  "critic_train received a moment off its train layout")
        g = 1e-3 * (1 + len(inputs))
        m = tree_map(lambda x: each(x, lambda b: b * 0.9 + 0.1 * g), ms.opt_state["m"])
        v = tree_map(lambda x: each(x, lambda b: b * 0.95 + 0.05 * g * g), ms.opt_state["v"])
        master = tree_map(lambda x, mm, vv: each(x, lambda b, bm, bv: b - 1e-4 * bm / (
            bv.sqrt() + 1e-8), mm, vv), ms.opt_state["master"], m, v)
        ms.params = tree_map(lambda p, x: each(x, lambda b: b.to(p.dtype)), ms.params, master)
        ms.opt_state = {"step": ms.opt_state["step"] + 1, "m": m, "v": v, "master": master}

    executors = {"gen": mk("gen", ("seq",)), "rew": mk("rew", ("r",)),
                 "atrain": mk("atrain", ("a_out",), atrain),
                 "ctrain": mk("ctrain", ("c_out",), ctrain)}
    eng = RT.RuntimeEngine(dfg, plan, executors, models,
                           sharding_for=sharding_for if physical else None,
                           opt_sharding_for=opt_sharding_for if physical else None,
                           pipeline_depth=depth)
    t0 = time.perf_counter()
    pools = eng.run(lambda t: {"prompts": t}, steps=steps)
    seconds = time.perf_counter() - t0

    def whole(tree):  # every tensor leaf gathered onto ``device``
        return [x.gather(device) if isinstance(x, ShardedTensor) else x.detach().to(device)
                for x in tree_leaves(tree) if isinstance(x, (torch.Tensor, ShardedTensor))]
    st = eng.stats()
    return dict(pools=pools, seconds=seconds, prefetch_hits=st["prefetch_hits"],
                records=sorted((r.name, r.iteration, r.realloc_bytes) for r in eng.records),
                expected_bytes=moved_bytes_between(actor, gen_l, trn_l),
                opt_bytes=st["opt_state_resharded_bytes"],
                expected_opt_bytes=expected_opt,
                actor_norm=whole(models["actor"].params["final_norm"]),
                critic=whole(models["critic"].params),
                critic_opt=whole(models["critic"].opt_state))


def report_layout_engine(actor, device, critic_cfg=None, counts=LLAMA_MOVE_COUNTS):
    """10c on the card: ``RuntimeEngine`` with ``sharding_for`` and
    ``opt_sharding_for``: the prefetch toy on llama-7b's tree (physical
    against logical), then the pipeline toy with llama-7b as the actor and
    qwen2-0.5b's value model (``critic_cfg``) with its AdamW state as the
    critic, at depth 1 and 2 and logically; pools, values and moved bytes
    held (the prefetch toy's also to ``counts``, the JAX executor's split
    of llama-7b's tree)."""
    t_phase = time.perf_counter()
    phys = layout_prefetch_toy(actor, device)
    free(device)
    logi = layout_prefetch_toy(actor, device, physical=False)
    want = counts[PREFETCH_MOVE[0]][2] if counts else phys["expected_bytes"]
    print(f"[layouts] prefetch toy ({PREFETCH_MOVE[0]} on llama-7b): y={phys['y']} (logical "
          f"{logi['y']}), prefetch_hits={phys['prefetch_hits']}, realloc bytes per call "
          f"{phys['records']} (layout count {phys['expected_bytes']}, the JAX executor's "
          f"{want}), realloc_s {phys['realloc_s']}, {phys['seconds']:.3f}s (logical "
          f"{logi['seconds']:.3f}s)")
    check(phys["layouts_seen"] == [True], "ex_train received leaves off the train layout")
    check(phys["prefetch_hits"] >= 1, "the actor's move was not prefetched")
    check(phys["y"] == logi["y"], "the physical toy computed another value than the logical")
    check(phys["records"]["train"] == phys["expected_bytes"] == want,
          f"moved {phys['records']['train']} bytes, the layouts count {want}")
    ccfg = critic_cfg or get_config("qwen2-0.5b")
    runs = {}
    for key, kw in (("depth1", dict(depth=1)), ("depth2", dict(depth=2)),
                    ("logical", dict(depth=1, physical=False))):
        runs[key] = layout_pipeline_toy(actor, ccfg, device, **kw)
        free(device)
    d1, d2, lg = runs["depth1"], runs["depth2"], runs["logical"]
    for key, r in runs.items():
        print(f"[layouts] pipeline toy {key}: run(steps=2) {r['seconds']:.3f}s, "
              f"prefetch_hits={r['prefetch_hits']}, realloc bytes per record {r['records']}, "
              f"opt state moved {r['opt_bytes']} bytes")
    check(d1["pools"] == d2["pools"] == lg["pools"], "the toy's pools differ between runs")
    for name in ("actor_norm", "critic", "critic_opt"):
        for r, other in ((d1, lg), (d2, d1)):
            check(len(r[name]) == len(other[name]) and all(
                torch.equal(a, b) for a, b in zip(r[name], other[name])),
                f"pipeline toy: {name} differs between runs")
    for r in (d1, d2):
        actor_moves = [b for n, t, b in r["records"] if n == "atrain" or (n == "gen" and t)]
        check(all(b == r["expected_bytes"] for b in actor_moves),
              f"actor moves {actor_moves} != the layout count {r['expected_bytes']}")
        check(r["opt_bytes"] == r["expected_opt_bytes"] > 0,
              f"opt state moved {r['opt_bytes']} != {r['expected_opt_bytes']}")
    print(f"[layouts] pools equal at depth 1, depth 2 and logical; final actor norm, critic "
          f"and its AdamW state bit-equal to the logical run; actor moves "
          f"{d1['expected_bytes']} bytes per reshard (half of its layers), the critic's "
          f"AdamW state {d1['expected_opt_bytes']} once; phase 10c "
          f"{time.perf_counter() - t_phase:.1f}s")


# ------------------------------------------------------------------ phase 11
# Compute on sharded layouts, on logical devices of the card: every rank's
# block its own buffer, collectives real copies and sums between them
# (``parallel/collectives.py``); ``COLL.STATS`` counts the bytes they move.
TRAIN_LAYOUT = (2, 2)   # (a): (data, model), FSDP 2 x TP 2, ShardingRules()
GEN_LAYOUT = (1, 4)     # (b): phase 10's generation layout, TP 4
EP_LAYOUT = (1, 2)      # (c): experts over 2 ranks
PIPE_STAGES = 4         # (d)
PIPE_MICRO = 8


def shard_params(params, dp, tp, device):
    """(mesh, ``params`` placed on a (dp, tp) (data, model) mesh of logical
    devices 0 .. dp * tp - 1 by ``ShardingRules()``, sanitized)."""
    lay = strategy_layouts(params, dp, tp, tuple(range(dp * tp)), device)
    return tree_leaves(lay)[0].mesh, place_tree(params, lay)


def same(a, b) -> bool:
    """``a`` and ``b`` bit-equal, wherever each lies (logical devices may
    sit on different cards)."""
    return torch.equal(a, b.to(a.device))


def replicas_equal(tree) -> bool:
    """Every block of every ``ShardedTensor`` leaf bit-equal to the first
    block that holds the same region."""
    for st in tree_leaves(tree):
        first = {}
        for _, reg, blk in st.shards:
            if not same(first.setdefault(reg, blk), blk):
                return False
    return True


def lm_batch(cfg, device, *, batch=16, prompt=128, new=256, seed=0):
    """An LM-loss batch of phase 6's traffic: random tokens, labels the next
    token, the mask 0 over the prompt and 1 over the first ``cut`` of the
    ``new`` generated tokens (a seeded cut per row, so the replicas' mask
    counts differ)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (batch, prompt + new))
    labels = np.roll(toks, -1, axis=1)
    cut = rng.integers(new // 16, new + 1, batch)
    mask = np.zeros((batch, prompt + new), np.float32)
    for i, c in enumerate(cut):
        mask[i, prompt:prompt + c] = 1.0
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "mask": torch.from_numpy(mask).to(device)}


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _cards(device):
    return range(torch.cuda.device_count()) if torch.device(device).type == "cuda" else ()


def peak_reset(device):
    for c in _cards(device):
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)


def peak(device) -> int:
    """The peak memory allocated since ``peak_reset``, summed over the
    cards (0 on the host)."""
    out = 0
    for c in _cards(device):
        torch.cuda.synchronize(c)
        out += torch.cuda.max_memory_allocated(c)
    return out


def moment_agreement(got, want):
    """Two AdamW first moments after one step (m = (1 - b1) x the clipped
    gradient): |m - m_ref| / |m_ref| (Frobenius) over the tree and the
    worst leaf, its name; ``got`` may hold ``ShardedTensor`` leaves."""
    names = leaf_names(want)
    d2 = r2 = 0.0
    worst = (0.0, "")
    for name, g, w in zip(names, adamw.leaves(got), adamw.leaves(want)):
        g = g.gather(w.device) if isinstance(g, ShardedTensor) else g
        a, b = square_norms(g, w)
        d2, r2 = d2 + a, r2 + b
        worst = max(worst, (math.sqrt(a / max(b, 1e-60)), name))
    return math.sqrt(d2 / max(r2, 1e-60)), worst


def phase_tp_train(cfg, params, batch, layout, *, impl, opt_cfg=adamw.AdamWConfig()):
    """11a: one single-device ``make_train_step`` and one sharded one on a
    ``layout`` (dp, tp) mesh (``ShardingRules()``: FSDP over data, TP over
    model), from the same parameters and batch.  Returns both runs' loss
    and grad_norm, ``moment_agreement`` of their first moments, whether
    every replica of the sharded parameters and state is bit-equal, the
    sharded parameters finite and moved, seconds, peak memory, the bytes
    the collectives moved and each run's launches; ``trained`` is the
    sharded parameter tree after the step."""
    ref, m_ref = single_train(cfg, params, batch, impl=impl, opt_cfg=opt_cfg)
    return sharded_train(cfg, params, batch, layout, ref, m_ref, impl=impl, opt_cfg=opt_cfg)


def single_train(cfg, params, batch, *, impl, opt_cfg=adamw.AdamWConfig(),
                 make_step=PSTEPS.make_train_step, **kw):
    """One single-device ``make_train_step`` (``kw``: its ``max_seqlen``;
    ``make_step`` another step of its signature) from a copy of
    ``params``: ({seconds, peak, launches, loss, grad_norm}, the AdamW
    first moment)."""
    device = params["embed"]["table"].device
    single = clone_tree(params)
    for t in adamw.leaves(single):
        t.requires_grad_(True)
    state = adamw.init(opt_cfg, single)
    reset_launches()
    peak_reset(device)
    t0 = time.perf_counter()
    _, state, m1 = make_step(cfg, opt_cfg, impl=impl, **kw)(single, state, batch)
    sync(device)
    ref = dict(seconds=time.perf_counter() - t0, peak=peak(device), launches=launches(),
               loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]))
    m_ref = state["m"]
    del single, state
    free(device)
    return ref, m_ref


def sharded_train(cfg, params, batch, layout, ref, m_ref, *, impl,
                  opt_cfg=adamw.AdamWConfig(), device=None, **kw):
    """``phase_tp_train``'s sharded step, held to ``single_train``'s run
    ``ref`` and its first moment ``m_ref``, its logical devices on
    ``device`` (default: the parameters')."""
    device = device or params["embed"]["table"].device
    mesh, sharded = shard_params(params, *layout, device)
    before = clone_tree(tree_map(lambda st: st.blocks[mesh.device_ids[0]], sharded))
    sstate = adamw.init(opt_cfg, sharded)
    COLL.reset_stats()
    reset_launches()
    peak_reset(device)
    t0 = time.perf_counter()
    sharded, sstate, m2 = PSTEPS.make_train_step(cfg, opt_cfg, impl=impl, mesh=mesh, **kw)(
        sharded, sstate, batch)
    sync(device)
    out = dict(seconds=time.perf_counter() - t0, peak=peak(device), launches=launches(),
               bytes=COLL.STATS["bytes"], copies=COLL.STATS["copies"], record=dict(COLL.RECORD),
               loss=float(m2["loss"]), grad_norm=float(m2["grad_norm"]), ref=ref)
    out["global_err"], (out["worst_leaf_err"], out["worst_leaf"]) = moment_agreement(
        sstate["m"], m_ref)
    out["loss_err"] = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
    out["grad_norm_err"] = abs(out["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    out["replicas_equal"] = replicas_equal(sharded) and replicas_equal(sstate["m"])
    after = tree_map(lambda st: st.blocks[mesh.device_ids[0]], sharded)
    out["finite"] = all(bool(torch.isfinite(t).all()) for t in tree_leaves(after))
    out["moved"] = any(not torch.equal(a, b) for a, b in zip(tree_leaves(after),
                                                             tree_leaves(before)))
    out["trained"] = sharded
    return out


def tp_train_predicted(cfg, layout):
    """Launches of one train step: every rank's forward of every layer,
    again in the backward's recompute (remat): flash_mha per attention
    layer (an encoder-decoder's per encoder layer and per decoder layer's
    self- and cross-attention), ssd_scan per SSD and rglru_scan per RG-LRU
    layer."""
    n = layout[0] * layout[1] * 2
    per = {"flash_mha": attn_layers(cfg) * (3 if cfg.family == "encdec" else 1),
           **scan_launches(cfg, 1)}
    return {k: n * per.get(k, 0) for k in launches()}


def report_tp_train(device, total, *, layers=2):
    """11a on the card: full-width qwen2-0.5b, phase 6's traffic, bf16 at
    full depth against TRAIN_TOL / TRAIN_LEAF_TOL and an fp32 copy of
    ``layers`` layers against FP32_GRAD_TOL; every replica bit-equal."""
    cfg = get_config("qwen2-0.5b")
    batch = lm_batch(cfg, device)
    for c, seed, tol, leaf_tol in ((cfg, 0, TRAIN_TOL, TRAIN_LEAF_TOL),
                                   (shallow(cfg, layers, dtype="float32"), 1, FP32_GRAD_TOL,
                                    FP32_GRAD_TOL)):
        params = make_params(c, seed=seed, device=device)
        r = phase_tp_train(c, params, batch, TRAIN_LAYOUT, impl="cuda")
        del r["trained"]
        ref, want = r["ref"], tp_train_predicted(c, TRAIN_LAYOUT)
        print(f"[shard] train {c.name} {c.num_layers} layers {c.dtype} on "
              f"(data, model)={TRAIN_LAYOUT}: loss {r['loss']:.6e} vs {ref['loss']:.6e} (err "
              f"{r['loss_err']:.3e}), grad_norm {r['grad_norm']:.6e} vs {ref['grad_norm']:.6e} "
              f"(err {r['grad_norm_err']:.3e}), first moment err {r['global_err']:.3e}, worst "
              f"leaf {r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol {tol}, per leaf "
              f"{leaf_tol}); replicas bit-equal {r['replicas_equal']}; {r['seconds']:.3f}s "
              f"(single device {ref['seconds']:.3f}s), peak {r['peak']} bytes (single device "
              f"{ref['peak']}), collectives moved {r['bytes']} bytes in {r['copies']} copies "
              f"per step; launches {r['launches']} (predicted {want}; single device "
              f"{ref['launches']})")
        check(max(r["loss_err"], r["grad_norm_err"], r["global_err"]) <= tol
              and r["worst_leaf_err"] <= leaf_tol,
              f"sharded train step of {c.name} disagrees with the single-device step")
        check(r["replicas_equal"], f"{c.name}: replicas differ after the sharded step")
        check(r["finite"] and r["moved"], f"{c.name}: sharded parameters not finite or unmoved")
        check(same_launches(r["launches"], want),
              f"sharded train launches {r['launches']} != {want}")
        for k in total:
            total[k] += r["launches"][k]
        del params
        free(device)


def phase_tp_serve(cfg, params, layout, *, impl, batch=4, prompt_len=256, steps=8, seed=0,
                   sharded=None, extra_len=None):
    """11b: a sharded ``make_prefill_step`` and ``steps`` sharded
    ``make_decode_step``s on a ``layout`` mesh against the single-device
    steps, both fed the single-device run's greedy tokens, the caches made
    for ``extra_len`` (default ``steps``) positions past the prompt.
    ``sharded``: (mesh, tree) already laid out (else ``params`` placed by
    ``shard_params``).  An encoder-decoder's or prefix model's prompt
    carries its frames or prefix embeddings (``modal_batch``).  Returns the
    scaled logit errors, the greedy agreement, the gathered caches' largest
    difference (``cache_diff``; ``cache_err`` over each leaf's largest
    |value|), each rank's bytes of self-attention k/v (``kv_bytes``, in
    mesh order), seconds (the single device's too), bytes and launches per
    call."""
    extra_len = steps if extra_len is None else extra_len
    device = params["embed"]["table"].device
    if cfg.prefix_len:
        prompt = modal_batch(cfg, device, batch=batch, seq=prompt_len, seed=seed)
    else:
        rng = np.random.default_rng(seed)
        prompt = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                          (batch, prompt_len))).to(device)}
    reset_launches()
    t0 = time.perf_counter()
    lg, caches = PSTEPS.make_prefill_step(cfg, impl=impl, extra_len=extra_len)(params, prompt)
    sync(device)
    ref_prefill_s = time.perf_counter() - t0
    want, feed = [lg], []
    decode = PSTEPS.make_decode_step(cfg, impl=impl)
    t0 = time.perf_counter()
    for i in range(steps):
        feed.append(want[-1].argmax(-1))
        lg, caches = decode(params, feed[-1], caches, prompt_len + i)
        want.append(lg)
    sync(device)
    ref_decode_s = (time.perf_counter() - t0) / steps
    ref_launches = launches()
    mesh, sharded = sharded or shard_params(params, *layout, device)
    COLL.reset_stats()
    reset_launches()
    t0 = time.perf_counter()
    lg, scaches = PSTEPS.make_prefill_step(cfg, impl=impl, extra_len=extra_len, mesh=mesh)(
        sharded, prompt)
    sync(device)
    out = dict(prefill_s=time.perf_counter() - t0, prefill_bytes=COLL.STATS["bytes"],
               prefill_launches=launches(), ref_launches=ref_launches,
               ref_prefill_s=ref_prefill_s, ref_decode_s=ref_decode_s)
    got = [lg.gather(device)]
    sdecode = PSTEPS.make_decode_step(cfg, impl=impl, mesh=mesh)
    COLL.reset_stats()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        lg, scaches = sdecode(sharded, feed[i], scaches, prompt_len + i)
        got.append(lg.gather(device))
    sync(device)
    out.update(decode_s=(time.perf_counter() - t0) / steps,
               decode_bytes=COLL.STATS["bytes"] // steps, decode_launches=launches())
    got, want = torch.stack(got, dim=1), torch.stack(want, dim=1)
    check(bool(torch.isfinite(got).all()), "non-finite sharded logits")
    scale = want.abs().amax().item()
    err = (got - want).abs()
    diffs = tree_leaves(tree_map(lambda a, b: (b.float() - a.float()).abs().max().item(),
                                 caches, PSTEPS.gathered_caches(scaches, device)))
    mags = tree_leaves(tree_map(lambda a: a.float().abs().max().item(), caches))
    out.update(prefill_err=err[:, 0].max().item() / scale,
               decode_err=err[:, 1:].max().item() / scale, logit_scale=scale,
               argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item(),
               cache_diff=max(diffs),
               cache_err=max(d / max(m, 1e-30) for d, m in zip(diffs, mags)),
               kv_bytes=[sum(st.blocks[r].numel() * st.blocks[r].element_size()
                             for spec, layer in zip(cfg.layers, scaches) if spec.kind == ATTN
                             for st in tree_leaves(layer.get("self", layer)))
                         for r in mesh.device_ids],
               n_ranks=mesh.size)
    return out


def report_tp_serve(params, device, total, *, steps=8):
    """11b on the card: llama-7b on phase 10's generation layout (TP 4)."""
    cfg = get_config(LLAMA)
    peak_reset(device)
    r = phase_tp_serve(cfg, params, GEN_LAYOUT, impl="cuda", steps=steps)
    n = r["n_ranks"] * attn_layers(cfg)
    print(f"[shard] serve {cfg.name} on (data, model)={GEN_LAYOUT}, 4 x 256 tokens then "
          f"{steps} decode steps: prefill_err={r['prefill_err']:.3e} decode_err="
          f"{r['decode_err']:.3e} (of max |logit| {r['logit_scale']:.3f}; tol {LOGIT_TOL}), "
          f"greedy agreement {r['argmax_agreement']:.3f} (printed), gathered caches differ by "
          f"{r['cache_diff']:.3e} at most (printed); prefill {r['prefill_s']:.3f}s, "
          f"{r['prefill_bytes']} bytes moved; decode {r['decode_s']:.4f}s and "
          f"{r['decode_bytes']} bytes per step; peak {peak(device)} bytes; launches "
          f"prefill {r['prefill_launches']}, decode {r['decode_launches']} (predicted {n} "
          "per call)")
    check(r["prefill_err"] <= LOGIT_TOL and r["decode_err"] <= LOGIT_TOL,
          "sharded llama logits disagree with the single-device run")
    check(r["prefill_launches"]["flash_mha"] == n and
          r["decode_launches"]["flash_decode"] == n * steps,
          f"sharded serve launches {r['prefill_launches']} / {r['decode_launches']}")
    for k in total:
        total[k] += r["prefill_launches"][k] + r["decode_launches"][k]


def phase_ep(cfg, params, layout, *, impl, batch=4, prompt_len=256, seed=0):
    """11c: the sharded forward with the experts split over the model axis
    against the single-device forward on the same tokens: logits (scaled
    error; ``agree_err`` over the tokens every layer routed alike in both,
    ``parted`` the others, ``parted_grid``'s ``held_gap``), the route
    agreement of the single run with the first model rank's
    (``route_diff``), whether every model rank routed alike."""
    if layout[0] != 1:
        raise ValueError("phase_ep compares routes of one batch replica: need data size 1")
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    with torch.no_grad(), recorded_routes() as ref_routes:
        reset_launches()
        want = MDL.logits_of(params, cfg, MDL.forward(params, cfg, {"tokens": toks}, impl=impl))
        ref_launches = launches()
    mesh, sharded = shard_params(params, *layout, device)
    rules = SHD.ShardingRules()
    COLL.reset_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad(), recorded_routes() as routes, \
            CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        parts = PSTEPS.split_batch({"tokens": toks}, mesh, rules)
        hs = MDL.forward_sharded(sharded, cfg, parts, ctx=c, impl=impl)
        top = c.local({k: v for k, v in sharded.items() if k != "layers"})
        lg = {r: MDL.logits_of(top[r], cfg, h) for r, h in hs.items()}
    sync(device)
    out = dict(seconds=time.perf_counter() - t0, bytes=COLL.STATS["bytes"],
               launches=launches(), ref_launches=ref_launches,
               vocab_split=MDL.vocab_split(sharded, cfg, c))
    got = lg[mesh.device_ids[0]]
    if out["vocab_split"]:
        got = torch.cat([lg[r].to(device) for r in mesh.device_ids[:layout[1]]], dim=-1)
    check(bool(torch.isfinite(got).all()), "non-finite EP logits")
    scale = want.abs().amax().item()
    tp = layout[1]
    d = route_diff(routes[::tp], ref_routes)
    parted, held_gap = parted_grid(d, batch, prompt_len)
    err = (got - want).abs().amax(dim=-1).cpu()
    out.update(err=err.max().item() / scale, logit_scale=scale,
               agree_err=err.masked_fill(parted, 0.0).max().item() / scale,
               parted=int(parted.sum()), tokens=toks.numel(), routes=d, held_gap=held_gap,
               ranks_route_alike=all(same(routes[i - i % tp][0], routes[i][0])
                                     for i in range(len(routes))))
    return out


def report_ep(device, total):
    """11c on the card: full-width granite-moe-1b-a400m, 32 experts over 2
    ranks."""
    cfg = get_config("granite-moe-1b-a400m")
    params = make_params(cfg, seed=0, device=device)
    check_ep(cfg, params, EP_LAYOUT, device, total, "[shard]")
    del params
    free(device)


def check_ep(cfg, params, layout, device, total, tag, routed=False):
    """``phase_ep`` on the card, printed and held (logits at LOGIT_TOL, the
    ranks' routers alike, one grouped_ffn per rank per MoE layer); adds
    its launches to ``total``.  With ``routed`` (arctic-480b, whose parted
    routes move a token's logits past LOGIT_TOL: ``compare_routed``) the
    logits are held where both forwards routed the token alike, and each
    first parting to a near-tie (``route_tie_tol``)."""
    peak_reset(device)
    r = phase_ep(cfg, params, layout, impl="cuda")
    n = layout[0] * layout[1] * moe_layers(cfg)
    rt = r["routes"]
    dense = (f", dense residual d_ff {cfg.d_ff // layout[1]} of {cfg.d_ff}"
             if cfg.dense_residual_ffn else "")
    tie = f", tol {route_tie_tol(cfg)}" if routed else "; printed"
    print(f"{tag} EP forward {cfg.name} {cfg.num_layers} layers on (data, model)={layout} "
          f"({cfg.n_experts // layout[1]} of {cfg.n_experts} experts per rank{dense}; "
          f"vocabulary split: {r['vocab_split']}), 4 x 256 tokens: logits err "
          f"{r['err']:.3e}, {r['agree_err']:.3e} over the {r['tokens'] - r['parted']} of "
          f"{r['tokens']} tokens routed alike (tol {LOGIT_TOL} on the "
          f"{'latter' if routed else 'former'}) of max |logit| {r['logit_scale']:.3f}; routes "
          f"agree with the single device on {rt['agreement']:.6f} of (token, layer) pairs, "
          f"{rt['flips']} part (largest probability gap {rt['worst_gap']:.3e}, at a parting "
          f"no earlier one reaches {r['held_gap']:.3e}{tie}); "
          f"ranks route alike {r['ranks_route_alike']}; {r['seconds']:.3f}s, "
          f"{r['bytes']} bytes moved, peak {peak(device)} bytes; launches {r['launches']} "
          f"(grouped_ffn predicted {n}; single device {r['ref_launches']})")
    check(r["agree_err" if routed else "err"] <= LOGIT_TOL,
          "EP logits disagree with the single-device forward")
    check(not routed or r["held_gap"] <= route_tie_tol(cfg), "EP routes part past a near-tie")
    check(r["ranks_route_alike"], "the model ranks' replicated routers routed differently")
    check(r["launches"]["grouped_ffn"] == n, f"EP grouped_ffn launches {r['launches']}")
    for k in total:
        total[k] += r["launches"][k]


def phase_pipeline(cfg, params, *, impl, stages=PIPE_STAGES, mbs=PIPE_MICRO, batch=16,
                   seq=256, seed=0):
    """11d: ``pipeline_apply`` over ``stages`` stages of ``cfg``'s layers
    (``transformer.stack_apply`` as the layer function) on ``mbs``
    microbatches of embedded tokens, against the unpipelined stack run on
    each microbatch.  Returns whether the two are bit-equal, seconds,
    bytes, launches."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, seq))).to(device)
    mesh = Mesh(np.arange(stages), ("stage",), device=device)
    stacked = PIPE.stack_stages(params["layers"], stages)

    def layer_fn(p, x):
        return T.stack_apply(PIPE.unstack_layers(p), cfg, x, impl=impl)
    with torch.no_grad():
        x = PIPE.microbatch(MDL._embed(params, cfg, toks), mbs)
        reset_launches()
        want = torch.stack([T.stack_apply(params["layers"], cfg, xm, impl=impl) for xm in x])
        ref_launches = launches()
        COLL.reset_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = PIPE.pipeline_apply(layer_fn, stacked, x, mesh=mesh)
        sync(device)
    return dict(seconds=time.perf_counter() - t0, bytes=COLL.STATS["bytes"],
                launches=launches(), ref_launches=ref_launches, ticks=mbs + stages - 1,
                bit_equal=all(same(want, b) for b in out.blocks.values()))


def report_pipeline(device, total):
    """11d on the card: full-width qwen2-0.5b's 24 layers in 4 stages."""
    cfg = get_config("qwen2-0.5b")
    params = make_params(cfg, seed=0, device=device)
    peak_reset(device)
    r = phase_pipeline(cfg, params, impl="cuda")
    print(f"[shard] pipeline {cfg.name}: {PIPE_STAGES} stages of "
          f"{cfg.num_layers // PIPE_STAGES} layers, {PIPE_MICRO} microbatches of 2 x 256 "
          f"tokens, {r['ticks']} ticks (utilization {PIPE_MICRO / r['ticks']:.3f}); bit-equal "
          f"to the unpipelined stack {r['bit_equal']}; {r['seconds']:.3f}s, {r['bytes']} "
          f"bytes moved, peak {peak(device)} bytes; launches {r['launches']} (unpipelined "
          f"{r['ref_launches']})")
    check(r["bit_equal"], "the pipeline's outputs differ from the unpipelined stack's")
    check(same_launches(r["launches"], r["ref_launches"]),
          "the pipeline launched other kernels than the unpipelined stack")
    for k in total:
        total[k] += r["launches"][k]
    del params
    free(device)


def psum_bound(xs, prev_err, k):
    """The largest error one ``compressed_psum`` call can make against the
    exact mean of ``xs`` ({rank: fp32 gradient}) after the residuals
    ``prev_err`` were added: each rank's chunk rounds by half its scale, at
    most M / 254 with M = max |x + residual| over the ranks; the reduced
    chunk (at most k M (1 + 1/254)) rounds by half of its scale; the
    residuals that went in come out of the mean as they are.  fp32
    rounding of the sums adds 2^-20 of k M."""
    m = max((x + (e if e is not None else 0)).abs().max().item()
            for x, e in zip(xs, prev_err))
    res = sum(e.abs().max().item() for e in prev_err if e is not None)
    return res / k + m / 254 + m * (1 + 1 / 254) / 254 + k * m * 2.0 ** -20


def phase_compressed(grads, device, *, steps=3):
    """11e: ``compressed_psum`` over len(grads) logical devices of the
    ``data`` axis, leaf by leaf of the ranks' gradient trees (fp32), for
    ``steps`` calls with error feedback.  Per step: the largest error
    against the exact mean over the largest |mean| and over the leaf's
    ``psum_bound``, the copies bit-equal across ranks, seconds, bytes."""
    k = len(grads)
    mesh = Mesh(np.arange(k), ("data",), device=device)
    flat = [adamw.leaves(g) for g in grads]
    errs = [[None] * k for _ in flat[0]]
    out = []
    for _ in range(steps):
        COLL.reset_stats()
        t0 = time.perf_counter()
        worst_rel = worst_bound = 0.0
        alike = True
        for i in range(len(flat[0])):
            xs = [flat[r][i].float().to(mesh.torch_device(r)) for r in range(k)]
            bound = psum_bound(xs, errs[i], k)
            mean, new = GRAD.compressed_psum(
                {r: xs[r] for r in range(k)}, mesh, "data",
                None if errs[i][0] is None else {r: errs[i][r] for r in range(k)})
            exact = sum(x.to(xs[0].device) for x in xs) / k
            e = (mean[0] - exact).abs().max().item()
            worst_rel = max(worst_rel, e / max(exact.abs().max().item(), 1e-30))
            worst_bound = max(worst_bound, e / bound)
            alike = alike and all(same(mean[0], mean[r]) for r in range(k))
            errs[i] = [new[r] for r in range(k)]
        sync(device)
        out.append(dict(rel_err=worst_rel, of_bound=worst_bound, alike=alike,
                        seconds=time.perf_counter() - t0, bytes=COLL.STATS["bytes"]))
    return out


def rank_grads(cfg, params, n, *, impl, batch=2, seq=256, seed=0):
    """``n`` ranks' gradient trees: the LM loss's gradient of ``params`` on
    ``n`` different seeded batches."""
    for t in adamw.leaves(params):
        t.requires_grad_(True)
    out = []
    for r in range(n):
        b = lm_batch(cfg, params["embed"]["table"].device, batch=batch, prompt=seq // 2,
                     new=seq // 2, seed=seed + r)
        with torch.enable_grad():
            loss, _ = MDL.lm_loss(params, cfg, b, impl=impl, remat=False)
            out.append(torch.autograd.grad(loss, adamw.leaves(params)))
    return out


def report_compressed(device, total):
    """11e on the card: qwen2-0.5b's gradient tree on 4 logical devices."""
    cfg = get_config("qwen2-0.5b")
    params = make_params(cfg, seed=0, device=device)
    reset_launches()
    grads = rank_grads(cfg, params, 4, impl="cuda")
    for k in total:
        total[k] += launches()[k]
    del params
    peak_reset(device)
    runs = phase_compressed(grads, device)
    n = sum(t.numel() for t in grads[0])
    for i, r in enumerate(runs):
        print(f"[shard] compressed_psum step {i}: qwen2-0.5b's {n}-element gradient tree on 4 "
              f"logical devices, largest error {r['rel_err']:.3e} of the largest |exact "
              f"mean|, {r['of_bound']:.3f} of the quantization bound; copies alike "
              f"{r['alike']}; {r['seconds']:.3f}s, {r['bytes']} bytes moved (int8 payloads "
              f"and fp32 scales; an fp32 ring all-reduce moves {2 * 3 * 4 * n} bytes)")
        check(r["of_bound"] <= 1.0, f"compressed_psum step {i} past its quantization bound")
        check(r["alike"], f"compressed_psum step {i}: ranks got different means")
    print(f"[shard] compressed_psum peak {peak(device)} bytes")
    del grads
    free(device)


def report_sharded(llama_params, device, total):
    """Phase 11 on the card: (b) on ``llama_params``, whose dict it then
    empties to free them, then (a), (c), (d), (e); each part's seconds."""
    t0 = time.perf_counter()
    report_tp_serve(llama_params, device, total)
    llama_params.clear()
    free(device)
    print(f"[time] phase 11b {time.perf_counter() - t0:.1f}s")
    for name, part in (("a", report_tp_train), ("c", report_ep), ("d", report_pipeline),
                       ("e", report_compressed)):
        t0 = time.perf_counter()
        part(device, total)
        print(f"[time] phase 11{name} {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 12
# The dense decoder configs (qwen3-1.7b, gemma3-1b, qwen2.5-14b) and the
# paper's other algorithms (§8.3: DPO, GRPO, ReMax) at full width.

# The configs in phase 12's order; qwen2.5-14b (29.5 GB of bf16 weights)
# last, alone on the card.
DENSE = ("qwen3-1.7b", "gemma3-1b", "qwen2.5-14b")
# Longest prompt of each config's traffic: gemma3-1b's run past its window
# of 512, so prefill windows bite and the 512-slot rings wrap in decode;
# the others take phase 5's.
DENSE_MAX_PROMPT = {"qwen3-1.7b": 400, "gemma3-1b": 1000, "qwen2.5-14b": 400}
# phase 3's prompt length per config (gemma3-1b's past the window)
DENSE_SLICE_PROMPT = {"qwen3-1.7b": 256, "gemma3-1b": 600, "qwen2.5-14b": 256}
# 12a's serving (phases 4 and 5) runs each config's first layers at full
# width, a quarter of its depth (gemma3-1b's 5 local and 1 global): the
# host's time per decode step grows with the layers, and every check of the
# serve holds at any depth; phase 3's tiers keep the full depth.
DENSE_SERVE_LAYERS = {"qwen3-1.7b": 7, "gemma3-1b": 6, "qwen2.5-14b": 12}
# DPO runs: (config, pairs, tokens per sequence, gen_start), 3 steps each
DPO_RUNS = (("qwen3-1.7b", 8, 512, 256), ("gemma3-1b", 4, 1024, 512))
DPO_STEPS = 3
# AdamW for GRPO and ReMax (one step each): at lr 1e-5 most bf16 weights
# of std d_model^-0.5 would round back after a step (one bf16 unit at 0.022
# is 8.6e-5); 5e-5 moves them and stays a fine-tuning rate.
ALGO_OPT = adamw.AdamWConfig(lr=5e-5)
# DPO takes three steps on one batch: at 5e-5 its first step alone drives
# qwen3-1.7b's margin to ~150 on the H100 (loss 0 in fp32, so it cannot
# fall again; PERF.md); at 2e-6 only the bf16 weights within ~2^7 lr of 0
# move each step, and the loss falls step by step.
DPO_OPT = adamw.AdamWConfig(lr=2e-6)
# DPO's first step with the reference equal to the policy: every logit 0,
# so the loss is ln 2 (both forwards run the same kernels on the same
# weights) and dpo_acc 0 (logits > 0 is false at 0).
DPO_LOSS0_TOL = 1e-3
# GRPO's group advantages: each group's mean 0 and population std 1 (the
# +1e-6 in the denominator moves the std by 1e-6 / std of the rewards)
ADV_MEAN_TOL = 1e-5
ADV_STD_TOL = 1e-3
# GRPO's and ReMax's rollouts: prompts x group rows of prompt_len + new
RL_SHAPES = {"grpo": dict(prompts=4, group=8, prompt_len=128, new=128),
             "remax": dict(prompts=16, group=1, prompt_len=128, new=128)}
# per algorithm: its grads function, its train step, its hyperparameters
# from the group size, and the batch's log-probs a tier's inference gives
RL = {"grpo": (GRPO.grpo_grads, GRPO.make_grpo_train_step,
               lambda group: GRPO.GRPOHyperparameters(group_size=group), ("logp", "ref_logp")),
      "remax": (REMAX.remax_grads, REMAX.make_remax_train_step,
                lambda group: REMAX.ReMaxHyperparameters(), ("ref_logp",))}
REWARD = "qwen2-0.5b"  # the reward model's trunk: the same 151,936-token vocabulary


def randomize_dense(params, *, seed):
    """Biases at std 0.1 and norm scales (the qk-norm ones too) at 1 +
    N(0, 0.1), in place: with zero biases and unit scales a bias or a
    norm applied in the wrong place (qk-norm after RoPE commutes with the
    rotation while every scale is 1) shows in no output."""
    dev = params["embed"]["table"].device
    g = torch.Generator(device=dev).manual_seed(seed + 1000)

    def walk(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k == "b" and torch.is_tensor(v):
                    v.copy_(torch.randn(v.shape, generator=g, device=dev) * 0.1)
                elif k == "scale" and torch.is_tensor(v):
                    v.copy_(1 + torch.randn(v.shape, generator=g, device=dev) * 0.1)
                else:
                    walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
    with torch.no_grad():
        walk(params)
    return params


def make_dense_params(cfg, *, seed, device):
    """``make_params`` with biases and norm scales drawn (``randomize_dense``)."""
    return randomize_dense(make_params(cfg, seed=seed, device=device), seed=seed)


def dense_shallow(cfg, *, dtype="float32"):
    """``cfg`` at full width on 4 layers in ``dtype``: 4 of the dense
    configs' one-layer superblocks, or for gemma3-1b (5 local + 1 global)
    its last local and its global layer twice, so both kinds run."""
    if len(cfg.superblock) == 1:
        return shallow(cfg, 4, dtype=dtype)
    kinds = (next(s for s in cfg.superblock if s.window is not None),
             next(s for s in cfg.superblock if s.window is None))
    return dataclasses.replace(cfg, dtype=dtype, superblock=kinds, n_superblocks=2, tail=(),
                               num_layers=4)


def plain_attention(p, cfg, spec, x):
    """One attention layer transcribed from its published definition, in
    fp32 and independent of ``models/attention.py``: q/k/v projections
    (with their biases where the config has them); qk-norm, RMSNorm over
    head_dim in fp32 with eps ``norm_eps`` times its scale, *before* RoPE;
    half-split RoPE at ``rope_theta`` on positions 0..S-1; causal GQA
    softmax attention at D^-0.5 over the keys within ``spec.window``; the
    output projection."""
    b, s, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def lin(w, t):
        y = t @ w["w"].float()
        return y + w["b"].float() if "b" in w else y

    def rms(t, scale):
        return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + cfg.norm_eps) * scale.float()
    x = x.float()
    q = lin(p["wq"], x).reshape(b, s, hq, d)
    k = lin(p["wk"], x).reshape(b, s, hkv, d)
    v = lin(p["wv"], x).reshape(b, s, hkv, d)
    if cfg.qk_norm:
        q, k = rms(q, p["q_norm"]["scale"]), rms(k, p["k_norm"]["scale"])
    pos = torch.arange(s, device=x.device, dtype=torch.float32)
    ang = pos[:, None] * cfg.rope_theta ** (-torch.arange(0, d, 2, device=x.device,
                                                          dtype=torch.float32) / d)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]

    def rope(t):
        t1, t2 = t[..., :d // 2], t[..., d // 2:]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)
    q, k = rope(q), rope(k)
    k, v = (t.repeat_interleave(hq // hkv, dim=2) for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    i, j = torch.arange(s, device=x.device)[:, None], torch.arange(s, device=x.device)[None]
    allowed = (j <= i) & ((i - j < spec.window) if spec.window else True)
    probs = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * d)
    return lin(p["wo"], out)


def layer_check(cfg, params, *, impl, batch=2, seq=640, seed=0):
    """The port's attention layer (``attention.attn_apply_with_kv``) against
    ``plain_attention`` on the first layer of each kind (local and global)
    on the same normal inputs: {layer: max |difference| over max |plain|}."""
    device = params["embed"]["table"].device
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for i, spec in enumerate(cfg.layers):
        kind = "local" if spec.window else "global"
        if spec.kind != ATTN or any(k.startswith(kind) for k in out):
            continue
        p = params["layers"][i]["mixer"]
        x = torch.randn((batch, seq, cfg.d_model), generator=g, device=device).to(
            L.dtype_of(cfg))
        rope = L.rope_tables(torch.arange(seq, device=device), cfg.head_dim, cfg.rope_theta)
        with torch.no_grad():
            got, _ = ATT.attn_apply_with_kv(p, cfg, spec, x, rope, impl=impl)
            want = plain_attention(p, cfg, spec, x)
        check(bool(torch.isfinite(got).all()), f"{cfg.name} layer {i}: non-finite output")
        out[f"{kind} layer {i}"] = ((got.float() - want).abs().max().item()
                                    / want.abs().max().item())
    return out


def report_batch_serve(cfg, params, total, *, max_prompt=400, modes=("greedy", "sampled"),
                       tag="[serve]"):
    """Phase 4 for one model: ``BatchServer.serve`` of 8 ragged requests,
    64 new tokens each, in each of ``modes``, launches held to the
    prediction and added to ``total``."""
    prompts = serve_prompts(cfg, max_prompt=max_prompt)
    want = predicted_launches(cfg, prompts, 64)
    torch.cuda.reset_peak_memory_stats()
    runs = phase_serve(cfg, params, prompts, impl="cuda", new=64, modes=modes)
    for mode, r in runs.items():
        print(f"{tag} {cfg.name} {mode}: {len(prompts)} requests (prompt lengths "
              f"{sorted(len(p) for p in prompts)}), {r['tokens_per_s']:.1f} tokens/s "
              f"in {r['seconds']:.3f}s; launches {r['launches']} (predicted {want})")
        check(same_launches(r["launches"], want), f"{mode}: launches {r['launches']} != {want}")
        for k in total:
            total[k] += r["launches"][k]
    if "sampled" in runs:
        same_out = sum(bool((a == b).all()) for a, b in zip(runs["greedy"]["outputs"],
                                                             runs["sampled"]["outputs"]))
        print(f"{tag} {cfg.name} sampled equals greedy on {same_out}/{len(prompts)} requests")
    print(f"{tag} {cfg.name} max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")


def report_dense(cfg, params, total):
    """12a for one config: phase 3 (cuda vs reference in bf16, prompts of
    ``DENSE_SLICE_PROMPT``, paged vs dense decode), the same in fp32 on 4
    layers (``dense_shallow``) with each attention kind's layer against
    ``plain_attention``, then phases 4 and 5 on its traffic
    (``DENSE_MAX_PROMPT``) on its first ``DENSE_SERVE_LAYERS``."""
    t0 = time.perf_counter()
    device = params["embed"]["table"].device
    report_slice(cfg, params, prompt_len=DENSE_SLICE_PROMPT[cfg.name])
    small = dense_shallow(cfg)
    p32 = make_dense_params(small, seed=1, device=device)
    sl = phase_slice(small, p32, impl="cuda", prompt_len=DENSE_SLICE_PROMPT[cfg.name])
    lc = layer_check(small, p32, impl="cuda")
    del p32
    free(device)
    print(f"[dense] {cfg.name} fp32, {small.num_layers} layers: prefill_err="
          f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} (of max |logit| "
          f"{sl['logit_scale']:.3f}; tol {FP32_LOGIT_TOL}); against the plain layer "
          "(qk-norm before RoPE): " + ", ".join(f"{k} {e:.3e}" for k, e in lc.items())
          + f" (tol {FP32_LOGIT_TOL})")
    check(sl["prefill_err"] <= FP32_LOGIT_TOL and sl["decode_err"] <= FP32_LOGIT_TOL,
          f"{cfg.name}: fp32 cuda logits disagree with the reference")
    check(max(lc.values()) <= FP32_LOGIT_TOL,
          f"{cfg.name}: the attention layer disagrees with its plain transcription")
    n = DENSE_SERVE_LAYERS[cfg.name]
    serve_cfg, serve_params = first_layers(cfg, n), dict(params, layers=params["layers"][:n])
    print(f"[dense] {cfg.name} serves on its first {n} of {cfg.num_layers} layers")
    report_batch_serve(serve_cfg, serve_params, total, max_prompt=DENSE_MAX_PROMPT[cfg.name])
    report_continuous(serve_cfg, serve_params, total, ("greedy", "sampled"),
                      traffic=continuous_traffic(cfg, max_prompt=DENSE_MAX_PROMPT[cfg.name]),
                      near_ties=True)
    print(f"[time] phase 12a {cfg.name} {time.perf_counter() - t0:.1f}s")


# 12c-e: the algorithms' train steps ------------------------------------

def frozen_copy(params):
    """The reference model: a detached copy of the policy's weights."""
    return tree_map(lambda t: t.detach().clone(), params)


def state_of(params, before):
    """Whether every parameter is finite, and how many leaves differ from
    ``before`` (host copies of ``adamw.leaves``)."""
    now = adamw.leaves(params)
    return dict(finite=all(bool(torch.isfinite(p).all()) for p in now),
                changed=sum(bool((p.cpu() != q).any()) for p, q in zip(now, before)),
                leaves=len(now))


def algo_grads(grads_fn, cfg, params, hp, batch, gen_start, *, impl, adv_scale=None):
    """``grads_fn``'s (``dpo_grads``, ``grpo_grads``, ``remax_grads``)
    loss, grad_norm and gradients under ``impl``, as ``agreement`` reads
    them; ``adv_scale`` the loss's term scale (None: |loss|)."""
    loss, st, grads = grads_fn(params, cfg, hp, batch, gen_start, impl=impl)
    return dict(loss=loss.item(), grad_norm=adamw.global_norm(grads).item(), grads=grads,
                names=leaf_names(params),
                clip_frac=st["clip_frac"].item() if "clip_frac" in st else 0.0,
                adv_scale=adv_scale, routes=None, rows=None)


def algo_tiers(name, grads_fn, cfg, params, hp, batches, gen_start, *, adv_scale=None,
               impl="cuda"):
    """{name: ``agreement``} of ``impl`` against "reference", each on its
    own batch of ``batches`` ({impl: batch}; the reference model's and the
    behaviour's log-probs are each tier's own inference), before any
    update."""
    got = algo_grads(grads_fn, cfg, params, hp, batches[impl], gen_start, impl=impl,
                     adv_scale=adv_scale)
    want = algo_grads(grads_fn, cfg, params, hp, batches["reference"], gen_start,
                      impl="reference", adv_scale=adv_scale)
    return {name: agreement(name, got, want)}


def dpo_batch(cfg, params, *, pairs, seq, gen_start, impl, seed=0):
    """A ``PreferenceDataset`` batch with the frozen reference's summed
    log-probs (a copy of ``params``, freed after)."""
    device = params["embed"]["table"].device
    batch = PreferenceDataset(cfg.vocab_size, seq, pairs, seed=seed, device=device).batch_at(0)
    ref = frozen_copy(params)
    with torch.no_grad():
        for side in ("chosen", "rejected"):
            batch[f"ref_{side}_logp"] = DPO.seq_logp_sum(ref, cfg, batch[side],
                                                         batch[f"{side}_mask"], gen_start,
                                                         impl=impl, remat=False)
    del ref
    return batch


def dpo_predicted(cfg, steps):
    """The reference's two forwards, then per step the chosen and rejected
    forwards and their recomputes (remat): flash_mha in every attention
    layer of each."""
    return {"flash_mha": attn_layers(cfg) * (2 + 4 * steps)}


def phase_dpo(cfg, params, *, impl, pairs, seq, gen_start, steps=DPO_STEPS, opt=DPO_OPT,
              seed=0):
    """``steps`` DPO train steps on one fixed ``PreferenceDataset`` batch,
    the reference a frozen copy of the initial policy (β 0.1): per step the
    stats and seconds; the launches from the reference's inference to the
    last step and their prediction; the parameters' state."""
    device = params["embed"]["table"].device
    hp = DPO.DPOHyperparameters(beta=0.1)
    reset_launches()
    batch = dpo_batch(cfg, params, pairs=pairs, seq=seq, gen_start=gen_start, impl=impl,
                      seed=seed)
    before = [p.detach().to("cpu", copy=True) for p in adamw.leaves(params)]
    opt_state = adamw.init(opt, params)
    step = DPO.make_dpo_train_step(cfg, hp, opt, gen_start, impl=impl)
    out = []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt_state, st = step(params, opt_state, batch)
        sync(device)
        out.append(dict(seconds=time.perf_counter() - t0, **{k: float(v) for k, v in st.items()}))
    counts = launches()
    del opt_state
    return dict(steps=out, launches=counts, predicted=dpo_predicted(cfg, steps),
                state=state_of(params, before), batch=batch, hp=hp)


def report_dpo(cfg, params, total, *, pairs, seq, gen_start, compare=False):
    """12c for one model on the card: ``phase_dpo`` and its checks; with
    ``compare``, first the cuda-vs-reference agreement of step 0's loss,
    grad_norm and gradient in bf16 (``TRAIN_TOL`` / ``TRAIN_LEAF_TOL``)
    and in fp32 on 2 layers (``FP32_GRAD_TOL``)."""
    t0 = time.perf_counter()
    device = params["embed"]["table"].device
    tag = f"[dpo] {cfg.name} {cfg.num_layers} layers, {pairs} pairs of {seq} tokens, " \
          f"gen_start {gen_start}"
    if compare:
        report_algo_tiers("[dpo]", "dpo", DPO.dpo_grads, cfg, params,
                          lambda c, p, impl: dpo_batch(c, p, pairs=pairs, seq=seq,
                                                       gen_start=gen_start, impl=impl),
                          DPO.DPOHyperparameters(beta=0.1), gen_start)
    peak_reset(device)
    r = phase_dpo(cfg, params, impl="cuda", pairs=pairs, seq=seq, gen_start=gen_start)
    for i, st in enumerate(r["steps"]):
        print(f"{tag}: step {i} loss {st['loss']:.6f} dpo_acc {st['dpo_acc']:.4f} margin "
              f"{st['margin']:+.4e} grad_norm {st['grad_norm']:.4e} in {st['seconds']:.3f}s")
    losses = [st["loss"] for st in r["steps"]]
    print(f"{tag}: step 0 loss - ln 2 = {losses[0] - math.log(2):+.3e} (tol {DPO_LOSS0_TOL}); "
          f"parameters {r['state']}; launches {r['launches']} (predicted {r['predicted']}); "
          f"peak {peak(device)} bytes; {time.perf_counter() - t0:.1f}s")
    check(abs(losses[0] - math.log(2)) <= DPO_LOSS0_TOL, f"{tag}: step 0 loss is not ln 2")
    check(r["steps"][0]["dpo_acc"] == 0.0, f"{tag}: step 0 dpo_acc is not 0")
    check(all(math.isfinite(v) for st in r["steps"] for v in st.values()),
          f"{tag}: non-finite stats")
    check(all(b < a for a, b in zip(losses, losses[1:])), f"{tag}: the loss did not fall")
    check(r["state"]["finite"] and r["state"]["changed"] > 0, f"{tag}: parameters "
          f"{r['state']}")
    check(same_launches(r["launches"], r["predicted"]), f"{tag}: launches {r['launches']}")
    for k in total:
        total[k] += r["launches"][k]


def report_algo_tiers(tag, name, grads_fn, cfg, params, make_batch, hp, gen_start, *,
                      adv_scale=None):
    """The tiers' agreement for one algorithm on the card: on the full
    model (bf16, gated at ``TRAIN_TOL`` / ``TRAIN_LEAF_TOL``), then on an
    fp32 2-layer model of the same config (``FP32_GRAD_TOL``).
    ``make_batch(cfg, params, impl)`` gives a batch whose log-probs (the
    reference model's, the behaviour's) are ``impl``'s inference.  In bf16
    each tier takes its own, as each tier would run the whole algorithm
    (fed the other tier's, the bf16 spread between the tiers' forwards
    reads as a loss error); in fp32 both take the reference tier's, so
    the loss at step 0 differs by what the tiers' train forwards compute.
    ``adv_scale(batch)`` gives the loss's term scale (None: |loss|).  The
    comparison's launches are not counted."""
    device = params["embed"]["table"].device
    for label, c, p, tol, leaf_tol in (("bf16", cfg, params, TRAIN_TOL, TRAIN_LEAF_TOL),
                                       ("fp32", None, None, FP32_GRAD_TOL, FP32_GRAD_TOL)):
        if c is None:
            c = shallow(cfg, 2, dtype="float32")
            p = make_dense_params(c, seed=1, device=device)
        batches = {"reference": make_batch(c, p, "reference")}
        batches["cuda"] = make_batch(c, p, "cuda") if label == "bf16" else batches["reference"]
        cmp = algo_tiers(name, grads_fn, c, p, hp, batches, gen_start,
                         adv_scale=adv_scale(batches["reference"]) if adv_scale else None)
        report_compare(tag, f"{label}, {c.num_layers} layers, step 0 cuda vs reference", cmp,
                       tol, leaf_tol)
        del batches, cmp
        if label == "fp32":
            del p
        free(device)


def prompt_rows(cfg, device, *, prompts, prompt_len, repeat=1, seed=0):
    """Seeded prompts (prompts, prompt_len), each row repeated ``repeat``
    times in a row (GRPO's groups)."""
    rng = np.random.default_rng(seed + 200)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (prompts, prompt_len))).to(device)
    return toks.repeat_interleave(repeat, dim=0)


def rollout(cfg, params, prompts, *, new, impl, seed=None):
    """``generate`` of ``new`` tokens after ``prompts``, greedy (``seed``
    None) or sampled from a seeded ``torch.Generator``; returns prompt and
    generated tokens as one (B, P + new) int64 tensor."""
    device = prompts.device
    gen = None if seed is None else torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        out = MDL.generate(params, cfg, {"tokens": prompts}, num_new_tokens=new, rng=gen,
                           impl=impl)
    return torch.cat([prompts, out["tokens"].to(prompts.dtype)], dim=1)


def scores(rcfg, rparams, tokens, *, impl):
    with torch.no_grad():
        return RWD.score_sequences(rparams, rcfg, tokens, torch.ones_like(tokens,
                                                                          dtype=torch.float32),
                                   impl=impl)


def inference_logp(cfg, params, tokens, gen_start, *, impl):
    with torch.no_grad():
        return PPO.sequence_logprobs(params, cfg, tokens, gen_start, impl=impl, remat=False)


def group_stats(adv, group):
    """Each group's |mean| and |population std - 1| of ``adv``, worst over
    the groups, computed here (not by ``group_advantages``)."""
    a = adv.double().reshape(-1, group)
    mean = a.mean(-1)
    std = (a - mean[:, None]).square().mean(-1).sqrt()
    return mean.abs().max().item(), (std - 1).abs().max().item()


def rl_batch(kind, cfg, params, rcfg, rparams, *, impl, prompts, group, prompt_len, new,
             seed=0):
    """The inputs of one GRPO or ReMax step: ``prompts`` x ``group`` rows
    sampled by ``generate``, the reward model's scores of them and the
    frozen reference's log-probs; for GRPO the behaviour's log-probs, for
    ReMax the scores of a greedy ``generate`` of the same prompts (the
    baseline)."""
    device = params["embed"]["table"].device
    rows = prompt_rows(cfg, device, prompts=prompts, prompt_len=prompt_len, repeat=group,
                       seed=seed)
    toks = rollout(cfg, params, rows, new=new, impl=impl, seed=seed + 1)
    ref = frozen_copy(params)
    batch = {"tokens": toks, "mask": torch.ones((toks.shape[0], new), device=device),
             "ref_logp": inference_logp(cfg, ref, toks, prompt_len, impl=impl),
             "rewards": scores(rcfg, rparams, toks, impl=impl)}
    del ref
    if kind == "grpo":
        batch["logp"] = inference_logp(cfg, params, toks, prompt_len, impl=impl)
    else:
        greedy = rollout(cfg, params, rows, new=new, impl=impl)
        batch["rewards_baseline"] = scores(rcfg, rparams, greedy, impl=impl)
    return batch


def rl_predicted(kind, cfg, rcfg, new):
    """``rl_batch``'s ``generate``s (ReMax's two) and forwards (the
    reference, the reward model's per rollout, GRPO's behaviour), then the
    train step's forward and its recompute."""
    n_gen = 1 if kind == "grpo" else 2
    out = {k: n_gen * v for k, v in generate_predicted(cfg, new).items()}
    out["flash_mha"] += (n_gen * attn_layers(rcfg)
                         + (2 if kind == "grpo" else 1) * attn_layers(cfg) + 2 * attn_layers(cfg))
    return out


def phase_rl(kind, cfg, params, batch, hp, gen_start, *, impl, opt=ALGO_OPT):
    """One GRPO or ReMax step (``RL[kind]``) on ``batch`` (``rl_batch``'s):
    the step's stats and seconds, its launches, the parameters' state and,
    for GRPO, the group advantages' worst |mean| and |population std - 1|
    (``group_stats``)."""
    device = params["embed"]["table"].device
    make_step = RL[kind][1]
    out = {}
    if kind == "grpo":
        g = hp.group_size
        out["mean_err"], out["std_err"] = group_stats(
            GRPO.group_advantages(batch["rewards"], g), g)
    before = [p.detach().to("cpu", copy=True) for p in adamw.leaves(params)]
    reset_launches()
    t0 = time.perf_counter()
    params, _, st = make_step(cfg, hp, opt, gen_start, impl=impl)(
        params, adamw.init(opt, params), batch)
    sync(device)
    return dict(out, step_s=time.perf_counter() - t0, launches=launches(),
                stats={k: float(v) for k, v in st.items()}, state=state_of(params, before))


def with_logp(batch, cfg, params, gen_start, keys, impl):
    """``batch`` with each of ``keys`` ("logp", "ref_logp") recomputed by
    ``params`` under ``impl``: a tier's inference, and on the fp32 2-layer
    model of the comparison its ratios start at 1 as the full model's do
    (the reference is the policy's frozen copy: the same weights)."""
    out = dict(batch)
    for k in keys:
        out[k] = inference_logp(cfg, params, batch["tokens"], gen_start, impl=impl)
    return out


def algo_scale(name, hp, batch):
    """The size of the loss's per-token terms, which the tiers' loss error
    is read against (as the PPO actor's mean |advantage|): GRPO's mean
    |advantage| (ratio * advantage with ratio ~1), ReMax's mean
    |(reward - baseline) * log-prob|."""
    if name == "grpo":
        return GRPO.group_advantages(batch["rewards"], hp.group_size).abs().mean().item()
    adv = (batch["rewards"] - batch["rewards_baseline"])[:, None]
    return (adv * batch["ref_logp"]).abs().mean().item()


def report_rl_algos(device, total):
    """12d and 12e on the card: GRPO then ReMax on full qwen3-1.7b with the
    rewards of a qwen2-0.5b value-head trunk; between each batch and its
    step, the tiers' gradient agreement on that batch."""
    cfg, rcfg = get_config("qwen3-1.7b"), get_config(REWARD)
    rparams = MDL.init_params(rcfg, seed=3, device=device, head="value")
    rparams["embed"]["table"].mul_(EMBED_SCALE)
    for kind, shape in RL_SHAPES.items():
        t0 = time.perf_counter()
        tag, gen_start = f"[{kind}]", shape["prompt_len"]
        grads_fn, _, hp_of, keys = RL[kind]
        hp = hp_of(shape["group"])
        params = make_dense_params(cfg, seed=0, device=device)
        peak_reset(device)
        reset_launches()
        batch = rl_batch(kind, cfg, params, rcfg, rparams, impl="cuda", **shape)
        counts = launches()
        report_algo_tiers(tag, kind, grads_fn, cfg, params,
                          lambda c, p, impl: with_logp(batch, c, p, gen_start, keys, impl),
                          hp, gen_start, adv_scale=lambda b: algo_scale(kind, hp, b))
        r = phase_rl(kind, cfg, params, batch, hp, gen_start, impl="cuda")
        counts = {k: v + r["launches"][k] for k, v in counts.items()}
        predicted = rl_predicted(kind, cfg, rcfg, shape["new"])
        rewards = batch["rewards"].float()
        what = (f"{cfg.name} {cfg.num_layers} layers, {shape['prompts'] * shape['group']} rows "
                f"of {gen_start} + {shape['new']} tokens")
        print(f"{tag} {what}: rewards mean {rewards.mean().item():+.4f} std "
              f"{rewards.std(correction=0).item():.4f}" + (
                  f", greedy baseline mean {batch['rewards_baseline'].mean().item():+.4f}"
                  if kind == "remax" else ""))
        if kind == "grpo":
            print(f"{tag} {what}: group advantages worst |mean| {r['mean_err']:.3e} (tol "
                  f"{ADV_MEAN_TOL}), worst |population std - 1| {r['std_err']:.3e} (tol "
                  f"{ADV_STD_TOL})")
            check(r["mean_err"] <= ADV_MEAN_TOL and r["std_err"] <= ADV_STD_TOL,
                  f"{tag}: group advantages not whitened")
        print(f"{tag} {what}: step {r['stats']} in {r['step_s']:.3f}s; parameters {r['state']}; "
              f"launches {counts} (predicted {predicted}); peak {peak(device)} "
              f"bytes; {time.perf_counter() - t0:.1f}s")
        check(all(math.isfinite(v) for v in r["stats"].values()), f"{tag}: non-finite stats")
        check(r["state"]["finite"] and r["state"]["changed"] > 0,
              f"{tag}: parameters {r['state']}")
        check(same_launches(counts, predicted), f"{tag}: launches {counts}")
        for k in total:
            total[k] += counts[k]
        del params, batch, r
        free(device)
    del rparams
    free(device)


def report_dense_model(name, device, total):
    """12a for one config: its parameters drawn on the card, ``report_dense``,
    then freed."""
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = make_dense_params(cfg, seed=0, device=device)
    sync(device)
    print(f"[dense] {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim} (q_dim {cfg.q_dim}), windows "
          f"{sorted({s.window for s in cfg.layers}, key=str)}, vocabulary {cfg.vocab_size}, "
          f"{sum(t.numel() for t in tree_leaves(params))} parameters drawn in "
          f"{time.perf_counter() - t0:.1f}s; memory_allocated="
          f"{torch.cuda.memory_allocated()} bytes")
    report_dense(cfg, params, total)
    del params
    free(device)


def report_phase12(device, total):
    """Phase 12: (a) qwen3-1.7b and gemma3-1b served, (c) DPO on both, (d)
    GRPO and (e) ReMax on qwen3-1.7b, then (a) qwen2.5-14b, alone on the
    card; each model's parameters freed before the next is built.  (b), the
    kernels at these configs' shapes, runs in phase 2."""
    t_phase = time.perf_counter()
    for name in DENSE[:2]:
        report_dense_model(name, device, total)
    t0 = time.perf_counter()
    for name, pairs, seq, gen_start in DPO_RUNS:
        cfg = get_config(name)
        params = make_dense_params(cfg, seed=0, device=device)
        report_dpo(cfg, params, total, pairs=pairs, seq=seq, gen_start=gen_start,
                   compare=name == "qwen3-1.7b")
        del params
        free(device)
    report_rl_algos(device, total)
    print(f"[time] phase 12c-e {time.perf_counter() - t0:.1f}s")
    report_dense_model(DENSE[2], device, total)
    print(f"[time] phase 12 {time.perf_counter() - t_phase:.1f}s")


# ------------------------------------------------------------------ phase 13
# The encoder-decoder ([audio]) and prefix-embedding ([vlm]) paths:
# seamless-m4t-medium at full width and depth, internvl2-76b at full width
# on PREFIX_LAYERS of its 80 layers (141 GB in bf16 at full depth).

ENCDEC = "seamless-m4t-medium"
PREFIX = "internvl2-76b"
PREFIX_LAYERS = 8
# seamless's traffic: the tiers at 4 x 128 decoder tokens over 512 frames;
# 8 requests of 32-200 tokens, 64 new each; 3 train steps at 4 x 256
ENCDEC_SLICE = dict(batch=4, seq=128)
ENCDEC_GEN = dict(requests=8, min_prompt=32, max_prompt=200, new=64)
ENCDEC_TRAIN = dict(batch=4, seq=256, steps=3)
# internvl2's: 2 rows of 512 positions, the first 256 its patch embeddings
PREFIX_SLICE = dict(batch=2, seq=512)
PREFIX_NEW = 32


def modal_key(cfg):
    """The batch entry of a config's non-token input."""
    return "frames" if cfg.family == "encdec" else "prefix_embeds"


def modal_batch(cfg, device, *, batch, seq, seed=0, train=False):
    """Random tokens (B, seq) and the config's frames or prefix embeddings
    (B, prefix_len, D), N(0, 1) in its dtype as the JAX package's
    ``synth_batch`` draws them; with ``train`` the labels (the next token)
    and a mask of ones, zero over a prefix."""
    g = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (batch, seq), generator=g, device=device)
    emb = torch.randn((batch, cfg.prefix_len, cfg.d_model), generator=g, device=device)
    out = {"tokens": toks, modal_key(cfg): emb.to(L.dtype_of(cfg))}
    if train:
        out["labels"] = torch.roll(toks, -1, dims=1)
        out["mask"] = torch.ones((batch, seq), dtype=torch.float32, device=device)
        if cfg.family != "encdec":
            out["mask"][:, :cfg.prefix_len] = 0.0
    return out


def modal_logits(cfg, params, batch, *, impl, steps, seed=0):
    """The forward's logits (B, S, V), and the prefill's last-position
    logits followed by ``steps`` teacher-forced decode steps' (B, steps + 1,
    V), under ``impl``."""
    device = params["embed"]["table"].device
    g = torch.Generator(device=device).manual_seed(seed + 1)
    b, s = batch["tokens"].shape
    feed = torch.randint(1, cfg.vocab_size, (b, steps), generator=g, device=device)
    with torch.no_grad():
        fwd = MDL.logits_of(params, cfg, MDL.forward(params, cfg, batch, impl=impl))
    last, caches = MDL.prefill(params, cfg, batch, s + steps, impl=impl)
    out = [MDL.logits_of(params, cfg, last[:, None])[:, 0]]
    for i in range(steps):
        lg, caches = MDL.decode_step(params, cfg, feed[:, i], caches, s + i, impl=impl)
        out.append(lg)
    return fwd, torch.stack(out, dim=1)


def phase_modal_slice(cfg, params, batch, *, impl, steps=8):
    """Phase 3 for a config with frames or prefix embeddings: the forward's
    logits, the prefill's and ``steps`` teacher-forced decode steps' under
    ``impl`` against "reference" on the same inputs, each error over the
    largest |reference logit|; then the forward's logits with the frames
    moved by 1 or the prefix embeddings scaled by 1.5 (``moved_by``: how
    far they move, over the same scale), and for a prefix model with the
    token ids under the prefix changed (``prefix_tokens_ignored``: bit-equal
    logits, the splice replaces them)."""
    fwd, seq = {}, {}
    for name in dict.fromkeys((impl, "reference")):
        fwd[name], seq[name] = modal_logits(cfg, params, batch, impl=name, steps=steps)
    got, want = seq[impl], seq["reference"]
    check(bool(torch.isfinite(got).all() and torch.isfinite(fwd[impl]).all()),
          f"{cfg.name}: non-finite logits")
    scale = max(want.abs().amax().item(), fwd["reference"].abs().amax().item())
    err = (got - want).abs()
    out = {"forward_err": (fwd[impl] - fwd["reference"]).abs().max().item() / scale,
           "prefill_err": err[:, 0].max().item() / scale,
           "decode_err": err[:, 1:].max().item() / scale, "logit_scale": scale,
           "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item()}
    base = fwd[impl]
    del fwd, seq
    key = modal_key(cfg)
    x = batch[key]
    moved = dict(batch, **{key: x + 1.0 if cfg.family == "encdec" else x * 1.5})
    with torch.no_grad():
        lg = MDL.logits_of(params, cfg, MDL.forward(params, cfg, moved, impl=impl))
        out["moved_by"] = (lg - base).abs().max().item() / scale
        if cfg.family != "encdec":
            toks = batch["tokens"].clone()
            toks[:, :cfg.prefix_len] = (toks[:, :cfg.prefix_len] + 1) % cfg.vocab_size
            lg = MDL.logits_of(params, cfg, MDL.forward(params, cfg, dict(batch, tokens=toks),
                                                        impl=impl))
            out["prefix_tokens_ignored"] = bool(torch.equal(lg, base))
    return out


def encdec_requests(cfg, device, *, requests, min_prompt, max_prompt, seed=0, **_):
    """Ragged requests, each {"tokens": (1, n), "frames": (1, prefix_len,
    D)}; the first is 128 tokens long, a bucket, so ``BucketedGenerator``
    pads nothing there and must give ``generate``'s tokens."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_prompt, max_prompt + 1, requests)
    lens[0] = 128
    return [modal_batch(cfg, device, batch=1, seq=int(n), seed=seed + 10 + i)
            for i, n in enumerate(lens)]


def encdec_gen_predicted(cfg, new):
    """Launches of one encoder-decoder ``generate`` of ``new`` tokens: the
    encoder's flash_mha per layer, the prefill's self- and cross-attention
    per decoder layer, then per decode step (new - 1) a flash_decode (self)
    and a flash_mha (cross, Sq 1) per decoder layer."""
    n = attn_layers(cfg)
    return {"flash_mha": 3 * n + n * (new - 1), "flash_decode": n * (new - 1)}


def phase_modal_generate(cfg, params, requests, *, impl, new):
    """Greedy ``generate`` of each request, then ``BucketedGenerator`` of
    each (its prompt left-padded to a bucket, its frames as given).
    Returns per engine the seconds, tokens/s, launches and their prediction
    and the tokens; and whether the requests of a bucket's length got the
    same tokens from both."""
    device = params["embed"]["table"].device
    gen = MDL.BucketedGenerator(cfg, impl=impl)
    runs = {}
    for engine, fn in (("generate", lambda b: MDL.generate(params, cfg, b, num_new_tokens=new,
                                                           impl=impl)),
                       ("bucketed", lambda b: gen(params, b, num_new_tokens=new))):
        sync(device)
        reset_launches()
        t0 = time.perf_counter()
        outs = [fn(b) for b in requests]
        sync(device)
        dt = time.perf_counter() - t0
        steps = MDL.bucket_len(new) if engine == "bucketed" else new
        want = {k: v * len(requests) for k, v in encdec_gen_predicted(cfg, steps).items()}
        for o in outs:
            t = o["tokens"]
            check(tuple(t.shape) == (1, new), f"{engine}: tokens {tuple(t.shape)}")
            check(bool(((t >= 0) & (t < cfg.vocab_size)).all()), f"{engine}: token out of range")
            check(bool(torch.isfinite(o["logprobs"]).all()), f"{engine}: non-finite logprobs")
        runs[engine] = {"seconds": dt, "tokens_per_s": len(outs) * new / dt,
                        "launches": launches(), "predicted": want,
                        "tokens": [o["tokens"][0] for o in outs]}
    runs["same_at_bucket"] = [bool(torch.equal(a, b)) for a, b, r in zip(
        runs["generate"]["tokens"], runs["bucketed"]["tokens"], requests)
        if MDL.bucket_len(r["tokens"].shape[1]) == r["tokens"].shape[1]]
    return runs


def grads_of(cfg, params, batch, *, impl):
    """``lm_loss`` and its gradient in every leaf, on a copy of the
    parameters that requires grad."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss, _ = MDL.lm_loss(p, cfg, batch, impl=impl)
    grads = torch.autograd.grad(loss, adamw.leaves(p))
    return loss.item(), grads


def grad_tiers(cfg, params, batch, *, impl):
    """``grads_of`` under ``impl`` against "reference": the loss's error over
    |loss|, the whole gradient's and the worst leaf's (Frobenius, over the
    reference's), and that leaf's name."""
    loss, got = grads_of(cfg, params, batch, impl=impl)
    ref_loss, want = grads_of(cfg, params, batch, impl="reference")
    sq = [square_norms(a, b) for a, b in zip(got, want)]
    worst = max(zip((math.sqrt(d2 / max(r2, 1e-60)) for d2, r2 in sq), leaf_names(params)))
    return {"loss": loss, "loss_err": abs(loss - ref_loss) / max(abs(ref_loss), 1e-12),
            "global_err": math.sqrt(sum(d2 for d2, _ in sq) / max(sum(r2 for _, r2 in sq),
                                                                   1e-60)),
            "worst_leaf_err": worst[0], "worst_leaf": worst[1], "n_leaves": len(sq)}


def modal_train_predicted(cfg, steps):
    """One flash_mha per attention call of the train forward and again in
    its recompute (remat) per step: the encoder's layers, and the decoder's
    self- and cross-attention."""
    calls = attn_layers(cfg) * (3 if cfg.family == "encdec" else 1)
    return {"flash_mha": 2 * calls * steps}


def phase_modal_train(cfg, params, batch, *, impl, steps, opt=None):
    """``steps`` single-device ``make_train_step`` updates (AdamW) of a copy
    of ``params`` on one batch.  Returns the per-step metrics, the launches
    and their prediction, seconds, whether the parameters stayed finite,
    how many fp32 master leaves moved (``moved``: every leaf has a
    gradient, so all of them must) and how many of the parameters did
    (``params_moved``: a bf16 leaf near 1, a norm scale, rounds a step of
    lr back)."""
    device = params["embed"]["table"].device
    opt = opt or ALGO_OPT
    p = clone_tree(params)
    for t in adamw.leaves(p):
        t.requires_grad_(True)
    state = adamw.init(opt, p)
    step = PSTEPS.make_train_step(cfg, opt, impl=impl)
    sync(device)
    reset_launches()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        p, state, m = step(p, state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    sync(device)
    out = {"seconds": time.perf_counter() - t0, "steps": metrics, "launches": launches(),
           "predicted": modal_train_predicted(cfg, steps)}
    leaves, before = adamw.leaves(p), adamw.leaves(params)
    out["finite"] = all(bool(torch.isfinite(t).all()) for t in leaves)
    out["moved"] = sum(not torch.equal(a, b.to(a.dtype))
                       for a, b in zip(adamw.leaves(state["master"]), before))
    out["params_moved"] = sum(not torch.equal(a, b) for a, b in zip(leaves, before))
    out["leaves"] = len(leaves)
    return out


def prefix_loss_check(cfg, params, batch, *, impl):
    """One ``lm_loss`` with its backward, then the loss again with the
    labels and token ids under the prefix changed: the mask is zero there
    and the splice replaces those tokens, so the loss must keep its bits.
    Returns both losses and whether every gradient is finite."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = MDL.lm_loss(p, cfg, batch, impl=impl)
    loss.backward()
    finite = all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                 for t in adamw.leaves(p))
    for t in adamw.leaves(p):
        t.grad = None
        t.requires_grad_(False)
    n = cfg.prefix_len
    moved = {k: v.clone() for k, v in batch.items()}
    moved["labels"][:, :n] = (moved["labels"][:, :n] + 3) % cfg.vocab_size
    moved["tokens"][:, :n] = (moved["tokens"][:, :n] + 5) % cfg.vocab_size
    with torch.no_grad():
        again, _ = MDL.lm_loss(params, cfg, moved, impl=impl)
    return {"loss": loss.item(), "loss_moved": again.item(), "grads_finite": finite}


def report_modal_slice(cfg, params, batch, tag):
    """The tiers, the input sensitivity and (prefix) the ignored tokens,
    printed and held."""
    sl = phase_modal_slice(cfg, params, batch, impl="cuda")
    print(f"{tag} {cfg.name} bf16: forward_err={sl['forward_err']:.3e} prefill_err="
          f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} (of max |logit| "
          f"{sl['logit_scale']:.3f}; tol {LOGIT_TOL}) argmax_agreement="
          f"{sl['argmax_agreement']:.3f}; {modal_key(cfg)} moved: the logits move by "
          f"{sl['moved_by']:.3e} (must exceed {LOGIT_TOL})"
          + (f"; token ids under the prefix changed: logits bit-equal "
             f"{sl['prefix_tokens_ignored']}" if "prefix_tokens_ignored" in sl else ""))
    check(max(sl["forward_err"], sl["prefill_err"], sl["decode_err"]) <= LOGIT_TOL,
          f"{cfg.name}: cuda logits disagree with the reference")
    check(sl["moved_by"] > LOGIT_TOL, f"{cfg.name}: the {modal_key(cfg)} do not reach the logits")
    check(sl.get("prefix_tokens_ignored", True),
          f"{cfg.name}: the token ids under the prefix reach the logits")


def report_encdec(device, total):
    """13a: seamless-m4t-medium at full width and depth, bf16, seeded
    weights with norm scales drawn (``make_dense_params``): the tiers and
    the frames' reach, greedy ``generate`` and ``BucketedGenerator`` on
    ragged requests, three train steps, and the fp32 2-layer gradient
    against the reference tier."""
    cfg = get_config(ENCDEC)
    t0 = time.perf_counter()
    params = make_dense_params(cfg, seed=0, device=device)
    sync(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[encdec] {cfg.name}: {len(params['encoder']['layers'])} encoder + "
          f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, heads {cfg.n_heads} of "
          f"{cfg.head_dim}, {cfg.prefix_len} frames, vocabulary {cfg.vocab_size}, {n_params} "
          f"parameters drawn in {time.perf_counter() - t0:.1f}s; memory_allocated="
          f"{torch.cuda.memory_allocated()} bytes")
    report_modal_slice(cfg, params, modal_batch(cfg, device, **ENCDEC_SLICE), "[encdec]")
    reqs = encdec_requests(cfg, device, **ENCDEC_GEN)
    runs = phase_modal_generate(cfg, params, reqs, impl="cuda", new=ENCDEC_GEN["new"])
    for engine in ("generate", "bucketed"):
        r = runs[engine]
        print(f"[encdec] {cfg.name} greedy {engine}: {len(reqs)} requests (prompt lengths "
              f"{sorted(q['tokens'].shape[1] for q in reqs)}, {ENCDEC_GEN['new']} new each), "
              f"{r['tokens_per_s']:.1f} tokens/s in {r['seconds']:.3f}s; launches "
              f"{r['launches']} (predicted {r['predicted']})")
        check(same_launches(r["launches"], r["predicted"]),
              f"{engine}: launches {r['launches']} != {r['predicted']}")
        for k in total:
            total[k] += r["launches"][k]
    print(f"[encdec] bucketed equals generate on the requests of a bucket's length: "
          f"{runs['same_at_bucket']}")
    check(runs["same_at_bucket"] and all(runs["same_at_bucket"]),
          "BucketedGenerator parts from generate where it pads nothing")
    batch = modal_batch(cfg, device, train=True, seed=2, batch=ENCDEC_TRAIN["batch"],
                        seq=ENCDEC_TRAIN["seq"])
    peak_reset(device)
    tr = phase_modal_train(cfg, params, batch, impl="cuda", steps=ENCDEC_TRAIN["steps"])
    print(f"[encdec] {cfg.name} train, {ENCDEC_TRAIN['steps']} steps at "
          f"{ENCDEC_TRAIN['batch']} x {ENCDEC_TRAIN['seq']} tokens over {cfg.prefix_len} "
          f"frames (AdamW lr {ALGO_OPT.lr}): " + ", ".join(
              f"loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f}" for m in tr["steps"])
          + f"; {tr['moved']}/{tr['leaves']} fp32 master leaves moved ({tr['params_moved']} "
          f"bf16 parameters), finite {tr['finite']}; "
          f"{tr['seconds']:.2f}s, peak {peak(device)} bytes; launches {tr['launches']} "
          f"(predicted {tr['predicted']})")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in tr["steps"]),
          "non-finite train metrics")
    check(tr["finite"] and tr["moved"] == tr["leaves"], "the train steps left a master leaf "
          "unmoved or a parameter non-finite")
    check(same_launches(tr["launches"], tr["predicted"]),
          f"train: launches {tr['launches']} != {tr['predicted']}")
    for k in total:
        total[k] += tr["launches"][k]
    del params, tr
    free(device)
    small = shallow(cfg, 2, dtype="float32")
    p32 = make_dense_params(small, seed=1, device=device)
    gt = grad_tiers(small, p32, modal_batch(small, device, train=True, seed=3,
                                            batch=ENCDEC_TRAIN["batch"],
                                            seq=ENCDEC_TRAIN["seq"]), impl="cuda")
    del p32
    free(device)
    print(f"[encdec] {cfg.name} fp32, {small.num_layers} encoder + {small.num_layers} decoder "
          f"layers: lm_loss {gt['loss']:.5f} loss_err={gt['loss_err']:.3e} gradient "
          f"global_err={gt['global_err']:.3e} worst leaf {gt['worst_leaf']} "
          f"{gt['worst_leaf_err']:.3e} over {gt['n_leaves']} leaves (tol {FP32_GRAD_TOL})")
    check(max(gt["loss_err"], gt["global_err"], gt["worst_leaf_err"]) <= FP32_GRAD_TOL,
          f"{cfg.name}: fp32 gradients cuda vs reference past {FP32_GRAD_TOL}")
    print(f"[time] phase 13a {time.perf_counter() - t0:.1f}s")


def report_prefix(device, total):
    """13b: internvl2-76b at full width on PREFIX_LAYERS layers, bf16,
    seeded weights with norm scales drawn: the tiers, the prefix's reach
    and the token ids under it ignored, greedy ``generate``, and one
    ``lm_loss`` with its backward whose loss keeps its bits when the labels
    under the prefix change."""
    cfg = shallow(get_config(PREFIX), PREFIX_LAYERS)
    t0 = time.perf_counter()
    params = make_dense_params(cfg, seed=0, device=device)
    sync(device)
    print(f"[prefix] {cfg.name}: {cfg.num_layers} of 80 layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, a {cfg.prefix_len}-embedding "
          f"prefix, vocabulary {cfg.vocab_size}, {sum(t.numel() for t in tree_leaves(params))} "
          f"parameters drawn in {time.perf_counter() - t0:.1f}s; memory_allocated="
          f"{torch.cuda.memory_allocated()} bytes")
    batch = modal_batch(cfg, device, **PREFIX_SLICE)
    report_modal_slice(cfg, params, batch, "[prefix]")
    sync(device)
    reset_launches()
    t1 = time.perf_counter()
    out = MDL.generate(params, cfg, batch, num_new_tokens=PREFIX_NEW, impl="cuda")
    sync(device)
    dt = time.perf_counter() - t1
    counts = launches()
    n = attn_layers(cfg)
    want = {"flash_mha": n, "flash_decode": n * (PREFIX_NEW - 1)}
    toks = out["tokens"]
    print(f"[prefix] {cfg.name} greedy generate: {tuple(toks.shape)} tokens after "
          f"{PREFIX_SLICE['seq']} positions, {toks.numel() / dt:.1f} tokens/s in {dt:.3f}s; "
          f"launches {counts} (predicted {want})")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token out of range")
    check(same_launches(counts, want), f"generate: launches {counts} != {want}")
    for k in total:
        total[k] += counts[k]
    del out
    peak_reset(device)
    reset_launches()
    pl = prefix_loss_check(cfg, params, modal_batch(cfg, device, train=True, seed=4,
                                                    **PREFIX_SLICE), impl="cuda")
    counts = launches()
    # the loss under grad, its recompute in the backward (remat), the loss again
    want = {"flash_mha": 3 * n}
    print(f"[prefix] {cfg.name} bf16 lm_loss {pl['loss']:.6f} with its backward (gradients "
          f"finite {pl['grads_finite']}), {pl['loss_moved']:.6f} with the labels and tokens "
          f"under the prefix changed; peak {peak(device)} bytes; launches {counts} "
          f"(predicted {want})")
    check(math.isfinite(pl["loss"]) and pl["grads_finite"], "non-finite loss or gradient")
    check(same_launches(counts, want), f"lm_loss: launches {counts} != {want}")
    check(pl["loss"] == pl["loss_moved"], "the labels under the prefix reach the loss")
    for k in total:
        total[k] += counts[k]
    del params
    free(device)
    print(f"[time] phase 13b {time.perf_counter() - t0:.1f}s")


def report_phase13(device, total):
    """Phase 13: (a) seamless-m4t-medium, then (b) internvl2-76b, each
    model's parameters freed before the next is built.  The kernels at
    these configs' shapes run in phase 2."""
    t0 = time.perf_counter()
    report_encdec(device, total)
    report_prefix(device, total)
    print(f"[time] phase 13 {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 14
# Snowflake Arctic: in every layer 128 experts top-2 of (7,168 x 4,864)
# beside a dense residual MLP of d_ff 4,864, 56 query / 8 KV heads of 128,
# an untied 32,000 vocabulary.  One layer is 27.2 GB in bf16 (26.78 GB of
# it experts), so the card holds 2 of its 35 layers (55.4 GB with the
# embedding and head; 3 would take 82.6 GB); the gradient (its bf16
# gradients as large again), the expert split (a sharded copy) and the
# fp32 tiers (54 GB) run on 1.
#
# With 128 experts the router's k-th and (k+1)-th probabilities lie close,
# so bf16 rounding (the tiers round attention differently) parts ~2% of
# the (token, layer) routes, and with top-2 a parted route swaps half of
# its token's expert output: the H100 read 2.6e-1 of max |logit| over all
# compared logits, route agreement 0.98.  Two runs are held where every
# layer routed the compared token alike, and each parting that no earlier
# one reaches (``first_partings``) to a near-tie: ROUTE_TIE_TOL in fp32,
# BF16_ROUTE_TIE_TOL in bf16.

ARCTIC = "arctic-480b"
ARCTIC_LAYERS = 2
ARCTIC_EP = (1, 4)  # (e): 32 experts and 1,216 of the dense residual's 4,864 per rank
ARCTIC_TRAIN = dict(batch=4, prompt=128, new=128)


def plain_arctic_ffn(p, cfg, x):
    """Arctic's FFN transcribed from its published definition, in fp32 and
    independent of ``models/moe.py``: a softmax router, each token through
    its top-k experts' SwiGLU weighted by their probabilities renormalised
    to sum to 1, plus the dense residual SwiGLU MLP.  x: (..., D); returns
    (T, D)."""
    silu = torch.nn.functional.silu
    x = x.float().reshape(-1, x.shape[-1])
    probs = torch.softmax(x @ p["router"]["w"].float(), dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j])
            h = silu(x[t] @ p["w_gate"][e].float()) * (x[t] @ p["w_in"][e].float())
            out[t] += w[t, j] * (h @ p["w_out"][e].float())
    d = p["dense"]
    h = silu(x @ d["w_gate"]["w"].float()) * (x @ d["w_in"]["w"].float())
    return out + h @ d["w_out"]["w"].float()


def arctic_layer_check(cfg, params, *, impl, tokens=8, seed=0):
    """Layer 0's FFN (``moe.moe_apply``) under each dispatch against
    ``plain_arctic_ffn`` on ``tokens`` normal inputs (8: within the
    capacity floor, so the capacity dispatch keeps every assignment):
    {dispatch: max |difference| over max |plain|}."""
    device = params["embed"]["table"].device
    g = torch.Generator(device=device).manual_seed(seed)
    p = params["layers"][0]["ffn"]
    x = torch.randn((1, tokens, cfg.d_model), generator=g, device=device).to(L.dtype_of(cfg))
    out = {}
    with torch.no_grad():
        want = plain_arctic_ffn(p, cfg, x)
        for dispatch in ("dropless", "capacity"):
            got = MOE.moe_apply(p, dataclasses.replace(cfg, moe_dispatch=dispatch), x,
                                impl=impl)
            check(bool(torch.isfinite(got).all()), f"{cfg.name} {dispatch}: non-finite FFN")
            out[dispatch] = ((got.float().reshape(want.shape) - want).abs().max().item()
                             / want.abs().max().item())
    return out


def phase_capacity(cfg, params, *, impl, batch=4, prompt_len=256, steps=8, seed=0):
    """The capacity dispatch (``cfg`` with ``moe_dispatch="capacity"``):
    ``compare_routed`` of ``impl`` against "reference" on ``batch`` x
    ``prompt_len`` prompts and ``steps`` decode steps, with the share of
    assignments the ``impl`` run's prefill drops and its launches; then on
    the same rows at prompt length 1, every cohort ``batch`` tokens (within
    the capacity floor: nothing drops), against the dropless dispatch
    under ``impl`` (``small``, with the assignments dropped there)."""
    ccfg = dataclasses.replace(cfg, moe_dispatch="capacity")
    toks, feed = slice_tokens(cfg, params, batch, prompt_len, steps, seed)
    reset_launches()
    out = compare_routed(params, toks, feed, (ccfg, impl), (ccfg, "reference"))
    out["launches"] = launches()
    prefill = out["capacity"][:sum(s.has_ffn for s in cfg.layers)]
    out.update(dropped=sum(c[0] for c in prefill), assignments=sum(c[1] for c in prefill))
    out["drop_share"] = out["dropped"] / out["assignments"]
    small = compare_routed(params, toks[:, :1], feed, (ccfg, impl), (cfg, impl))
    small["dropped"] = sum(c[0] for c in small["capacity"])
    out["small"] = small
    return out


def parted_tokens(cfg, params, tokens, *, impl):
    """The forwards of ``impl`` and the reference on ``tokens`` (B, S), each
    router call recorded: ``parted_grid``'s (B, S) tokens whose expert set
    parts in some MoE layer and largest gap at a first parting."""
    runs = []
    with torch.no_grad():
        for name in (impl, "reference"):
            with recorded_routes() as routes:
                MDL.forward(params, cfg, {"tokens": tokens}, impl=name)
            runs.append(routes)
    return parted_grid(route_diff(*runs), *tokens.shape)


def grad_tiers_in_place(cfg, params, batch, *, impl):
    """``grad_tiers`` without a copy of the parameters, which take
    requires_grad in place for the two backward passes (a copy of one
    Arctic layer is 27 GB more); the first pass's bf16 gradients wait on
    the host while the second runs.  Returns grad_tiers' numbers, both aux
    losses, whether every gradient is finite and the first pass's
    launches."""
    leaves = adamw.leaves(params)
    device = leaves[0].device
    for t in leaves:
        t.requires_grad_(True)
    try:
        reset_launches()
        loss, stats = MDL.lm_loss(params, cfg, batch, impl=impl)
        loss.backward()
        counts = launches()
        finite = all(all_finite(t.grad) for t in leaves)
        got = []
        for t in leaves:
            got.append(t.grad.to("cpu"))
            t.grad = None
        ref_loss, ref_stats = MDL.lm_loss(params, cfg, batch, impl="reference")
        ref_loss.backward()
        sq = [square_norms(g.to(device), t.grad) for g, t in zip(got, leaves)]
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
    worst = max(zip((math.sqrt(d2 / max(r2, 1e-60)) for d2, r2 in sq), leaf_names(params)))
    return {"loss": loss.item(),
            "loss_err": abs(loss.item() - ref_loss.item()) / max(abs(ref_loss.item()), 1e-12),
            "aux_loss": stats["aux_loss"].item(), "ref_aux_loss": ref_stats["aux_loss"].item(),
            "global_err": math.sqrt(sum(d2 for d2, _ in sq) / max(sum(r2 for _, r2 in sq),
                                                                   1e-60)),
            "worst_leaf_err": worst[0], "worst_leaf": worst[1], "n_leaves": len(sq),
            "finite": finite, "launches": counts}


def arctic_grouped_case(cfg, ffn, device):
    """grouped_ffn on layer 0's own expert weights (no second 27 GB copy)
    at phase 14's prefill (4 x 256 tokens, top-2: N 2,048) and a decode
    step of 8 rows (N 16), rows routed by layer 0's router from normal
    inputs: held to the plain version (GROUPED_TOL) and timed
    (``grouped_times``)."""
    g = torch.Generator(device=device).manual_seed(14)
    wb = (ffn["w_gate"], ffn["w_in"], ffn["w_out"])
    e, d, f = wb[0].shape
    out = {}
    for key, t in (("arctic_prefill", 4 * 256), ("arctic_decode", 8)):
        x = torch.randn((t, d), generator=g, device=device).to(torch.bfloat16)
        xs, gs, _ = routed_rows(x, ffn["router"]["w"], cfg.top_k)
        label = (f"grouped_ffn {key} (E {e}, D {d}, F {f}, N {xs.shape[0]}, "
                 f"{int((gs > 0).sum())} experts hit)")
        err = held(label, grouped_ffn(xs, gs, *wb), ref.grouped_ffn_ref(xs, gs, *wb),
                   GROUPED_TOL)
        out[key] = r = dict(max_abs_err=err, **grouped_times(xs, gs, wb, plain_iters=5))
        print(f"[kernels] {label}: ms={r['ms']:.4f} (warm L2) cold_ms={r['cold_ms']:.4f} "
              f"(L2 flushed) eager_ms={r['eager_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; {r['bound_ms'] / r['ms']:.3f} "
              f"of ms) library_ms={r['library_ms']:.4f} ({r['library']})")
    return out


def route_tie_tol(cfg):
    """The near-tie a first route parting of ``cfg``'s runs is held to."""
    return ROUTE_TIE_TOL if cfg.dtype == "float32" else BF16_ROUTE_TIE_TOL


def report_routed(tag, cfg, r, what):
    """Print and hold one ``compare_routed`` result of an MoE model: the
    error over the compared tokens every layer routed alike (LOGIT_TOL,
    FP32_LOGIT_TOL in fp32), each first parting a near-tie
    (``route_tie_tol``)."""
    tol = FP32_LOGIT_TOL if cfg.dtype == "float32" else LOGIT_TOL
    print(f"{tag} {cfg.name} {what}: error {r['agreed_err']:.3e} over the "
          f"{r['entries'] - r['parted']} of {r['entries']} compared tokens every layer routed "
          f"alike (of max |logit| {r['logit_scale']:.3f}; tol {tol}); over all: prefill_err="
          f"{r['prefill_err']:.3e} decode_err={r['decode_err']:.3e}; largest probability gap "
          f"at a route parting no earlier one reaches {r['held_gap']:.3e} (tol "
          f"{route_tie_tol(cfg)}); route_agreement={r['route_agreement']:.4f} "
          f"argmax_agreement={r['argmax_agreement']:.3f}")
    check(r["agreed_err"] <= tol, f"{cfg.name} {what}: logits disagree where the routes agree")
    check(r["held_gap"] <= route_tie_tol(cfg), f"{cfg.name} {what}: a route parts past a near-tie")


def report_capacity(cfg, params):
    """14c on the card: ``phase_capacity``, printed and held."""
    r = phase_capacity(cfg, params, impl="cuda")
    print(f"[arctic] capacity dispatch, 4 x 256 prompt tokens (capacity "
          f"{MOE.capacity(4 * 256, cfg)} rows per expert, "
          f"{4 * 256 * cfg.top_k / cfg.n_experts:g} on average): {r['dropped']} of "
          f"{r['assignments']} assignments dropped (share {r['drop_share']:.4f}) over the "
          f"prefill's {cfg.num_layers} layers; launches {r['launches']} (no grouped_ffn)")
    report_routed("[arctic]", cfg, r, "capacity dispatch, cuda vs reference")
    report_routed("[arctic]", cfg, r["small"],
                  f"capacity vs dropless on 4-token cohorts (capacity {MOE.capacity(4, cfg)}, "
                  f"the floor; {r['small']['dropped']} dropped)")
    check(r["drop_share"] > 0, "the capacity dispatch dropped nothing at 4 x 256 tokens")
    check(r["launches"]["grouped_ffn"] == 0 and r["launches"]["flash_mha"] == cfg.num_layers,
          f"capacity dispatch: launches {r['launches']}")
    check(r["small"]["dropped"] == 0, "the capacity dispatch dropped within its floor")


def report_arctic_grads(cfg, params, device, total):
    """14d on the card: one bf16 ``lm_loss`` with its backward, cuda
    against reference (loss and whole gradient at TRAIN_TOL, each leaf at
    TRAIN_LEAF_TOL, as phase 6) on a mask that leaves out the tokens whose
    route parts between the tiers (on 1 layer a token's route reaches only
    its own loss term; the aux loss keeps every token), each parting a
    near-tie (``route_tie_tol``); launches held and added to ``total``."""
    batch = lm_batch(cfg, device, **ARCTIC_TRAIN)
    parted, held_gap = parted_tokens(cfg, params, batch["tokens"], impl="cuda")
    batch["mask"] = batch["mask"].masked_fill(parted.to(device), 0.0)
    peak_reset(device)
    t0 = time.perf_counter()
    r = grad_tiers_in_place(cfg, params, batch, impl="cuda")
    want = {"flash_mha": 2 * attn_layers(cfg), "grouped_ffn": 2 * moe_layers(cfg)}
    print(f"[arctic] {cfg.name} {cfg.num_layers} layer bf16 lm_loss {r['loss']:.6f} (aux "
          f"{r['aux_loss']:.6f}, reference {r['ref_aux_loss']:.6f}) with its backward on "
          f"{ARCTIC_TRAIN['batch']} x {ARCTIC_TRAIN['prompt'] + ARCTIC_TRAIN['new']} tokens "
          f"({int(parted.sum())} tokens whose route parts between the tiers masked out, "
          f"largest probability gap {held_gap:.3e}, tol {route_tie_tol(cfg)}), "
          f"cuda vs reference: loss_err={r['loss_err']:.3e} global_err={r['global_err']:.3e} "
          f"(tol {TRAIN_TOL}) worst leaf {r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol "
          f"{TRAIN_LEAF_TOL}) over {r['n_leaves']} leaves; gradients finite {r['finite']}; "
          f"{time.perf_counter() - t0:.1f}s; peak {peak(device)} bytes; launches "
          f"{r['launches']} (predicted {want})")
    check(r["finite"] and math.isfinite(r["loss"]), "non-finite loss or gradient")
    check(held_gap <= route_tie_tol(cfg), "Arctic gradient: a route parts past a near-tie")
    check(r["loss_err"] <= TRAIN_TOL and r["global_err"] <= TRAIN_TOL,
          "Arctic gradient: cuda disagrees with the reference")
    check(r["worst_leaf_err"] <= TRAIN_LEAF_TOL, f"Arctic gradient: leaf {r['worst_leaf']}")
    check(same_launches(r["launches"], want), f"lm_loss: launches {r['launches']} != {want}")
    for k in total:
        total[k] += r["launches"][k]


def report_arctic(device, total, kern):
    """Phase 14: arctic-480b at full width on ARCTIC_LAYERS layers, bf16,
    seeded weights with norm scales drawn: (a) layer 0's FFN against a
    plain transcription, the tiers and paged decode; (b) phases 4 and 5,
    greedy; (c) the capacity dispatch; grouped_ffn at its shapes (added to
    ``kern``); then on layer 0 alone (d) the gradient and (e) the experts
    over ARCTIC_EP ranks; last the tiers in fp32 on 1 layer."""
    t0 = time.perf_counter()
    cfg = shallow(get_config(ARCTIC), ARCTIC_LAYERS)
    peak_reset(device)
    params = make_dense_params(cfg, seed=0, device=device)
    sync(device)
    leaves = tree_leaves(params)
    print(f"[arctic] {cfg.name}: {cfg.num_layers} of 35 layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.expert_d_ff} and a dense "
          f"residual of d_ff {cfg.d_ff}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.head_dim}, vocabulary {cfg.vocab_size}; {sum(t.numel() for t in leaves)} "
          f"parameters, {sum(t.numel() * t.element_size() for t in leaves)} bytes of weights "
          f"drawn in {time.perf_counter() - t0:.1f}s; memory_allocated="
          f"{torch.cuda.memory_allocated()} bytes, max_memory_allocated={peak(device)} "
          "bytes (the init)")
    del leaves
    errs = arctic_layer_check(cfg, params, impl="cuda")
    print(f"[arctic] layer 0's FFN vs a plain fp32 transcription (softmax top-{cfg.top_k}, "
          "renormalised, plus the dense residual), 8 tokens: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {KERNEL_TOL})")
    check(max(errs.values()) <= KERNEL_TOL, "Arctic's FFN disagrees with its definition")
    report_routed("[slice]", cfg, phase_slice(cfg, params, impl="cuda"),
                  f"{cfg.num_layers} layers bf16, cuda vs reference")
    report_paged(cfg, params)
    print(f"[arctic] max_memory_allocated={peak(device)} bytes")
    report_batch_serve(cfg, params, total, modes=("greedy",), tag="[arctic]")
    report_continuous(cfg, params, total, ("greedy",), near_ties=True)
    report_capacity(cfg, params)
    kern["grouped_ffn"].update(arctic_grouped_case(cfg, params["layers"][0]["ffn"], device))
    del params["layers"][1:]
    cfg = shallow(cfg, 1)
    free(device)
    report_arctic_grads(cfg, params, device, total)
    check_ep(cfg, params, ARCTIC_EP, device, total, "[arctic]", routed=True)
    del params
    free(device)
    small = dataclasses.replace(shallow(cfg, 1, dtype="float32"), name=f"{ARCTIC} fp32")
    peak_reset(device)
    p32 = make_dense_params(small, seed=1, device=device)
    report_routed("[slice]", small, phase_slice(small, p32, impl="cuda"),
                  "1 layer, cuda vs reference")
    report_continuous(small, p32, total, ("greedy",))
    print(f"[arctic] fp32 1 layer: max_memory_allocated={peak(device)} bytes")
    del p32
    free(device)
    print(f"[time] phase 14 {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 15
# Sharded compute of the recurrent mixers and of the capacity dispatch, on
# logical devices of the card (phase 11's machinery): mamba2-1.3b's SSD
# layer split by head, recurrentgemma-9b's RG-LRU block by channel and its
# local attention's one KV head on every rank for a block of the slots, each
# trained on TRAIN_LAYOUT, its trained tree moved to GEN_LAYOUT by
# ``prefetch_reshard`` and served there; arctic-480b's capacity dispatch
# over the global cohort of CAP_LAYOUT's replicas.
# (model, bf16 layers trained, fp32 layers, bf16 served at full depth)
REC_SHARDED = (("mamba2-1.3b", 8, 2, True), ("recurrentgemma-9b", 5, 3, False))
REC_TRAFFIC = dict(batch=8, prompt=128, new=128)  # phase 7's
CAP_LAYOUT = (2, 2)  # (c): 64 of 128 experts per model rank, replicated over data
CAP_TOKENS = (4, 256)


def first_layers(cfg, n, *, dtype=None):
    """``cfg`` at full width on its first ``n`` layers."""
    return dataclasses.replace(cfg, superblock=tuple(cfg.layers[:n]), n_superblocks=1, tail=(),
                               num_layers=n, dtype=dtype or cfg.dtype)


def allreduce_bytes(nbytes, k, groups=1):
    """Bytes ``collectives.all_reduce`` moves: per group of k, k - 1 values
    to the root and the sum back to each of them."""
    return groups * 2 * (k - 1) * nbytes


def allgather_bytes(part, k, groups=1):
    """Bytes ``collectives.all_gather`` moves: every member of a group of k
    receives the k - 1 parts of the others."""
    return groups * k * (k - 1) * part


def stack_bytes(cfg, tp, rows, seq, *, cross=None, decode=False):
    """Bytes the collectives move in one sharded pass of ``rows`` x ``seq``
    through ``cfg``'s layer stack on a (1, tp) mesh: per layer the mixer's
    and the FFN's fp32 shares summed; an SSD layer's ``in_proj`` product,
    conv weights and norm sums of squares; a replicated-KV attention
    layer's wk/wv blocks, and its wq blocks where the axis splits a head
    (``heads_split``).  A ``decode`` step over caches split by slot
    (``seq_split``) gathers wq too (every rank computes every query head)
    and merges the ranks' partials: an all-reduce max of the (rows, Hq)
    fp32 lse and an all-reduce sum of the (rows, Hq, Dh + 1) fp32 weighted
    rows and weights.  ``cross`` ("prefill" or "decode") adds a decoder
    layer's cross-attention: its fp32 shares summed, its wq blocks where
    ``heads_split``, and in prefill its wk/wv blocks where replicated
    (decode reads its "xkv" cache).  A block the axis leaves whole
    (``whole_blocks``) sums nothing over it; it gathers only the leaves the
    axis still splits (``whole_gather_bytes``)."""
    bf, f32 = L.dtype_of(cfg).itemsize, 4
    act = rows * seq * cfg.d_model
    whole = whole_blocks(cfg, tp)
    kv_w = q_w = 0
    rows_w = cfg.d_model + (1 if cfg.qkv_bias else 0)  # the bias as one more row
    if T.kv_replicated(cfg, tp):
        kv_w = 2 * allgather_bytes(rows_w * cfg.kv_dim // tp * bf, tp)
    if T.heads_split(cfg, tp):  # wq gathered too: every rank computes every head
        q_w = allgather_bytes(rows_w * cfg.q_dim // tp * bf, tp)
    self_q_w, merge = q_w, 0
    if decode and tp > 1 and T.seq_split(cfg, tp):
        self_q_w = allgather_bytes(rows_w * cfg.q_dim // tp * bf, tp)
        merge = (allreduce_bytes(rows * cfg.n_heads * f32, tp)
                 + allreduce_bytes(rows * cfg.n_heads * (cfg.head_dim + 1) * f32, tp))
    out = 0
    for spec in cfg.layers:
        kind = {ATTN: "attn", LRU: "lru", SSM: "ssm"}[spec.kind]
        if whole[kind]:  # a decoder layer's cross-attention gathers as its self-attention
            out += whole_gather_bytes(cfg, tp, spec.kind) * (2 if cross else 1)
        else:
            out += allreduce_bytes(act * f32, tp)
        if cross and not whole["attn"]:
            out += (allreduce_bytes(act * f32, tp) + q_w
                    + (kv_w if cross == "prefill" else 0))
        if spec.has_ffn and cfg.ffn_kind != "none" and not whole["ffn"]:
            out += allreduce_bytes(act * f32, tp)
        if whole[kind]:
            continue
        if spec.kind == SSM:
            di, n = cfg.ssm_inner, cfg.ssm_state
            cols, ch = 2 * di + 2 * n + cfg.ssm_heads, di + 2 * n
            out += allgather_bytes(rows * seq * cols // tp * bf, tp)
            out += allgather_bytes((cfg.ssm_conv + 1) * ch // tp * bf, tp)
            out += allreduce_bytes(rows * seq * f32, tp)
        elif spec.kind == ATTN:
            out += kv_w + self_q_w + merge
    return out


def sharded_serve_bytes(cfg, tp, rows, seq, *, decode=False):
    """Bytes the collectives move in one sharded prefill (``seq`` tokens) or
    decode step (``decode``, ``seq`` 1) of ``rows`` rows on a (1, tp) mesh:
    the vocabulary-parallel embedding's sum, then ``stack_bytes`` of the
    decoder; an encoder-decoder's prefill adds its encoder's over
    ``prefix_len`` frames (two all-reduces per layer)."""
    out = (allreduce_bytes(rows * seq * cfg.d_model * L.dtype_of(cfg).itemsize, tp)
           if cfg.vocab_size % tp == 0 else 0)
    if cfg.family != "encdec":
        return out + stack_bytes(cfg, tp, rows, seq, decode=decode)
    out += stack_bytes(cfg, tp, rows, seq, cross="decode" if decode else "prefill",
                       decode=decode)
    return out if decode else out + stack_bytes(cfg, tp, rows, cfg.prefix_len)


def serve_predicted(cfg, tp, steps):
    """Launches of a sharded prefill and ``steps`` decode steps on tp
    ranks: every rank's flash_mha and scans per prefill, flash_decode per
    attention layer per step, grouped_ffn per dropless MoE layer per
    prefill and per step; an encoder-decoder's prefill also runs its
    encoder's and its cross-attention's flash_mha, and each decode step
    its cross-attention's (Sq 1)."""
    n, e = attn_layers(cfg), moe_layers(cfg)
    prefill = {"flash_mha": tp * n, **{k: tp * v for k, v in scan_launches(cfg, 1).items()}}
    decode = {"flash_decode": tp * n * steps}
    if e:
        prefill["grouped_ffn"], decode["grouped_ffn"] = tp * e, tp * e * steps
    if cfg.family == "encdec":
        prefill["flash_mha"] *= 3
        decode["flash_mha"] = tp * n * steps
    return prefill, decode


def phase_rec_sharded(cfg, params, batch, *, impl, rest=None, steps=8, serve_batch=4,
                      prompt_len=256):
    """15a/b and 16a for one model: ``phase_tp_train`` on TRAIN_LAYOUT, the trained
    tree moved to GEN_LAYOUT by ``prefetch_reshard`` (donating), then
    ``phase_tp_serve`` of it there against the single-device steps on the
    gathered tree.  ``rest``: (full config, the layers after ``cfg``'s),
    served behind the trained ones at full depth.  Returns (train, move,
    serve) results."""
    device = params["embed"]["table"].device
    train = phase_tp_train(cfg, params, batch, TRAIN_LAYOUT, impl=impl)
    trained = train.pop("trained")
    serve_cfg, rest_layers = rest if rest else (cfg, [])
    full = {**params, "layers": list(params["layers"]) + list(rest_layers)}
    lay = strategy_layouts(full, *GEN_LAYOUT, tuple(range(GEN_LAYOUT[1])), device)
    mine = {**lay, "layers": lay["layers"][:cfg.num_layers]}
    t0 = time.perf_counter()
    task = RX.prefetch_reshard(trained, mine)
    moved = task.wait()
    sync(device)
    move = dict(seconds=time.perf_counter() - t0, n_moved=task.n_moved,
                n_aliased=task.n_aliased, moved_bytes=task.moved_bytes,
                total_bytes=task.total_bytes)
    del trained, task
    moved["layers"] = moved["layers"] + place_tree(list(rest_layers),
                                                   lay["layers"][cfg.num_layers:])
    dense = tree_map(lambda st: st.gather(device), moved)
    move["finite"] = all(bool(torch.isfinite(t).all()) for t in tree_leaves(dense))
    mesh = tree_leaves(moved)[0].layout.mesh
    serve = phase_tp_serve(serve_cfg, dense, GEN_LAYOUT, impl=impl, batch=serve_batch,
                           prompt_len=prompt_len, steps=steps, sharded=(mesh, moved))
    serve["predicted_bytes"] = (sharded_serve_bytes(serve_cfg, GEN_LAYOUT[1], serve_batch,
                                                    prompt_len),
                                sharded_serve_bytes(serve_cfg, GEN_LAYOUT[1], serve_batch, 1,
                                                    decode=True))
    serve["predicted"] = serve_predicted(serve_cfg, GEN_LAYOUT[1], steps)
    return train, move, serve


def report_rec_sharded(name, layers, fp32_layers, full_depth, device, total):
    """15a/b on the card: ``name`` at full width, ``layers`` bf16 layers
    trained (TRAIN_TOL / TRAIN_LEAF_TOL) and served (LOGIT_TOL), with
    ``full_depth`` at full depth behind the trained layers; the same on
    ``fp32_layers`` fp32 layers (FP32_GRAD_TOL, FP32_LOGIT_TOL) at their
    depth."""
    cfg = get_config(name)
    batch = lm_batch(cfg, device, **REC_TRAFFIC)
    for dtype, n, tol, leaf_tol, logit_tol, seed in (
            ("bfloat16", layers, TRAIN_TOL, TRAIN_LEAF_TOL, LOGIT_TOL, 0),
            ("float32", fp32_layers, FP32_GRAD_TOL, FP32_GRAD_TOL, FP32_LOGIT_TOL, 1)):
        peak_reset(device)
        t0 = time.perf_counter()
        deep = full_depth and dtype == cfg.dtype
        c = first_layers(cfg, n, dtype=dtype)
        whole = make_params(cfg if deep else c, seed=seed, device=device)
        rest = None
        if deep:
            rest = (cfg, whole["layers"][n:])
            whole["layers"] = whole["layers"][:n]
        runs = phase_rec_sharded(c, whole, batch, impl="cuda", rest=rest)
        del whole, rest
        report_train_move_serve(
            "[rec]", c, runs, (tol, leaf_tol, logit_tol), device, total, t0,
            train_what=f"{n} layers {dtype} on (data, model)={TRAIN_LAYOUT}, "
                       f"{REC_TRAFFIC['batch']} x "
                       f"{REC_TRAFFIC['prompt'] + REC_TRAFFIC['new']} tokens",
            serve_what=f"{cfg.num_layers if deep else n} layers {dtype} on (data, model)="
                       f"{GEN_LAYOUT}, 4 x 256 tokens then 8 decode steps")
        del runs
        free(device)


def report_train_move_serve(tag, c, runs, tols, device, total, t0, *, train_what,
                            serve_what):
    """Print ``phase_rec_sharded``'s (train, move, serve) of config ``c``
    and hold them to ``tols`` (train, train per leaf, logits), the launches
    and the serve's bytes to their predictions; add the launches to
    ``total``."""
    train, move, serve = runs
    name = c.name
    tol, leaf_tol, logit_tol = tols
    ref, want = train["ref"], tp_train_predicted(c, TRAIN_LAYOUT)
    print(f"{tag} train {name} {train_what}: "
          f"loss {train['loss']:.6e} vs {ref['loss']:.6e} (err {train['loss_err']:.3e}), "
          f"grad_norm err {train['grad_norm_err']:.3e}, first moment err "
          f"{train['global_err']:.3e}, worst leaf {train['worst_leaf']} "
          f"{train['worst_leaf_err']:.3e} (tol {tol}, per leaf {leaf_tol}); replicas "
          f"bit-equal {train['replicas_equal']}; {train['seconds']:.3f}s (single device "
          f"{ref['seconds']:.3f}s), peak {train['peak']} bytes (single device "
          f"{ref['peak']}), collectives moved {train['bytes']} bytes in "
          f"{train['copies']} copies; launches {train['launches']} (predicted {want})")
    check(max(train["loss_err"], train["grad_norm_err"], train["global_err"]) <= tol
          and train["worst_leaf_err"] <= leaf_tol,
          f"sharded train step of {name} disagrees with the single-device step")
    check(train["replicas_equal"], f"{name}: replicas differ after the sharded step")
    check(train["finite"] and train["moved"], f"{name}: trained parameters not finite "
          "or unmoved")
    check(same_launches(train["launches"], want),
          f"{name}: sharded train launches {train['launches']} != {want}")
    print(f"{tag} reshard {name} trained tree {TRAIN_LAYOUT} -> {GEN_LAYOUT}: "
          f"{move['n_moved']} leaves moved ({move['moved_bytes']} of "
          f"{move['total_bytes']} bytes), {move['n_aliased']} aliased, "
          f"{move['seconds']:.3f}s, finite {move['finite']}")
    check(move["finite"], f"{name}: non-finite tree after the reshard")
    report_sharded_serve(tag, name, serve, logit_tol, device, total, t0, serve_what=serve_what)
    for k in total:
        total[k] += train["launches"][k]


def report_sharded_serve(tag, name, serve, logit_tol, device, total, t0, *, serve_what):
    """Print ``phase_tp_serve``'s result with its "predicted" launches and
    "predicted_bytes", hold the logits to ``logit_tol`` and the launches and
    bytes to their predictions; add the launches to ``total``."""
    pre_want, dec_want = serve["predicted"]
    pb, db = serve["predicted_bytes"]
    print(f"{tag} serve {name} {serve_what}: prefill_err={serve['prefill_err']:.3e} "
          f"decode_err={serve['decode_err']:.3e} (of max |logit| "
          f"{serve['logit_scale']:.3f}; tol {logit_tol}), greedy agreement "
          f"{serve['argmax_agreement']:.3f}, gathered caches differ by "
          f"{serve['cache_diff']:.3e} at most ({serve['cache_err']:.3e} of a leaf's largest "
          f"|value|); prefill {serve['prefill_s']:.3f}s (single device "
          f"{serve['ref_prefill_s']:.3f}s), {serve['prefill_bytes']} bytes moved (predicted "
          f"{pb}); decode {serve['decode_s']:.4f}s per step (single device "
          f"{serve['ref_decode_s']:.4f}s), {serve['decode_bytes']} bytes (predicted {db}); "
          f"peak {peak(device)} bytes over the part; launches prefill "
          f"{serve['prefill_launches']} (predicted {pre_want}), decode "
          f"{serve['decode_launches']} (predicted {dec_want}); "
          f"{time.perf_counter() - t0:.1f}s")
    check(serve["prefill_err"] <= logit_tol and serve["decode_err"] <= logit_tol,
          f"sharded {name} logits disagree with the single-device run")
    check(serve["prefill_bytes"] == pb and serve["decode_bytes"] == db,
          f"{name}: sharded serve moved {serve['prefill_bytes']} / "
          f"{serve['decode_bytes']} bytes, predicted {pb} / {db}")
    check(same_launches(serve["prefill_launches"], pre_want)
          and same_launches(serve["decode_launches"], dec_want),
          f"{name}: sharded serve launches {serve['prefill_launches']} / "
          f"{serve['decode_launches']}")
    for k in total:
        total[k] += serve["prefill_launches"][k] + serve["decode_launches"][k]


@contextlib.contextmanager
def recorded_sharded_capacity():
    """Record every ``capacity_route_sharded`` call while the block runs:
    {rank: each row's kept experts (T_r, K) sorted, -1 for a dropped one}
    per call, into the yielded list."""
    calls = []
    route = MOE.capacity_route_sharded

    def recording(cfg, routes, *, ctx):
        out = route(cfg, routes, ctx=ctx)
        rec = {}
        for r, (order, _, _, keep, _, _) in out.items():
            top_i = routes[r][1]
            kept = torch.empty_like(keep).scatter_(0, order, keep).view(top_i.shape)
            rec[r] = torch.sort(torch.where(kept, top_i, -1), dim=-1).values
        calls.append(rec)
        return out
    MOE.capacity_route_sharded = recording
    try:
        yield calls
    finally:
        MOE.capacity_route_sharded = route


def place_freeing(tree, layouts):
    """``place_tree`` that drops each dense leaf from ``tree`` once its
    blocks are made, in ``tree_leaves`` order, so the dense tree and the
    placed one never lie on the card whole at once."""
    if isinstance(tree, dict):
        return {k: place_freeing_item(tree, k, layouts[k]) for k in sorted(tree)}
    return [place_freeing_item(tree, i, layouts[i]) for i in range(len(tree))]


def place_freeing_item(container, key, lay):
    x = container[key]
    if isinstance(x, (dict, list)):
        return place_freeing(x, lay)
    container[key] = None
    return ShardedTensor.place(x, lay)


def cap_predicted_bytes(cfg, layout, rows, seq):
    """Bytes the collectives move in the sharded forward of phase 15c
    (FSDP off): the embedding's sum over the model axis, per layer the
    attention's and the dense residual's fp32 shares and the MoE's (T_r,
    K, D) fp32 rows summed over it, the per-expert counts gathered over the
    data axis."""
    dp, tp = layout
    rows_r = rows // dp
    act = rows_r * seq * cfg.d_model
    bf = L.dtype_of(cfg).itemsize
    out = allreduce_bytes(act * bf, tp, dp) if cfg.vocab_size % tp == 0 else 0
    for spec in cfg.layers:
        out += allreduce_bytes(act * 4, tp, dp)
        if spec.has_ffn:
            out += allreduce_bytes(act * cfg.top_k * 4, tp, dp)
            out += allreduce_bytes(act * 4, tp, dp) if cfg.dense_residual_ffn else 0
            out += allgather_bytes(cfg.n_experts * 8, dp, tp)
    return out


def phase_cap_sharded(cfg, params, layout, *, impl, batch=4, prompt_len=256, seed=0):
    """15c: the forward of ``cfg`` (capacity dispatch) on one device, its
    outputs and routes kept, then ``params`` placed leaf by leaf on a
    ``layout`` mesh with FSDP off (``place_freeing``: the dense tree is
    gone after) and the sharded forward.  Returns both runs' seconds and
    routes, the assignments whose kept status the routes before them fix
    alike and those kept alike (``kept_agreement``), the hidden states'
    errors (all tokens; those routed and kept alike in every layer), the
    bytes moved and predicted, the peak memory predicted for the placement
    and measured, and launches."""
    device = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (batch, prompt_len))).to(device)
    peak_reset(device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad(), recorded_routes() as ref_routes, recorded_capacity() as ref_caps:
        want = MDL.forward(params, cfg, {"tokens": toks}, impl=impl)
    sync(device)
    out = dict(ref_seconds=time.perf_counter() - t0, ref_launches=launches(),
               ref_peak=peak(device))
    rules = SHD.ShardingRules(fsdp_axis=None)
    mesh = Mesh(np.arange(layout[0] * layout[1]).reshape(layout), ("data", "model"),
                device=device)
    specs = SHD.sanitize_specs(SHD.param_specs(params, rules), params, mesh)
    lay = tree_map(lambda sp: Layout(mesh, sp), specs)
    dense = [t.numel() * t.element_size() for t in tree_leaves(params)]
    shard = [sum(math.prod(hi - lo for lo, hi in reg) for _, reg in lt.regions(t.shape))
             * t.element_size() for t, lt in zip(tree_leaves(params), tree_leaves(lay))]
    start = sum(torch.cuda.memory_allocated(c) for c in _cards(device))
    out["predicted_peak"] = start - sum(dense) + max(
        sum(dense[i:]) + sum(shard[:i + 1]) for i in range(len(dense)))
    out["sharded_bytes"] = sum(shard)
    peak_reset(device)
    sharded = place_freeing(params, lay)
    params.clear()
    COLL.reset_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad(), recorded_routes() as routes, recorded_sharded_capacity() as caps, \
            CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        parts = PSTEPS.split_batch({"tokens": toks}, mesh, rules)
        hs = MDL.forward_sharded(sharded, cfg, parts, ctx=c, impl=impl)
        first = [next(r for r in mesh.device_ids if c.batch_index(r) == i)
                 for i in range(c.batch_size)]
    sync(device)
    out.update(seconds=time.perf_counter() - t0, bytes=COLL.STATS["bytes"],
               launches=launches(), peak=peak(device),
               predicted_bytes=cap_predicted_bytes(cfg, layout, batch, prompt_len))
    got = torch.cat([hs[r].to(device) for r in first])
    tp = layout[1]
    # routes: one router call per rank per layer, in mesh order; a
    # replica's rows from its first model rank, replica 0 first
    per_layer = [routes[i:i + len(mesh.device_ids)] for i in range(0, len(routes),
                                                                   len(mesh.device_ids))]
    joined = [(torch.cat([layer[r][0] for r in first]), torch.cat([layer[r][1] for r in first]))
              for layer in per_layer]
    out["ranks_route_alike"] = all(same(layer[r - r % tp][0], layer[r][0])
                                   for layer in per_layer for r in mesh.device_ids)
    d = route_diff(joined, ref_routes)
    kept = [torch.cat([call[r].cpu() for r in first]) for call in caps]
    compared = agree = 0
    for (sets, _), (ref_sets, _), k, rc in zip(joined, ref_routes, kept, ref_caps):
        c, a = kept_agreement(sets.cpu(), ref_sets.cpu(), k, rc[2].cpu(), cfg.n_experts)
        compared, agree = compared + c, agree + a
    out.update(routes=d, compared=compared, kept_agree=agree, tokens=toks.numel(),
               dropped=[rc[0] for rc in ref_caps], assignments=[rc[1] for rc in ref_caps],
               sharded_dropped=[int((k < 0).sum()) for k in kept])
    check(bool(torch.isfinite(got).all()), "non-finite sharded hidden states")
    alike = torch.stack(d["agree"] + [(k == rc[2].cpu()).all(-1) for k, rc in
                                      zip(kept, ref_caps)], -1).all(-1)
    err = (got - want).abs().amax(dim=-1).flatten().float().cpu()
    scale = want.abs().amax().item()
    out.update(err=err.max().item() / scale, alike=int(alike.sum()),
               err_alike=err.masked_fill(~alike, 0.0).max().item() / scale)
    return out


def kept_agreement(sets, ref_sets, kept, ref_kept, n_experts):
    """Two capacity dispatches of one cohort, per expert: an assignment's
    slot counts the cohort's earlier assignments to its expert, so up to
    the first token that one run routes to the expert and the other does
    not, the runs must keep the same assignments to it.  ``sets`` /
    ``kept``: (T, K) expert sets and kept experts (-1 dropped) of each run.
    Returns (assignments compared, those kept alike)."""
    def member(x):
        m = torch.zeros((x.shape[0], n_experts + 1), dtype=torch.bool)
        return m.scatter_(1, torch.where(x < 0, n_experts, x), True)[:, :n_experts]
    ins, ref_in = member(sets), member(ref_sets)
    keep, ref_keep = member(kept), member(ref_kept)
    parted = (ins != ref_in).int().cummax(dim=0).values.bool()  # (T, E): from the first
    both = ins & ref_in & ~parted
    return int(both.sum()), int((both & (keep == ref_keep)).sum())


def report_cap_sharded(device, total):
    """15c on the card: arctic-480b's capacity dispatch on 1 layer at full
    width, CAP_LAYOUT with FSDP off: the kept assignments equal wherever
    the routes before them agree (``kept_agreement``), every parting a
    near-tie (BF16_ROUTE_TIE_TOL)."""
    cfg = dataclasses.replace(shallow(get_config(ARCTIC), 1), moe_dispatch="capacity")
    peak_reset(device)
    t0 = time.perf_counter()
    params = make_dense_params(cfg, seed=0, device=device)
    sync(device)
    init_s, init_peak = time.perf_counter() - t0, peak(device)
    r = phase_cap_sharded(cfg, params, CAP_LAYOUT, impl="cuda", batch=CAP_TOKENS[0],
                          prompt_len=CAP_TOKENS[1])
    del params
    n = CAP_LAYOUT[0] * CAP_LAYOUT[1] * attn_layers(cfg)
    want = {"flash_mha": n}
    d = r["routes"]
    print(f"[cap] {cfg.name} capacity dispatch 1 layer on (data, model)={CAP_LAYOUT}, FSDP "
          f"off ({cfg.n_experts // CAP_LAYOUT[1]} of {cfg.n_experts} experts per rank, "
          f"replicated over data), {CAP_TOKENS[0]} x {CAP_TOKENS[1]} tokens (capacity "
          f"{MOE.capacity(CAP_TOKENS[0] * CAP_TOKENS[1], cfg)}): single device dropped "
          f"{r['dropped']} of {r['assignments']} assignments, sharded {r['sharded_dropped']}; "
          f"routes agree on {d['agreement']:.6f} of tokens, {d['flips']} part (largest "
          f"probability gap {d['worst_gap']:.3e}, tol {BF16_ROUTE_TIE_TOL}); kept alike "
          f"on {r['kept_agree']} of the {r['compared']} assignments each expert's earlier "
          f"routes fix alike; ranks route alike {r['ranks_route_alike']}; hidden err "
          f"{r['err']:.3e}, {r['err_alike']:.3e} over the {r['alike']} tokens routed and "
          f"kept alike (printed); {r['seconds']:.3f}s (single device "
          f"{r['ref_seconds']:.3f}s); "
          f"{r['bytes']} bytes moved (predicted {r['predicted_bytes']}); init "
          f"{init_s:.1f}s peak {init_peak} bytes, single forward peak {r['ref_peak']}, "
          f"placement and sharded forward peak {r['peak']} bytes (predicted placement "
          f"{r['predicted_peak']}; {r['sharded_bytes']} bytes of blocks); launches "
          f"{r['launches']} (predicted {want}; single device {r['ref_launches']})")
    check(r["kept_agree"] == r["compared"] > 0,
          "sharded capacity dispatch keeps other experts than one device")
    check(d["worst_gap"] <= BF16_ROUTE_TIE_TOL,
          "sharded capacity dispatch: a route parts past a near-tie")
    check(r["ranks_route_alike"], "the model ranks' replicated routers routed differently")
    check(r["bytes"] == r["predicted_bytes"],
          f"capacity dispatch moved {r['bytes']} bytes, predicted {r['predicted_bytes']}")
    check(same_launches(r["launches"], want), f"capacity launches {r['launches']} != {want}")
    for k in total:
        total[k] += r["launches"][k]
    free(device)


def report_phase15(device, total):
    """Phase 15 on the card: (a) mamba2-1.3b, (b) recurrentgemma-9b, (c)
    arctic-480b's capacity dispatch; each part's seconds."""
    for args, tag in zip(REC_SHARDED, "ab"):
        t0 = time.perf_counter()
        report_rec_sharded(*args, device, total)
        print(f"[time] phase 15{tag} {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_cap_sharded(device, total)
    print(f"[time] phase 15c {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ phase 16
# Sharded compute of the encoder-decoder and prefix configs on logical
# devices of the card (phase 15's machinery): seamless-m4t-medium's encoder
# and its decoder's cross-attention split by head, trained on TRAIN_LAYOUT,
# its trained tree moved to GEN_LAYOUT by ``prefetch_reshard`` and served
# there (its 256,206-row vocabulary split at TP 2 and whole at TP 4, so
# both embedding paths run); internvl2-76b served on GEN_LAYOUT on
# PREFIX_LAYERS layers, its prefix spliced after the vocabulary-parallel
# sum, and its loss with the backward on TRAIN_LAYOUT on PREFIX_LOSS_LAYERS.
ENCDEC_SHARDED = dict(batch=4, seq=256)  # seamless's train traffic: phase 13's, 512 frames
ENCDEC_SHARDED_PROMPT = 128              # its serve: 4 x 128 tokens, phase 13's slice
ENCDEC_FP32_LAYERS = 2                   # 2 encoder + 2 decoder layers in fp32
PREFIX_LOSS_LAYERS = 2


def report_encdec_sharded(device, total):
    """16a on the card: seamless-m4t-medium at full width and depth in bf16
    (TRAIN_TOL / TRAIN_LEAF_TOL, LOGIT_TOL), then on ENCDEC_FP32_LAYERS in
    fp32 (FP32_GRAD_TOL, FP32_LOGIT_TOL, the gathered caches, "xkv"
    included, within FP32_LOGIT_TOL of each leaf's largest |value|):
    trained, moved and served by ``phase_rec_sharded``."""
    cfg = get_config(ENCDEC)
    for c, tols, seed in ((cfg, (TRAIN_TOL, TRAIN_LEAF_TOL, LOGIT_TOL), 0),
                          (shallow(cfg, ENCDEC_FP32_LAYERS, dtype="float32"),
                           (FP32_GRAD_TOL, FP32_GRAD_TOL, FP32_LOGIT_TOL), 1)):
        peak_reset(device)
        t0 = time.perf_counter()
        params = make_dense_params(c, seed=seed, device=device)
        batch = modal_batch(c, device, train=True, seed=seed + 2, **ENCDEC_SHARDED)
        runs = phase_rec_sharded(c, params, batch, impl="cuda",
                                 prompt_len=ENCDEC_SHARDED_PROMPT)
        del params, batch
        depth = f"{c.num_layers} + {c.num_layers} layers {c.dtype}"
        report_train_move_serve(
            "[encdec-shard]", c, runs, tols, device, total, t0,
            train_what=f"{depth} on (data, model)={TRAIN_LAYOUT}, {ENCDEC_SHARDED['batch']} x "
                       f"{ENCDEC_SHARDED['seq']} tokens over {c.prefix_len} frames",
            serve_what=f"{depth} on (data, model)={GEN_LAYOUT}, 4 x {ENCDEC_SHARDED_PROMPT} "
                       f"tokens over {c.prefix_len} frames then 8 decode steps")
        if c.dtype == "float32":
            check(runs[2]["cache_err"] <= FP32_LOGIT_TOL,
                  f"{c.name}: gathered fp32 caches differ from one device's by "
                  f"{runs[2]['cache_err']:.3e}")
        del runs
        free(device)


def phase_prefix_loss_sharded(cfg, params, batch, layout, *, impl):
    """16b's loss: ``lm_loss`` and its gradient on one device
    (``grads_of``) against ``lm_loss_sharded`` and its gradient
    (``steps.sharded_grads``) on a ``layout`` mesh, then the sharded loss
    again with the labels and token ids under the prefix changed (it must
    keep its bits, as ``prefix_loss_check``).  Returns both losses, the
    loss's, the whole gradient's and the worst leaf's errors (Frobenius,
    over the single device's), whether the replicas' gradients are
    bit-equal, seconds, peak memory, bytes and launches of each run."""
    device = params["embed"]["table"].device
    reset_launches()
    peak_reset(device)
    t0 = time.perf_counter()
    ref_loss, ref_grads = grads_of(cfg, params, batch, impl=impl)
    sync(device)
    out = dict(ref_loss=ref_loss, ref_seconds=time.perf_counter() - t0, ref_peak=peak(device),
               ref_launches=launches())
    mesh, sharded = shard_params(params, *layout, device)
    rules = SHD.ShardingRules()
    n = cfg.prefix_len
    moved = {k: v.clone() for k, v in batch.items()}
    moved["labels"][:, :n] = (moved["labels"][:, :n] + 3) % cfg.vocab_size
    moved["tokens"][:, :n] = (moved["tokens"][:, :n] + 5) % cfg.vocab_size
    COLL.reset_stats()
    reset_launches()
    peak_reset(device)
    t0 = time.perf_counter()
    with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        loss, grads, _ = PSTEPS.sharded_grads(
            lambda p, parts: MDL.lm_loss_sharded(p, cfg, parts, ctx=c, impl=impl),
            sharded, batch, 1, mesh, rules, cfg=cfg)
        sync(device)
        out.update(seconds=time.perf_counter() - t0, bytes=COLL.STATS["bytes"],
                   copies=COLL.STATS["copies"])
        with torch.no_grad():
            again, _ = MDL.lm_loss_sharded(sharded, cfg, PSTEPS.split_batch(moved, mesh, rules),
                                           ctx=c, impl=impl)
    out.update(peak=peak(device), launches=launches(), loss=loss.item(),
               loss_moved=again.item(), replicas_equal=replicas_equal(grads))
    sq = [square_norms(g.gather(device), w) for g, w in zip(tree_leaves(grads), ref_grads)]
    worst = max(zip((math.sqrt(d2 / max(r2, 1e-60)) for d2, r2 in sq), leaf_names(params)))
    out.update(loss_err=abs(out["loss"] - ref_loss) / max(abs(ref_loss), 1e-12),
               global_err=math.sqrt(sum(d2 for d2, _ in sq)
                                    / max(sum(r2 for _, r2 in sq), 1e-60)),
               worst_leaf_err=worst[0], worst_leaf=worst[1], n_leaves=len(sq),
               finite=all(all_finite(g.gather(device)) for g in tree_leaves(grads)))
    return out


def report_prefix_sharded(device, total):
    """16b on the card: internvl2-76b at full width on PREFIX_LAYERS layers
    in bf16, served on GEN_LAYOUT against one device (LOGIT_TOL; bytes and
    launches to their predictions), then its loss with the backward on
    TRAIN_LAYOUT on its first PREFIX_LOSS_LAYERS layers (TRAIN_TOL /
    TRAIN_LEAF_TOL; the loss's bits kept under a changed prefix)."""
    cfg = shallow(get_config(PREFIX), PREFIX_LAYERS)
    t0 = time.perf_counter()
    peak_reset(device)
    params = make_dense_params(cfg, seed=0, device=device)
    steps, rows, seq, tp = 8, PREFIX_SLICE["batch"], PREFIX_SLICE["seq"], GEN_LAYOUT[1]
    r = phase_tp_serve(cfg, params, GEN_LAYOUT, impl="cuda", batch=rows, prompt_len=seq,
                       steps=steps)
    r["predicted_bytes"] = (sharded_serve_bytes(cfg, tp, rows, seq),
                            sharded_serve_bytes(cfg, tp, rows, 1, decode=True))
    r["predicted"] = serve_predicted(cfg, tp, steps)
    report_sharded_serve("[prefix-shard]", cfg.name, r, LOGIT_TOL, device, total, t0,
                         serve_what=f"{cfg.num_layers} of 80 layers on (data, model)="
                                    f"{GEN_LAYOUT}, {rows} x {seq} positions (the first "
                                    f"{cfg.prefix_len} patch embeddings) then {steps} decode "
                                    "steps")
    del r
    small = first_layers(cfg, PREFIX_LOSS_LAYERS)
    params["layers"] = params["layers"][:PREFIX_LOSS_LAYERS]
    free(device)
    batch = modal_batch(small, device, train=True, seed=4, **PREFIX_SLICE)
    g = phase_prefix_loss_sharded(small, params, batch, TRAIN_LAYOUT, impl="cuda")
    del params, batch
    n = TRAIN_LAYOUT[0] * TRAIN_LAYOUT[1] * attn_layers(small)
    # the loss under grad and its recompute in the backward (remat), the loss again
    want, ref_want = {"flash_mha": 3 * n}, {"flash_mha": 2 * attn_layers(small)}
    print(f"[prefix-shard] lm_loss {small.name} {small.num_layers} layers bf16 with its "
          f"backward on (data, model)={TRAIN_LAYOUT}, {rows} x {seq} positions: loss "
          f"{g['loss']:.6e} vs {g['ref_loss']:.6e} (err {g['loss_err']:.3e}), gradient "
          f"global_err={g['global_err']:.3e}, worst leaf {g['worst_leaf']} "
          f"{g['worst_leaf_err']:.3e} over {g['n_leaves']} leaves (tol {TRAIN_TOL}, per leaf "
          f"{TRAIN_LEAF_TOL}); finite {g['finite']}, replicas bit-equal "
          f"{g['replicas_equal']}; {g['loss_moved']:.6e} with the labels and tokens under the "
          f"prefix changed; {g['seconds']:.3f}s (single device {g['ref_seconds']:.3f}s), peak "
          f"{g['peak']} bytes (single device {g['ref_peak']}), collectives moved "
          f"{g['bytes']} bytes in {g['copies']} copies; launches {g['launches']} (predicted "
          f"{want}; single device {g['ref_launches']}, predicted {ref_want}); "
          f"{time.perf_counter() - t0:.1f}s in 16b")
    check(max(g["loss_err"], g["global_err"]) <= TRAIN_TOL
          and g["worst_leaf_err"] <= TRAIN_LEAF_TOL,
          f"sharded {small.name} loss or gradient disagrees with the single device")
    check(g["finite"] and g["replicas_equal"], f"{small.name}: sharded gradient non-finite "
          "or its replicas differ")
    check(g["loss"] == g["loss_moved"], "the labels under the prefix reach the sharded loss")
    check(same_launches(g["launches"], want) and same_launches(g["ref_launches"], ref_want),
          f"{small.name}: loss launches {g['launches']} / {g['ref_launches']}")
    for k in total:
        total[k] += g["launches"][k] + g["ref_launches"][k]
    free(device)


def report_phase16(device, total):
    """Phase 16 on the card: (a) seamless-m4t-medium, (b) internvl2-76b;
    each part's seconds."""
    for fn, tag in ((report_encdec_sharded, "a"), (report_prefix_sharded, "b")):
        t0 = time.perf_counter()
        fn(device, total)
        print(f"[time] phase 16{tag} {time.perf_counter() - t0:.1f}s")


# -------------------------------------------- phase 17: split heads, ZeRO-1

SPLIT = "qwen2-0.5b"          # 14 query heads over 2 KV heads
SPLIT_LAYOUT = (1, 4)         # (a): 14 heads over 4 ranks, 224 of 896 q columns each
GEMMA = "gemma3-1b"           # 4 query heads over 1 KV head
GEMMA_LAYOUT = (1, 8)         # (a): 4 heads over 8 ranks, 128 of 1,024 q columns each
GEMMA_PROMPT = 600            # past the 512-slot rings of its local layers
ZERO1_LAYOUT = (2, 1, 2)      # (b): (pod, data, model)
DRY_LAYERS = 2                # (c): qwen2-0.5b's train step on 2 layers, (data 2, model 2)
# (c): the card's max_memory_allocated rise over the dry run's reckoned peak
# per card x 4 (PERF.md states the band and its reasons)
DRY_PEAK_BAND = (0.6, 1.4)
DRY_CELL = ("qwen2-0.5b", "decode_32k", "pod1")


def report_split_serve(cfg, params, layout, total, *, prompt_len=256, steps=8, tag="[split]"):
    """17a's serve: ``phase_tp_serve`` on a ``layout`` whose tensor axis
    splits the query heads, held to LOGIT_TOL, the bytes (wq, wk, wv
    gathered per attention layer) and launches to their predictions."""
    device = params["embed"]["table"].device
    t0 = time.perf_counter()
    peak_reset(device)
    tp, rows = layout[1], 4
    check(T.heads_split(cfg, tp), f"{cfg.name} at {tp}: no query head is split")
    r = phase_tp_serve(cfg, params, layout, impl="cuda", batch=rows, prompt_len=prompt_len,
                       steps=steps)
    r["predicted_bytes"] = (sharded_serve_bytes(cfg, tp, rows, prompt_len),
                            sharded_serve_bytes(cfg, tp, rows, 1, decode=True))
    r["predicted"] = serve_predicted(cfg, tp, steps)
    report_sharded_serve(tag, cfg.name, r, LOGIT_TOL, device, total, t0,
                         serve_what=f"{cfg.num_layers} layers on (data, model)={layout}, "
                                    f"{cfg.n_heads} query heads over {tp} ranks, {rows} x "
                                    f"{prompt_len} tokens then {steps} decode steps")


def report_split_train(device, total, *, layers=2):
    """17a's train step: ``report_tp_train``'s checks with qwen2-0.5b's 14
    heads split over SPLIT_LAYOUT's 4 ranks."""
    cfg = get_config(SPLIT)
    batch = lm_batch(cfg, device)
    for c, seed, tol, leaf_tol in ((cfg, 0, TRAIN_TOL, TRAIN_LEAF_TOL),
                                   (shallow(cfg, layers, dtype="float32"), 1, FP32_GRAD_TOL,
                                    FP32_GRAD_TOL)):
        params = make_params(c, seed=seed, device=device)
        r = phase_tp_train(c, params, batch, SPLIT_LAYOUT, impl="cuda")
        del r["trained"]
        ref, want = r["ref"], tp_train_predicted(c, SPLIT_LAYOUT)
        print(f"[split] train {c.name} {c.num_layers} layers {c.dtype} on "
              f"(data, model)={SPLIT_LAYOUT}: loss err {r['loss_err']:.3e}, grad_norm err "
              f"{r['grad_norm_err']:.3e}, first moment err {r['global_err']:.3e}, worst leaf "
              f"{r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol {tol}, per leaf {leaf_tol}); "
              f"replicas bit-equal {r['replicas_equal']}; {r['seconds']:.3f}s (single device "
              f"{ref['seconds']:.3f}s), peak {r['peak']} bytes, collectives moved "
              f"{r['bytes']} bytes; launches {r['launches']} (predicted {want})")
        check(max(r["loss_err"], r["grad_norm_err"], r["global_err"]) <= tol
              and r["worst_leaf_err"] <= leaf_tol,
              f"split-head train step of {c.name} disagrees with the single-device step")
        check(r["replicas_equal"] and r["finite"] and r["moved"],
              f"{c.name}: split-head replicas differ, or parameters not finite or unmoved")
        check(same_launches(r["launches"], want), f"split-head train launches {r['launches']}")
        for k in total:
            total[k] += r["launches"][k]
        del params
        free(device)


def phase_zero1(cfg, params, batch, *, impl, layout=ZERO1_LAYOUT, opt_cfg=adamw.AdamWConfig()):
    """17b: one sharded train step on a (pod, data, model) mesh with the
    AdamW state ZeRO-1 over the pod axis (``steps.opt_layouts``), and the
    same step with ``shard_opt_over_pod=False``, from the same params and
    batch.  Returns whether parameters and m, v, master are bit-equal
    between the two, whether the ZeRO-1 replicas are bit-equal, how many
    leaves' state the pod axis splits, their state bytes per rank against
    the equal layout's, seconds and launches."""
    device = params["embed"]["table"].device
    n = int(np.prod(layout))
    mesh = Mesh(np.arange(n).reshape(layout), ("pod", "data", "model"), device=device)
    runs = []
    for zero1 in (True, False):
        rules = SHD.ShardingRules(pod_axis="pod", shard_opt_over_pod=zero1)
        specs = SHD.sanitize_specs(SHD.param_specs(params, rules), params, mesh)
        sharded = place_tree(params, tree_map(lambda s: Layout(mesh, s), specs))
        state = adamw.init(opt_cfg, sharded, PSTEPS.opt_layouts(sharded, mesh, rules))
        reset_launches()
        t0 = time.perf_counter()
        sharded, state, m = PSTEPS.make_train_step(cfg, opt_cfg, impl=impl, mesh=mesh,
                                                   rules=rules)(sharded, state, batch)
        sync(device)
        runs.append(dict(params=sharded, state=state, seconds=time.perf_counter() - t0,
                         launches=launches(), loss=float(m["loss"])))
    z, e = runs
    state_bytes = [sum(st.blocks[0].numel() * st.blocks[0].element_size()
                       for k in ("m", "v", "master") for st in tree_leaves(r["state"][k]))
                   for r in runs]
    out = dict(seconds=z["seconds"], ref_seconds=e["seconds"], launches=z["launches"],
               ref_launches=e["launches"], loss=z["loss"], state_bytes=state_bytes,
               n_split=sum(st.layout != p.layout for st, p in zip(tree_leaves(z["state"]["m"]),
                                                                  tree_leaves(z["params"]))))
    out["bit_equal"] = all(same(a.gather(), b.gather()) for k in ("m", "v", "master")
                           for a, b in zip(tree_leaves(z["state"][k]), tree_leaves(e["state"][k])))
    out["bit_equal"] &= all(same(a.gather(), b.gather())
                            for a, b in zip(tree_leaves(z["params"]), tree_leaves(e["params"])))
    out["replicas_equal"] = replicas_equal(z["params"]) and replicas_equal(z["state"]["master"])
    return out


def report_zero1(device, total):
    cfg = get_config(SPLIT)
    params = make_params(cfg, seed=2, device=device)
    r = phase_zero1(cfg, params, lm_batch(cfg, device, seed=3), impl="cuda")
    print(f"[zero1] {cfg.name} on (pod, data, model)={ZERO1_LAYOUT}: the step with the AdamW "
          f"state ZeRO-1 over the pod axis ({r['n_split']} leaves split; m, v, master "
          f"{r['state_bytes'][0]} bytes on rank 0 against {r['state_bytes'][1]}) bit-equal to "
          f"the equal-layout step: {r['bit_equal']}; replicas bit-equal {r['replicas_equal']}; "
          f"loss {r['loss']:.6f}; {r['seconds']:.3f}s (equal layout {r['ref_seconds']:.3f}s); "
          f"launches {r['launches']}")
    check(r["bit_equal"], "the ZeRO-1 step parts from the equal-layout step")
    check(r["replicas_equal"], "ZeRO-1 replicas differ")
    check(r["n_split"] > 0 and r["state_bytes"][0] < r["state_bytes"][1],
          "the pod axis split no optimizer state")
    for k in total:
        total[k] += r["launches"][k] + r["ref_launches"][k]
    del params
    free(device)


def phase_dry_check(cfg, params, batch, *, impl, layout=TRAIN_LAYOUT):
    """17c: the dry run's record of ``cfg``'s train step on a ``layout``
    mesh of ``meta`` ranks (``dryrun.measure`` and ``memory_of``), then the
    same step on ``params``' device: the collectives' records, the
    argument bytes (rank 0's placed blocks of params, state and batch
    rows) and, on a card, the rise of ``max_memory_allocated`` from before
    the placement beside the reckoned peak per card x the ranks."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as DRY
    device = params["embed"]["table"].device
    n = layout[0] * layout[1]
    meta = torch.device("meta")
    mmesh = Mesh(np.arange(n).reshape(layout), ("data", "model"), device=lambda i: meta)
    rules, b_axes, _ = DRY._variant_setup(DRY.CellSpec(cfg.name, "check", False), mmesh)
    b, s = batch["tokens"].shape
    shape = ShapeSpec("check", s, b, "train")
    t0 = time.perf_counter()
    dry = DRY.measure(cfg, shape, mmesh, rules, b_axes)
    mem = DRY.memory_of(cfg, shape, mmesh, rules, b_axes, dry["peak_live"])
    out = dict(dry_s=time.perf_counter() - t0, dry_record=dry["record"], dry_flops=dry["flops"],
               memory=mem)
    batch = {k: (v.to(torch.int32) if k in ("tokens", "labels") else v) for k, v in batch.items()}
    free(device)
    base = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    peak_reset(device)
    mesh, sharded = shard_params(params, *layout, device)
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init(opt_cfg, sharded)
    r0 = mesh.device_ids[0]
    rows = PSTEPS.split_batch(batch, mesh, rules)[r0]
    out["argument_bytes"] = sum(st.blocks[r0].numel() * st.blocks[r0].element_size()
                                for st in tree_leaves(sharded)
                                + [x for k in ("m", "v", "master")
                                   for x in tree_leaves(state[k])]) + sum(
        v.numel() * v.element_size() for v in rows.values())
    del rows
    COLL.reset_stats()
    reset_launches()
    t0 = time.perf_counter()
    PSTEPS.make_train_step(cfg, opt_cfg, impl=impl, mesh=mesh, rules=rules)(sharded, state,
                                                                             batch)
    sync(device)
    out.update(seconds=time.perf_counter() - t0, record=dict(COLL.RECORD), launches=launches(),
               rise=(torch.cuda.max_memory_allocated() - base if device.type == "cuda" else None),
               n_ranks=n)
    out["reckoned"] = mem["peak_per_device"] * n
    del sharded, state
    free(device)
    return out


def report_dry(device, total):
    """17c on the card: ``phase_dry_check`` on qwen2-0.5b's first
    DRY_LAYERS layers on TRAIN_LAYOUT, then on gemma3-1b's 2 layers
    (``head_shallow``) on HEAD_LAYOUT at HEAD_SHARDED_ROWS x HEAD_SEQ,
    where the LM head runs in chunks (their all-reduces recomputed in the
    backward on ``meta`` as on the card); then one production cell through
    the dry run's CLI (a subprocess, ``--force``), its OK line and seconds
    printed."""
    kinds = lambda rec: {k: (sum(n for (kd, _, _, _), n in rec.items() if kd == k),  # noqa: E731
                             sum(b * n for (kd, b, _, _), n in rec.items() if kd == k))
                         for k in sorted({kd for kd, _, _, _ in rec})}
    for cfg, layout, make_batch in (
            (shallow(get_config(SPLIT), DRY_LAYERS), TRAIN_LAYOUT,
             lambda c: lm_batch(c, device, seed=5)),
            (head_shallow(get_config(HEAD)), HEAD_LAYOUT,
             lambda c: head_batch(c, device, HEAD_SHARDED_ROWS, seed=5))):
        params = make_params(cfg, seed=4, device=device)
        batch = make_batch(cfg)
        r = phase_dry_check(cfg, params, batch, impl="cuda", layout=layout)
        del params
        ratio = r["rise"] / r["reckoned"]
        mem = r["memory"]
        print(f"[dry] {cfg.name} {cfg.num_layers} layers train step of "
              f"{' x '.join(map(str, batch['tokens'].shape))} tokens on (data, model)={layout}: "
              f"on meta {r['dry_s']:.1f}s, {r['dry_flops']:.4e} flops over the ranks; "
              f"collectives (calls, payload bytes) by kind on meta {kinds(r['dry_record'])}, on "
              f"the card {kinds(r['record'])}, records equal {r['dry_record'] == r['record']}; "
              f"argument bytes per card {mem['argument_bytes']} reckoned, "
              f"{r['argument_bytes']} placed; reckoned peak per card "
              f"{mem['peak_per_device']:.0f} (temp {mem['temp_bytes']:.0f}) x {r['n_ranks']} = "
              f"{r['reckoned']:.0f} bytes against the card's max_memory_allocated rise "
              f"{r['rise']} bytes: {ratio:.3f} (band {DRY_PEAK_BAND}); the card's step "
              f"{r['seconds']:.3f}s, launches {r['launches']}")
        check(r["dry_record"] == r["record"], "the dry run's collectives differ from the card's")
        check(mem["argument_bytes"] == r["argument_bytes"],
              "the dry run's argument bytes differ from the placed blocks'")
        check(DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1],
              f"the card's memory rise is {ratio:.3f} of the dry run's reckoning")
        for k in total:
            total[k] += r["launches"][k]
        del batch
        free(device)
    arch, shp, mesh = DRY_CELL
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shp, "--mesh", mesh, "--force"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    ok = [ln for ln in res.stdout.splitlines() if ln.startswith("OK ")]
    print(f"[dry] CLI {arch} {shp} {mesh} (256 cards, meta): "
          + (ok[0] if ok else res.stdout[-500:] + res.stderr[-2000:])
          + f"; {time.perf_counter() - t0:.1f}s with the process's start")
    check(res.returncode == 0 and len(ok) == 1, "the dry run's production cell failed")


def report_phase17(device, total):
    """Phase 17 on the card: (a) split heads, (b) ZeRO-1, (c) the dry run;
    each part's seconds."""
    t0 = time.perf_counter()
    cfg = get_config(SPLIT)
    params = make_params(cfg, seed=0, device=device)
    report_split_serve(cfg, params, SPLIT_LAYOUT, total)
    del params
    free(device)
    report_split_train(device, total)
    gcfg = get_config(GEMMA)
    params = make_dense_params(gcfg, seed=0, device=device)
    report_split_serve(gcfg, params, GEMMA_LAYOUT, total, prompt_len=GEMMA_PROMPT)
    del params
    free(device)
    print(f"[time] phase 17a {time.perf_counter() - t0:.1f}s")
    for fn, tag in ((report_zero1, "b"), (report_dry, "c")):
        t0 = time.perf_counter()
        fn(device, total)
        print(f"[time] phase 17{tag} {time.perf_counter() - t0:.1f}s")


# ------------------------------- phase 18: decode caches split by slot

SEQ_MODEL = "internvl2-76b"   # (b): 8 KV heads over 16 ranks
SEQ_LAYOUT = (1, 16)          # every KV head on each rank for 64 of the 1,024 slots
SEQ_LAYERS = 2                # of its 80
SEQ_ROWS = 2
SEQ_PROMPT = 636              # the 256 patch embeddings and 380 tokens: ranks 0-9's blocks
SEQ_SLOTS = 1024              # t = 636 .. 643 crosses from rank 9's block into rank 10's
SEQ_STEPS = 8
GEMMA_SEQ_LAYERS = 2          # (c)'s fp32 run: one local (ring) layer and the global one
# the split decode in fp32 against one device: only the order of the sums
# differs (the ranks' partials merged, the row-parallel shares summed)
SPLIT_FP32_TOL = 1e-5
# flash_decode(return_lse) in fp32 against its plain version (fp32 FMAs
# against the plain einsum; ~1e-7 of the output, ~1e-6 of the lse)
LSE_FP32_TOL = 1e-5
# digests of flash_decode's and paged_flash_decode's outputs (no lse) on
# ``decode_digest_inputs`` before return_lse was added, by the card's SM
# count: scripts/decode_digests.py on the tree before it, on an NVIDIA H100
# 80GB HBM3 (132 SMs, 700 W), where the tree after it gave the same digests
DECODE_DIGESTS = {132: {
    "flash_decode D64 linear (qwen2-0.5b) bf16":
        "f18ccfa665f166a19882f548728fc9d5d86fafb10d3f07a5761f94099277b781",
    "flash_decode D64 ring256 bf16":
        "f312baf29d1989c69d1c70111f538ae9720ed918815bffe0419ffb71032e9aa9",
    "flash_decode D128 linear (llama-7b) bf16":
        "f6e1abb8371edecdfd38d17f2f320f55ec996e212114b587284ffeaeeef052af",
    "flash_decode D256 ring576 (recurrentgemma-9b) bf16":
        "89d6ec1c4094f4d9176856007b6c6d7954563465854f9189c33e2a8d0561b534",
    "flash_decode D256 ring512 G4 (gemma3-1b) bf16":
        "9aa821c89e8bc88563f83485e917bdf714628a0c3bd774d83e16c3fdcfd68520",
    "flash_decode D128 G8 block (internvl2-76b on 16 ranks) bf16":
        "7f96040916680ebeec7b0a3c34851b0e9d820599818d8e24adf95d78c58e3b45",
    "paged_flash_decode shuffled bf16":
        "bebb8fe31277311cce638e8f84dfbbd2d36936a6e24703d7ccee6c6f4af2ac54",
    "flash_decode D64 linear (qwen2-0.5b) fp32":
        "8e4b05866f5776147a8f223b6cfcec3f90d46c244dc3fc11a48c82ce6358b733",
    "flash_decode D64 ring256 fp32":
        "64625294c56fc9d1ee635a54ecb96d8b0449707abffe65314d68fd9f066c6de2",
    "flash_decode D128 linear (llama-7b) fp32":
        "0d475d402c2db53114aadf77fa4dbac4dd9060d0b270648a311a5ff1cab371de",
    "flash_decode D256 ring576 (recurrentgemma-9b) fp32":
        "4dd14c7f6c63bb9c99f74e684018263b01b13c8d7be83cdbc95857e52d7cab4c",
    "flash_decode D256 ring512 G4 (gemma3-1b) fp32":
        "905133abd7af39e5d66c1e8d78e5b6467334b355bd596a5d2a2dc80acd46aab8",
    "flash_decode D128 G8 block (internvl2-76b on 16 ranks) fp32":
        "baea578553ab01da68c524710dccc75915e134d6dced7e761641fac26f895ffb",
    "paged_flash_decode shuffled fp32":
        "22b095d5d5d19eb04c614a74203441768e686d016303d06ea24d9c1fcd3b6e0a",
}}


def np_tensor(g, shape, dtype, device):
    """Seeded normal values made on the host (numpy), cast there, moved to
    ``device``: the same bits on any card."""
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(dtype)
    return x.to(device)


# (label, B, Hq, Hkv, D, C, lens, window): phase 2's decode shapes, each
# with a row of length 0
LSE_CASES = (("D64 linear (qwen2-0.5b)", 8, 14, 2, 64, 1088,
              (0, 17, 64, 65, 400, 777, 1000, 1088), None),
             ("D64 ring256", 8, 14, 2, 64, 256, (0, 1, 100, 255, 256, 257, 1000, 3000), 256),
             ("D128 linear (llama-7b)", 8, 32, 8, 128, 1088,
              (0, 17, 64, 65, 400, 777, 1000, 1088), None),
             ("D256 ring576 (recurrentgemma-9b)", 8, 16, 1, 256, 576,
              (0, 1, 64, 200, 333, 575, 576, 900), 2048),
             ("D256 ring512 G4 (gemma3-1b)", 8, 4, 1, 256, 512,
              (0, 100, 511, 512, 513, 700, 1000, 2048), 512),
             ("D128 G8 block (internvl2-76b on 16 ranks)", 2, 64, 8, 128, 64, (0, 60), None))


def decode_digest_inputs(device):
    """{name: (kernel name, args, kwargs)}: flash_decode on LSE_CASES'
    shapes and paged_flash_decode on a shuffled 36-block table, bf16 and
    fp32, inputs from numpy (``np_tensor``)."""
    out = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        g = np.random.default_rng(18)
        for label, b, hq, hkv, d, c, lens, window in LSE_CASES:
            q, kc, vc = (np_tensor(g, s, dtype, device)
                         for s in ((b, hq, d), (b, c, hkv, d), (b, c, hkv, d)))
            cl = torch.tensor(lens, dtype=torch.int32, device=device)
            out[f"flash_decode {label} {dt}"] = ("flash_decode", (q, kc, vc),
                                                 dict(cache_len=cl, window=window))
        b, hq, hkv, d, m, bs = 8, 14, 2, 64, 36, 16
        n = 1 + b * m
        table = torch.from_numpy((g.permutation(n - 1) + 1).reshape(b, m).astype(np.int32))
        q, kp, vp = (np_tensor(g, s, dtype, device)
                     for s in ((b, hq, d), (n, bs, hkv, d), (n, bs, hkv, d)))
        cl = torch.tensor([0, 1, 17, 64, 100, 333, 500, m * bs], dtype=torch.int32,
                          device=device)
        out[f"paged_flash_decode shuffled {dt}"] = ("paged_flash_decode",
                                                    (q, kp, vp, table.to(device)),
                                                    dict(cache_len=cl))
    return out


def decode_digests(device, kernels):
    """{name: sha256 of the output's bytes} of ``decode_digest_inputs``
    through ``kernels`` {"flash_decode": fn, "paged_flash_decode": fn}."""
    out = {}
    for name, (kernel, args, kw) in decode_digest_inputs(device).items():
        y = kernels[kernel](*args, **kw)
        torch.cuda.synchronize()
        out[name] = hashlib.sha256(y.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    return out


def lse_case(device, label, b, hq, hkv, d, c, lens, window, dtype):
    """flash_decode(return_lse=True) against its plain version on one
    shape: (out err, lse err, the empty rows exact, the no-lse output's bits
    kept on the rows with a key)."""
    g = np.random.default_rng(c + d)
    q, kc, vc = (np_tensor(g, s, dtype, device)
                 for s in ((b, hq, d), (b, c, hkv, d), (b, c, hkv, d)))
    cl = torch.tensor(lens, dtype=torch.int32, device=device)
    out, lse = flash_decode(q, kc, vc, cache_len=cl, window=window, return_lse=True)
    want, want_lse = ref.decode_mha_ref(q, kc, vc, cache_len=cl, window=window,
                                        return_lse=True)
    plain = flash_decode(q, kc, vc, cache_len=cl, window=window)
    torch.cuda.synchronize()
    empty = cl == 0
    check(out.dtype == lse.dtype == torch.float32 and lse.shape == (b, hq),
          f"flash_decode return_lse {label}: dtypes {out.dtype}/{lse.dtype}")
    exact = (bool((out[empty] == 0).all()) and bool(torch.isneginf(lse[empty]).all())
             and bool((want[empty] == 0).all()) and bool(torch.isneginf(want_lse[empty]).all()))
    full = ~empty
    out_err = _max_err(out[full], want[full])
    lse_err = ((lse[full] - want_lse[full]).abs().max()
               / want_lse[full].abs().max().clamp(min=1)).item()
    kept = torch.equal(out[full].to(dtype), plain[full])
    return out_err, lse_err, exact, kept


def lse_timing(device):
    """flash_decode(return_lse=True) at phase 2's main decode shape (bf16,
    8 rows of 14 query heads over 2 KV heads, D 64, the 1,088-slot linear
    cache at ragged lengths with a row of 0): kernel, plain version, bound
    (the bytes of q, the live keys and values, the fp32 rows and lse), and
    SDPA on the same cache (which returns no lse)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    label, b, hq, hkv, d, c, lens, window = LSE_CASES[0]
    g = np.random.default_rng(0)
    q, kc, vc = (np_tensor(g, s, torch.bfloat16, device)
                 for s in ((b, hq, d), (b, c, hkv, d), (b, c, hkv, d)))
    cl = torch.tensor(lens, dtype=torch.int32, device=device)
    n_keys = int(cl.sum())
    bms, by = bound_ms(4 * d * hq * n_keys,
                       2 * q.numel() + 2 * 2 * n_keys * hkv * d + 4 * q.numel() + 4 * b * hq)
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    valid = torch.arange(c, device=device)[None] < cl[:, None]
    mask = (valid | (cl[:, None] == 0))[:, None, None]

    def kernel():
        return flash_decode(q, kc, vc, cache_len=cl, return_lse=True)
    out, _ = kernel()
    want, _ = ref.decode_mha_ref(q, kc, vc, cache_len=cl, return_lse=True)
    return dict(max_abs_err=_max_err(out, want)[0], library="scaled_dot_product_attention",
                ms=graph_ms(kernel), cold_ms=graph_cold_ms(kernel), eager_ms=time_ms(kernel),
                plain_ms=time_ms(lambda: ref.decode_mha_ref(q, kc, vc, cache_len=cl,
                                                            return_lse=True)),
                bound_ms=bms, bound_by=by, splits=decode_splits(b, hkv, c),
                library_ms=graph_ms(lambda: sdpa(q[:, :, None], ks, vs, attn_mask=mask,
                                                 enable_gqa=True)))


def report_lse_kernel(device, kern):
    """18a: flash_decode(return_lse=True) against its plain version at
    LSE_CASES' shapes in bf16 (KERNEL_TOL) and fp32 (LSE_FP32_TOL), the
    empty rows exactly 0 with lse -inf; the no-lse outputs of flash_decode
    and paged_flash_decode against their digests from before return_lse
    (``DECODE_DIGESTS``, by SM count) and, in the same run, the lse
    variant's rows rounded to the input dtype against the no-lse ones, bit
    for bit; the lse variant timed at phase 2's main shape into
    kern["flash_decode"]["lse"]."""
    for label, *shape in LSE_CASES:
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL), (torch.float32, LSE_FP32_TOL)):
            (abs_err, rel_err), lse_err, exact, kept = lse_case(device, label, *shape, dtype)
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(f"[lse] flash_decode return_lse {label} {dt}: out max_abs_err={abs_err:.3e} "
                  f"scaled_err={rel_err:.3e}, lse err {lse_err:.3e} of max |lse| (tol {tol}); "
                  f"the empty row 0 with lse -inf: {exact}; its rows in {dt} equal the no-lse "
                  f"output bit for bit: {kept}")
            check(rel_err <= tol and lse_err <= tol,
                  f"flash_decode return_lse {label} {dt}: err {rel_err} / {lse_err} > {tol}")
            check(exact, f"flash_decode return_lse {label} {dt}: an empty row is not 0 / -inf")
            check(kept, f"flash_decode {label} {dt}: the lse variant's rows part from the "
                        "no-lse output")
    sms = build.sm_count(torch.cuda.current_device())
    got = decode_digests(device, {"flash_decode": flash_decode,
                                  "paged_flash_decode": paged_flash_decode})
    want = DECODE_DIGESTS.get(sms)
    if want is None:
        print(f"[lse] no-lse digests recorded for {sorted(DECODE_DIGESTS)} SMs, this card has "
              f"{sms}: the bits before return_lse are not checked here (the in-run checks "
              "above hold)")
    else:
        same = [k for k in got if got[k] == want.get(k)]
        print(f"[lse] flash_decode and paged_flash_decode without lse bit-identical to their "
              f"outputs before return_lse on {len(same)}/{len(got)} cases ({sms} SMs)")
        check(len(same) == len(got) == len(want), "the no-lse decode kernels' bits changed: "
              + ", ".join(k for k in got if k not in same))
    t = lse_timing(device)
    kern["flash_decode"]["lse"] = t
    print(f"[kernels] flash_decode lse (D64 linear, bf16): ms={t['ms']:.4f} (warm L2) cold_ms="
          f"{t['cold_ms']:.4f} (L2 flushed) eager_ms={t['eager_ms']:.4f} splits={t['splits']} "
          f"plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
          f"library_ms={t['library_ms']:.4f} (scaled_dot_product_attention, no lse)")


def slot_blocks(cap, k):
    """[(start, stop)] of ``cap`` slots cut into ``k`` ceil-sized blocks."""
    size = -(-cap // k)
    return [(min(cap, i * size), min(cap, (i + 1) * size)) for i in range(k)]


def kv_cache_bytes(cfg, tp, rows, max_len, *, split=True):
    """Bytes of attention k/v each of ``tp`` ranks holds for ``rows`` rows
    at ``max_len`` positions: by KV head where the axis divides them, else
    (``split``) every KV head for its block of each cache's slots, or every
    slot (the replicated layout)."""
    bf = L.dtype_of(cfg).itemsize
    out = [0] * tp
    for spec in cfg.layers:
        if spec.kind != ATTN:
            continue
        cap = min(spec.window, max_len) if spec.window else max_len
        slot = 2 * rows * cfg.head_dim * bf  # one slot of k and v, every KV head below
        for i, (lo, hi) in enumerate(slot_blocks(cap, tp)):
            if cfg.n_kv_heads % tp == 0:
                out[i] += cap * slot * cfg.n_kv_heads // tp
            else:
                out[i] += (hi - lo if split else cap) * slot * cfg.n_kv_heads
    return out


def report_seq_serve(tag, cfg, params, layout, total, *, rows, prompt_len, steps, extra_len,
                     tol, what):
    """``phase_tp_serve`` with ``extra_len`` positions past the prompt,
    held to ``tol``, its bytes and launches to their predictions and each
    rank's k/v bytes to ``kv_cache_bytes``; prints the cache bytes on the
    card beside the replicated layout's."""
    device = params["embed"]["table"].device
    t0 = time.perf_counter()
    peak_reset(device)
    tp = layout[1]
    check(T.seq_split(cfg, tp), f"{cfg.name} at {tp}: its caches are not split by slot")
    r = phase_tp_serve(cfg, params, layout, impl="cuda", batch=rows, prompt_len=prompt_len,
                       steps=steps, extra_len=extra_len)
    max_len = prompt_len + extra_len
    r["predicted_bytes"] = (sharded_serve_bytes(cfg, tp, rows, prompt_len),
                            sharded_serve_bytes(cfg, tp, rows, 1, decode=True))
    r["predicted"] = serve_predicted(cfg, tp, steps)
    want = kv_cache_bytes(cfg, tp, rows, max_len)
    whole = kv_cache_bytes(cfg, tp, rows, max_len, split=False)
    report_sharded_serve(tag, cfg.name, r, tol, device, total, t0, serve_what=what)
    print(f"{tag} {cfg.name} k/v cache bytes per rank {r['kv_bytes']} (predicted {want}); "
          f"{sum(r['kv_bytes'])} bytes on the card over {tp} ranks, where every rank holding "
          f"every slot would hold {sum(whole)} ({sum(whole) / max(sum(r['kv_bytes']), 1):.2f}x)")
    check(r["kv_bytes"] == want, f"{cfg.name}: per-rank cache bytes {r['kv_bytes']} != {want}")


def seq_fp32(cfg, layers):
    """``cfg`` at full width on ``layers`` in fp32: its first layers, or
    for a model with rings and global layers one local and one global."""
    specs = list(dict.fromkeys(cfg.layers)) if len(set(cfg.layers)) > 1 else cfg.layers[:layers]
    return dataclasses.replace(cfg, superblock=tuple(specs[:layers]), n_superblocks=1,
                               tail=(), num_layers=layers, dtype="float32")


def report_phase18(device, total, kern):
    """Phase 18 on the card: (a) flash_decode's lse variant, (b)
    internvl2-76b and (c) gemma3-1b decoding over caches split by slot;
    each part's seconds."""
    t0 = time.perf_counter()
    report_lse_kernel(device, kern)
    print(f"[time] phase 18a {time.perf_counter() - t0:.1f}s")
    for tag, name, layout, n, rows, prompt, extra in (
            ("b", SEQ_MODEL, SEQ_LAYOUT, SEQ_LAYERS, SEQ_ROWS, SEQ_PROMPT,
             SEQ_SLOTS - SEQ_PROMPT),
            ("c", GEMMA, GEMMA_LAYOUT, GEMMA_SEQ_LAYERS, 4, GEMMA_PROMPT, SEQ_STEPS)):
        t0 = time.perf_counter()
        full = get_config(name)
        for cfg, tol, seed in ((shallow(full, n) if tag == "b" else full, LOGIT_TOL, 0),
                               (seq_fp32(full, n), SPLIT_FP32_TOL, 1)):
            params = make_dense_params(cfg, seed=seed, device=device)
            report_seq_serve(
                f"[seq] 18{tag}", cfg, params, layout, total, rows=rows, prompt_len=prompt,
                steps=SEQ_STEPS, extra_len=extra, tol=tol,
                what=f"{cfg.num_layers} layers {cfg.dtype} on (data, model)={layout}, {rows} x "
                     f"{prompt} positions in a cache of {prompt + extra}, then {SEQ_STEPS} "
                     "decode steps")
            del params
            free(device)
        print(f"[time] phase 18{tag} {time.perf_counter() - t0:.1f}s")


# ------------------------------- phase 19: packed training on sharded layouts

PACKED = "qwen2-0.5b"               # (a): 14 query heads over 2 KV heads
PACKED_LAYOUTS = ((2, 2), (1, 4))   # (a): FSDP 2 x TP 2; the 14 heads split over 4 ranks
PACKED_MOE = "granite-moe-1b-a400m"
PACKED_EP = ((1, 4),)               # (b): 8 of its 32 experts a rank
PACKED_MOE_LAYERS = 24              # all of granite's
PACKED_FP32_LAYERS = 2
# The cohort: 16 sequences of 64-384 tokens (``PromptDataset.packed_batch_at``),
# its token count bucketed to a multiple of 64 with phantoms.
PACKED_COHORT = dict(seqs=16, min_len=64, max_len=384, bucket=64)


def packed_lm_batch(cfg, device, *, seqs, min_len, max_len, bucket, seed=0):
    """A packed LM cohort of ``seqs`` sequences of ``min_len``-``max_len``
    tokens from ``data/synth.py``'s ``PromptDataset.packed_batch_at``,
    padded with phantoms to a multiple of ``bucket``: {"tokens" (T,),
    "positions", "cu_seqlens", "labels" (1, T) the next token, "mask" (1,
    T) 0 on each sequence's last token and on the phantoms}."""
    ds = PromptDataset(cfg.vocab_size, max_len, seqs, seed=seed, min_len=min_len, device=device)
    pb = ds.packed_batch_at(0)
    pb = packing.pad_to(pb, packing.bucket_total(pb.total_tokens, bucket))
    tokens = pb.tokens.long()
    cu = pb.cu_seqlens.long()
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=device)
    mask[cu[1:] - 1] = 0.0
    mask[int(cu[-1]):] = 0.0
    return {"tokens": tokens, "positions": pb.positions, "cu_seqlens": pb.cu_seqlens,
            "labels": torch.roll(tokens, -1)[None], "mask": mask[None]}


def packed_train_predicted(cfg, layout=None):
    """Launches of one packed train step on a (dp, tp) ``layout`` (None:
    one device): every rank's forward of every layer and its recompute
    (remat) run flash_mha_varlen per attention layer and grouped_ffn per
    dropless MoE layer; the plain backwards launch nothing."""
    n = 2 * (layout[0] * layout[1] if layout else 1)
    return {"flash_mha_varlen": n * attn_layers(cfg), "grouped_ffn": n * moe_layers(cfg)}


def replica_routes(calls, layout):
    """``recorded_routes`` of a sharded step on a (dp, tp) ``layout`` as one
    device's: each router call of tensor rank 0 of every replica (the mesh
    order), their rows joined in replica order (the cohort's order)."""
    n, tp = layout[0] * layout[1], layout[1]
    out = []
    for i in range(0, len(calls), n):
        group = calls[i:i + n][::tp]
        out.append(tuple(torch.cat([g[j] for g in group]) for j in range(2)))
    return out


def phase_packed_train(cfg, params, batch, layouts, *, impl, max_seqlen):
    """19: the single-device packed ``make_train_step`` once, then the
    sharded one on each (dp, tp) of ``layouts`` from the same parameters
    and cohort (``max_seqlen`` its band).  Returns {layout:
    ``sharded_train``'s result, with the single device's "ref" and, for an
    MoE model, "routes": ``route_diff`` of the runs' router calls}."""
    with recorded_routes() as ref_calls:
        ref, m_ref = single_train(cfg, params, batch, impl=impl, max_seqlen=max_seqlen)
    out = {}
    for layout in layouts:
        with recorded_routes() as calls:
            r = sharded_train(cfg, params, batch, layout, ref, m_ref, impl=impl,
                              max_seqlen=max_seqlen)
        del r["trained"]
        r["routes"] = (route_diff(replica_routes(calls, layout), ref_calls)
                       if cfg.ffn_kind == "moe" else None)
        out[layout] = r
    return out


def report_packed(tag, cfg, runs, batch, tol, leaf_tol, total):
    """``phase_packed_train``'s runs printed and held: loss, grad_norm and
    first moment within ``tol``, each leaf within ``leaf_tol`` (where an
    fp32 MoE run's routes part, each parting's gap to ROUTE_TIE_TOL in
    their place, as phase 7 holds them), replicas bit-equal, parameters
    finite and moved, each run's launches to ``packed_train_predicted``;
    adds the launches to ``total``."""
    cu = batch["cu_seqlens"].tolist()
    lens = np.diff(cu)
    ref = next(iter(runs.values()))["ref"]
    print(f"{tag} {cfg.name} {cfg.num_layers} layers {cfg.dtype}: {len(lens)} sequences of "
          f"{lens.min()}-{lens.max()} tokens, {cu[-1]} tokens + "
          f"{batch['tokens'].shape[0] - cu[-1]} phantoms; single device loss "
          f"{ref['loss']:.6e}, grad_norm {ref['grad_norm']:.6e}, {ref['seconds']:.3f}s, peak "
          f"{ref['peak']} bytes, launches {ref['launches']}")
    want = packed_train_predicted(cfg)
    check(same_launches(ref["launches"], want),
          f"{tag} single-device packed launches {ref['launches']} != {want}")
    for k in total:
        total[k] += ref["launches"][k]
    for layout, r in runs.items():
        parts = packing.split_packed(batch, layout[0])
        rt = r["routes"]
        routes = ("" if rt is None else f"; routes agree on {rt['agreement']:.6f} of (token, "
                  f"router call) pairs, {rt['flips']} part (largest probability gap "
                  f"{rt['worst_gap']:.3e})")
        want = packed_train_predicted(cfg, layout)
        print(f"{tag} {cfg.name} on (data, model)={layout}: replicas of "
              + ", ".join(f"{p['tokens'].shape[0]} tokens (max_seqlen {p['max_seqlen']})"
                          for p in parts)
              + f"; loss {r['loss']:.6e} (err {r['loss_err']:.3e}), grad_norm err "
              f"{r['grad_norm_err']:.3e}, first moment err {r['global_err']:.3e}, worst leaf "
              f"{r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol {tol}, per leaf {leaf_tol})"
              f"{routes}; replicas bit-equal {r['replicas_equal']}; {r['seconds']:.3f}s "
              f"(single device {ref['seconds']:.3f}s), peak {r['peak']} bytes, collectives "
              f"moved {r['bytes']} bytes; launches {r['launches']} (predicted {want})")
        if cfg.dtype == "float32" and rt is not None and rt["flips"]:
            check(rt["worst_gap"] <= ROUTE_TIE_TOL,
                  f"{tag} {cfg.name} on {layout}: a route parts {rt['worst_gap']:.3e} from a tie")
        else:
            check(max(r["loss_err"], r["grad_norm_err"], r["global_err"]) <= tol
                  and r["worst_leaf_err"] <= leaf_tol,
                  f"{tag} packed train step of {cfg.name} on {layout} disagrees with one device")
        check(r["replicas_equal"] and r["finite"] and r["moved"],
              f"{tag} {cfg.name} on {layout}: replicas differ, or parameters not finite or "
              "unmoved")
        check(same_launches(r["launches"], want),
              f"{tag} packed train launches {r['launches']} != {want}")
        for k in total:
            total[k] += r["launches"][k]


def report_phase19(device, total, *, cohort=PACKED_COHORT):
    """Phase 19 on the card: (a) qwen2-0.5b's packed train step at full
    width and depth in bf16 (TRAIN_TOL, TRAIN_LEAF_TOL) and on 2 fp32
    layers (FP32_GRAD_TOL) on (2, 2) and (1, 4) against one device; (b)
    granite-moe-1b-a400m's on (1, 4), its experts over the ranks (dropless:
    grouped_ffn on each rank's experts); each part's seconds."""
    for part, name, layouts, layers in (("a", PACKED, PACKED_LAYOUTS, None),
                                        ("b", PACKED_MOE, PACKED_EP, PACKED_MOE_LAYERS)):
        t0 = time.perf_counter()
        full = get_config(name)
        if layers is not None:
            full = shallow(full, layers)
        for cfg, seed, tol, leaf_tol in ((full, 0, TRAIN_TOL, TRAIN_LEAF_TOL),
                                         (shallow(full, PACKED_FP32_LAYERS, dtype="float32"), 1,
                                          FP32_GRAD_TOL, FP32_GRAD_TOL)):
            params = make_params(cfg, seed=seed, device=device)
            batch = packed_lm_batch(cfg, device, seed=seed, **cohort)
            runs = phase_packed_train(cfg, params, batch, layouts, impl="cuda",
                                      max_seqlen=cohort["max_len"])
            report_packed(f"[packed] 19{part}", cfg, runs, batch, tol, leaf_tol, total)
            del params, runs
            free(device)
        print(f"[time] phase 19{part} {time.perf_counter() - t0:.1f}s")


# ------------------------------ phase 20: the chunked LM head at 4,096 tokens

HEAD = "gemma3-1b"            # 262,144 tied vocabulary rows: the widest head of the configs
HEAD_ROWS, HEAD_SEQ = 4, 4096  # (a): the sequence of the JAX dry run's train_4k cells
HEAD_PROMPT = 512             # the mask is 0 over each row's first 512 positions
HEAD_LAYOUT = (1, 4)          # (c): 65,536 vocabulary rows a rank
HEAD_SHARDED_ROWS = 2         # (c): 2 x 4,096


def head_shallow(cfg, *, dtype=None):
    """gemma3-1b at full width on 2 layers, its first local (window 512)
    and its first global layer, in ``dtype`` (None: its own)."""
    kinds = (next(s for s in cfg.superblock if s.window is not None),
             next(s for s in cfg.superblock if s.window is None))
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype, superblock=kinds, n_superblocks=1,
                               tail=(), num_layers=2)


def head_batch(cfg, device, rows, *, seq=HEAD_SEQ, seed=0):
    """``lm_batch`` of ``rows`` x ``seq`` tokens, the mask 0 over the first
    HEAD_PROMPT positions of each row and past a seeded cut."""
    return lm_batch(cfg, device, batch=rows, prompt=HEAD_PROMPT, new=seq - HEAD_PROMPT,
                    seed=seed)


def whole_head_step(cfg, opt_cfg, *, impl, remat=True):
    """The plain version of ``make_train_step``'s single-device step: the
    same forward, loss, AdamW update and metrics with the LM head taken
    whole (``forward``, ``logits_of`` over every position at once,
    ``layers.cross_entropy``), where ``lm_loss`` chunks it."""
    def loss_fn(params, batch):
        hidden, aux = MDL.forward(params, cfg, batch, impl=impl, remat=remat, return_aux=True)
        loss, _ = L.cross_entropy(MDL.logits_of(params, cfg, hidden), batch["labels"],
                                  batch["mask"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        return loss + 0.01 * aux, {"lm_loss": loss, "aux_loss": aux}

    def step(params, opt_state, batch):
        loss, grads, aux = GRAD.accumulate_grads(loss_fn, params, batch, 1)
        params, opt_state, stats = adamw.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **aux, **stats}
    return step


def head_peak_predicted(cfg, params, rows, seq, chunk):
    """The peak bytes of one ``single_train`` step reckoned from the
    shapes: the parameters and their trained copy, the fp32 AdamW master,
    m and v, the layer inputs remat saves, the embedding's gradient, and
    the LM head's backward over ``chunk`` positions (0: the whole
    sequence), its fp32 logits saved and three transients of their size
    (logsumexp's backward)."""
    n = sum(t.numel() for t in tree_leaves(params))
    bf = L.dtype_of(cfg).itemsize
    return (2 * n * bf + 12 * n + cfg.num_layers * rows * seq * cfg.d_model * bf
            + cfg.vocab_size * cfg.d_model * bf + 4 * rows * (chunk or seq) * cfg.vocab_size * 4)


def phase_head_train(cfg, params, batch, *, impl):
    """20a, b, d: one single-device ``make_train_step`` of ``batch`` (its LM
    head chunked), then the same step with the head whole
    (``whole_head_step``) from the same parameters; where the whole head
    does not fit (``OutOfMemoryError``), both steps again at one row fewer,
    until it fits.  Returns "chunked" (the full batch's run), "tried"
    ([(rows, whether the whole head fitted)]), "rows", the chunked and the
    whole run at those rows ("got", "ref"), the loss's and grad_norm's
    relative errors and ``moment_agreement`` of the first moments."""
    device = params["embed"]["table"].device
    host = lambda tree: tree_map(lambda t: t.to("cpu"), tree)  # noqa: E731
    got, m_got = single_train(cfg, params, batch, impl=impl)
    m_got = host(m_got)
    out = {"chunked": got, "tried": []}
    for rows in range(batch["tokens"].shape[0], 0, -1):
        sub = {k: v[:rows] for k, v in batch.items()}
        if rows < batch["tokens"].shape[0]:
            got, m_got = single_train(cfg, params, sub, impl=impl)
            m_got = host(m_got)
        try:
            ref, m_ref = single_train(cfg, params, sub, impl=impl, make_step=whole_head_step)
        except torch.OutOfMemoryError:
            ref = None
        out["tried"].append((rows, ref is not None))
        if ref is not None:
            break
        free(device)
    check(ref is not None, f"{cfg.name}: the whole LM head fits at no batch")
    m_got = tree_map(lambda t: t.to(device), m_got)
    out.update(rows=rows, got=got, ref=ref,
               loss_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
               grad_norm_err=abs(got["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"])
    out["global_err"], (out["worst_leaf_err"], out["worst_leaf"]) = moment_agreement(m_got, m_ref)
    return out


def report_head_train(cfg, params, batch, tol, leaf_tol, total, tag, *, impl="cuda"):
    """``phase_head_train`` printed and held: the chunked step's loss,
    grad_norm and first moment within ``tol`` of the whole head's, each
    leaf within ``leaf_tol``, its peak memory below the whole head's at
    the same batch (on a card); each step's seconds, peak beside
    ``head_peak_predicted`` and launches (``tp_train_predicted``, one
    device).  Returns ``phase_head_train``'s result."""
    r = phase_head_train(cfg, params, batch, impl=impl)
    rows, seq = batch["tokens"].shape
    chunk = L.lm_head_chunk(seq)
    want = tp_train_predicted(cfg, (1, 1))
    c, got, ref = r["chunked"], r["got"], r["ref"]
    print(f"{tag} {cfg.name} {cfg.num_layers} layers {cfg.dtype}, one make_train_step of {rows} "
          f"x {seq} tokens with the LM head in checkpointed chunks of {chunk} positions: loss "
          f"{c['loss']:.6e}, grad_norm {c['grad_norm']:.6e}, {c['seconds']:.3f}s, peak "
          f"{c['peak']} bytes (reckoned {head_peak_predicted(cfg, params, rows, seq, chunk)}; "
          f"the whole head {head_peak_predicted(cfg, params, rows, seq, 0)}), launches "
          f"{c['launches']} (predicted {want})")
    print(f"{tag} the whole head (forward, logits_of, cross_entropy) tried at rows "
          + ", ".join(f"{b} ({'fits' if ok else 'out of memory'})" for b, ok in r["tried"])
          + f"; at {r['rows']} x {seq}: chunked against whole loss err {r['loss_err']:.3e}, "
          f"grad_norm err {r['grad_norm_err']:.3e}, first moment err {r['global_err']:.3e}, "
          f"worst leaf {r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol {tol}, per leaf "
          f"{leaf_tol}); peak {got['peak']} bytes chunked against {ref['peak']} whole "
          f"(reckoned {head_peak_predicted(cfg, params, r['rows'], seq, chunk)} and "
          f"{head_peak_predicted(cfg, params, r['rows'], seq, 0)}); {got['seconds']:.3f}s "
          f"against {ref['seconds']:.3f}s")
    check(max(r["loss_err"], r["grad_norm_err"], r["global_err"]) <= tol
          and r["worst_leaf_err"] <= leaf_tol,
          f"{tag} the chunked LM head's step disagrees with the whole head's")
    check(got["peak"] < ref["peak"] or got["peak"] == ref["peak"] == 0,
          f"{tag} the chunked step's peak {got['peak']} is not below the whole head's")
    for run in [c] + ([got] if r["rows"] < rows else []) + [ref]:
        check(same_launches(run["launches"], want), f"{tag} train launches {run['launches']}")
        for k in total:
            total[k] += run["launches"][k]
    return r


def head_loss_predicted(rows, seq, tp):
    """(bytes, {RECORD key: calls}) of the collectives of one sharded LM
    loss with its backward, rows x seq on a (1, tp) mesh whose tensor axis
    splits the vocabulary: per chunk (the whole sequence where the head is
    not chunked) an all-reduce max, sum of exponentials and gold in the
    forward, again in the backward's recompute where chunked, and the
    backward of the two sums, of which only the root's value carries a
    gradient (the loss is computed once, from it), so each moves the other
    members' k - 1 copies to the root."""
    chunk = L.lm_head_chunk(seq)
    v = rows * seq * 4
    fwd = 3 * allreduce_bytes(v, tp) * (2 if chunk else 1)
    n = seq // chunk if chunk else 1
    key = ("all-reduce", rows * (chunk or seq) * 4, tp, 1)
    return fwd + 2 * (tp - 1) * v, {key: n * (8 if chunk else 5)}


def head_loss_bytes(cfg, params, batch, layout, *, impl):
    """(c): the bytes the collectives move in ``lm_loss_sharded``'s head
    alone, and its ``RECORD``: the final hidden states of ``batch`` on a
    ``layout`` mesh (not counted), then ``nll_sums_sharded`` of them and
    the backward of the root rank's sum, as the step's loss runs them."""
    device = params["embed"]["table"].device
    mesh, sharded = shard_params(params, *layout, device)
    rules = SHD.ShardingRules()
    parts = PSTEPS.split_batch(batch, mesh, rules)
    with CTX.use(mesh, rules.batch_axes, rules.tp_axis) as c:
        with torch.no_grad():
            top, hs, _ = MDL._final_hidden(sharded, cfg, parts, c, impl=impl)
        hs = {r: h.detach().requires_grad_(True) for r, h in hs.items()}
        COLL.reset_stats()
        sums = MDL.nll_sums_sharded(top, cfg, hs, {r: b["labels"] for r, b in parts.items()},
                                    {r: b["mask"] for r, b in parts.items()}, ctx=c,
                                    split=MDL.vocab_split(sharded, cfg, c),
                                    chunk=L.lm_head_chunk(MDL.global_seq_len(parts, c)))
        sums[mesh.device_ids[0]].backward()
    out = COLL.STATS["bytes"], dict(COLL.RECORD)
    del sharded, top, hs, sums
    free(device)
    return out


def report_head_sharded(cfg, params, batch, tol, leaf_tol, total, tag, *, impl="cuda"):
    """20c for one config: ``phase_tp_train`` on HEAD_LAYOUT against one
    device (``tol``, ``leaf_tol``), the loss's collectives
    (``head_loss_bytes``: bytes, and the step's own record) to
    ``head_loss_predicted``; launches held."""
    tp, (rows, seq) = HEAD_LAYOUT[1], batch["tokens"].shape
    r = phase_tp_train(cfg, params, batch, HEAD_LAYOUT, impl=impl)
    del r["trained"]
    loss_bytes, loss_record = head_loss_bytes(cfg, params, batch, HEAD_LAYOUT, impl=impl)
    want_bytes, want_calls = head_loss_predicted(rows, seq, tp)
    step_calls = {k: r["record"].get(k, 0) for k in want_calls}
    ref, want = r["ref"], tp_train_predicted(cfg, HEAD_LAYOUT)
    print(f"{tag} {cfg.name} {cfg.num_layers} layers {cfg.dtype} on (data, model)="
          f"{HEAD_LAYOUT}, {rows} x {seq} tokens: loss err {r['loss_err']:.3e}, grad_norm err "
          f"{r['grad_norm_err']:.3e}, first moment err {r['global_err']:.3e}, worst leaf "
          f"{r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol {tol}, per leaf {leaf_tol}); "
          f"replicas bit-equal {r['replicas_equal']}; {r['seconds']:.3f}s (single device "
          f"{ref['seconds']:.3f}s), peak {r['peak']} bytes (single device {ref['peak']}); the "
          f"step's collectives moved {r['bytes']} bytes; the loss's {loss_bytes} bytes "
          f"(predicted {want_bytes}, the chunks recomputed in the backward), its all-reduces "
          f"{loss_record} (the step's {step_calls}; predicted {want_calls}); launches "
          f"{r['launches']} (predicted {want})")
    check(max(r["loss_err"], r["grad_norm_err"], r["global_err"]) <= tol
          and r["worst_leaf_err"] <= leaf_tol,
          f"the sharded chunked-head step of {cfg.name} disagrees with one device's")
    check(r["replicas_equal"] and r["finite"] and r["moved"],
          f"{cfg.name}: replicas differ, or parameters not finite or unmoved")
    check(loss_bytes == want_bytes, f"the sharded loss moved {loss_bytes} bytes")
    check(loss_record == want_calls and step_calls == want_calls,
          f"the sharded loss's all-reduces {loss_record}, the step's {step_calls}")
    check(same_launches(r["launches"], want), f"sharded head launches {r['launches']}")
    for k in total:
        total[k] += r["launches"][k] + ref["launches"][k]


def head_kernel_cases(device, kern):
    """20e: flash_mha at phase 20's attention shapes (B 4, S 4,096, 4 query
    heads on 1 KV head, D 256), causal over the whole sequence (the global
    layers) and with the window of 512 (the local ones), in phase 2's
    manner, into ``kern``."""
    g = torch.Generator(device=device).manual_seed(20)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    kern["flash_mha"]["gemma3_train_causal"] = mha_case(
        randn, device, "gemma3-1b train, global layers", HEAD_ROWS, HEAD_SEQ, HEAD_SEQ, 4, 1,
        256, True)
    kern["flash_mha"]["gemma3_train_window"] = mha_window_case(randn, device, HEAD_SEQ,
                                                               b=HEAD_ROWS)
    for key in ("gemma3_train_causal", "gemma3_train_window"):
        k = kern["flash_mha"][key]
        print(f"[head] 20e flash_mha {key}: {k['ms']:.4f} ms (cold {k['cold_ms']:.4f}, eager "
              f"{k['eager_ms']:.4f}), bound {k['bound_ms']:.4f} ms by {k['bound_by']}, plain "
              f"{k['plain_ms']:.4f} ms, SDPA {k['library_ms']:.4f} ms; "
              f"{2 * attn_layers(get_config(HEAD))} launches a phase-20 step (26 layers x 2 "
              "with remat)")


def report_phase20(device, total, kern):
    """Phase 20 on the card: (a, b, d) gemma3-1b at full width and depth
    trained one step at HEAD_ROWS x HEAD_SEQ with the chunked LM head
    against the whole head, bf16, then on 2 fp32 layers; (c) the same loss
    on HEAD_LAYOUT on 2 layers, bf16 and fp32; (e) flash_mha at the step's
    shapes; each part's seconds."""
    full = get_config(HEAD)
    for part, report, rows, runs in (
            ("a", report_head_train, HEAD_ROWS,
             ((full, 0, TRAIN_TOL, TRAIN_LEAF_TOL),
              (head_shallow(full, dtype="float32"), 1, FP32_GRAD_TOL, FP32_GRAD_TOL))),
            ("c", report_head_sharded, HEAD_SHARDED_ROWS,
             ((head_shallow(full), 0, TRAIN_TOL, TRAIN_LEAF_TOL),
              (head_shallow(full, dtype="float32"), 1, FP32_GRAD_TOL, FP32_GRAD_TOL)))):
        t0 = time.perf_counter()
        for cfg, seed, tol, leaf_tol in runs:
            params = make_dense_params(cfg, seed=seed, device=device)
            report(cfg, params, head_batch(cfg, device, rows, seed=seed), tol, leaf_tol, total,
                   f"[head] 20{part}")
            del params
            free(device)
        print(f"[time] phase 20{part} {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    head_kernel_cases(device, kern)
    print(f"[time] phase 20e {time.perf_counter() - t0:.1f}s")


# ----------------- phase 21: blocks the tensor axis leaves whole, at degree 3
# The plan search's own choice for actor_train and critic_train on six
# 8-card H100 nodes (``mcmc_search`` with ``examples/plan_search.py``'s
# settings) is d4t3p4m32.  At tensor degree 3 no config's q_dim, d_ff,
# experts, lru_width or SSD heads divide, so ``sanitize_specs`` leaves
# those blocks' weights whole, and every tensor rank runs them whole
# (``transformer.layer_plan``), as GSPMD replicates them in the JAX
# package; the vocabulary splits where 3 divides it.
WHOLE = "llama-7b"                  # (a, b, d): 128,256 vocabulary rows split, 1 x 42,752
WHOLE_LAYERS = 2
WHOLE_LAYOUTS = ((2, 3), (1, 3))    # (a): t3 with FSDP over 2 replicas, and alone
WHOLE_TRAIN = dict(batch=4, prompt=128, new=384)   # (a): 4 x 512 tokens
WHOLE_SERVE = dict(batch=4, prompt_len=512, steps=8)  # (b)
# (c): (model, layers at full width, dtype): recurrentgemma's FFN split, its
# RG-LRU and attention whole; mamba2's 64 SSD heads whole, its vocabulary
# split; granite's 32 experts and attention whole, its vocabulary split, in
# fp32 so that no route parts between the runs at a bf16 rounding.
WHOLE_REC = (("recurrentgemma-9b", 3, None), ("mamba2-1.3b", 4, None),
             ("granite-moe-1b-a400m", 4, "float32"))
WHOLE_REC_SERVE = dict(batch=4, prompt_len=256, steps=8)
WHOLE_TP = 3
WHOLE_GEN = (1, 8)                  # (d): actor_gen's layout in the same plan
WHOLE_FP32_TOL = 1e-5               # (a)'s fp32 step: loss, grad_norm, first moment


def whole_blocks(cfg, tp):
    """{block: whether a tensor axis of ``tp`` leaves it whole}, from the
    widths ``sanitize_specs`` tests: attention (and cross-attention) by
    q_dim, the FFN by d_ff or the experts, RG-LRU by lru_width, SSD by its
    heads and ``out_proj``'s rows."""
    def whole(*widths):
        return tp > 1 and any(w % tp for w in widths)
    ffn = (cfg.n_experts,) if cfg.ffn_kind == "moe" else (cfg.d_ff,)
    return {"attn": whole(cfg.q_dim), "ffn": whole(*ffn), "lru": whole(cfg.lru_width),
            "ssm": whole(cfg.ssm_heads, cfg.ssm_inner)}


def whole_gather_bytes(cfg, tp, kind):
    """Bytes one pass of a whole ``kind`` layer moves to gather the leaves
    the tensor axis still splits (their widths it divides): attention's
    wk/wv where it divides kv_dim; SSD's fused ``in_proj`` columns, conv
    channels and ``out_proj`` rows where it divides them."""
    bf = L.dtype_of(cfg).itemsize
    out = 0
    if kind == ATTN and cfg.kv_dim % tp == 0:
        rows_w = cfg.d_model + (1 if cfg.qkv_bias else 0)
        out += 2 * allgather_bytes(rows_w * cfg.kv_dim // tp * bf, tp)
    if kind == SSM:
        di, n = cfg.ssm_inner, cfg.ssm_state
        cols, ch = 2 * di + 2 * n + cfg.ssm_heads, di + 2 * n
        if cols % tp == 0:
            out += allgather_bytes(cfg.d_model * cols // tp * bf, tp)
        if ch % tp == 0:
            out += allgather_bytes((cfg.ssm_conv + 1) * ch // tp * bf, tp)
        if di % tp == 0:
            out += allgather_bytes(di // tp * cfg.d_model * bf, tp)
    return out


def whole_leaves(params, layout):
    """[(path, leaf, the mesh axes its sanitized spec splits it over, the
    axes its gradient is summed over)] of ``params`` on a (dp, tp)
    ``layout`` (FSDP over data, TP over model) where the tensor axis
    leaves every layer block whole: a layer leaf's gradient is whole on
    every tensor rank (``transformer.full_grad_leaves``), so it is summed
    over the data axis only; any other leaf's over each axis its spec
    leaves replicated."""
    mesh = Mesh(np.arange(math.prod(layout)).reshape(layout), ("data", "model"), device="cpu")
    specs = SHD.sanitize_specs(SHD.param_specs(params, SHD.ShardingRules()), params, mesh)
    out = []

    def one(path, leaf):
        axes = [a for part in tree_at(specs, path) for a in axes_of(part)]
        rep = [a for a in ("data", "model") if a not in axes and mesh.shape[a] > 1
               and not (path[0] == "layers" and a == "model")]
        out.append((path, leaf, axes, rep))
    tree_map_with_path(one, params)
    return out


def whole_train_bytes(cfg, params, layout, rows, seq):
    """(bytes, {part: bytes}) the collectives move in one sharded train step
    of ``rows`` x ``seq`` padded tokens on a (dp, tp) ``layout`` (FSDP over
    data, TP over model, remat) where the tensor axis leaves every layer
    block whole (``whole_blocks``) and no layer leaf split: "fsdp", each
    leaf's blocks all-gathered over data (a layer's in its forward, its
    recompute and, as the reduce-scatter, the backward; the table and head
    in the forward and the backward); "embed", the vocabulary-parallel
    lookup's all-reduce and its backward, which sends only the root's
    gradient (the stack's first whole sublayer keeps it there); "stream",
    the stack's gradient shares all-reduced where its last whole sublayer
    meets the head, in the activations' dtype; "head",
    ``head_loss_predicted`` per replica; "loss", the masked sum's and the
    count's all-reduces over the replicas (the sum's backward from the
    root); "grads", each leaf's fp32 gradient blocks all-reduced over
    ``whole_leaves``' axes."""
    dp, tp = layout
    n = dp * tp
    w = whole_blocks(cfg, tp)
    check(all(w[k] for k, kind in (("attn", ATTN), ("lru", LRU), ("ssm", SSM))
              if any(s.kind == kind for s in cfg.layers))
          and (cfg.ffn_kind == "none" or w["ffn"]),
          f"{cfg.name} at {tp}: whole_train_bytes reckons only stacks left whole")
    parts = dict.fromkeys(("fsdp", "embed", "stream", "head", "loss", "grads"), 0)
    bf = L.dtype_of(cfg).itemsize
    act = rows // dp * seq * cfg.d_model * bf
    for path, leaf, axes, rep in whole_leaves(params, layout):
        block = leaf.numel() // math.prod(layout[("data", "model").index(a)] for a in axes)
        if path[0] == "layers":
            check("model" not in axes, f"{path}: a layer leaf split over the tensor axis")
        if "data" in axes:
            parts["fsdp"] += ((3 if path[0] == "layers" else 2)
                              * allgather_bytes(block * leaf.element_size(), dp, tp))
        if rep:
            k = math.prod(layout[("data", "model").index(a)] for a in rep)
            parts["grads"] += allreduce_bytes(block * 4, k, n // k)
    if tp > 1:
        parts["stream"] = allreduce_bytes(act, tp, dp)
    if cfg.vocab_size % tp == 0:
        parts["embed"] = allreduce_bytes(act, tp, dp) + dp * (tp - 1) * act
        parts["head"] = dp * head_loss_predicted(rows // dp, seq, tp)[0]
    if dp > 1:
        parts["loss"] = 2 * allreduce_bytes(4, dp, tp) + (dp - 1) * 4
    return sum(parts.values()), parts


def whole_peak_predicted(params, layout, *, host_ref):
    """The peak bytes of the sharded train step reckoned from the layouts:
    every rank's blocks of the parameters, their fp32 gradient (twice for a
    leaf summed over some axis: the blocks autograd returns and their
    all-reduced copies), the AdamW m, v and fp32 master; beside them the
    single-device parameters and their fp32 first moment (on the host with
    ``host_ref``, else on the card) and one layer's FSDP-gathered leaves
    on every rank."""
    dp, tp = layout
    per_rank = 0
    for _, leaf, axes, rep in whole_leaves(params, layout):
        block = leaf.numel() // math.prod(layout[("data", "model").index(a)] for a in axes)
        per_rank += block * (leaf.element_size() + (8 if rep else 4) + 12)
    layer = sum(t.numel() * t.element_size() for t in tree_leaves(params["layers"][0]))
    dense = 0 if host_ref else sum(t.numel() * (t.element_size() + 4)
                                   for t in tree_leaves(params))
    return per_rank * dp * tp + layer * dp * tp + dense


def phase_whole_train(cfg, params, batch, layouts, *, impl):
    """21a: one single-device ``make_train_step``, then the sharded one on
    each (dp, tp) of ``layouts`` from the same parameters and batch; with
    ``host_ref`` the single device's first moment and the dense parameters
    wait on the host while a sharded step runs (fp32 llama-7b's step holds
    2.36e9 elements on the card with their gradients and AdamW state).
    Returns {layout: ``sharded_train``'s result (without "trained") with
    "predicted_bytes" and "predicted_peak"}."""
    device = params["embed"]["table"].device
    host_ref = cfg.dtype == "float32"
    rows, seq = batch["tokens"].shape
    ref, m_ref = single_train(cfg, params, batch, impl=impl)
    if host_ref:
        m_ref, params = (tree_map(lambda t: t.to("cpu"), tree) for tree in (m_ref, params))
        free(device)
    out = {}
    for layout in layouts:
        r = sharded_train(cfg, params, batch, layout, ref, m_ref, impl=impl, device=device)
        del r["trained"]
        r["predicted_bytes"] = whole_train_bytes(cfg, params, layout, rows, seq)
        r["predicted_peak"] = whole_peak_predicted(params, layout, host_ref=host_ref)
        out[layout] = r
        free(device)
    return out


def report_whole_train(cfg, runs, tols, total, tag):
    """21a printed and held: loss, grad_norm and first moment within
    ``tols[0]``, each leaf within ``tols[1]``, every replica (every whole
    block's copy on each tensor rank) bit-equal, the parameters finite and
    moved, the collectives' bytes equal to ``whole_train_bytes`` and the
    launches to ``tp_train_predicted``; adds the launches to ``total``."""
    tol, leaf_tol = tols
    ref = next(iter(runs.values()))["ref"]
    want = tp_train_predicted(cfg, (1, 1))
    print(f"{tag} {cfg.name} {cfg.num_layers} layers {cfg.dtype}: single device loss "
          f"{ref['loss']:.6e}, grad_norm {ref['grad_norm']:.6e}, {ref['seconds']:.3f}s, peak "
          f"{ref['peak']} bytes, launches {ref['launches']} (predicted {want})")
    check(same_launches(ref["launches"], want), f"{tag} single-device launches")
    for k in total:
        total[k] += ref["launches"][k]
    for layout, r in runs.items():
        want = tp_train_predicted(cfg, layout)
        pb, parts = r["predicted_bytes"]
        print(f"{tag} {cfg.name} on (data, model)={layout}, every layer block whole on each "
              f"of {layout[1]} tensor ranks: loss err {r['loss_err']:.3e}, grad_norm err "
              f"{r['grad_norm_err']:.3e}, first moment err {r['global_err']:.3e}, worst leaf "
              f"{r['worst_leaf']} {r['worst_leaf_err']:.3e} (tol {tol}, per leaf {leaf_tol}); "
              f"replicas bit-equal {r['replicas_equal']}; {r['seconds']:.3f}s (single device "
              f"{ref['seconds']:.3f}s), peak {r['peak']} bytes (reckoned "
              f"{r['predicted_peak']}), collectives moved {r['bytes']} bytes (predicted {pb}: "
              f"{parts}); launches {r['launches']} (predicted {want})")
        check(max(r["loss_err"], r["grad_norm_err"], r["global_err"]) <= tol
              and r["worst_leaf_err"] <= leaf_tol,
              f"{tag} the whole-block train step of {cfg.name} on {layout} disagrees with one "
              "device")
        check(r["replicas_equal"] and r["finite"] and r["moved"],
              f"{tag} {cfg.name} on {layout}: replicas differ, or parameters not finite or "
              "unmoved")
        check(r["bytes"] == pb, f"{tag} {cfg.name} on {layout}: {r['bytes']} bytes moved, "
              f"predicted {pb}")
        check(same_launches(r["launches"], want), f"{tag} train launches {r['launches']}")
        for k in total:
            total[k] += r["launches"][k]


def report_whole_serve(cfg, params, total, tag, *, batch, prompt_len, steps, logit_tol,
                       impl="cuda"):
    """21b/c: ``phase_tp_serve`` on (1, WHOLE_TP) against one device, held
    to ``logit_tol``, its bytes to ``sharded_serve_bytes`` and its launches
    to ``serve_predicted``; the kv bytes per card beside the single
    device's."""
    device = params["embed"]["table"].device
    t0 = time.perf_counter()
    peak_reset(device)
    layout = (1, WHOLE_TP)
    r = phase_tp_serve(cfg, params, layout, impl=impl, batch=batch, prompt_len=prompt_len,
                       steps=steps)
    r["predicted_bytes"] = (sharded_serve_bytes(cfg, WHOLE_TP, batch, prompt_len),
                            sharded_serve_bytes(cfg, WHOLE_TP, batch, 1, decode=True))
    r["predicted"] = serve_predicted(cfg, WHOLE_TP, steps)
    w = whole_blocks(cfg, WHOLE_TP)
    kinds = {s.kind for s in cfg.layers}
    blocks = {k: "whole" if w[k] else "split" for k, kind in (("attn", ATTN), ("lru", LRU),
                                                              ("ssm", SSM)) if kind in kinds}
    if cfg.ffn_kind != "none":
        blocks["ffn"] = "whole" if w["ffn"] else "split"
    blocks["vocab"] = "split" if cfg.vocab_size % WHOLE_TP == 0 else "whole"
    report_sharded_serve(tag, cfg.name, r, logit_tol, device, total, t0,
                         serve_what=f"{cfg.num_layers} layers {cfg.dtype} on (data, model)="
                                    f"{layout} ({blocks}), {batch} x {prompt_len} tokens then "
                                    f"{steps} decode steps; self-attention k/v per rank "
                                    f"{r['kv_bytes']} bytes")
    return r


def phase_whole_move(params, device):
    """21d: ``params`` placed on actor_gen's (1, 8) layout of logical
    devices 0-7, then moved by ``prefetch_reshard`` onto actor_train's
    (2, 3) layout of devices 0-5; every leaf moves (the device sets
    differ).  Returns the move's split, seconds, the predicted bytes (each
    leaf's global bytes once) and whether the moved tree gathers to
    ``params`` bit for bit."""
    gen = strategy_layouts(params, *WHOLE_GEN, tuple(range(math.prod(WHOLE_GEN))), device)
    train = strategy_layouts(params, *WHOLE_LAYOUTS[0],
                             tuple(range(math.prod(WHOLE_LAYOUTS[0]))), device)
    src = place_tree(params, gen)
    sync(device)
    t0 = time.perf_counter()
    task = RX.prefetch_reshard(src, train)
    moved = task.wait()
    sync(device)
    out = dict(seconds=time.perf_counter() - t0, n_moved=task.n_moved,
               n_aliased=task.n_aliased, moved_bytes=task.moved_bytes,
               total_bytes=task.total_bytes, n_leaves=len(tree_leaves(params)),
               predicted_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)))
    out["equal"] = all(torch.equal(st.gather(device), t)
                       for st, t in zip(tree_leaves(moved), tree_leaves(params)))
    out["whole_on_model"] = sum("model" not in str(st.layout.spec)
                                for st in tree_leaves(moved["layers"]))
    del src, moved, task
    free(device)
    return out


def report_phase21(device, total):
    """Phase 21 on the card: (a) llama-7b at full width on 2 layers trained
    one step on (2, 3) and (1, 3), every layer block whole on each tensor
    rank, bf16 against one device (TRAIN_TOL, TRAIN_LEAF_TOL), then in fp32
    on (2, 3) (WHOLE_FP32_TOL, FP32_GRAD_TOL per leaf); (b) its prefill and
    decode on (1, 3); (c) recurrentgemma-9b, mamba2-1.3b and granite at
    TP 3 served against one device; (d) llama-7b's 2 layers moved from
    actor_gen's (1, 8) onto (2, 3); each part's seconds."""
    t0 = time.perf_counter()
    full = get_config(WHOLE)
    for dtype, layouts, tols, seed in (
            (None, WHOLE_LAYOUTS, (TRAIN_TOL, TRAIN_LEAF_TOL), 0),
            ("float32", WHOLE_LAYOUTS[:1], (WHOLE_FP32_TOL, FP32_GRAD_TOL), 1)):
        cfg = first_layers(full, WHOLE_LAYERS, dtype=dtype)
        params = make_params(cfg, seed=seed, device=device)
        batch = lm_batch(cfg, device, seed=seed, **WHOLE_TRAIN)
        runs = phase_whole_train(cfg, params, batch, layouts, impl="cuda")
        del params
        report_whole_train(cfg, runs, tols, total, "[whole] 21a")
        free(device)
    print(f"[time] phase 21a {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cfg = first_layers(full, WHOLE_LAYERS)
    params = make_params(cfg, seed=2, device=device)
    report_whole_serve(cfg, params, total, "[whole] 21b", logit_tol=LOGIT_TOL, **WHOLE_SERVE)
    print(f"[time] phase 21b {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    m = phase_whole_move(params, device)
    print(f"[whole] 21d {cfg.name} {cfg.num_layers} layers from (data, model)={WHOLE_GEN} "
          f"onto {WHOLE_LAYOUTS[0]}: {m['n_moved']} of {m['n_leaves']} leaves moved, "
          f"{m['n_aliased']} aliased, {m['moved_bytes']} of {m['total_bytes']} bytes "
          f"(predicted {m['predicted_bytes']}: every leaf, the device sets differ), "
          f"{m['whole_on_model']} layer leaves whole over the model axis, {m['seconds']:.3f}s; "
          f"gathers to the source bit for bit {m['equal']}")
    check(m["n_moved"] == m["n_leaves"] and m["moved_bytes"] == m["predicted_bytes"]
          and m["equal"], "the (1, 8) -> (2, 3) reshard moved other bytes or changed a bit")
    del params
    free(device)
    print(f"[time] phase 21d {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for name, layers, dtype in WHOLE_REC:
        cfg = first_layers(get_config(name), layers, dtype=dtype)
        params = make_params(cfg, seed=3, device=device)
        report_whole_serve(cfg, params, total, "[whole] 21c",
                           logit_tol=FP32_LOGIT_TOL if dtype else LOGIT_TOL, **WHOLE_REC_SERVE)
        del params
        free(device)
    print(f"[time] phase 21c {time.perf_counter() - t0:.1f}s")


# ------------------------------------------------------------------ main

def shallow(cfg, layers=4, *, dtype=None):
    """``cfg`` at full width with about ``layers`` layers (whole
    superblocks, at least one, and the tail), in ``dtype`` (None: its
    own)."""
    n_sb = max(1, layers // len(cfg.superblock))
    return dataclasses.replace(cfg, dtype=dtype or cfg.dtype, n_superblocks=n_sb,
                               num_layers=n_sb * len(cfg.superblock) + len(cfg.tail))


def report_slice(cfg, params, *, prompt_len=256):
    """Phase 3 on the card for one model: cuda vs reference logits (and the
    router's agreement for MoE; for a model with recurrent mixers also in
    fp32 on a few layers), then paged vs dense decode, on prompts of
    ``prompt_len``."""
    sl = phase_slice(cfg, params, impl="cuda", prompt_len=prompt_len)
    routes = (f" route_agreement={sl['route_agreement']:.4f} (largest probability gap at a "
              f"route parting no earlier one reaches {sl['held_gap']:.3e}; printed)"
              if sl["route_agreement"] is not None else "")
    print(f"[slice] {cfg.name} {cfg.num_layers} layers bf16: prefill_err="
          f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} "
          f"(of max |logit| {sl['logit_scale']:.3f}; tol {LOGIT_TOL}) "
          f"argmax_agreement={sl['argmax_agreement']:.3f}{routes}")
    check(sl["prefill_err"] <= LOGIT_TOL and sl["decode_err"] <= LOGIT_TOL,
          f"{cfg.name}: cuda logits disagree with the reference")
    if any(s.kind != ATTN for s in cfg.layers):
        small = shallow(cfg, dtype="float32")
        p32 = make_params(small, seed=1, device=params["embed"]["table"].device)
        sl = phase_slice(small, p32, impl="cuda")
        del p32
        torch.cuda.empty_cache()
        print(f"[slice] {cfg.name} fp32, {small.num_layers} layers: prefill_err="
              f"{sl['prefill_err']:.3e} decode_err={sl['decode_err']:.3e} (of max |logit| "
              f"{sl['logit_scale']:.3f}; tol {FP32_LOGIT_TOL}) "
              f"argmax_agreement={sl['argmax_agreement']:.3f}")
        check(sl["prefill_err"] <= FP32_LOGIT_TOL and sl["decode_err"] <= FP32_LOGIT_TOL,
              f"{cfg.name}: fp32 cuda logits disagree with the reference")
    report_paged(cfg, params, prompt_len=prompt_len)


def report_paged(cfg, params, *, prompt_len=256):
    """Phase 3's paged decode against the dense decode, both cuda, printed
    and held."""
    pg = phase_paged_slice(cfg, params, impl="cuda", prompt_len=prompt_len)
    # on the same split grid the paged decode is flash_decode's bits on the
    # gathered cache (phase 2), so the logits must be the same bits; one key
    # left out of the last paged layer reads 3.9e-3 to 7.0e-3 here
    # (scripts/limit_controls.py), under LOGIT_TOL
    tol = 0.0 if pg["same_grid"] else LOGIT_TOL
    print(f"[slice] {cfg.name} paged decode vs dense decode, both cuda: paged_err="
          f"{pg['paged_err']:.3e} (of max |logit| {pg['logit_scale']:.3f}; tol {tol}"
          + (", the same split grid: the same bits" if pg["same_grid"] else "")
          + f") argmax_agreement={pg['argmax_agreement']:.3f}")
    check(pg["paged_err"] <= tol, f"{cfg.name}: paged logits disagree with the dense decode")


def report_continuous(cfg, params, total, modes, traffic=None, near_ties=False):
    """Phase 5 on the card for one model, on ``traffic`` (prompts, new)
    (None: ``continuous_traffic``'s); adds each run's launches to
    ``total``.  The kernels of the path are those the prediction launches.
    Greedy continuous and bucketed outputs of an attention-only model agree
    on all requests but one; with ``near_ties`` (phase 12's configs), and
    for a model with recurrent mixers, each request where they part is
    held to a near-tie (``tie_gaps``, RECURRENT_TIE_TOL) instead; with
    ``near_ties`` an MoE model's (arctic-480b in bf16, whose parted routes
    move a token's logits past any logit near-tie) to a route that parted
    before (``report_engine_routes``)."""
    prompts, new = traffic or continuous_traffic(cfg)
    torch.cuda.reset_peak_memory_stats()
    cruns = phase_continuous(cfg, params, prompts, new, impl="cuda", modes=modes)
    for mode, r in cruns.items():
        print(f"[continuous] {cfg.name} {mode}: {len(prompts)} requests (prompt lengths "
              f"{sorted(len(p) for p in prompts)}, new {sum(new)} tokens), "
              f"{r['tokens_per_s']:.1f} tokens/s in {r['seconds']:.3f}s, latency "
              f"p50={r['p50_s']:.3f}s p99={r['p99_s']:.3f}s; steps={r['steps']} "
              f"admissions={r['admissions']} preemptions={r['preemptions']} "
              f"peak_blocks={r['peak_blocks']}/{r['pool_blocks'] - PC.RESERVED_BLOCKS} "
              f"kv_peak_bytes={r['kv_peak_bytes']} "
              f"full_buffer_bytes={r['full_buffer_bytes']}; launches {r['launches']} "
              f"(predicted {r['predicted']})")
        check(same_launches(r["launches"], r["predicted"]),
              f"continuous {mode}: launches {r['launches']} != {r['predicted']}")
        check(all(r["launches"][k] > 0 for k, n in r["predicted"].items() if n),
              f"continuous {mode}: a kernel of the path never launched")
        for k in total:
            total[k] += r["launches"][k]
    bk = bucketed_on(cfg, params, prompts, new, impl="cuda")
    check(same_launches(bk["launches"], bk["predicted"]),
          f"bucketed: launches {bk['launches']} != {bk['predicted']}")
    for k in total:
        total[k] += bk["launches"][k]
    same_bk = sum(bool((a == b).all()) for a, b in zip(cruns["greedy"]["outputs"],
                                                       bk["outputs"]))
    agree = ""
    if "preempt" in cruns:
        check(cruns["preempt"]["preemptions"] >= 1, "the small pool preempted nothing")
        n_agree = sum(bool((a == b).all()) for a, b in zip(cruns["greedy"]["outputs"],
                                                           cruns["preempt"]["outputs"]))
        agree = f"the preempted greedy run on {n_agree}/{len(prompts)} requests and "
        # the runs batch rows differently, so in bf16 a near-tie may fall
        # the other way in one request; more than one disagreeing is a fault
        check(n_agree >= len(prompts) - 1, "greedy and preempted continuous runs disagree")
    print(f"[continuous] {cfg.name} greedy equals {agree}the bucketed server on "
          f"{same_bk}/{len(prompts)}; bucketed on the same traffic: "
          f"{bk['useful_tokens_per_s']:.1f} useful tokens/s in {bk['seconds']:.3f}s, "
          f"launches {bk['launches']} (predicted {bk['predicted']}); "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} bytes")
    if all(s.kind == ATTN for s in cfg.layers) and not near_ties:
        check(same_bk >= len(prompts) - 1, "continuous and bucketed greedy outputs disagree")
        return
    if moe_layers(cfg):
        report_engine_routes(cfg, params, prompts, new)
        return
    # a recurrent state carries each bf16 rounding difference between the
    # engines' batches on to every later token, so greedy runs part at more
    # near-ties than qwen2-0.5b's; so do phase 12's configs (1-7 of 16
    # requests on the H100, each a near-tie); each request where they part
    # must be one
    gaps = tie_gaps(cfg, params, prompts, cruns["greedy"]["outputs"], bk["outputs"])
    worst = max((g / sc for g, sc in gaps.values()), default=0.0)
    print(f"[continuous] {cfg.name} where greedy continuous and bucketed part, the two "
          "tokens' larger distance below the top logit, over the top |logit|: "
          + (", ".join(f"request {i} {g / sc:.3e}" for i, (g, sc) in gaps.items()) or "none")
          + f" (tol {RECURRENT_TIE_TOL})")
    check(worst <= RECURRENT_TIE_TOL,
          f"{cfg.name}: continuous and bucketed greedy outputs part at {worst:.3e} below the "
          f"top logit, past a near-tie ({RECURRENT_TIE_TOL})")


def report_engine_routes(cfg, params, prompts, new, *, impl="cuda"):
    """Phase 5's engines for an MoE model in bf16 (``engine_partings``),
    printed and held: a request whose outputs part past a logit near-tie
    (RECURRENT_TIE_TOL) must have had a route part before, and each route
    parting that no earlier one reaches must be a near-tie
    (``route_tie_tol``)."""
    ties, routes = engine_partings(cfg, params, prompts, new, impl=impl)
    past = [i for i, g in ties.items() if g > RECURRENT_TIE_TOL]
    worst = max(h for _, h in routes.values())
    print(f"[continuous] {cfg.name} greedy continuous and bucketed runs with every route "
          f"recorded: outputs part on {len(ties)}/{len(prompts)} requests ("
          + (", ".join(f"request {i} {g:.3e} below the top logit over the top |logit|, "
                       f"{routes[i][0]} (token, layer) routes parted before"
                       for i, g in ties.items()) or "none")
          + f"; {len(past)} past the logit near-tie {RECURRENT_TIE_TOL}, each held to a "
          f"route parted before); routes part on {sum(n > 0 for n, _ in routes.values())}/"
          f"{len(prompts)} requests, largest probability gap at a parting no earlier one "
          f"reaches {worst:.3e} (tol {route_tie_tol(cfg)})")
    check(all(routes[i][0] for i in past),
          f"{cfg.name}: continuous and bucketed greedy outputs part past a near-tie with no "
          "route parted before")
    check(worst <= route_tie_tol(cfg),
          f"{cfg.name}: the engines' routes part at {worst:.3e}, past a near-tie")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s")
    device = torch.device("cuda")

    kern = phase_kernels(device)

    cfg = get_config("qwen2-0.5b")
    params = make_params(cfg, seed=0, device=device)
    report_slice(cfg, params)

    total = {k: 0 for k in launches()}
    report_batch_serve(cfg, params, total)
    report_continuous(cfg, params, total, ("greedy", "sampled", "preempt"))
    del params
    torch.cuda.empty_cache()

    for name in ("granite-moe-1b-a400m", "mamba2-1.3b", "recurrentgemma-9b"):
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = make_params(cfg, seed=0, device=device)
        n_params = sum(t.numel() for t in tree_leaves(params["layers"]))
        print(f"[model] {name}: {cfg.num_layers} layers, {n_params} layer parameters "
              f"(+ {params['embed']['table'].numel()} embedding), built in "
              f"{time.perf_counter() - t0:.1f}s; memory_allocated="
              f"{torch.cuda.memory_allocated()} bytes")
        report_slice(cfg, params)
        report_continuous(cfg, params, total, ("greedy", "sampled"))
        del params
        torch.cuda.empty_cache()

    report_train(get_config("qwen2-0.5b"), train_experiment(), device, total)
    report_phase7(device, total)
    report_engine(device, total)
    report_spec(device, total)

    t0 = time.perf_counter()
    params = report_llama(device, total)
    report_realloc(get_config(LLAMA), params, device)
    report_layout_engine(params, device)
    print(f"[time] phase 10 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_sharded(params, device, total)
    del params
    free(device)
    print(f"[time] phase 11 {time.perf_counter() - t0:.1f}s")
    report_phase12(device, total)
    report_phase13(device, total)
    report_arctic(device, total, kern)
    t0 = time.perf_counter()
    report_phase15(device, total)
    print(f"[time] phase 15 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_phase16(device, total)
    print(f"[time] phase 16 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_phase17(device, total)
    print(f"[time] phase 17 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_phase18(device, total, kern)
    print(f"[time] phase 18 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_phase19(device, total)
    print(f"[time] phase 19 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_phase20(device, total, kern)
    print(f"[time] phase 20 {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    report_phase21(device, total)
    print(f"[time] phase 21 {time.perf_counter() - t0:.1f}s")

    source = "src/repro_torch/kernels/csrc/"
    rows = [dict(name="flash_mha", route="cuda", source=source + "flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:91",
                 launches=total["flash_mha"], **kern["flash_mha"]),
            dict(name="flash_decode", route="cuda", source=source + "decode_attention.cu",
                 replaces="src/repro/kernels/decode_attention.py:82",
                 launches=total["flash_decode"], **kern["flash_decode"]),
            dict(name="paged_flash_decode", route="cuda",
                 source=source + "paged_decode_attention.cu",
                 replaces="src/repro/kernels/paged_decode_attention.py:43",
                 launches=total["paged_flash_decode"], **kern["paged_flash_decode"]),
            dict(name="grouped_ffn", route="cuda", source=source + "grouped_expert.cu",
                 replaces="src/repro/kernels/grouped_expert.py:73",
                 launches=total["grouped_ffn"], **kern["grouped_ffn"]),
            dict(name="ssd_scan", route="cuda", source=source + "ssd_scan.cu",
                 replaces="src/repro/kernels/ssd_scan.py:76",
                 launches=total["ssd_scan"], **kern["ssd_scan"]),
            dict(name="rglru_scan", route="cuda", source=source + "rglru_scan.cu",
                 replaces="src/repro/kernels/rglru_scan.py:48",
                 launches=total["rglru_scan"], **kern["rglru_scan"]),
            dict(name="flash_mha_varlen", route="cuda", source=source + "varlen_attention.cu",
                 replaces="src/repro/kernels/varlen_attention.py:117",
                 launches=total["flash_mha_varlen"], **kern["flash_mha_varlen"])]
    for r in rows:
        check(all(math.isfinite(r[k]) for k in ("ms", "cold_ms", "plain_ms", "bound_ms")),
              f"{r['name']}: non-finite time")
        check(r["library_ms"] is None or math.isfinite(r["library_ms"]),
              f"{r['name']}: non-finite library time")
        check(r["launches"] > 0, f"{r['name']}: never launched on the main path")
    print(f"[time] chip_smoke wall time {time.perf_counter() - t_start:.1f}s")
    print(smi)  # again, so that the card stays beside the numbers in a tail of the output
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
