#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`fa2_triton_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. Phases (any failure raises, and the script exits nonzero):

1. Build the CUDA kernels from `fa2_triton_tpu_torch/csrc/` with nvcc for
   sm_90a (ptxas register / shared-memory report printed), and start
   cuobjdump -sass of the built library in the background. Before phase 8
   (while the card ran phases 1-7, the dump was read), a line per 16-bit
   instantiation of the tensor-core kernels (the forward and the dq + dk/dv
   pair, with and without bias / softcap; dbias; the tri-square / diag and
   work-list backward; the packed forward, dq and dk/dv; bf16 and fp16, D
   64 / 128 / 256 / 384 / 512, with and without dropout): ptxas registers
   and spills, and the HMMA instructions in its SASS; it fails where one
   has no tensor-core instruction, a bf16 D 128 one of the trainers'
   spills, any one at D 384 / 512 spills, or any packed forward spills.
2. Hold each kernel against its plain PyTorch twin at the serving slice's
   shapes, in bf16 and fp32, and time both with CUDA events. The decode
   kernel also runs over int8 and fp8 caches (B5 quant) and over shuffled
   page pools at page 128 and 512 (B6), each variant once per call: paged
   must equal contiguous bit for bit, and NaN in unused pages and rows must
   not change the output. Decode is timed by its kernel's device time
   (torch.profiler; at ~0.03 ms a call's CUDA-event time is the host's,
   printed beside it), with its split-KV grid: chunks per (slot, KV head)
   and the blocks whose chunk holds a live row. Before it, right after the
   build, a line sums up the 360 decode instantiations' ptxas registers
   and spills and the HMMA of the 16-bit ones; any spill fails.
3. Serve 16 requests through `runtime.serving.Engine` at the published
   widths of Mistral-7B-v0.3 (random bf16 weights from a seed), with the
   launch counters reset just before; every prefill dispatch and decode step
   must have gone through the kernels on every layer.
4. Recompute the served log-probs of two requests with the port's plain
   fp32 forward and compare. Then serve the same requests three more times:
   paged bf16 (tokens and log-probs equal to phase 3's), paged int8 with a
   57-page pool of 128 tokens (it runs dry, so a request is preempted, and
   every page comes back), and contiguous fp8; the quantized runs' log-probs
   are held against the fp32 forward.
5. Hold each backward kernel (dq, dk/dv) against its plain twin at the
   training shape (B 2, 32 / 8 heads, D 128, S 2047, causal), in bf16 and
   fp32, under the FA gradient contract, and time both: each 16-bit kernel's
   profiler time with its share of the bound and the aten backward's time,
   and at least 3x faster than its earlier FMA design's.
6. The bias path: `flash_attn_func` with a trainable per-head bias at the
   training shape, launch counts reset just before; the forward-with-bias,
   dq, dk/dv and dbias kernels must all have run, and out / dq / dk / dv /
   dbias are held against the plain twins. The tensor-core dbias kernel's
   profiler time, with its share of the bound, must be 3x faster than its
   FMA design's (phase 10 holds the bias path with dropout to the same).
7. Training at Mistral-7B-v0.3 widths: (i) 2 layers, every parameter
   gradient through the kernels and through the plain attention, both held
   to an fp32 plain run; (ii) full depth, `examples/train.py` with remat,
   AdamW and clipping for a few steps on one repeated batch, launch counts
   reset after its warm-up: every loss finite, the last below the first,
   and layers x steps dq / dk/dv launches, twice that of flash_fwd.
8. Packed varlen at Mistral-7B-v0.3 attention widths (32 / 8 heads, D 128,
   bf16, causal): documents of log-uniform length packed into T <= 16384,
   forward and backward through `flash_attn_varlen_func` with the launch
   counts reset just before (one launch of each varlen kernel); out, lse and
   gradients held against the fp32 and bf16 plain twins, dead positions
   exactly 0; kernel, plain and library times, each kernel's share of its
   bound and its time over the library's, each tensor-core kernel at least
   3x faster than its FMA design; the host time of the q-major and the
   kv-major launch table apart; packed against the same documents
   right-padded through `flash_attn_func(attention_mask=...)`.
9. Block-sparse at the same widths (B 2, S 4096, a local band plus an
   attention sink) through `flash_attn_blocksparse_func`, checked and timed
   the same way, with flex_attention as the library yardstick.
10. Attention dropout (p 0.1, bf16, 32 / 8 heads, D 128): mask probes that
   read every kernel's applied mask bit for bit (`utils/mask_probes.py`:
   forward, dq, dk/dv, dbias, varlen forward / dq / dk/dv; D 64/128/256,
   GQA 1 and 4, global offsets); `flash_attn_func` with dropout at B 2 x
   S 2048 (launch counts reset just before) against the fp32 oracle fed the
   same mask, the drop share over the whole mask grid, determinism in the
   seed, the bias path with dropout, phase 8's packed batch with dropout,
   and a full-width `FlashSelfAttention` trained for 3 AdamW steps (launch
   counts reset just before; eval equal to `flash_attn_func` without
   dropout; remat gradients equal bit for bit); times with and without
   dropout.
11. Long-context causal schedules at the same widths (B 1, bf16, causal, no
   mask): the split (one diag launch over leaves of 2048, one rectangle
   merged in place) at S 4096 and 4095, with split_leaf 1024 (three merged
   rectangles), the diag and a 2048 x 2048 rectangle alone and merged, and
   the strip at S 6144 and at 2048 queries against 4096 keys: launches of
   each default route, every kernel against its plain twin (fp32, bf16, and
   fp32 with dropout fed the same mask), the strip (the generic kernel's
   causal call) equal to the generic kernel bit for bit, times against the
   generic kernel (which must beat the FMA split at S 4096), the plain
   twins, the library and the bound; `flash_attn_func` forward + backward at S 4096
   through the split (FA rules against fp32; each of its four kernels'
   device time); and `examples/train.py` at
   full depth, batch 1 x seq 4096 (attention over 4095 tokens: the split),
   with finite, falling losses and 2 x layers x steps diag and merged-rect
   launches, none of the generic forward.
12. The causal backward schedules at Qwen1.5-7B attention widths (32 / 32
   heads, D 128, bf16, causal, no mask): the tri-square (B13) at B 2 x S
   2047, the work list (B14) at B 1 x S 8191 (four strips of 2048) and the split
   forced with split_leaf 2048 at S 4096 (one diag launch over two leaves,
   one rect), each reached through `flash_attn_backward`'s routing with its
   launches counted, the block partitions printed (blocks, per kv head,
   largest / mean work: at least one block per SM and at most 1.25), each
   kernel held against its plain twin (fp32, bf16 under the FA gradient
   contract, fp32 with dropout fed the same mask, two runs equal bit for
   bit) and timed against the generic dq + dk/dv pair (fused / pair
   printed; each must beat its own earlier FMA design), those times, its plain
   twin, the library and its bound; the trainers' forward at both Qwen
   shapes (the generic kernel: its time, the FMA design's, aten flash's
   causal forward on the same inputs, its bound and the share of it); then
   `examples/train.py --config qwen1.5-7b` at full depth, 2 x 2048
   (attention over 2047 tokens: the tri-square backward) and 1 x 8192 (the
   work list; 1 x 6144, the same route, only if 8192 runs out of memory),
   with finite, falling losses and layers x steps launches of the
   schedule's kernel, none of the dq / dk/dv pair.
13. (Run right after phase 4, on its model.) Chunked prefill and the
   prefix cache: (a) phase 3's requests with `prefill_chunk=512` on the
   contiguous bf16 cache: every request finishes, a decode step runs while
   a slot is mid-prefill, launches are layers x (prefill dispatches,
   chunks included) and layers x decode steps, and the log-probs pass
   phase 4's check; (b) a 1024-token shared prefix plus log-uniform tails
   of 64-1024 tokens, two waves of 8 on one paged engine (page 128,
   prefix cache, chunks of 512), requests 0-3 of a wave greedy and 4-7
   sampled (temperature 0.8, top-k 50, top-p 0.95): wave B reuses exactly
   8 x 1024 cached tokens, every page comes back, wave B's log-probs pass
   the check, and the first sampled decode step's logits rows, copied to
   the CPU, draw the card's tokens there (random bits equal bit for bit,
   tokens wherever the top-two gap exceeds 1e-4); (c) the chunk's kernel
   call (C 512 at q_off 1024 over 1536 rows) against its plain twin under
   the FA rule, timed beside aten flash and its bound. Prints ms per
   greedy-only and per sampled decode step and per chunk dispatch.
14. (Run right after phase 13, on its model, but (d).) Speculative
   decoding on the cached forward (`runtime/speculative.py`: B1 at width 1
   and gamma + 1 over the cache through `flash_attn_with_kv_cache`) and the
   GPT-2 family: (a) fp32, a 2-layer target and a 1-layer draft at
   Mistral-7B-v0.3 widths: the cache attention against its plain twin at
   widths 1 and 5 over 1000 rows (fp32 1e-4, bf16 the FA rule), greedy
   speculative equal to `greedy_reference` at gamma 1 and 4, the perfect
   draft accepting everything in ceil((n - 1) / 5) verify passes, an EOS
   inside a round cutting it; (b) the full-depth bf16 model as the target
   with a 2-layer draft (seed 1) and as its own draft, gamma 4, 64 tokens
   after each of 4 of phase 3's prompts, the counts reset before each run:
   B1 once a layer a model step and nothing else, each stream equal to
   `greedy_reference`'s up to any divergence, which must sit where the
   reference's top-two logit gap is under 0.1; acceptance, tokens per
   target call, ms per emitted token against the reference's, B1 launches
   a round, a width-1 and a width-5 target step's ms, and the verify
   call's B1 device time beside aten's, the plain twin's and the bound;
   (c) speculative sampling (temperature 0.8, top-k 50, top-p 0.95, seed
   7): two runs equal and in the vocab, round 0's keys, uniforms and bits
   equal on the card and the CPU, the perfect draft's sampled acceptance
   at least 0.9; (d) (after the served model is freed) GPT-2 small, bf16:
   3 AdamW steps at 8 x 1024 (finite, falling losses, the routes' launches
   once a layer a step), 2-layer gradients against fp32 under the FA
   contract, a cached greedy decode (512, then 63 width-1 steps) against
   the full forward's log-probs, and position 1024 raising.
15. The rest of the model zoo on the kernels above (no kernel of its own):
   (e) (run on phase 3's model, after phase 14) `quantize_model_params`
   with int8 and with fp8 weights: the weight bytes against bf16, layer 0's
   `w_gate` through `qmatmul` against x @ (values x scales) in fp32, 8 of
   phase 3's requests served paged, and the served tokens held against the
   quantized model's own `forward` (teacher-forced: each token forward's
   argmax or within ZOO_TIE_GAP of it, log-probs within ZOO_LOGPROB_MEAN_TOL
   on average); then, after the served model is freed: (b) one
   Mixtral-8x7B-v0.1 layer at T 4094: `moe_mlp` at capacity T against an
   fp32 evaluation of the same routing under the FA output rule (the dense
   block the yardstick), the slots at the default and a small capacity
   equal to JAX's rule rebuilt index by index, every token whose choices all
   dropped equal to its residual, the router's gradient finite; (a)
   `examples/train.py --config mixtral-8x7b-v0.1 --layers 5` at 2 x 2048,
   remat, 3 steps on one repeated batch: every warm-up gradient finite, the
   routers' nonzero, drops per layer, falling losses, the forward / dq /
   dk/dv launches; (c) Mixtral at 16 layers serving 8 of phase 3's prompts
   paged, held against `forward` by the share of equal tokens and the mean
   log-prob error (a bf16 router swaps near-tied experts between the two
   paths), then the same at 2 layers in fp32 held token by token as in
   (e); (d) LoRA (rank 8 on wq / wk /
   wv / wo, alpha 16) on the full-depth Mistral-7B-v0.3 model, 3 AdamW
   steps on the adapters at 2 x 2048, remat: falling losses, the base bit
   for bit unchanged, the launches; the merged model serving 2 prompts.
16. The runtime and training extras (no kernel of their own; run last):
   at Mistral-7B-v0.3 widths cut to 4 layers (1.14 B parameters; a
   checkpoint of the bf16 weights and both AdamW moments is ~6.8 GB), on a
   corpus of 64 windows of 2048 tokens written by `utils/data.py:
   encode_corpus` from numpy.random.RandomState(0): (a) `examples/train.py
   --data ... --ckpt-dir <tmp> --save-every 2` for 4 steps at 2 x 2048,
   remat, then a fresh run to `--steps 6` from the same directory, which
   must resume at step 4 with steps 4-5 equal bit for bit to an
   uninterrupted 6-step run's (launch counts reset after its warm-up:
   layers x 2 steps dq / dk/dv, twice that of the forward); the
   checkpoint's bytes, its save (host copy) and write seconds, the restore
   seconds; (b) on the state restored from step 6, a step whose loss is
   multiplied by NaN must be skipped (`steps_skipped` 1) with every
   parameter, AdamW moment and step count bit for bit unchanged; (c)
   `examples/eval.py` on that checkpoint must give the cross-entropy of
   `loss_fn` on the restored model over the same windows, exactly
   (forward launches layers x batches, no backward); (d) `devices_healthy()`
   (a subprocess) True, `profile_trace` around one step writes a non-empty
   trace, `device_time` of one `flash_attn_func` call at 2 x 2048 within
   0.5-2x of `cuda_ms`, and the trainer's roofline line; (e)
   `runtime/serving_demo.py --requests 8 --new-tokens 16` prints its JSON
   line with tokens/s > 0. The checkpoint and corpus live in a temporary
   directory under `build/`, removed at the end of the phase.
17. The card's tuning table (`ops/tables/tuning_h100.json`; phases 1-16
   run with FA2_DISABLE_TUNING_TABLE=1, the prior's routes, which they
   assert): `detect_chip()`, the table's path and entries; (a) for every
   (head dim, bucket, GQA group) of the table, `flash_attn_func` forward
   + backward in bf16 at B 1, 4 / (4 / group) heads, length bucket - 1,
   once with the table and once without it where the routes differ, the
   launch counts showing each route, each run held against the fp32 plain
   twins under the FA rules; (b) one tune-on-miss (FA2_TUNE_ON_MISS=1 into
   a temporary FA2_TUNING_DIR under `build/`) on a key the table lacks, the
   persisted winner one of its candidates; (c) fp16 `flash_attn_func`: the
   fp32 kernels by default, the tensor-core kernels with
   fp16_compute_dtype=bfloat16, by the profiler's kernel names. Prints its
   time; its summary sits under the forward entry's `routing`.
18. The parallel layer (`parallel/`), ranks spawned (`spawn`) on this one
   card over gloo, every CUDA tensor staged through host memory: (a) ring
   attention at Mistral-7B-v0.3 attention widths (32 / 8 heads, D 128,
   bf16), B 1 x S 8192 over seq 4, zigzag (chunks of 1024): forward +
   backward, with dropout (p 0.1, a fixed seed), and with `return_lse` and
   a `dlse`; and a non-causal contiguous ring; (b) Ulysses (seq 4) and TP
   attention (data 2 x model 2, B 2); rank 0 holds every case's out, lse
   and gradients to `flash_attn_reference` on one card, a kv head at a
   time, under the FA rules (the fp32 truth, the bf16 reference computed in
   bf16 as the yardstick, the ring's dropout mask); (c) phase 3's prompts
   through a TP-2 Engine and a data-2 `DataParallelEngine` (4 slots a
   replica) at Mistral-7B-v0.3 widths, cut to 8 of 32 layers
   (CHIP_SMOKE_PAR_LAYERS), contiguous, paged and int8 KV, held to the single-device
   Engine's tokens (a divergence only at a near tie, within 4x the measured
   log-prob drift). Each rank's launches (reset just before each case; a
   case whose forward or backward kernels never ran fails), wall times, its
   kernels' device time (torch.profiler) and host staging (ms an op) are
   printed; a failed rank fails the run. The
   launches, summed over the ranks, sit in each kernel's
   `launches_parallel`, the rest under the forward entry's `parallel`.
19. Parallel training, ranks spawned on this one card over gloo as in
   phase 18 (cuts printed first): (a) `examples/train.py` (a rank's
   `run_rank`) at Mistral-7B-v0.3 widths cut to 4 of 32 layers
   (CHIP_SMOKE_PAR_TRAIN_LAYERS), bf16, 2 x 2048 globally (1 row a data
   rank), remat, over data 2 x model 2 without and with FSDP, 2 steps
   each: step 0's loss and every gradient before clipping (the warm-up's,
   each rank's pieces written under `build/` and joined here) held to the
   single-rank step under the FA rules (the fp32 truth with the plain
   attention, the bf16 single-rank step as the yardstick), step 1's loss
   finite and equal on every rank, FSDP's cut in each rank's parameter
   bytes (and AdamW moments twice those); per rank the bytes, step
   walls, launches (reset after the warm-up), the kernels' device ms per
   launch (torch.profiler) and host staging ms an op; (b) at the same
   widths, `make_llama_pipeline_forward` (pipe 2, 2 microbatches) and
   `make_llama_3d_forward` (pipe 2 x model 2) on B 4 x S 1024, logits and
   the gradients of loss_fn's cross-entropy held likewise; (c)
   Mixtral-8x7B-v0.1 at 2 layers, `moe_param_pspecs` over model 2 (4
   experts a rank), one `moe.loss_fn` step with `make_ep_mlp` and TP
   attention on 1 x 2048, loss and gradients held likewise, the one-rank
   steps taking the EP step's expert choices (a near tie flips between
   precisions), which may differ from the fp32 step's own on at most 3 x
   the tokens the bf16 one-rank step's own choices do, + 8; each EP rank's
   kernels' device ms (torch.profiler); (d)
   `parallel/dryrun.py:dryrun_multichip(4)` on the card. A case whose
   forward or backward kernels never ran fails; the launches, summed over
   the ranks, sit in `launches_parallel_train` of every entry (the
   forward, dq and dk/dv ones nonzero), the rest under the forward entry's
   `parallel_train`.
20. Head dims 384 and 512: (a) at each, B 1 x S 1024, 8 query / 2 KV
   heads, each kernel against its plain twin under the FA rules: the
   forward on every route forced by name (tri-square at S 256, the split
   with its merge, the strip, the generic kernel), with dropout, a bias,
   softcap and a window; fp32, and fp16 at the ops level and through
   `flash_attn_func` (fp32 and bf16 compute); the dq + dk/dv pair on the
   generic route (and the strip's where its gate passes) with dropout and
   with a bias that needs no gradient or softcap, and in fp32; decode over
   bf16 / fp16 / fp32 / int8 / fp8 caches and paged bf16 / int8 pools
   (equal to contiguous bit for bit); every family launched at each D; (b)
   times at B 2 x S 2048 causal (D 512 and 384) and decode over 8 slots x
   4096 rows (D 512): kernel device ms (torch.profiler), the calls by CUDA
   events, plain ms, bounds and SDPA's memory-efficient backend (its flash
   backend stops at 256); (c) Mistral-7B-v0.3's widths with the attention cut into 8
   / 2 heads of 512 (`preset_config(..., n_heads=8, n_kv_heads=2,
   head_dim=512)`), full depth: 8 of phase 3's prompts served contiguous
   bf16 and paged int8 with phase 3's log-prob check, the 2-layer
   gradients against fp32 (phase 7 (i)'s check), 3 trainer steps at 2 x
   2048; (d) Phi-3-mini-4k-instruct's
   widths (head_dim 96, caches 128 wide), phase 3's 16 requests contiguous
   bf16 and paged int8 with the same check. Each entry of the kernels line
   names the head dims its kernel is built for (`head_dims`); the
   forward, dq, dk/dv and decode entries carry the launches at each D
   (`launches_wide_384` / `_512`), of (c) and (d) (`launches_wide_serve`,
   `launches_phi3_serve`, `launches_wide_train`), the rest under the
   forward entry's `wide`.
21. The fused causal backward schedules and dbias at head dims 384 and
   512: (a) at each D, through JAX's routes, each against its plain twin
   under the FA rules: the tri-square (bf16 at S 512 MHA and S 256 GQA 2,
   fp32 at S 256), the split forced with leaves of 512 at S 1024 (diag +
   rect), the work list (bf16 at D 512 / S 2048 and D 384 / S 4096, one
   direct fp32 call) and dbias ([1, 8, S, S] and [2, 1, S, S] biases, bf16
   / fp16 / fp32), with and without dropout; every family launched at each
   D; (b) at 8 / 8 heads of 512, bf16, causal: the work list at B 2 x S
   2048 and the tri-square at 8 x 512, each against the dq + dk/dv pair on
   the same call (CUDA events, the profiler's split), the plain backward
   and SDPA's memory-efficient backward; the split's diag and rect at B 2
   x S 2048 (leaves of 1024); dbias at B 2 x S 2048 with a [1, 8, S, S]
   bias; each with its bound; (c) Qwen1.5-7B's widths cut into 8 / 8 heads
   of 512 (`preset_config("qwen1.5-7b", n_heads=8, n_kv_heads=8,
   head_dim=512)`): the 2-layer gradients against fp32, and 3 trainer steps
   at 2 x 2048 (the work list) and 8 x 512 (the tri-square) at the
   preset's full depth, the launches held to the route. The B4, B13, B13 diag, B13 rect and B14
   entries of the kernels line carry (a)'s launches (`launches_wide_384` /
   `_512`), (c)'s (`launches_wide_train`) and (b)'s numbers (`wide_512`).
22. The packed kernels (B7, B8) at head dims 384 and 512, 8 query / 2 KV
   heads, causal: (a) at each D, through the launchers, the forward, dq
   and dk/dv against their plain twins in bf16, fp16 and fp32 (FA rules;
   fp32 within 1e-4), on ragged documents with NaN in the packed gaps,
   with dropout, and block-sparse with a filtered row and kv block, one
   launch of each a call, dead positions exactly 0; (b) phase 8's
   documents (T 14592) at Mistral-7B-v0.3's attention widths in heads of
   384 and of 512, and phase 9's block-sparse 2 x 4096 at 512, through
   `flash_attn_varlen_func` / `flash_attn_blocksparse_func` forward +
   backward with the launch counts reset just before (one launch of each
   kernel), checked against the fp32 / bf16 plain twins, then each
   kernel's device ms, the calls', the plain twins' and the library's
   (SDPA's memory-efficient kernel with cu_seqlens; flex_attention, or the
   reason it refuses, for block-sparse), and its bound. The B7 / B8
   entries carry the head dims, (b)'s launches (`launches_wide_384` /
   `_512`, `launches_wide_blocksparse_512`), (a)'s (`launches_wide_checks`)
   and (b)'s numbers (`wide_384`, `wide_512`, `wide_blocksparse_512`; the
   dropout entries (b)'s documents at D 512 with dropout, `wide_512`).

Every kernel is also timed against PyTorch's own call for the same function
(`library_ms`, where one exists) and its bound on the H100 (`bound_ms`: the
larger of its operations over the tensor-core peak of its inputs' type —
bf16, or int8/fp8 for the quantized decode — and its bytes over the HBM
rate). The last line of stdout is a JSON object {"ok": true, "device":
{...}}; the line before it lists each kernel's (eighteen, and six dropout
entries) launches, error, times and bound; phase 15's launches sit in the
forward, dq, dk/dv, decode and paged decode entries (`launches_moe_train`,
`launches_moe_serve`, `launches_lora`, `launches_wquant`); phase 16's in the
forward, dq and dk/dv entries (`launches_resume`, `launches_eval`) and the
forward and decode entries (`launches_demo`), with its measurements under
the forward entry's `runtime_extras`. Without a CUDA device, or without the package beside this
script, it exits nonzero.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N_REQUESTS = 16
NEW_TOKENS = 32
# Prompt lengths are drawn log-uniformly in this range: serving traffic is
# heavy-tailed, and with seed 0 the 16 prompts land in buckets 128 (the TPU's
# B1 schedule) and 512-2048 (its B9 tri-square schedule).
PROMPT_RANGE = (100, 1800)
# The serve runs of phases 3-4, by name: each Engine's cache options
# (qdtype by torch dtype name).
SERVE_MODES = {"serve": {}, "serve paged bf16": {"paged": True},
               "serve paged int8": {"paged": True, "page_size": 128, "n_pages": 57,
                                    "qdtype": "int8"},
               "serve contiguous fp8": {"qdtype": "float8_e4m3fn"},
               # Phase 13: chunked prefill, then the prefix cache with it.
               "serve chunked": {"prefill_chunk": 512},
               "serve prefix": {"paged": True, "page_size": 128, "prefix_cache": True,
                                "prefill_chunk": 512},
               # Phase 15: Mixtral, the LoRA-merged model and the weight-quantized
               # models (the weights quantized, the cache bf16).
               "serve moe": {"paged": True}, "serve moe fp32": {"paged": True},
               "serve lora": {},
               "serve wquant int8": {"paged": True}, "serve wquant fp8": {"paged": True}}
ATTN_SEQ = (128, 1024, 2048)
DECODE_LENS = (1, 17, 300, 1024, 2048, 3000, 4000, 4096)
FP32_TOL = 1e-4                  # fp32 kernel vs fp32 plain, max abs
LSE_TOL = 1e-4                   # base-2 lse, fp32 math on both sides
# FA tolerance rule (tests/utils.py:19-20): a low-precision kernel may be off
# from the fp32 truth by at most 2x the low-precision plain version's own
# error, + 5e-5.
OUT_ERROR_MUL, OUT_ERROR_BIAS = 2.0, 5e-5
# FA gradient contract (tests/utils.py:21-23): at most 3x the low-precision
# plain version's error + 1e-5, and the dV waiver (summed error < 1e-4).
GRAD_ERROR_MUL, GRAD_ERROR_BIAS, DV_SUM_WAIVER = 3.0, 1e-5, 1e-4
# fp32 kernel vs fp32 plain gradients: sums of ~2000 fp32 products taken in
# another order.
FP32_GRAD_RTOL = 1e-4
# The training path's attention length: loss_fn feeds tokens[:, :-1] of
# --seq 2048 (the TPU's B9 forward / B12 backward route).
TRAIN_SEQ = 2048
BWD_SEQ = TRAIN_SEQ - 1
TRAIN_ARGV = ["--config", "mistral-7b-v0.3", "--steps", "4", "--batch", "2",
              "--seq", str(TRAIN_SEQ), "--remat", "--repeat-batch", "--lr", "3e-4",
              "--grad-clip", "1.0"]
# Packed varlen traffic (packed SFT / pretraining batches): document lengths
# log-uniform in this range from numpy.random.default_rng(0), drawn until the
# next one would push the packed total past VARLEN_T_MAX; starts aligned to
# the user blocks (block_q = block_kv = VARLEN_BLOCK).
VARLEN_DOC_RANGE = (64, 4096)
VARLEN_T_MAX = 16384
VARLEN_BLOCK = 128
# Block-sparse traffic: a local band of BS_BAND blocks below the diagonal plus
# the first column (an attention sink), causal, B x S.
BS_BATCH, BS_SEQ, BS_BAND = 2, 4096, 3
# Published peaks of one NVIDIA H100 SXM (data sheet; dense): each kernel's
# bound is the larger of operations / bf16 tensor-core rate and bytes / HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_8BIT_OPS = 1979e12          # fp8 and int8 tensor-core rate
PEAK_HBM_BYTES_S = 3.35e12
# Paged decode (B6) is checked at these page sizes (128: the smallest the
# kernels take; 512: the Engine's default).
DECODE_PAGES = (128, 512)
# A library yardstick whose bf16 error vs the fp32 truth exceeds this many
# times the bf16 plain twin's (+ bias) computes another function.
LIBRARY_ERROR_MUL, LIBRARY_ERROR_BIAS = 10.0, 1e-3


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(torch, a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def check_lse(torch, lse, lse_ref, what):
    if not torch.equal(torch.isinf(lse), torch.isinf(lse_ref)):
        raise AssertionError(f"{what}: lse -inf pattern differs from the plain version")
    fin = torch.isfinite(lse_ref)
    err = max_abs(torch, lse[fin], lse_ref[fin])
    if not err <= LSE_TOL:
        raise AssertionError(f"{what}: lse max abs err {err:.3e} > {LSE_TOL}")
    return err


def roofline(flops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate of their inputs' type (bf16 by default) and the bytes
    over the HBM rate."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attn_bound(kernel: str, pairs: int, tokens: int, Hq: int, Hkv: int, D: int, elt: int) -> dict:
    """Bound of one attention kernel over `pairs` kept (query, key) pairs
    per q head and `tokens` live rows: 2 D operations per pair, head and
    S x S x D product (forward: q k^T, p v; dq: + do v^T, ds k; dk/dv:
    q k^T, do v^T, p^T do, ds^T q), and each live row of each input read
    once and of each output written once."""
    q_like = tokens * Hq * D * elt     # q, o, do, dq
    kv_like = tokens * Hkv * D * elt   # k, v, dk, dv
    row_vec = tokens * Hq * 4          # fp32 lse, delta
    products, nbytes = {
        "fwd": (2, 2 * q_like + 2 * kv_like + row_vec),
        "dq": (3, 3 * q_like + 2 * kv_like + 2 * row_vec),
        "dkdv": (4, 2 * q_like + 4 * kv_like + 2 * row_vec),
    }[kernel]
    return roofline(2 * D * products * pairs * Hq, nbytes)


def causal_pairs(lens) -> int:
    return sum(n * (n + 1) // 2 for n in lens)


def dbias_bound(B: int, Hq: int, Hkv: int, S: int, D: int, elt: int = 2) -> dict:
    """Bound of the dbias kernel on a causal call with a [1, Hq, S, S] bias:
    q k^T and do v^T over the causal pairs of every batch row; reads q, k,
    v, do, lse, delta and the bias's causal part, writes all of dbias."""
    pairs = B * causal_pairs([S])
    nbytes = (B * S * (2 * Hq + 2 * Hkv) * D * elt + 2 * B * Hq * S * 4
              + Hq * causal_pairs([S]) * elt + Hq * S * S * elt)
    return roofline(2 * D * 2 * pairs * Hq, nbytes)


def check_dbias_ms(ms: float, bound: dict, fma_key: str, what: str) -> float:
    """Print the tensor-core dbias kernel's share of its bound beside its
    FMA design's time, and fail unless it is DBIAS_SPEEDUP times faster
    than the top of that time. Returns the share in percent."""
    share = 100 * bound["bound_ms"] / ms
    print(f"[{what}] dbias_mma_kernel {ms:.3f} ms (profiler; the FMA design: "
          f"{FMA_DESIGN_MS[fma_key]} ms), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
          f"{share:.1f} % of the bound")
    beats_fma_design(fma_key, [ms], by=DBIAS_SPEEDUP)
    return share


def tight(torch, x, lens):
    """[B, S, H, D] right-padded rows -> the live rows back to back
    [sum(lens), H, D], the layout of PyTorch's varlen attention."""
    return torch.cat([x[b, :n] for b, n in enumerate(lens)]).contiguous()


def library_attention(torch, q, k, v, lens_q, lens_k, causal, scale, dropout_p=0.0):
    """PyTorch's own varlen FlashAttention-2 (`aten._flash_attention_forward`
    / `_backward`) on tight-packed bf16 rows: the `library_ms` yardstick of
    the attention kernels, timed beside them and called nowhere in the port.
    With `dropout_p` it draws its own Philox mask (a timing yardstick only).
    Returns (forward call, its outputs, backward call given do)."""
    cu = lambda lens: torch.tensor(np.cumsum([0, *lens]), dtype=torch.int32, device=q.device)
    cq, ck, mq, mk = cu(lens_q), cu(lens_k), max(lens_q), max(lens_k)

    def fwd():
        return torch.ops.aten._flash_attention_forward(q, k, v, cq, ck, mq, mk, dropout_p, causal,
                                                       False, scale=scale)
    out = fwd()

    def bwd(do):
        o, lse, rng, unused, _ = out
        return lambda: torch.ops.aten._flash_attention_backward(
            do, q, k, v, o, lse, cq, ck, mq, mk, dropout_p, causal, rng, unused, scale=scale)
    return fwd, out, bwd


def rounded_p_attention(torch, q, k, v, lens, scale):
    """Causal attention with p rounded to q's dtype before P V and fp32
    everywhere else (`compare_results_fa`'s upcast=False reference): the
    arithmetic of the 16-bit forward, as a second yardstick beside the
    plain twin, which rounds only o. BHSD in, o in q's dtype out."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    B, Hq, Sq, D = q.shape
    g = Hq // k.shape[1]
    s = torch.matmul(q.float(), k.float().repeat_interleave(g, 1).transpose(-1, -2))
    keep = flash_fwd._masks(lens, 0, 0, Sq, k.shape[2], True, (-1, -1), q.device)
    s = torch.where(keep, s * (scale * 1.4426950408889634), float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True).clamp(min=-1e30))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float().repeat_interleave(g, 1))
    return (o / torch.where(l > 0, l, torch.ones_like(l))).to(q.dtype)


def check_library(torch, what, got, ref32, plain_err):
    """The yardstick must compute the kernel's function: its bf16 error
    against the fp32 truth stays near the bf16 plain twin's (a wrong mask
    or length gives errors of order 0.1-1)."""
    err = max_abs(torch, got, ref32)
    if not err <= LIBRARY_ERROR_MUL * plain_err + LIBRARY_ERROR_BIAS:
        raise AssertionError(f"{what}: library err {err:.3e} vs plain {plain_err:.3e}: "
                             f"not the kernel's function")
    return err


def phase_build():
    from fa2_triton_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    print(f"[build] {path.relative_to(HERE)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)")


def phase_kernels(torch):
    """Each kernel vs its plain twin at the slice's shapes. Returns
    {kernel: {"max_abs_err", "ms", "plain_ms"}} at the served dtype (bf16)
    and the largest served shape."""
    from fa2_triton_tpu_torch.ops import flash_fwd, decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    result = {}
    B, Hq, Hkv, D = 2, 32, 8, 128
    scale = D ** -0.5
    bf16_errs = []
    for S in ATTN_SEQ:
        shape_q, shape_kv = (B, S, Hq, D), (B, S, Hkv, D)
        q32 = torch.randn(shape_q, generator=gen, device=dev) * 0.5
        k32 = torch.randn(shape_kv, generator=gen, device=dev) * 0.5
        v32 = torch.randn(shape_kv, generator=gen, device=dev) * 0.5
        # Right-padding like a bucketed prompt: one full row, one ~60%.
        n2 = int(S * 0.6) + 1
        lens = torch.tensor([[S, S], [n2, n2]], dtype=torch.int32, device=dev)
        kw = dict(causal=True, softmax_scale=scale)
        bhsd = lambda x: x.transpose(1, 2)  # the BSHD->BHSD view the API hands over
        o_ref, lse_ref = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens, **kw)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (bhsd(x.to(dt)) for x in (q32, k32, v32))
            o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            err = max_abs(torch, o, o_ref)
            # lse: both sides compute it in fp32 from the same (rounded) inputs.
            o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
            lse_err = check_lse(torch, lse, lse_pl, f"flash_fwd S={S} {dt}")
            if dt == torch.float32:
                bound, rule = FP32_TOL, f"<= {FP32_TOL}"
            else:
                pl_err = max_abs(torch, o_pl, o_ref)
                bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
                rp_err = max_abs(torch, rounded_p_attention(torch, q, k, v, lens, scale), o_ref)
                rule = (f"<= 2 x plain bf16 err {pl_err:.3e} + 5e-5; {err / pl_err:.2f} x plain, "
                        f"{err / rp_err:.2f} x the bf16-p reference's {rp_err:.3e}")
                bf16_errs.append(err)
            ms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw))
            pms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw))
            if dt == torch.bfloat16:
                seq = [S, n2]
                lib_fwd, lib_out, _ = library_attention(
                    torch, *(tight(torch, x.to(dt), seq) for x in (q32, k32, v32)), seq, seq, True,
                    scale)
                lib_err = check_library(torch, f"flash_fwd S={S}", lib_out[0],
                                        tight(torch, bhsd(o_ref), seq), pl_err)
                fwd_extra = {"library_ms": cuda_ms(torch, lib_fwd),
                             **attn_bound("fwd", causal_pairs(seq), sum(seq), Hq, Hkv, D, 2)}
                print(f"[kernels] flash_fwd S={S} bf16: library (aten varlen flash) "
                      f"{fwd_extra['library_ms']:.3f} ms, err {lib_err:.3e}; bound "
                      f"{fwd_extra['bound_ms']:.3f} ms ({fwd_extra['bound_by']})")
            print(f"[kernels] flash_fwd B={B} Hq={Hq} Hkv={Hkv} D={D} S={S} {str(dt)[6:]}: "
                  f"max abs err {err:.3e} ({rule}), lse err {lse_err:.3e}; "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
            if not err <= bound:
                raise AssertionError(f"flash_fwd S={S} {dt}: err {err:.3e} > {bound:.3e}")
        result["flash_fwd"] = {"max_abs_err": max(bf16_errs), "ms": ms, "plain_ms": pms, **fwd_extra}
        del q32, k32, v32, o_ref, lse_ref, q, k, v, o, lse, o_pl, lse_pl

    slots, S_max = 8, 4096
    q32 = torch.randn((slots, Hq, D), generator=gen, device=dev) * 0.5
    k32 = torch.randn((slots, Hkv, S_max, D), generator=gen, device=dev) * 0.5
    v32 = torch.randn((slots, Hkv, S_max, D), generator=gen, device=dev) * 0.5
    kv_lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    o_ref = decode.decode_attention_plain(q32, k32, v32, kv_lens, softmax_scale=scale)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        o = decode.decode_attention(q, k, v, kv_lens, softmax_scale=scale)
        torch.cuda.synchronize()
        err = max_abs(torch, o, o_ref)
        if dt == torch.float32:
            bound, rule = FP32_TOL, f"<= {FP32_TOL}"
        else:
            pl_err = max_abs(torch, decode.decode_attention_plain(q, k, v, kv_lens, softmax_scale=scale), o_ref)
            bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
            rule = f"<= 2 x plain bf16 err {pl_err:.3e} + 5e-5"
        run = lambda: decode.decode_attention(q, k, v, kv_lens, softmax_scale=scale)
        ms, call_ms = decode_kernel_ms(torch, run), cuda_ms(torch, run)
        pms = cuda_ms(torch, lambda: decode.decode_attention_plain(q, k, v, kv_lens, softmax_scale=scale))
        live = sum(DECODE_LENS) * Hkv * D * 2 * q.element_size()   # K and V bytes read
        grid = split_kv_counts(decode, S_max, Hkv)
        print(f"[kernels] decode slots={slots} Hq={Hq} Hkv={Hkv} D={D} S_max={S_max} "
              f"kv_lens={list(DECODE_LENS)} {str(dt)[6:]}: max abs err {err:.3e} ({rule}); "
              f"kernel {ms:.4f} ms ({live / (ms * 1e-3) / 1e9:.0f} GB/s of live K/V; the call "
              f"{call_ms:.4f} ms), split-KV grid {grid['n_chunks']} chunks of {grid['chunk']} "
              f"rows x {Hkv} KV heads x {slots} slots = {grid['grid_blocks']} blocks, "
              f"{grid['working_blocks']} working, plain {pms:.3f} ms")
        if not err <= bound:
            raise AssertionError(f"decode {dt}: err {err:.3e} > {bound:.3e}")
    # The library yardstick: each slot as a varlen sequence of one query.
    lib_fwd, lib_out, _ = library_attention(
        torch, q, *(tight(torch, x.transpose(1, 2), DECODE_LENS) for x in (k, v)),
        [1] * slots, list(DECODE_LENS), False, scale)
    lib_err = check_library(torch, "decode", lib_out[0], o_ref, pl_err)
    nbytes = 2 * slots * Hq * D * q.element_size() + live
    extra = {"library_ms": library_mean_ms(torch, lib_fwd),
             "library_call_ms": cuda_ms(torch, lib_fwd),
             **roofline(4 * D * Hq * sum(DECODE_LENS), nbytes)}
    print(f"[kernels] decode bf16: library (aten varlen flash, one query per slot) "
          f"{extra['library_ms']:.4f} ms of device time (the call {extra['library_call_ms']:.4f} "
          f"ms), err {lib_err:.3e}; bound {extra['bound_ms']:.4f} ms ({extra['bound_by']})")
    result["decode"] = {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": pms, **extra,
                        **grid}
    result.update(decode_variants(torch, q32, k32, v32, kv_lens, scale))
    return result


def decode_kernel_ms(torch, fn) -> float:
    """Device time of one decode launch (torch.profiler): at some 0.03 ms
    the whole call's CUDA-event time is the host's, not the kernel's."""
    return kernel_ms(torch, fn, ["decode_kernel"], iters=10)["decode_kernel"]


def library_mean_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call of a library yardstick whose kernels are not
    known by name (aten may split a call of few rows over the keys: a
    split-KV kernel and a combine), tolerant of the profiler dropping
    launches late in this long process (`profiled`): each kernel's mean
    per launch recorded, times its launches per call (its count over the
    calls, rounded, at least 1), summed. Where five windows record no
    kernel at all, the call's CUDA-event time (`cuda_ms`) instead."""
    from torch.autograd import DeviceType

    def hits(events):
        return [(e.key, e.count, _device_us(e)) for e in events
                if e.device_type == DeviceType.CUDA and e.count and _device_us(e) > 0]

    windows = 5
    found = hits(profiled(torch, fn, iters, lambda ev: bool(hits(ev)), attempts=windows))
    if not found:
        # Every window dropped every launch (PERF.md §7): the yardstick is
        # then the whole call's CUDA-event time, host included, and says so.
        ms = cuda_ms(torch, fn, iters=iters)
        print(f"[profiler] library: no kernel recorded in {windows} windows of {iters} calls; "
              f"the call's CUDA-event time {ms:.4f} ms stands in")
        return ms
    ms = sum(us / n * max(1, round(n / iters)) for _, n, us in found) / 1e3
    print(f"[profiler] library: {ms:.4f} ms of device time per call, kernels (name, launches "
          f"recorded in {iters} calls): {[(k[:80], n) for k, n, _ in found]}")
    return ms


def split_kv_counts(decode, cap: int, Hkv: int) -> dict:
    """The decode grid at phase 2's lengths: chunks per (slot, KV head)
    from the cap alone, and the blocks whose chunk holds a live row."""
    live = sum(decode.live_chunks(n, cap) for n in DECODE_LENS)
    return {"chunk": decode.CHUNK, "n_chunks": decode.chunk_count(cap),
            "grid_blocks": decode.chunk_count(cap) * Hkv * len(DECODE_LENS),
            "working_blocks": live * Hkv}


def page_pool(torch, caches, lens, page, seed, fill):
    """Contiguous caches [B, Hkv, S, D] and scales [B, Hkv, 1, S] (or None)
    -> a page pool in `runtime/paged_cache.py`'s layout and its tables: each
    slot's live pages at shuffled physical pages, everything else (page 0,
    the rows past each length) filled with `fill`, and table entries past a
    slot's last live page at the reserved page 0."""
    k = caches[0]
    B, Hkv, S, D = k.shape
    M = S // page
    perm = torch.randperm(B * M, generator=torch.Generator().manual_seed(seed)) + 1
    tables = torch.zeros(B, M, dtype=torch.int32)
    empty = lambda shape, dtype: torch.full(shape, fill, device=k.device).to(dtype)
    pools = [None if x is None else
             empty((B * M + 1, Hkv, 1, page) if x.shape[2] == 1 else (B * M + 1, Hkv, page, D), x.dtype)
             for x in caches]
    for b, n in enumerate(lens):
        for i in range(-(-n // page)):
            p, r0, r1 = int(perm[b * M + i]), i * page, min((i + 1) * page, n)
            tables[b, i] = p
            for pool, x in zip(pools, caches):
                if x is not None and x.shape[2] == 1:
                    pool[p, :, :, :r1 - r0] = x[b, :, :, r0:r1]
                elif x is not None:
                    pool[p, :, :r1 - r0] = x[b, :, r0:r1]
    return pools, tables.to(k.device)


def decode_variants(torch, q32, k32, v32, kv_lens, scale):
    """B5 quant and B6 at phase 2's decode shape: the same K/V quantized to
    int8 and fp8 with `quantize_tensor`, each held against its plain twin at
    matched bit-width (the plain twin dequantizes the same stored values, so
    the bf16 rule applies), then in shuffled page pools at page 128 and 512
    (bf16, int8, fp8), where paged must equal contiguous bit for bit and NaN
    in every unused page and row must not change it. Each call launches its
    variant once. Returns the kernels-line entries `decode_quant` and
    `paged_decode`, with every variant's numbers."""
    from fa2_triton_tpu_torch.ops import decode
    from fa2_triton_tpu_torch.ops.quant import quantize_tensor

    lens = [int(n) for n in kv_lens.tolist()]
    slots, Hq, D = q32.shape
    Hkv, S = k32.shape[1], k32.shape[2]
    q = q32.to(torch.bfloat16)
    kw = dict(softmax_scale=scale)
    stored = {"bf16": (k32.to(torch.bfloat16), v32.to(torch.bfloat16), None, None)}
    for name, qd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        (kq, ks), (vq, vs) = (quantize_tensor(x, qd) for x in (k32, v32))
        stored[name] = (kq, vq, ks.transpose(-1, -2).contiguous(), vs.transpose(-1, -2).contiguous())
    # Library yardstick of the bf16 rows: the logical rows gathered back to
    # back outside the timed region, one query per slot (as for B5).
    lib_fwd, _, _ = library_attention(
        torch, q, *(tight(torch, x.transpose(1, 2), lens) for x in stored["bf16"][:2]),
        [1] * slots, lens, False, scale)
    lib_ms, lib_call_ms = library_mean_ms(torch, lib_fwd), cuda_ms(torch, lib_fwd)
    flops = 4 * D * Hq * sum(lens)
    qo_bytes = 2 * slots * Hq * D * q.element_size()
    no_lib = ("none: no PyTorch call reads an int8/fp8 cache with per-token scales or a paged pool")
    variants = {}

    def launch_once(run, want):
        decode.reset_launches()
        out = run()
        torch.cuda.synchronize()
        if decode.VARIANT_LAUNCHES != {want: 1}:
            raise AssertionError(f"{want}: launches {decode.VARIANT_LAUNCHES}, not one of it")
        return out

    for name, caches in stored.items():
        quant = caches[2] is not None
        elt = caches[0].element_size()
        kv_bytes = sum(lens) * Hkv * (2 * D * elt + (8 if quant else 0))
        truth = caches if quant else (k32, v32, None, None)
        ref32 = decode.decode_attention_plain(q32, truth[0], truth[1], kv_lens, *truth[2:], **kw)
        plain = lambda: decode.decode_attention_plain(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
        pl_err = max_abs(torch, plain(), ref32)
        bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
        run = lambda: decode.decode_attention(q, caches[0], caches[1], kv_lens, *caches[2:], **kw)
        o = launch_once(run, decode.variant(False, caches[0].dtype))
        err = max_abs(torch, o, ref32)
        if not err <= bound:
            raise AssertionError(f"decode {name}: err {err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
        peak = PEAK_8BIT_OPS if quant else PEAK_BF16_FLOPS
        if quant:
            variants[f"contiguous {name}"] = {
                "max_abs_err": err, "ms": decode_kernel_ms(torch, run),
                "call_ms": cuda_ms(torch, run),
                "plain_ms": cuda_ms(torch, plain), "library_ms": None, "library_call_ms": None,
                **roofline(flops, kv_bytes + qo_bytes, peak), **split_kv_counts(decode, S, Hkv)}
        for page in DECODE_PAGES:
            pools, tables = page_pool(torch, caches, lens, page, seed=page, fill=0.0)
            prun = lambda: decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens,
                                                         *pools[2:], **kw)
            pplain = lambda: decode.paged_decode_attention_plain(q, pools[0], pools[1], tables,
                                                                 kv_lens, *pools[2:], **kw)
            op = launch_once(prun, decode.variant(True, caches[0].dtype))
            if not torch.equal(op, o):
                raise AssertionError(f"paged decode {name} page {page} differs from contiguous "
                                     f"(max abs {max_abs(torch, op, o):.3e})")
            nan_pools, nan_tables = page_pool(torch, caches, lens, page, seed=page, fill=float("nan"))
            op_nan = decode.paged_decode_attention(q, nan_pools[0], nan_pools[1], nan_tables, kv_lens,
                                                   *nan_pools[2:], **kw)
            if not (torch.equal(nan_tables, tables) and torch.equal(op_nan, op)):
                raise AssertionError(f"paged decode {name} page {page}: NaN in unused pages or rows "
                                     f"changed the output")
            del nan_pools, op_nan
            table_bytes = 4 * sum(-(-n // page) for n in lens)
            variants[f"paged {name} page {page}"] = {
                "max_abs_err": err, "ms": decode_kernel_ms(torch, prun),
                "call_ms": cuda_ms(torch, prun), "plain_ms": cuda_ms(torch, pplain),
                "library_ms": None if quant else lib_ms,
                "library_call_ms": None if quant else lib_call_ms,
                **roofline(flops, kv_bytes + qo_bytes + table_bytes, peak),
                **split_kv_counts(decode, tables.shape[1] * page, Hkv)}
            del pools
        print(f"[kernels] decode {name} cache (contiguous and paged at {DECODE_PAGES}): max abs err "
              f"{err:.3e} (<= 2 x plain {pl_err:.3e} + 5e-5); paged == contiguous bit for bit; "
              f"NaN in unused pages and rows: output unchanged")
    for v, e in variants.items():
        share = 100 * e["bound_ms"] / e["ms"]
        print(f"[kernels] {v}: kernel {e['ms']:.4f} ms ({share:.1f} % of its "
              f"bound {e['bound_ms']:.4f} ms, {e['bound_by']}; the call {e['call_ms']:.4f} ms), "
              f"{e['n_chunks']} chunks of {e['chunk']} rows, {e['working_blocks']} working blocks "
              f"of {e['grid_blocks']}, plain {e['plain_ms']:.3f} ms, library "
              + (f"{e['library_ms']:.4f} ms of device time, the call {e['library_call_ms']:.4f} "
                 "ms (aten varlen flash on the gathered rows)"
                 if e["library_ms"] is not None else no_lib))
    worst = lambda keys: max(variants[k]["max_abs_err"] for k in keys)
    return {
        "decode_quant": {**variants["contiguous fp8"],
                         "max_abs_err": worst(["contiguous int8", "contiguous fp8"]),
                         "library_reason": no_lib, "variants": variants_of(variants, "contiguous")},
        "paged_decode": {**variants["paged bf16 page 512"],
                         "max_abs_err": worst([k for k in variants if k.startswith("paged")]),
                         "library_reason": no_lib + " (the bf16 rows: aten varlen flash)",
                         "variants": variants_of(variants, "paged")},
    }


def variants_of(variants, prefix):
    return {k: {n: e[n] for n in ("max_abs_err", "ms", "call_ms", "plain_ms", "library_ms",
                                  "library_call_ms", "bound_ms", "n_chunks", "working_blocks")}
            for k, e in variants.items() if k.startswith(prefix)}


def served_prompts(cfg):
    """Phase 3's traffic: N_REQUESTS prompts of log-uniform length in
    PROMPT_RANGE, random tokens, from numpy.random.RandomState(0)."""
    rng = np.random.RandomState(0)
    lens = np.exp(rng.uniform(*np.log(PROMPT_RANGE), size=N_REQUESTS)).astype(int)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def serve(torch, model, cfg, prompts, card: str, what: str, samplings=None, waves=None):
    """Serve `prompts` (NEW_TOKENS each; `samplings`: a SamplingParams or
    None per prompt) through a fresh Engine with the cache options of
    SERVE_MODES[what], the launch counts reset just before, and check that
    every prefill dispatch and decode step went through the kernels on
    every layer, with the one decode variant the cache calls for. `waves`
    (a count of prompts per wave) serves the prompts in turn on the same
    engine, each wave to completion. Returns the requests, the stats, the
    launches, the seconds of each decode step (host clock to the device's
    end) and `info`: per decode step whether it sampled and whether a slot
    was mid-prefill, the seconds of each chunk or suffix dispatch, the
    prefix-cached tokens of each wave, and the inputs and tokens of the
    first sampled decode step (on the CPU)."""
    from fa2_triton_tpu_torch.ops import decode, flash_fwd
    from fa2_triton_tpu_torch.runtime import Engine

    torch.cuda.reset_peak_memory_stats()
    engine_kw = {k: getattr(torch, v) if k == "qdtype" else v for k, v in SERVE_MODES[what].items()}
    engine = Engine(model, cfg, n_slots=8, max_seq=4096, **engine_kw)
    store = engine.pcache.pools if engine.paged else engine.caches
    kv_bytes = sum(t.numel() * t.element_size() for layer in store for t in layer.values())
    want = decode.variant(engine.paged, store[0]["k"].dtype)
    free0 = engine.pcache.free_pages if engine.paged else None
    samplings = samplings or [None] * len(prompts)
    info = {"sampled": [], "mixed": [], "chunk_s": [], "cached": [], "draw": None}
    # Host clock around each decode step and chunk dispatch, to the
    # device's end: the step reads its tokens back right after anyway.
    step_s, decode_step, chunk, select = [], engine._decode, engine._chunk, engine._select

    def timed_decode(active):
        info["mixed"].append(bool(engine._prefilling))
        info["sampled"].append(not all(engine.temp_np[s] <= 0.0 for s in active))
        t0 = time.perf_counter()
        out = decode_step(active)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    def timed_chunk(*args):
        t0 = time.perf_counter()
        out = chunk(*args)   # reads its token back
        info["chunk_s"].append(time.perf_counter() - t0)
        return out

    def kept_select(logits, samp, greedy):
        out = select(logits, samp, greedy)
        if not greedy and info["draw"] is None and logits.shape[0] == len(engine.slot_req):
            live = [s for s, r in enumerate(engine.slot_req)
                    if r is not None and s not in engine._prefilling]
            info["draw"] = {"logits": logits.float().cpu(), "samp": [np.array(a) for a in samp],
                            "tokens": out[0].cpu(), "live": live}
        return out
    engine._decode, engine._chunk, engine._select = timed_decode, timed_chunk, kept_select
    flash_fwd.LAUNCHES = 0
    decode.reset_launches()
    reqs, wall, done = [], 0.0, 0
    for n in waves or [len(prompts)]:
        before = engine.stats.prefix_cached_tokens
        reqs += [engine.submit(p, NEW_TOKENS, sampling=sp)
                 for p, sp in zip(prompts[done:done + n], samplings[done:done + n])]
        done += n
        stats = engine.run()
        wall += stats.wall_s
        info["cached"].append(stats.prefix_cached_tokens - before)
    stats.wall_s = wall
    launches = {"flash_fwd": flash_fwd.LAUNCHES, "decode": decode.LAUNCHES,
                "decode_variants": dict(decode.VARIANT_LAUNCHES)}
    lens = [len(p) for p in prompts]
    print(f"[{what}] {len(reqs)} requests, prompts {min(lens)}-{max(lens)} tokens: "
          f"prefill tokens {stats.prefill_tokens}, prefill dispatches {stats.prefill_dispatches}, "
          f"decode tokens {stats.decode_tokens}, decode steps {stats.decode_steps}, "
          f"wall {stats.wall_s:.3f} s, decode {stats.decode_tokens_per_s:.1f} tokens/s, "
          f"{1e3 * sum(step_s) / len(step_s):.2f} ms per decode step; KV cache "
          f"{kv_bytes / 1e9:.3f} GB, peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"[{card}]")
    print(f"[{what}] launches: {launches}")
    if not all(r.done and len(r.out_tokens) == NEW_TOKENS for r in reqs):
        raise AssertionError(f"{what}: not every request finished with its tokens")
    if launches["flash_fwd"] != cfg.n_layers * stats.prefill_dispatches or stats.prefill_dispatches == 0:
        raise AssertionError(f"{what}: flash_fwd launches {launches['flash_fwd']} != "
                             f"{cfg.n_layers} x {stats.prefill_dispatches} prefill dispatches")
    if launches["decode_variants"] != {want: cfg.n_layers * stats.decode_steps} or stats.decode_steps == 0:
        raise AssertionError(f"{what}: decode launches {launches['decode_variants']} != "
                             f"{{{want!r}: {cfg.n_layers} x {stats.decode_steps} decode steps}}")
    if engine.paged and (engine.pcache.free_pages != free0 or engine.pcache._refs.any()):
        raise AssertionError(f"{what}: {engine.pcache.free_pages} pages free after the run, "
                             f"{free0} before")
    lps = np.array([r.out_logprobs for r in reqs])
    if not np.isfinite(lps).all():
        raise AssertionError(f"{what}: non-finite served log-probs")
    return reqs, stats, launches, step_s, info


def phase_serve(torch, card: str):
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params

    # Published widths of Mistral-7B-v0.3 (the trainer's preset names its
    # source), full depth: 7.25 B parameters, 14.5 GB in bf16.
    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16)
    t0 = time.perf_counter()
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] Mistral-7B-v0.3 widths, {n_params / 1e9:.2f} B params bf16, random "
          f"(seed 0), init {time.perf_counter() - t0:.1f} s")
    prompts = served_prompts(cfg)
    reqs, _, launches = serve(torch, model, cfg, prompts, card, "serve")[:3]
    return model, cfg, reqs, prompts, launches


def fp32_logprobs(torch, model, cfg, prompt, out_tokens):
    """Log-probs of `out_tokens` after `prompt` from the port's plain
    forward in fp32: the plain attention oracle, weights upcast one layer at
    a time (the whole model in fp32 would need 29 GB more)."""
    from fa2_triton_tpu_torch.models import llama as L
    from fa2_triton_tpu_torch.ops import flash_attn_reference

    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    toks = torch.tensor([prompt + out_tokens[:-1]], device="cuda")
    x = model.embed[toks].float()
    positions = torch.arange(toks.shape[1], device="cuda")[None]
    cos, sin = L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta, cfg.rope_factors)

    def attn(q, k, v):
        return flash_attn_reference(q, k, v, causal=True, softmax_scale=cfg.scale)

    for layer in model.layers:
        l32 = L.LlamaLayer(c32, device="cuda")
        l32.load_state_dict(layer.state_dict())
        x = L.attention_block(l32, x, c32, cos, sin, attn)
        x = L._mlp_block(l32, x, c32)
        del l32
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = x[0, len(prompt) - 1:] @ model.lm_head.float()
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, torch.tensor(out_tokens, device="cuda")[:, None])[:, 0].cpu().numpy()


# Served (bf16 weights, activations and KV cache; kernels) vs the fp32
# plain forward. bf16 keeps 8 mantissa bits: each of the 32 layers rounds
# the residual stream and every matmul input, and the served path rounds the
# cached k/v too. The bounds are ~2x the bf16 plain forward's own error
# against the same fp32 forward, measured on an NVIDIA H100 80GB HBM3 at
# 700 W (mean 0.011-0.017, max 0.024-0.068 over the five shortest requests):
# the FA rule applied to
# log-probs. A decode kv_len off by one fails them: one key short (kv_len =
# lens) gives mean errors of 0.05-0.06, one stale row too many gives max
# errors of 0.15-0.19 on these requests.
LOGPROB_MEAN_TOL = 0.03
LOGPROB_MAX_TOL = 0.1
# Paged vs contiguous serving: the same kernels on the same rows, so the
# same log-probs; anything above fp32 rounding of the log-softmax is a fault.
PAGED_LOGPROB_TOL = 1e-5


# The quantized runs (int8 / fp8 KV cache, everything else as above) vs the
# same fp32 forward: the served error adds the cache's quantization error.
# The bounds are ~2x the largest errors measured over two chip runs on an
# NVIDIA H100 80GB HBM3 at 700 W (requests 14 and 15, the same in both
# runs): int8 mean 0.0161-0.0163, max 0.0451-0.0485 (per-token steps of
# amax / 127 cost about what bf16's rounding does); fp8 e4m3 (3 mantissa
# bits) mean 0.0310-0.0338, max 0.0844-0.0883. A kernel that drops the v
# scale gives an int8 mean error of 1.02.
QUANT_LOGPROB_TOL = {"int8": (0.035, 0.1), "fp8": (0.07, 0.18)}   # (mean, max)


def check_logprobs(torch, model, cfg, reqs, prompts, what, mean_tol, max_tol):
    """The served log-probs of the two shortest requests that were not
    preempted (a wrong decode kv_len changes one key of the fewest, so these
    show it most) against the fp32 plain forward."""
    fresh = [j for j in range(len(prompts)) if reqs[j].folded == 0]
    errs = []
    for i in sorted(fresh, key=lambda j: len(prompts[j]))[:2]:
        ref = fp32_logprobs(torch, model, cfg, prompts[i], reqs[i].out_tokens)
        err = np.abs(np.array(reqs[i].out_logprobs) - ref)
        errs.append(err)
        print(f"[{what}] request {i} (prompt {len(prompts[i])}, {len(err)} tokens): served vs fp32 "
              f"plain forward log-probs: mean abs err {err.mean():.4f} (tol {mean_tol}), "
              f"max {err.max():.4f} (tol {max_tol})")
        if not (np.isfinite(ref).all() and err.mean() <= mean_tol and err.max() <= max_tol):
            raise AssertionError(f"{what}: request {i}'s served log-probs disagree with the fp32 "
                                 f"forward")
    return errs


def phase_check(torch, model, cfg, reqs, prompts):
    check_logprobs(torch, model, cfg, reqs, prompts, "check", LOGPROB_MEAN_TOL, LOGPROB_MAX_TOL)


def phase_serve_modes(torch, card, model, cfg, reqs, prompts):
    """Phase 3's requests served again: (1) paged bf16, default pool and
    page 512: tokens and log-probs equal to phase 3's; (2) paged int8, 57
    pages of 128 (the first wave reserves 56), so the pool runs dry
    mid-generation and a request must be preempted; (3) contiguous fp8.
    Returns the decode launches of each run by variant."""
    base = serve(torch, model, cfg, prompts, card, "serve paged bf16")
    for r, b in zip(base[0], reqs):
        if r.out_tokens != b.out_tokens:
            raise AssertionError(f"paged bf16: request {r.rid} tokens differ from contiguous")
    delta = max(np.abs(np.array(r.out_logprobs) - np.array(b.out_logprobs)).max()
                for r, b in zip(base[0], reqs))
    print(f"[serve paged bf16] greedy tokens equal to contiguous serving, request by request; "
          f"log-probs max |delta| {delta:.3e} (tol {PAGED_LOGPROB_TOL})")
    if not delta <= PAGED_LOGPROB_TOL:
        raise AssertionError(f"paged bf16: log-probs differ from contiguous by {delta:.3e}")
    runs = {"paged bf16": base[2]["decode_variants"]}
    for what in ("serve paged int8", "serve contiguous fp8"):
        name = what.split()[-1]
        q_reqs, _, launches = serve(torch, model, cfg, prompts, card, what)[:3]
        folded = {r.rid: r.folded for r in q_reqs if r.folded}
        print(f"[{what}] preempted requests (rid: tokens folded into the prompt): {folded}")
        if SERVE_MODES[what].get("paged") and not folded:
            raise AssertionError(f"{what}: the 57-page pool never ran dry; nothing was preempted")
        check_logprobs(torch, model, cfg, q_reqs, prompts, what, *QUANT_LOGPROB_TOL[name])
        runs[what[6:]] = launches["decode_variants"]
    return runs


# Phase 13's traffic: a chat system prompt shared across users, PREFIX_LEN
# tokens from numpy.random.RandomState(1), then per request a tail of
# log-uniform length in TAIL_RANGE from the same generator; wave A, then
# wave B on the same engine, WAVE requests each. Requests 0-3 of a wave are
# greedy, 4-7 sampled (SAMPLED, seed = the request's index in the phase).
PREFIX_LEN = 1024
TAIL_RANGE = (64, 1024)
WAVE = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# The chunk kernel call of phase 13 (c): one layer's chunk of CHUNK queries
# at q_off CHUNK_Q_OFF over CHUNK_Q_OFF + CHUNK cached rows.
CHUNK, CHUNK_Q_OFF = 512, 1024
ATEN_FWD = "pytorch_flash::flash_fwd_kernel"   # aten flash's forward kernel, by name
DRAW_MARGIN = 1e-4


def prefix_prompts(cfg):
    rng = np.random.RandomState(1)
    head = rng.randint(0, cfg.vocab_size, size=PREFIX_LEN).tolist()
    lens = np.exp(rng.uniform(*np.log(TAIL_RANGE), size=2 * WAVE)).astype(int)
    return [head + rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


def step_ms(step_s, flags, want):
    """(mean ms, count) of the decode steps whose flag is `want`; (None, 0)
    when there is none (the kernels line stays strict JSON)."""
    picked = [t for t, f in zip(step_s, flags) if f == want]
    return (1e3 * float(np.mean(picked)), len(picked)) if picked else (None, 0)


def check_draws(torch, draw, what):
    """The first sampled decode step's logits rows, copied to the CPU: the
    port's sampler there must draw the card's tokens. The random bits are
    equal bit for bit; a token is held to the card's wherever the top-two
    gap of (adjusted logits + Gumbel noise) exceeds DRAW_MARGIN (log and exp
    may differ in the last bit between the two devices)."""
    from fa2_triton_tpu_torch.runtime import sampling

    temps, top_ks, top_ps, seeds, steps = draw["samp"]
    rows = [s for s in draw["live"] if temps[s] > 0]
    if not rows:
        raise AssertionError(f"{what}: the first sampled step has no live sampled row")
    V = draw["logits"].shape[-1]
    seeds_t, steps_t = torch.from_numpy(seeds[rows]), torch.from_numpy(steps[rows])
    bits_card = sampling.random_bits(seeds_t.cuda(), steps_t.cuda(), V).cpu()
    bits_cpu = sampling.random_bits(seeds_t, steps_t, V)
    if not torch.equal(bits_card, bits_cpu):
        raise AssertionError(f"{what}: the card's random bits differ from the CPU's")
    logits = draw["logits"][rows]
    samp = [a[rows] for a in draw["samp"]]
    cpu = sampling.sample_tokens(logits, *samp)
    noisy = sampling.adjust_logits(logits, *samp[:3]) + sampling._gumbel(seeds_t, steps_t, V)
    top2 = noisy.topk(2, dim=-1).values
    gap = torch.where(torch.isinf(top2[:, 1]), torch.full_like(top2[:, 0], float("inf")),
                      top2[:, 0] - top2[:, 1])
    card = draw["tokens"][rows]
    held = gap > DRAW_MARGIN
    print(f"[{what}] first sampled decode step: {len(rows)} live sampled rows, random bits equal "
          f"to the CPU's bit for bit ({len(rows)} x {V}); CPU draws {cpu.tolist()}, card "
          f"{card.tolist()}; top-two gaps {[f'{g:.3g}' for g in gap.tolist()]}, "
          f"{int(held.sum())} above {DRAW_MARGIN} held equal")
    if not torch.equal(cpu[held], card[held]):
        raise AssertionError(f"{what}: the card's sampled tokens differ from the CPU sampler's")
    # The token choice alone on the step's rows (all 8): the sampler against
    # the greedy path a step takes when no live slot samples.
    x = draw["logits"].cuda()
    ms = {"sampler_ms": cuda_ms(torch, lambda: sampling.sample_tokens_with_logprobs(
              x, *draw["samp"])),
          "greedy_ms": cuda_ms(torch, lambda: sampling.greedy_tokens_with_logprobs(x))}
    print(f"[{what}] token choice on [{x.shape[0]}, {V}] logits: sampler {ms['sampler_ms']:.3f} "
          f"ms, greedy {ms['greedy_ms']:.3f} ms (CUDA events, host launches included)")
    return {"rows": len(rows), "held": int(held.sum()), "bits_equal": True, **ms}


def chunk_kernel(torch):
    """Phase 13 (c): B1 (`flash_fwd_mma_kernel`) on one layer's chunk call,
    CHUNK queries at q_off CHUNK_Q_OFF over CHUNK_Q_OFF + CHUNK cached rows
    (lens (total, total), causal), 32 / 8 heads, D 128, against its plain
    twin: fp32 within FP32_TOL, bf16 under the FA rule; the kernel's and
    the library's (aten flash, causal: bottom-right aligned like the chunk)
    device time by the profiler, at this size under their calls' host
    time (CUDA events, beside them), the plain twin's ms and the bound."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    Hq, Hkv, D, Sk = 32, 8, 128, CHUNK_Q_OFF + CHUNK
    scale = D ** -0.5
    q32 = torch.randn((1, CHUNK, Hq, D), generator=gen, device=dev) * 0.5
    k32 = torch.randn((1, Sk, Hkv, D), generator=gen, device=dev) * 0.5
    v32 = torch.randn((1, Sk, Hkv, D), generator=gen, device=dev) * 0.5
    lens = torch.tensor([[Sk, Sk]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=scale)
    call = dict(kw, static_skip=False, varlen=True)
    bhsd = lambda x: x.transpose(1, 2)
    o_ref, _ = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens,
                                                  CHUNK_Q_OFF, **kw)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (bhsd(x.to(dt)) for x in (q32, k32, v32))
        n0 = flash_fwd.LAUNCHES
        o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, CHUNK_Q_OFF, **call)
        torch.cuda.synchronize()
        if flash_fwd.LAUNCHES != n0 + 1:
            raise AssertionError("chunk call: not one launch of flash_fwd.cu")
        o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(q, k, v, lens, CHUNK_Q_OFF, **kw)
        lse_err = check_lse(torch, lse, lse_pl, f"chunk {dt}")
        err = max_abs(torch, o, o_ref)
        if dt == torch.float32:
            bound, rule = FP32_TOL, f"<= {FP32_TOL}"
        else:
            pl_err = max_abs(torch, o_pl, o_ref)
            bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
            rule = f"<= 2 x plain bf16 err {pl_err:.3e} + 5e-5"
        print(f"[chunk] flash_fwd C {CHUNK} at q_off {CHUNK_Q_OFF} over {Sk} rows, Hq {Hq} Hkv "
              f"{Hkv} D {D} {str(dt)[6:]}: max abs err {err:.3e} ({rule}), lse err {lse_err:.3e}")
        if not err <= bound:
            raise AssertionError(f"chunk {dt}: err {err:.3e} > {bound:.3e}")
    run = lambda: flash_fwd.flash_attn_forward(q, k, v, lens, CHUNK_Q_OFF, **call)  # noqa: E731
    ms = kernel_ms(torch, run, ["flash_fwd_mma_kernel"], iters=10)["flash_fwd_mma_kernel"]
    call_ms = cuda_ms(torch, run)
    pms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, CHUNK_Q_OFF,
                                                                   **kw))
    lib_fwd, lib_out, _ = library_attention(torch, q32[0].to(q.dtype), k32[0].to(q.dtype),
                                            v32[0].to(q.dtype), [CHUNK], [Sk], True, scale)
    lib_err = check_library(torch, "chunk", lib_out[0], bhsd(o_ref)[0], pl_err)
    pairs = CHUNK * CHUNK_Q_OFF + CHUNK * (CHUNK + 1) // 2
    nbytes = 2 * CHUNK * Hq * D * 2 + 2 * Sk * Hkv * D * 2 + CHUNK * Hq * 4
    out = {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": pms,
           # aten's call is one launch of its flash forward kernel here; the
           # profiler averages over the launches it records (it may miss one).
           "library_ms": kernel_ms(torch, lib_fwd, [ATEN_FWD], iters=10)[ATEN_FWD],
           "library_call_ms": cuda_ms(torch, lib_fwd),
           **roofline(2 * D * 2 * pairs * Hq, nbytes)}
    print(f"[chunk] bf16: kernel {ms:.4f} ms of device time (the call {call_ms:.4f} ms), plain "
          f"{pms:.3f} ms, library (aten flash, causal) {out['library_ms']:.4f} ms of device time "
          f"(the call {out['library_call_ms']:.4f} ms; err {lib_err:.3e}), bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}): {100 * out['bound_ms'] / ms:.1f} % of "
          f"the bound")
    return out


def phase_chunked(torch, card, model, cfg, prompts):
    """Phase 13: (a) phase 3's requests with prefill_chunk 512, contiguous;
    (b) the shared-prefix waves, paged at page 128 with the prefix cache and
    chunks of 512, greedy and sampled requests; (c) the chunk kernel call.
    Returns the launches of (a) and (b) and (c)'s numbers."""
    reqs, stats, launches, step_s, info = serve(torch, model, cfg, prompts, card, "serve chunked")
    mixed = sum(info["mixed"])
    print(f"[serve chunked] {mixed} of {len(step_s)} decode steps ran while a slot was mid-prefill; "
          f"{len(info['chunk_s'])} chunk dispatches, {1e3 * np.mean(info['chunk_s']):.2f} ms each; "
          f"greedy decode steps {step_ms(step_s, info['sampled'], False)} (ms, count) [{card}]")
    if not mixed:
        raise AssertionError("serve chunked: no decode step ran beside a mid-prefill slot")
    check_logprobs(torch, model, cfg, reqs, prompts, "serve chunked", LOGPROB_MEAN_TOL,
                   LOGPROB_MAX_TOL)

    from fa2_triton_tpu_torch.runtime import SamplingParams

    wave_prompts = prefix_prompts(cfg)
    samplings = [SamplingParams(seed=i, **SAMPLED) if i % WAVE >= 4 else None
                 for i in range(2 * WAVE)]
    p_reqs, p_stats, p_launches, p_step_s, p_info = serve(
        torch, model, cfg, wave_prompts, card, "serve prefix", samplings, [WAVE, WAVE])
    (g_ms, g_n), (s_ms, s_n) = (step_ms(p_step_s, p_info["sampled"], f) for f in (False, True))
    print(f"[serve prefix] prefix_cached_tokens wave A {p_info['cached'][0]}, wave B "
          f"{p_info['cached'][1]} (want {WAVE} x {PREFIX_LEN}); decode steps greedy-only "
          f"{g_ms} ms ({g_n}), sampled {s_ms} ms ({s_n}); "
          f"{len(p_info['chunk_s'])} chunk dispatches, {1e3 * np.mean(p_info['chunk_s']):.2f} ms "
          f"each [{card}]")
    if p_info["cached"][1] != WAVE * PREFIX_LEN:
        raise AssertionError(f"serve prefix: wave B reused {p_info['cached'][1]} cached tokens, "
                             f"not {WAVE * PREFIX_LEN}")
    if p_info["draw"] is None:
        raise AssertionError("serve prefix: no decode step sampled")
    draws = check_draws(torch, p_info["draw"], "serve prefix")
    check_logprobs(torch, model, cfg, p_reqs[WAVE:], wave_prompts[WAVE:], "serve prefix wave B",
                   LOGPROB_MEAN_TOL, LOGPROB_MAX_TOL)
    chunk = chunk_kernel(torch)
    return {"chunked": launches, "prefix": p_launches, "chunk": chunk, "draws": draws,
            "steps": {"greedy_ms": step_ms(step_s, info["sampled"], False)[0],
                      "prefix_greedy_ms": g_ms, "prefix_sampled_ms": s_ms,
                      "chunk_ms": 1e3 * float(np.mean(info["chunk_s"] + p_info["chunk_s"]))},
            "prefix_cached_tokens": p_info["cached"]}


# Phase 14: speculative decoding on the cached forward (B1 at width 1 and
# gamma + 1 over the cache) and the GPT-2 family. (a) runs 2- and 1-layer
# fp32 models at Mistral-7B-v0.3 widths, where greedy equality is exact;
# (b) and (c) phase 3's full-depth bf16 model as the target, with a 2-layer
# draft at the same widths (seed 1) and the target as its own draft.
SPEC_GAMMA = 4
SPEC_WIDTHS = (1, SPEC_GAMMA + 1)
SPEC_KV = 1000                   # (a)'s kernel check: not a multiple of the 64-row tile
SPEC_EXACT_NEW = 32
SPEC_PROMPTS = 4                 # the first of phase 3's prompts
SPEC_NEW = 64
SPEC_MAX_SEQ = 4096
SPEC_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=7)
# The perfect draft's sampled acceptance: p (the verify pass, gamma + 1
# rows) and q (width-1 steps) come from other GEMM shapes in bf16, so p != q
# in the last bits and a few proposals may be rejected.
SPEC_PERFECT_SAMPLED_MIN = 0.9
# The verify call of (b) timed alone (as phase 13 (c) times the chunk's):
# gamma + 1 queries over SPEC_VERIFY_KV cached rows, and the width-1 step.
SPEC_VERIFY_KV = 2048
# (b)'s bf16 near ties: a divergence from greedy_reference passes where the
# reference prefers its own token by at most SPEC_TIE_MARGIN x the largest
# logit difference measured between a verify pass and the width-1 step at
# the same positions: 2 since both tokens' logits move, x 2 since the
# measured passes sit at other positions than the speculative run's.
SPEC_TIE_MARGIN = 4.0
# GPT-2 small (GPT2Config's defaults): training at B x S attention
# positions (tokens of S + 1), AdamW steps on one repeated batch, and a
# cached greedy decode of GPT2_DECODE tokens after a GPT2_PREFILL prompt.
GPT2_BATCH, GPT2_SEQ, GPT2_STEPS = 8, 1024, 3
GPT2_PREFILL, GPT2_DECODE = 512, 64


def spec_counts():
    """Every kernel counter of the forward and the decode, as one dict."""
    from fa2_triton_tpu_torch.ops import decode, flash_fwd

    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES,
            "decode": decode.LAUNCHES}


def reset_counts():
    from fa2_triton_tpu_torch.ops import decode, flash_bwd, flash_fwd

    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    decode.reset_launches()


def expect_spec_launches(what, st, tcfg, dcfg):
    """A generate call launches B1 once a layer for each model step (the
    two prefills, each verify pass, each draft step and backfill) and no
    other kernel."""
    want = tcfg.n_layers * (1 + st.target_calls) + dcfg.n_layers * (1 + st.draft_calls)
    got = spec_counts()
    if got != {**dict.fromkeys(got, 0), "flash_fwd": want}:
        raise AssertionError(f"{what}: launches {got}, want flash_fwd {want} and nothing else")
    return want


def kv_cache_check(torch, S, kv_len, Hq=32, Hkv=8, D=128, say=True):
    """`flash_attn_with_kv_cache` (one B1 launch) against its plain twin, S
    rows over kv_len cached rows (rows past kv_len NaN: never read), Hq / Hkv
    heads of D (by default Mistral-7B-v0.3's attention widths): fp32 within
    FP32_TOL, bf16 under the FA rule. Returns {dtype: max abs err}."""
    from fa2_triton_tpu_torch.ops import flash_fwd
    from fa2_triton_tpu_torch.ops.attention import flash_attn_with_kv_cache

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14 + S)
    q32 = torch.randn((1, S, Hq, D), generator=gen, device=dev) * 0.5
    k32, v32 = (torch.randn((1, Hkv, kv_len + 37, D), generator=gen, device=dev) * 0.5
                for _ in range(2))
    for x in (k32, v32):
        x[:, :, kv_len:] = float("nan")
    lens = torch.tensor([[kv_len, kv_len]], dtype=torch.int32, device=dev)

    def plain(q, k, v):
        return flash_fwd.flash_attn_forward_plain(
            q.transpose(1, 2), k[:, :, :kv_len], v[:, :, :kv_len], lens, kv_len - S, causal=True,
            softmax_scale=D ** -0.5)[0].transpose(1, 2)

    ref, errs = plain(q32, k32, v32), {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        n0 = flash_fwd.LAUNCHES
        out = flash_attn_with_kv_cache(q, k, v, kv_len)
        torch.cuda.synchronize()
        if flash_fwd.LAUNCHES != n0 + 1:
            raise AssertionError("flash_attn_with_kv_cache: not one launch of flash_fwd.cu")
        err = errs[str(dt)[6:]] = max_abs(torch, out, ref)
        if dt == torch.float32:
            bound, rule = FP32_TOL, f"<= {FP32_TOL}"
        else:
            pl_err = max_abs(torch, plain(q, k, v), ref)
            bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
            rule = f"<= 2 x plain bf16 err {pl_err:.3e} + 5e-5"
        if say:
            print(f"[spec] flash_attn_with_kv_cache width {S} over {kv_len} rows, {Hq} / {Hkv} "
                  f"heads, D {D} {str(dt)[6:]}: max abs err {err:.3e} ({rule})")
        if not err <= bound:
            raise AssertionError(f"flash_attn_with_kv_cache width {S} over {kv_len} rows, {Hq} / "
                                 f"{Hkv} heads, D {D}, {dt}: err {err:.3e} ({rule})")
    return errs


def mid_round_eos(ref, gamma):
    """The first token of `ref` that first occurs strictly inside a perfect
    draft's round (round r >= 1 emits ref[(r - 1) (gamma + 1) + 1 ...
    r (gamma + 1)]), neither its first nor its last token: (index, token),
    or None."""
    for i in range(1, len(ref)):
        if ref.index(ref[i]) == i and i % (gamma + 1) not in (0, 1):
            return i, ref[i]
    return None


def spec_exact(torch):
    """Phase 14 (a): fp32, a 2-layer target and a 1-layer draft at
    Mistral-7B-v0.3 widths: the cache attention's kernel at widths 1 and
    gamma + 1; greedy speculative == greedy_reference at gamma 1 and 4; the
    perfect draft accepts everything in ceil((n - 1) / (gamma + 1)) verify
    passes; an EOS inside a round cuts it there."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params
    from fa2_triton_tpu_torch.runtime import SpeculativeDecoder
    from fa2_triton_tpu_torch.runtime.speculative import greedy_reference

    errs = {f"width_{w}": kv_cache_check(torch, w, SPEC_KV) for w in SPEC_WIDTHS}
    tcfg = preset_config("mistral-7b-v0.3", torch.float32, n_layers=2)
    dcfg = preset_config("mistral-7b-v0.3", torch.float32, n_layers=1)
    target = init_params(torch.Generator(device="cuda").manual_seed(0), tcfg)
    draft = init_params(torch.Generator(device="cuda").manual_seed(1), dcfg)
    prompt, n = served_prompts(tcfg)[0], SPEC_EXACT_NEW
    ref = greedy_reference(target, tcfg, prompt, n, max_seq=SPEC_MAX_SEQ)
    runs = {}
    for name, d, c, gamma in (("gamma 1", draft, dcfg, 1), ("gamma 4", draft, dcfg, SPEC_GAMMA),
                              ("perfect", target, tcfg, SPEC_GAMMA)):
        reset_counts()
        out, st = SpeculativeDecoder(target, tcfg, d, c, gamma=gamma,
                                     max_seq=SPEC_MAX_SEQ).generate(prompt, n)
        launches = expect_spec_launches(f"(a) {name}", st, tcfg, c)
        runs[name] = {"acceptance": st.acceptance_rate, "target_calls": st.target_calls,
                      "launches": launches}
        if out != ref:
            raise AssertionError(f"(a) {name}: the fp32 speculative stream differs from "
                                 f"greedy_reference")
    st_perfect = runs["perfect"]
    if st_perfect["acceptance"] != 1.0 or st_perfect["target_calls"] != -(-(n - 1) // (SPEC_GAMMA + 1)):
        raise AssertionError(f"(a) the perfect draft: {st_perfect}")
    eos = mid_round_eos(ref, SPEC_GAMMA)
    if eos is None:
        raise AssertionError(f"(a) no token of {ref} first occurs inside a round")
    i, tok = eos
    out, st = SpeculativeDecoder(target, tcfg, target, tcfg, gamma=SPEC_GAMMA, max_seq=SPEC_MAX_SEQ,
                                 eos_id=tok).generate(prompt, n)
    if out != ref[:i + 1] or st.rounds != -(-i // (SPEC_GAMMA + 1)):
        raise AssertionError(f"(a) EOS {tok} at token {i}: got {len(out)} tokens in {st.rounds} rounds")
    print(f"[spec] (a) fp32, Mistral-7B-v0.3 widths, target 2 layers (seed 0), draft 1 layer "
          f"(seed 1), prompt {len(prompt)}, {n} new tokens: greedy speculative == "
          f"greedy_reference at gamma 1 and 4 and with the perfect draft; {runs}; EOS {tok} at "
          f"token {i} cuts round {st.rounds} after {i + 1} tokens")
    del target, draft
    return {"kv_cache_err": errs, "runs": runs, "eos_token_index": i}


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def reference_rows(torch, model, cfg, prompt, n):
    """`greedy_reference` (timed, host clock to the device's end) and the
    logits each of its tokens was chosen from: a spy on the model step it
    calls keeps the last row of every step. Returns (tokens, seconds, rows
    [n, vocab])."""
    from fa2_triton_tpu_torch.runtime import speculative

    rows, step = [], speculative.forward_with_cache

    def spy(*args, **kw):
        logits, caches = step(*args, **kw)
        rows.append(logits[0, -1].float().clone())
        return logits, caches

    speculative.forward_with_cache = spy
    try:
        ref, wall = timed(torch, lambda: speculative.greedy_reference(
            model, cfg, prompt, n, max_seq=SPEC_MAX_SEQ))
    finally:
        speculative.forward_with_cache = step
    return ref, wall, torch.stack(rows)


def prefilled(torch, model, cfg, tokens):
    """A fresh SPEC_MAX_SEQ cache of `model` holding the rows of `tokens`
    (a list), and the cached attention to go on with."""
    from fa2_triton_tpu_torch.models import llama

    caches = llama.init_kv_cache(cfg, 1, SPEC_MAX_SEQ)
    attn = llama.make_cached_attention_fn(cfg)
    llama.forward_with_cache(model, torch.tensor([tokens], device="cuda"), cfg, caches, 0, attn)
    return caches, attn


def verify_drift(torch, model, cfg, prompt, ref, rows):
    """The largest logit difference between a verify pass and the width-1
    step at the same positions: `ref` fed again after `prompt` in passes of
    gamma + 1 tokens, each pass's logits against `rows`, the logits of
    `greedy_reference`'s steps (rows[t + 1] comes from the step that fed
    ref[t])."""
    from fa2_triton_tpu_torch.models import llama

    caches, attn = prefilled(torch, model, cfg, prompt)
    w, drift = SPEC_GAMMA + 1, 0.0
    for i in range(0, len(ref) - 1, w):
        m = min(w, len(ref) - 1 - i)
        logits, _ = llama.forward_with_cache(model, torch.tensor([ref[i:i + w]], device="cuda"),
                                             cfg, caches, len(prompt) + i, attn)
        drift = max(drift, float((logits[0, :m].float() - rows[i + 1:i + 1 + m]).abs().max()))
    return drift


def tie_checked(torch, model, cfg, prompt, out, ref, rows, tie, what):
    """`out` against greedy_reference's `ref` and its logits `rows`: every
    divergence must be a bf16 near tie, where the reference prefers its own
    token to `out`'s by at most `tie`; the reference then restarts from
    `out` through that token, and the rest of the stream is compared again.
    Returns the divergences as [{"token", "gap"}]."""
    ties, done = [], 0
    while done < len(out):
        j = next((j for j, (a, b) in enumerate(zip(out[done:], ref)) if a != b), None)
        if j is None:
            if len(out) - done != len(ref):
                raise AssertionError(f"{what}: {len(out)} tokens, want {done + len(ref)}")
            break
        gap = float(rows[j, ref[j]] - rows[j, out[done + j]])
        ties.append({"token": done + j, "gap": gap})
        if not gap <= tie:
            raise AssertionError(f"{what}: diverges from greedy_reference at token {done + j}, "
                                 f"where it prefers its token by {gap:.4f} (> {tie:.4f})")
        done += j + 1
        if done < len(out):
            ref, _, rows = reference_rows(torch, model, cfg, prompt + out[:done], len(out) - done)
    return ties


def step_widths_ms(torch, model, cfg, caches, kv, tokens, iters=10):
    """ms of one full-depth target step (host clock to the device's end)
    at each of SPEC_WIDTHS over the first kv rows of `caches` (filled), fed
    the first tokens of `tokens` [1, n], in turns after a warm-up round:
    {width: [ms]}."""
    from fa2_triton_tpu_torch.models import llama

    attn = llama.make_cached_attention_fn(cfg)
    ms = {w: [] for w in SPEC_WIDTHS}
    for r in range(iters + 1):
        for w in (SPEC_WIDTHS if r % 2 else SPEC_WIDTHS[::-1]):
            _, s = timed(torch, lambda: llama.forward_with_cache(model, tokens[:, :w], cfg, caches,
                                                                 kv, attn))
            if r:
                ms[w].append(1e3 * s)
    return ms


def verify_call(torch, kv=SPEC_VERIFY_KV, iters=10):
    """B1 (`flash_fwd_mma_kernel`) on one layer's verify call, gamma + 1
    queries over kv cached rows, and on the width-1 step's, bf16, 32 / 8
    heads, D 128, against the fp32 truth under the FA rule: device time by
    the profiler, the call by CUDA events, aten flash (causal, bottom-right
    aligned like the cache call) on the same rows, the plain twin, and the
    bound; each timed over `iters` calls."""
    from fa2_triton_tpu_torch.ops import flash_fwd
    from fa2_triton_tpu_torch.ops.attention import flash_attn_with_kv_cache

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    Hq, Hkv, D = 32, 8, 128
    k32, v32 = (torch.randn((1, Hkv, SPEC_MAX_SEQ, D), generator=gen, device=dev) * 0.5
                for _ in range(2))
    k, v = k32.bfloat16(), v32.bfloat16()
    lens = torch.tensor([[kv, kv]], dtype=torch.int32, device=dev)
    out = {}
    for S in SPEC_WIDTHS:
        q32 = torch.randn((1, S, Hq, D), generator=gen, device=dev) * 0.5
        q = q32.bfloat16()

        def plain(q, k, v, S=S):
            return flash_fwd.flash_attn_forward_plain(
                q.transpose(1, 2), k[:, :, :kv], v[:, :, :kv], lens, kv - S, causal=True,
                softmax_scale=D ** -0.5)[0].transpose(1, 2)

        run = lambda: flash_attn_with_kv_cache(q, k, v, kv)   # noqa: E731
        truth = plain(q32, k32, v32)
        pl_err = max_abs(torch, plain(q, k, v), truth)
        err = max_abs(torch, run(), truth)
        if not err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
            raise AssertionError(f"verify call width {S}: err {err:.3e}, plain bf16 {pl_err:.3e}")
        ms = kernel_ms(torch, run, ["flash_fwd_mma_kernel"], iters)["flash_fwd_mma_kernel"]
        lib_fwd, lib_out, _ = library_attention(
            torch, q[0], k[0, :, :kv].transpose(0, 1).contiguous(),
            v[0, :, :kv].transpose(0, 1).contiguous(), [S], [kv], True, D ** -0.5)
        lib_err = check_library(torch, f"verify call width {S}", lib_out[0], truth[0], pl_err)
        pairs = S * kv - S * (S - 1) // 2
        nbytes = 2 * S * Hq * D * 2 + 2 * kv * Hkv * D * 2 + S * Hq * 4
        out[f"width_{S}"] = e = {
            "max_abs_err": err, "ms": ms, "call_ms": cuda_ms(torch, run, iters),
            "plain_ms": cuda_ms(torch, lambda: plain(q, k, v), iters),
            "library_ms": library_mean_ms(torch, lib_fwd, iters),
            "library_call_ms": cuda_ms(torch, lib_fwd, iters),
            **roofline(2 * D * 2 * pairs * Hq, nbytes)}
        print(f"[spec] verify call B1 width {S} over {kv} rows bf16: max abs err {err:.3e} (<= 2 x "
              f"plain bf16 err {pl_err:.3e} + 5e-5); kernel {ms:.4f} ms of device time (the call "
              f"{e['call_ms']:.4f} ms), plain {e['plain_ms']:.3f} ms, library (aten flash, causal) "
              f"{e['library_ms']:.4f} ms of device time (the call {e['library_call_ms']:.4f}; err "
              f"{lib_err:.3e}), bound {e['bound_ms']:.5f} ms ({e['bound_by']}): "
              f"{100 * e['bound_ms'] / ms:.2f} % of the bound")
    return out


def spec_full(torch, card, model, cfg, prompts):
    """Phase 14 (b): full depth, bf16, gamma 4, SPEC_NEW tokens after each
    of SPEC_PROMPTS of phase 3's prompts, with the 2-layer draft and the
    perfect draft, the counts reset just before each generate: every step
    through B1 and nothing else; each stream equal to greedy_reference's
    but at bf16 near ties (`tie_checked`), the tie bound SPEC_TIE_MARGIN x
    the largest logit difference measured between a verify pass and the
    width-1 step at the same positions (`verify_drift`)."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params
    from fa2_triton_tpu_torch.runtime import SpeculativeDecoder

    dcfg = preset_config("mistral-7b-v0.3", torch.bfloat16, n_layers=2)
    draft = init_params(torch.Generator(device="cuda").manual_seed(1), dcfg)
    drafts = {"2-layer draft": (draft, dcfg), "perfect draft": (model, cfg)}
    res = {name: {"launches": 0, "rounds": 0, "proposed": 0, "accepted": 0, "emitted": 0,
                  "target_calls": 0, "wall_s": 0.0, "divergences": []} for name in drafts}
    prompts = prompts[:SPEC_PROMPTS]
    refs, ref_tokens, ref_s, drift = [], 0, 0.0, 0.0
    for prompt in prompts:
        ref, wall, rows = reference_rows(torch, model, cfg, prompt, SPEC_NEW)
        refs.append((ref, rows))
        ref_tokens, ref_s = ref_tokens + len(ref), ref_s + wall
        drift = max(drift, verify_drift(torch, model, cfg, prompt, ref, rows))
    tie = SPEC_TIE_MARGIN * drift
    for p, (prompt, (ref, rows)) in enumerate(zip(prompts, refs)):
        for name, (d, c) in drafts.items():
            dec = SpeculativeDecoder(model, cfg, d, c, gamma=SPEC_GAMMA, max_seq=SPEC_MAX_SEQ)
            reset_counts()
            (out, st), wall = timed(torch, lambda: dec.generate(prompt, SPEC_NEW))
            r = res[name]
            r["launches"] += expect_spec_launches(f"(b) {name}", st, cfg, c)
            r["wall_s"] += wall
            for key in ("rounds", "proposed", "accepted", "emitted", "target_calls"):
                r[key] += getattr(st, key)
            r["divergences"] += [{"prompt": p, **t} for t in tie_checked(
                torch, model, cfg, prompt, out, ref, rows, tie, f"(b) {name}, prompt {p}")]
    caches, _ = prefilled(torch, model, cfg, prompts[0])
    steps = {w: float(np.median(v)) for w, v in step_widths_ms(
        torch, model, cfg, caches, len(prompts[0]), torch.tensor([prompts[0]], device="cuda")).items()}
    del caches
    out = {"prompts": [len(p) for p in prompts], "new_tokens": SPEC_NEW,
           "gamma": SPEC_GAMMA, "reference_ms_per_token": 1e3 * ref_s / ref_tokens,
           "verify_drift": drift, "tie_bound": tie,
           "target_step_ms": {f"width_{w}": ms for w, ms in steps.items()}}
    print(f"[spec] (b) the largest logit difference between a verify pass and the width-1 step at "
          f"the same positions: {drift:.4f}; a divergence passes as a near tie up to {tie:.4f}")
    for name, r in res.items():
        r["acceptance"] = r["accepted"] / r["proposed"]
        r["tokens_per_target_call"] = r["emitted"] / r["target_calls"]
        r["ms_per_token"] = 1e3 * r["wall_s"] / r["emitted"]
        r["b1_launches_per_round"] = r["launches"] / r["rounds"]
        out[name] = r
        print(f"[spec] (b) {name}, full depth bf16, gamma {SPEC_GAMMA}, prompts {out['prompts']}, "
              f"{SPEC_NEW} new tokens each: acceptance {r['acceptance']:.3f}, "
              f"{r['tokens_per_target_call']:.2f} tokens per target call, {r['ms_per_token']:.2f} "
              f"ms per emitted token against greedy_reference's "
              f"{out['reference_ms_per_token']:.2f}; B1 launches {r['launches']} "
              f"({r['b1_launches_per_round']:.1f} a round); divergences from greedy_reference "
              f"(prompt, token, the reference's preference for its own token): "
              f"{r['divergences']} [{card}]")
    print(f"[spec] (b) one full-depth target step after prompt 0 ({len(prompts[0])} tokens): width 1 "
          f"{steps[1]:.2f} ms, width {SPEC_GAMMA + 1} (a verify pass) {steps[SPEC_GAMMA + 1]:.2f} ms "
          f"(host clock to the device's end, medians) [{card}]")
    out["verify_call"] = verify_call(torch)
    return out, draft, dcfg


def spec_sampled(torch, card, model, cfg, draft, dcfg, prompt):
    """Phase 14 (c): speculative sampling (SPEC_SAMPLED) on the full-depth
    target with the 2-layer draft: two runs give equal tokens in the vocab;
    round 0's draft keys, accept uniforms and resample key on the card
    equal the CPU's bit for bit; the perfect draft's sampled acceptance."""
    from fa2_triton_tpu_torch.runtime import SamplingParams, SpeculativeDecoder
    from fa2_triton_tpu_torch.runtime import sampling

    sp = SamplingParams(**SPEC_SAMPLED)
    dec = SpeculativeDecoder(model, cfg, draft, dcfg, gamma=SPEC_GAMMA, max_seq=SPEC_MAX_SEQ)
    reset_counts()
    a, st = dec.generate(prompt, SPEC_NEW, sampling=sp)
    launches = expect_spec_launches("(c)", st, cfg, dcfg)
    b, _ = dec.generate(prompt, SPEC_NEW, sampling=sp)
    if a != b or len(a) != SPEC_NEW or not all(0 <= t < cfg.vocab_size for t in a):
        raise AssertionError("(c) two sampled runs differ, or a token is out of the vocab")

    def round0(dev):
        base = sampling.prng_key(sp.seed, device=dev)
        root = sampling.fold_in(base, 1)
        u_key, r_key = sampling.split(sampling.fold_in(base, 2))
        return torch.cat([torch.stack([sampling.fold_in(root, i) for i in range(SPEC_GAMMA)]).flatten(),
                          sampling.uniform(u_key, (SPEC_GAMMA,)).view(torch.int32).long(),
                          r_key, sampling.bits(r_key, (cfg.vocab_size,))]).cpu()

    if not torch.equal(round0(torch.device("cuda")), round0(torch.device("cpu"))):
        raise AssertionError("(c) round 0's keys, uniforms or bits differ between the card and the CPU")
    perfect = SpeculativeDecoder(model, cfg, model, cfg, gamma=SPEC_GAMMA, max_seq=SPEC_MAX_SEQ)
    _, pst = perfect.generate(prompt, SPEC_NEW, sampling=sp)
    print(f"[spec] (c) sampled {SPEC_SAMPLED}, prompt {len(prompt)}, {SPEC_NEW} tokens: two runs "
          f"equal, all in the vocab; acceptance 2-layer draft {st.acceptance_rate:.3f} "
          f"({st.rounds} rounds, {launches} B1 launches), perfect draft {pst.acceptance_rate:.3f} "
          f"(>= {SPEC_PERFECT_SAMPLED_MIN}); round 0's draft keys, accept uniforms, resample key "
          f"and its bits equal on the card and the CPU, bit for bit [{card}]")
    if not pst.acceptance_rate >= SPEC_PERFECT_SAMPLED_MIN:
        raise AssertionError(f"(c) the perfect draft accepts {pst.acceptance_rate:.3f} sampled")
    return {"acceptance": st.acceptance_rate, "perfect_acceptance": pst.acceptance_rate,
            "launches": launches, "rounds": st.rounds, "keys_equal": True}


def phase_speculative(torch, card, model, cfg, prompts):
    """Phase 14 (a)-(c) (see the module docstring); (d) is `phase_gpt2`."""
    exact = spec_exact(torch)
    torch.cuda.empty_cache()
    full, draft, dcfg = spec_full(torch, card, model, cfg, prompts)
    sampled = spec_sampled(torch, card, model, cfg, draft, dcfg, prompts[0])
    return {"exact": exact, "full": full, "sampled": sampled}


def gpt2_attention_times(torch, card):
    """GPT-2 small's attention kernels at the training shape (B GPT2_BATCH x
    S GPT2_SEQ, 12 / 12 heads, D 64, bf16, causal) through the routes the
    trainer takes (the tri-square forward and backward): device time per
    launch by the profiler beside the plain twins', aten flash's (forward;
    its backward after its own forward; every kernel of a call, summed) and
    the bounds."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    B, S, H, D = GPT2_BATCH, GPT2_SEQ, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = ((torch.randn((B, S, H, D), generator=gen, device="cuda") * sd).bfloat16()
                   for sd in (0.5, 0.5, 0.5, 1.0))
    t = lambda x: x.transpose(1, 2)   # noqa: E731
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o, lse = flash_fwd.flash_attn_forward(t(q), t(k), t(v), lens, static_skip=True, **kw)
    fwd = lambda: flash_fwd.flash_attn_forward(t(q), t(k), t(v), lens, static_skip=True, **kw)  # noqa: E731
    bwd = lambda: flash_bwd.flash_attn_backward(t(q), t(k), t(v), t(do), o, lse, lens,  # noqa: E731
                                                static_skip=True, **kw)
    lib_fwd, _, lib_bwd = library_attention(torch, q.reshape(B * S, H, D), k.reshape(B * S, H, D),
                                            v.reshape(B * S, H, D), [S] * B, [S] * B, True, D ** -0.5)
    pairs = B * causal_pairs([S])
    out = {
        "forward": {"ms": kernel_ms(torch, fwd, ["flash_fwd_mma_kernel"])["flash_fwd_mma_kernel"],
                    "call_ms": cuda_ms(torch, fwd),
                    "plain_ms": cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(
                        t(q), t(k), t(v), lens, **kw), iters=3),
                    "library_ms": library_mean_ms(torch, lib_fwd),
                    **attn_bound("fwd", pairs, B * S, H, H, D, 2)},
        # The tri-square backward's call: delta prologue, main kernel, dq reduction.
        "backward": {"ms": sum(kernel_ms(torch, bwd, ["fused_delta", "bwd_tri_mma_kernel",
                                                      "tri_dq_reduce"]).values()),
                     "call_ms": cuda_ms(torch, bwd),
                     "plain_ms": cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(
                         t(q), t(k), t(v), t(do), o, lse, lens, **kw), iters=3),
                     "library_ms": library_mean_ms(torch, lib_bwd(do.reshape(B * S, H, D))),
                     **fused_bound(pairs, B * S, B * S, H, H, D)}}
    for name, e in out.items():
        print(f"[gpt2] (d) attention {name} at {B} x {S}, 12 heads, D 64 bf16 (the tri-square): "
              f"kernels {e['ms']:.4f} ms of device time (the call {e['call_ms']:.4f} ms), plain "
              f"{e['plain_ms']:.3f} ms, library (aten "
              f"flash, causal) {e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}): {100 * e['bound_ms'] / e['ms']:.1f} % of the bound [{card}]")
    return out


def phase_gpt2(torch, card):
    """Phase 14 (d): GPT-2 small (`GPT2Config()`, bf16, random weights from
    seed 0): `loss_fn` + backward at GPT2_BATCH x GPT2_SEQ and GPT2_STEPS
    AdamW steps on one repeated batch, the counts reset just before (finite,
    falling losses; the routes' launches once a layer a step); 2-layer
    gradients through the kernels against an fp32 run of the same weights
    with the plain attention, under the FA contract; the cache attention
    at GPT-2's 12 / 12 heads, D 64 against its plain twin over every cache
    length of the decode that follows (`kv_cache_check`, fp32 and bf16); a
    cached greedy decode (GPT2_PREFILL, then GPT2_DECODE width-1 steps)
    whose log-probs match the full forward's at the same positions within
    phase 4's bf16 bounds; a position at max_seq_len raises; then
    `gpt2_attention_times`."""
    from fa2_triton_tpu_torch.examples.train import make_optimizer, optimizer_step
    from fa2_triton_tpu_torch.models import GPT2Config, gpt2
    from fa2_triton_tpu_torch.ops import flash_attn_reference, flash_bwd, flash_fwd

    cfg = GPT2Config()
    H, D = cfg.n_heads, cfg.hd
    routes = {"forward": flash_fwd.forward_route(GPT2_SEQ, GPT2_SEQ, D, 2, causal=True,
                                                 static_skip=True),
              "backward": flash_bwd.backward_route(GPT2_SEQ, GPT2_SEQ, D, 2, causal=True,
                                                   static_skip=True, group=1)}
    model = gpt2.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ + 1))).cuda()
    opt = make_optimizer(model, 3e-4)
    gpt2.loss_fn(model, tokens).backward()          # warm-up, gradients dropped
    model.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms = [], []
    for _ in range(GPT2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = gpt2.loss_fn(model, tokens)
        loss.backward()
        optimizer_step(model, opt, 3e-4, 1.0)
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = bwd_launches(flash_fwd, flash_bwd)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[gpt2] (d) GPT-2 small ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"bf16, head dim {D}), {GPT2_STEPS} AdamW steps of {GPT2_BATCH} x {GPT2_SEQ} on one repeated "
          f"batch: losses {[round(x, 4) for x in losses]}, ms per step "
          f"{[round(x, 1) for x in step_ms]}, peak {peak:.2f} GiB; routes {routes}; launches "
          f"{launches} [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"(d) GPT-2 losses not finite or not falling: {losses}")
    n = cfg.n_layers * GPT2_STEPS
    want_fwd = {"tri_square": "flash_fwd", "strip": "causal_strip", "generic": "flash_fwd"}
    want_bwd = {"tri_square": "bwd_tri_square", "worklist": "bwd_worklist",
                "generic": "flash_bwd_dq"}
    if (launches[want_fwd[routes["forward"]]] != n or launches[want_bwd[routes["backward"]]] != n):
        raise AssertionError(f"(d) GPT-2 launches {launches}: want {n} of the routes {routes}")
    del opt

    # 2-layer gradients against fp32 with the plain attention.
    c2 = dataclasses.replace(cfg, n_layers=2)
    m2 = gpt2.init_params(torch.Generator(device="cuda").manual_seed(1), c2)
    m32 = gpt2.GPT2Model(dataclasses.replace(c2, dtype=torch.float32), device="cuda")
    m32.load_state_dict(m2.state_dict())
    real_attn = gpt2.flash_attn_func

    def grads_of(m, plain):
        gpt2.flash_attn_func = ((lambda q, k, v, causal: flash_attn_reference(q, k, v, causal=causal))
                                if plain else real_attn)
        try:
            m.zero_grad(set_to_none=True)
            loss = gpt2.loss_fn(m, tokens)
            loss.backward()
        finally:
            gpt2.flash_attn_func = real_attn
        return loss.item(), {k: p.grad.detach().clone() for k, p in m.named_parameters()}

    (lk, gk), (lp, gp), (l32, g32) = grads_of(m2, False), grads_of(m2, True), grads_of(m32, True)
    worst, worst_name = 0.0, None
    for name in g32:
        err, yard = check_grad(torch, name, gk[name], g32[name], gp[name], "(d) GPT-2 2-layer grads")
        ratio = err / (GRAD_ERROR_MUL * yard + GRAD_ERROR_BIAS)
        if ratio >= worst:
            worst, worst_name = ratio, name
    print(f"[gpt2] (d) 2 layers, bf16, {GPT2_BATCH} x {GPT2_SEQ}: loss kernels {lk:.5f}, plain {lp:.5f}, "
          f"fp32 {l32:.5f}; all {len(g32)} parameter gradients within the FA contract vs fp32 "
          f"(worst {worst_name}: {worst:.2f} of the bound)")
    del m2, m32, gk, gp, g32

    # The cache attention at GPT-2's shape against its plain twin, over every
    # cache length the decode below reaches: the prefill, then width 1.
    cases = [(GPT2_PREFILL, GPT2_PREFILL)] + [
        (1, n) for n in range(GPT2_PREFILL + 1, GPT2_PREFILL + GPT2_DECODE)]
    cache_errs = [kv_cache_check(torch, S, n, H, H, D, say=False) for S, n in cases]
    cache_err = {dt: max(e[dt] for e in cache_errs) for dt in cache_errs[0]}
    print(f"[gpt2] (d) flash_attn_with_kv_cache at {H} / {H} heads, D {D}: width {GPT2_PREFILL} over "
          f"{GPT2_PREFILL} rows and width 1 over {GPT2_PREFILL + 1}-{GPT2_PREFILL + GPT2_DECODE - 1}: "
          f"max abs err fp32 {cache_err['float32']:.3e} (<= {FP32_TOL}), bf16 "
          f"{cache_err['bfloat16']:.3e} (each call <= 2 x its plain bf16 err + 5e-5)")

    # Cached greedy decode against the full forward.
    with torch.inference_mode():
        prompt = tokens[:1, :GPT2_PREFILL]
        caches = gpt2.init_kv_cache(cfg, 1, GPT2_PREFILL + GPT2_DECODE)
        reset_counts()
        logits, _ = gpt2.forward_with_cache(model, prompt, cfg, caches, 0)
        rows, toks = [logits[0, -1]], [logits[0, -1].argmax().view(1, 1)]
        t0 = time.perf_counter()
        for t in range(GPT2_DECODE - 1):
            logits, _ = gpt2.forward_with_cache(model, toks[-1], cfg, caches, GPT2_PREFILL + t)
            rows.append(logits[0, -1])
            toks.append(logits[0, -1].argmax().view(1, 1))
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / (GPT2_DECODE - 1)
        cached_launches = spec_counts()
        toks = torch.cat(toks, dim=1)
        full = gpt2.forward(model, torch.cat([prompt, toks[:, :-1]], dim=1))[0, GPT2_PREFILL - 1:]
        lp_cached = torch.log_softmax(torch.stack(rows), -1).gather(-1, toks[0, :, None])[:, 0]
        lp_full = torch.log_softmax(full, -1).gather(-1, toks[0, :, None])[:, 0]
        err = (lp_cached - lp_full).abs()
        if cached_launches != {**dict.fromkeys(cached_launches, 0),
                               "flash_fwd": cfg.n_layers * GPT2_DECODE}:
            raise AssertionError(f"(d) cached decode launches {cached_launches}")
        print(f"[gpt2] (d) cached greedy decode, prefill {GPT2_PREFILL} then {GPT2_DECODE - 1} width-1 "
              f"steps: {decode_ms:.2f} ms a step; the chosen tokens' log-probs vs the full forward at "
              f"the same positions: mean abs err {float(err.mean()):.4f} (tol {LOGPROB_MEAN_TOL}), "
              f"max {float(err.max()):.4f} (tol {LOGPROB_MAX_TOL}); launches {cached_launches} [{card}]")
        if not (torch.isfinite(lp_cached).all() and float(err.mean()) <= LOGPROB_MEAN_TOL
                and float(err.max()) <= LOGPROB_MAX_TOL):
            raise AssertionError("(d) GPT-2's cached decode disagrees with its full forward")
        try:
            gpt2.forward_with_cache(model, toks[:, :1], cfg, gpt2.init_kv_cache(cfg, 1, 1032),
                                    cfg.max_seq_len)
        except ValueError as e:
            print(f"[gpt2] (d) position {cfg.max_seq_len}: ValueError ({e})")
        else:
            raise AssertionError(f"(d) GPT-2 position {cfg.max_seq_len} did not raise")
    return {"routes": routes, "losses": losses, "step_ms": step_ms, "peak_gib": peak,
            "launches": launches, "grads_worst": worst, "cache_err": cache_err,
            "decode_ms": decode_ms,
            "cached_launches": cached_launches["flash_fwd"],
            "attention": gpt2_attention_times(torch, card)}


# Phase 15: the rest of the model zoo. Mixtral-8x7B-v0.1's published widths
# (the trainer's preset names its source), cut in depth: MOE_TRAIN_LAYERS of
# 32 for training (7.52 B parameters; at 8 bytes each, bf16 weights,
# gradients and both AdamW moments, ~60 GB) and MOE_SERVE_LAYERS for serving
# (23.5 B parameters, 47 GB in bf16; all 32 layers are 93 GB).
MOE_TRAIN_LAYERS = 5
MOE_SERVE_LAYERS = 16
MOE_TRAIN_ARGV = ["--config", "mixtral-8x7b-v0.1", "--layers", str(MOE_TRAIN_LAYERS),
                  "--steps", "3", "--batch", "2", "--seq", str(TRAIN_SEQ), "--remat",
                  "--repeat-batch", "--lr", "3e-4", "--grad-clip", "1.0"]
# (b): one Mixtral layer on the training batch's 2 x 2047 tokens; a small
# capacity drops most second choices and some tokens outright.
MOE_BLOCK_T = 2 * BWD_SEQ
MOE_SMALL_CAPACITY = 256
# (c) and (e) serve the first ZOO_REQUESTS of phase 3's prompts, (d) the first
# LORA_REQUESTS.
ZOO_REQUESTS = 8
LORA_REQUESTS = 2
LORA_RANK, LORA_ALPHA, LORA_STEPS = 8, 16.0, 3
# Adam moves each adapter entry by about the LR a step; B starts at 0, so the
# first steps' W + (alpha / r) A B must move W by more than bf16's half ulp
# (~3e-5 at |W| ~ 1/64) for the merged weights, and the loss, to change.
LORA_LR = 2e-3
# Tokens served by the Engine against `forward` on the same model, fed the
# served tokens (teacher forcing): a served token may differ from forward's
# argmax only where forward prefers its argmax by at most ZOO_TIE_GAP (a
# near tie: bf16 decode and prefill round apart from the full forward, and
# an MoE router fed slightly different inputs may swap a near-tied second
# expert), and the served log-probs must lie within ZOO_LOGPROB_MEAN_TOL of
# forward's on average.
ZOO_TIE_GAP = 0.25
ZOO_LOGPROB_MEAN_TOL = LOGPROB_MEAN_TOL
# Mixtral in bf16 cannot be held token by token: the router reads fp32
# logits of a bf16 rms_norm output, and where the served path and forward
# round that input apart, a near-tied second expert swaps, which moves the
# token's residual by a whole expert's share. (On an NVIDIA H100 80GB HBM3 at
# 700 W, 24 of 256 served tokens differed from forward's argmax, 6 at gaps
# 0.30-0.58 where a dense model's differ at <= 0.0625, and the mean log-prob
# error was 0.0338.) So bf16 is held by share and mean, at ~2x those
# measurements: a wrong expert, weight or cache row moves nearly every
# token. The exact check is fp32 at MOE_EXACT_LAYERS layers, where the two
# paths round ~1e-6 apart and a swap needs a router tie that close: every
# token forward's argmax or within FP32_TIE_GAP of it, log-probs within
# FP32_TOL on average.
MOE_AGREE_MIN = 0.8
MOE_LOGPROB_MEAN_TOL = 0.07
MOE_EXACT_LAYERS = 2
FP32_TIE_GAP = 1e-3
# (e): one layer's qmatmul against x @ (values x scales) in fp32: the result
# is rounded to bf16 (at most 2^-8 of its value: bf16 keeps 8 significant
# bits), plus fp32 sums of 4096 products in another order (1e-5 of the sum
# of |products|). Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.961 (int8)
# and 0.965 (fp8) of this bound, set by the rounding, which no kernel change
# can loosen.
QMM_REL, QMM_SUM_TOL = 2.0 ** -8, 1e-5


def forward_greedy_check(torch, model, cfg, reqs, prompts, what, tie=ZOO_TIE_GAP,
                         mean_tol=ZOO_LOGPROB_MEAN_TOL, agree_min=None):
    """Each served request fed again (prompt + its tokens but the last)
    through `llama.forward` on the same model (the flash forward kernel; the
    dense block on MoE layers): every served token must be forward's argmax
    at its position or within `tie` of it (`tie` None: at least `agree_min`
    of them its argmax), and the served log-probs within `mean_tol` of
    forward's on average. Returns the counts, the gaps of the tokens that
    differ and the log-prob errors."""
    from fa2_triton_tpu_torch.models import llama

    gaps, errs = [], []
    for r, p in zip(reqs, prompts):
        toks = torch.tensor([p + r.out_tokens[:-1]], device="cuda")
        logits = llama.forward(model, toks)[0, len(p) - 1:].float()
        out = torch.tensor(r.out_tokens, device="cuda")[:, None]
        gap = (logits.max(-1).values - logits.gather(-1, out)[:, 0]).cpu().numpy()
        lp = torch.log_softmax(logits, -1).gather(-1, out)[:, 0].cpu().numpy()
        gaps += [float(g) for g in gap if g > 0]
        errs.append(np.abs(lp - np.array(r.out_logprobs)))
        del logits
    err = np.concatenate(errs)
    agree = 1.0 - len(gaps) / err.size
    res = {"tokens": int(err.size), "differ": len(gaps), "gaps": sorted(gaps), "agree": agree,
           "lp_mean": float(err.mean()), "lp_max": float(err.max())}
    rule = f"tie bound {tie}" if tie is not None else f"at least {agree_min} equal"
    print(f"[{what}] served tokens vs `forward` on the same model, teacher-forced "
          f"({len(reqs)} requests, {err.size} tokens): {len(gaps)} differ from its argmax "
          f"({agree:.3f} equal), at top-two gaps {[round(g, 4) for g in sorted(gaps)]} ({rule}); "
          f"log-probs: mean abs err {err.mean():.3e} (tol {mean_tol}), max {err.max():.3e}")
    if ((tie is not None and gaps and max(gaps) > tie)
            or (tie is None and not agree >= agree_min) or not err.mean() <= mean_tol):
        raise AssertionError(f"{what}: the served tokens disagree with forward's greedy tokens")
    return res


def moe_drops(torch, model, tokens):
    """moe_mlp's drops at the default capacity, layer by layer, on `tokens`:
    a no-grad `moe.forward` whose MLP counts the (token, choice) entries
    past capacity and the tokens all of whose choices are."""
    from fa2_triton_tpu_torch.models import moe

    cfg, T = model.cfg, tokens.numel()
    entries, whole = [], []

    def counting(layer, x, c):
        h = moe.rms_norm(x, layer.mlp_norm, c.norm_eps).reshape(T, -1)
        keep = moe._slots(moe._route(h, layer.router, c)[1], c.n_experts, moe._capacity(c, T))[2]
        entries.append(int((~keep).sum()))
        whole.append(int((~keep.view(c.top_k, T).any(0)).sum()))
        return moe.moe_mlp(layer, x, c)

    with torch.no_grad():
        moe.forward(model, tokens, mlp_fn=counting)
    return {"capacity": moe._capacity(cfg, T), "entries": cfg.top_k * T,
            "dropped": entries, "tokens_dropped": whole}


def moe_train(torch, card):
    """(a) `examples/train.py --config mixtral-8x7b-v0.1 --layers 5`: every
    gradient of the warm-up (step 0's), the routers' included, finite and
    the routers' nonzero; drops per layer on the batch; finite, falling
    losses; the generic forward twice (remat) and the dq + dk/dv pair once
    a layer a step."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    drops = {}

    def on_grads(model, tokens):
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if bad or not all(float(layer.router.grad.abs().max()) > 0 for layer in model.layers):
            raise AssertionError(f"(a) gradients missing, not finite or zero at the router: {bad}")
        drops.update(moe_drops(torch, model, tokens[:, :-1]))

    def reset():
        flash_fwd.LAUNCHES = 0
        flash_bwd.reset_launches()

    args, res = run_trainer(torch, card, MOE_TRAIN_ARGV, reset, "moe train", on_grads)
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    L, steps = res["config"].n_layers, args.steps
    free = (torch.cuda.get_device_properties(0).total_memory - res["peak_bytes"]) / 2**30
    print(f"[moe train] {res['config'].n_experts} experts, top-{res['config'].top_k}, capacity "
          f"{drops['capacity']} of {drops['entries']} (token, choice) entries a layer; dropped a "
          f"layer (step 0's weights): {drops['dropped']}, tokens with every choice dropped "
          f"{drops['tokens_dropped']}; {free:.2f} GiB of the card left at the peak; launches "
          f"{launches} [{card}]")
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"(a) training launches {launches} != {want}")
    return {"launches": launches, "losses": res["losses"], "step_s": res["step_s"],
            "tokens_per_s": res["tokens_per_s"], "peak_gib": res["peak_bytes"] / 2**30,
            "free_gib": free, **drops}


def moe_truth(torch, layer, x, cfg):
    """The fp32 evaluation of one MoE block on the block's own routing (the
    same rms_norm output in x's dtype, so the same experts and weights):
    each expert's SwiGLU in fp32 on the tokens routed to it, weighted and
    summed in fp32, plus x."""
    import torch.nn.functional as F

    from fa2_triton_tpu_torch.models import moe

    T, D = x.shape[0] * x.shape[1], x.shape[-1]
    h = moe.rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, D)
    weights, idx, _ = moe._route(h, layer.router, cfg)
    out = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        t, j = (idx == e).nonzero(as_tuple=True)
        hf = h[t].float()
        y = (F.silu(hf @ layer.we_gate[e].float()) * (hf @ layer.we_up[e].float())) \
            @ layer.we_down[e].float()
        out.index_add_(0, t, weights[t, j, None] * y)
    return x.float() + out.view(x.shape)


def plain_slots(idx, n_experts, capacity):
    """JAX's rule index by index (`_dispatch_tensors`): the choices flattened
    j-major, each entry's position the count of earlier entries of its
    expert, kept below capacity."""
    flat = idx.t().reshape(-1).cpu().numpy()
    seen = np.zeros(n_experts, np.int64)
    pos = np.empty(flat.size, np.int64)
    for i, e in enumerate(flat):
        pos[i] = seen[e]
        seen[e] += 1
    return pos, pos < capacity


def moe_block(torch, card):
    """(b) One Mixtral layer, bf16, T = MOE_BLOCK_T: `moe_mlp` at capacity T
    against the fp32 evaluation under the FA output rule, the dense block
    its yardstick; the slots at the default and a small capacity equal to
    `plain_slots` bit for bit, and each token whose choices all dropped
    keeps its residual bit for bit; the router's gradient finite and
    nonzero; the block's times."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import moe

    cfg = preset_config("mixtral-8x7b-v0.1", torch.bfloat16, n_layers=1)
    layer = moe.init_params(torch.Generator(device="cuda").manual_seed(0), cfg).layers[0]
    T, D, E, k = MOE_BLOCK_T, cfg.dim, cfg.n_experts, cfg.top_k
    x = torch.randn(2, BWD_SEQ, D, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    res = {}
    with torch.no_grad():
        truth = moe_truth(torch, layer, x, cfg)
        sparse, _ = moe.moe_mlp(layer, x, cfg, capacity=T)
        dense, _ = moe.moe_mlp_dense(layer, x, cfg)
        err, yard = max_abs(torch, sparse, truth), max_abs(torch, dense, truth)
        del truth
        print(f"[moe block] Mixtral-8x7B-v0.1 layer, bf16, T {T}: moe_mlp at capacity T vs the fp32 "
              f"evaluation {err:.3e}, the dense block's {yard:.3e} (FA rule: <= {OUT_ERROR_MUL} x "
              f"+ {OUT_ERROR_BIAS})")
        if not err <= OUT_ERROR_MUL * yard + OUT_ERROR_BIAS:
            raise AssertionError("(b) moe_mlp at capacity T breaks the FA rule")
        idx = moe._route(moe.rms_norm(x, layer.mlp_norm, cfg.norm_eps).reshape(T, D),
                         layer.router, cfg)[1]
        for C in (moe._capacity(cfg, T), MOE_SMALL_CAPACITY):
            _, pos, keep = moe._slots(idx, E, C)
            ref_pos, ref_keep = plain_slots(idx, E, C)
            if not (np.array_equal(pos.cpu().numpy(), ref_pos)
                    and np.array_equal(keep.cpu().numpy(), ref_keep)):
                raise AssertionError(f"(b) slots at capacity {C} differ from JAX's rule")
            out = moe.moe_mlp(layer, x, cfg, capacity=C)[0].view(T, D)
            gone = ~keep.view(k, T).any(0)
            if not torch.equal(out[gone], x.view(T, D)[gone]):
                raise AssertionError(f"(b) a token dropped at capacity {C} is not its residual")
            res[C] = {"dropped": int((~keep).sum()), "tokens_dropped": int(gone.sum())}
        sparse_ms = cuda_ms(torch, lambda: moe.moe_mlp(layer, x, cfg))
        dense_ms = cuda_ms(torch, lambda: moe.moe_mlp_dense(layer, x, cfg))
    out, aux = moe.moe_mlp(layer, x, cfg)
    (out.float().square().mean() + aux).backward()
    g = layer.router.grad
    if not (torch.isfinite(g).all() and g.abs().max() > 0):
        raise AssertionError("(b) the router's gradient is not finite and nonzero")
    print(f"[moe block] slots equal to JAX's rule rebuilt index by index at capacity "
          f"{list(res)} of {k * T} entries; drops {res} (every fully dropped token equal to its "
          f"residual); router gradient finite, max {float(g.abs().max()):.3e}; moe_mlp "
          f"{sparse_ms:.3f} ms, moe_mlp_dense {dense_ms:.3f} ms [{card}]")
    return {"max_abs_err": err, "dense_err": yard, "drops": res, "ms": sparse_ms,
            "dense_ms": dense_ms}


def moe_serve(torch, card):
    """(c) Mixtral at MOE_SERVE_LAYERS layers served by the paged Engine:
    ZOO_REQUESTS of phase 3's prompts, NEW_TOKENS greedy each, then
    `forward_greedy_check` by share and mean (bf16); then the same requests
    at MOE_EXACT_LAYERS layers in fp32, held token by token."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import init_params

    cfg = preset_config("mixtral-8x7b-v0.1", torch.bfloat16, n_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    print(f"[serve moe] Mixtral-8x7B-v0.1 widths, {cfg.n_layers} of 32 layers, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params bf16, random (seed 0), "
          f"init {time.perf_counter() - t0:.1f} s")
    prompts = served_prompts(cfg)[:ZOO_REQUESTS]
    with torch.inference_mode():
        reqs, _, launches, step_s = serve(torch, model, cfg, prompts, card, "serve moe")[:4]
        check = forward_greedy_check(torch, model, cfg, reqs, prompts, "serve moe", tie=None,
                                     mean_tol=MOE_LOGPROB_MEAN_TOL, agree_min=MOE_AGREE_MIN)
    del model, reqs
    gc.collect()
    torch.cuda.empty_cache()
    c32 = preset_config("mixtral-8x7b-v0.1", torch.float32, n_layers=MOE_EXACT_LAYERS)
    m32 = init_params(torch.Generator(device="cuda").manual_seed(0), c32)
    with torch.inference_mode():
        reqs, _, launches32 = serve(torch, m32, c32, prompts, card, "serve moe fp32")[:3]
        exact = forward_greedy_check(torch, m32, c32, reqs, prompts, "serve moe fp32",
                                     tie=FP32_TIE_GAP, mean_tol=FP32_TOL)
    return {"launches": {k: launches[k] + launches32[k] for k in ("flash_fwd", "decode")},
            "decode_step_ms": 1e3 * float(np.mean(step_s)), **check,
            "fp32": {k: exact[k] for k in ("differ", "gaps", "lp_mean", "lp_max")}}


def lora_train(torch, card):
    """(d) LoRA at Mistral-7B-v0.3 widths, full depth: rank LORA_RANK
    adapters on `lora.DEFAULT_TARGETS`, alpha LORA_ALPHA, LORA_STEPS AdamW
    + clip steps on the adapters alone at 2 x TRAIN_SEQ, remat, on one
    repeated batch (counts reset after a warm-up): finite, falling losses,
    the base bit for bit as it was; then the merged model serves
    LORA_REQUESTS prompts (contiguous), held by `forward_greedy_check`."""
    from fa2_triton_tpu_torch.examples.train import make_optimizer, optimizer_step, preset_config
    from fa2_triton_tpu_torch.models import init_params, llama, lora
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16, remat=True)
    base = init_params(torch.Generator(device="cuda").manual_seed(0), cfg).requires_grad_(False)
    before = {n: p.clone() for n, p in base.named_parameters()}
    adapters = lora.init_lora(torch.Generator(device="cuda").manual_seed(1), base, rank=LORA_RANK)
    opt = make_optimizer(adapters, LORA_LR)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, TRAIN_SEQ))).cuda()

    def loss_of():
        return lora.lora_loss_fn(base, adapters, tokens, llama.loss_fn, LORA_ALPHA)

    loss_of().backward()                    # warm-up, gradients dropped
    adapters.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s = [], []
    for _ in range(LORA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_of()
        loss.backward()
        optimizer_step(adapters, opt, LORA_LR, 1.0)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    launches = bwd_launches(flash_fwd, flash_bwd)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = all(torch.equal(p, before[n]) for n, p in base.named_parameters())
    n_adapt = sum(p.numel() for p in adapters.parameters())
    print(f"[lora] Mistral-7B-v0.3 widths, 32 layers, rank {LORA_RANK} on {lora.DEFAULT_TARGETS} "
          f"({n_adapt / 1e6:.2f} M adapter params), alpha {LORA_ALPHA}, AdamW(lr {LORA_LR}) + clip "
          f"1.0, {LORA_STEPS} steps of 2 x {TRAIN_SEQ}, remat, one repeated batch: losses "
          f"{[round(x, 4) for x in losses]}; step s {[round(x, 3) for x in step_s]}, "
          f"{tokens[:, 1:].numel() / np.median(step_s):.0f} tokens/s (median step), peak "
          f"{peak:.2f} GiB; base bit for bit unchanged: {same}; launches {launches} [{card}]")
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L * LORA_STEPS, "flash_bwd_dq": L * LORA_STEPS,
            "flash_bwd_dkdv": L * LORA_STEPS}
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and same
            and all(launches[key] == n for key, n in want.items())):
        raise AssertionError(f"(d) LoRA: losses {losses}, base unchanged {same}, launches "
                             f"{launches} (want {want})")
    del before, opt
    merged = lora.merged_model(base, adapters, LORA_ALPHA)
    prompts = served_prompts(cfg)[:LORA_REQUESTS]
    with torch.inference_mode():
        reqs, _, serve_launches = serve(torch, merged, cfg, prompts, card, "serve lora")[:3]
        check = forward_greedy_check(torch, merged, cfg, reqs, prompts, "serve lora")
    return {"launches": launches, "serve_launches": serve_launches, "losses": losses,
            "step_s": step_s, "peak_gib": peak, **check}


def wquant_serve(torch, card, model, cfg, prompts):
    """(e) Phase 3's model quantized (`quantize_model_params`, int8 and fp8
    weights): weight bytes against bf16; layer 0's `w_gate` qmatmul on 1024
    rows against x @ (values x scales) in fp32 within QMM_REL of each entry
    + QMM_SUM_TOL of its sum of |products|, timed beside the bf16 matmul;
    ZOO_REQUESTS of phase 3's requests served paged, held by
    `forward_greedy_check`."""
    from fa2_triton_tpu_torch.models import quantize_model_params
    from fa2_triton_tpu_torch.ops.quant import qmatmul

    bf16_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    x = torch.randn(1024, cfg.dim, generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda").to(torch.bfloat16)
    runs = {}
    for qname, short in (("int8", "int8"), ("float8_e4m3fn", "fp8")):
        qm = quantize_model_params(model, getattr(torch, qname))
        q_bytes = sum(t.numel() * t.element_size()
                      for t in itertools.chain(qm.parameters(), qm.buffers()))
        w = qm.layers[0].w_gate
        wf = w["qvalues"].float() * w["qscale"]
        ref = x.float() @ wf
        err = (qmatmul(x, w).float() - ref).abs()
        bound = QMM_REL * ref.abs() + QMM_SUM_TOL * (x.float().abs() @ wf.abs())
        worst = float((err / bound).max())
        del wf, ref, err, bound
        q_ms = cuda_ms(torch, lambda: qmatmul(x, w))
        b_ms = cuda_ms(torch, lambda: x @ model.layers[0].w_gate)
        print(f"[wquant {short}] weights {q_bytes / 1e9:.3f} GB against bf16 {bf16_bytes / 1e9:.3f} "
              f"GB; layer 0 w_gate qmatmul on 1024 x {cfg.dim}: worst error {worst:.3f} of its "
              f"bound, {q_ms:.3f} ms (bf16 matmul {b_ms:.3f} ms) [{card}]")
        if not worst <= 1.0:
            raise AssertionError(f"(e) {short} qmatmul off x @ (values x scales)")
        reqs, _, launches, step_s = serve(torch, qm, cfg, prompts[:ZOO_REQUESTS], card,
                                          f"serve wquant {short}")[:4]
        check = forward_greedy_check(torch, qm, cfg, reqs, prompts[:ZOO_REQUESTS],
                                     f"serve wquant {short}")
        runs[short] = {"launches": launches, "weight_gb": q_bytes / 1e9, "qmatmul_err": worst,
                       "qmatmul_ms": q_ms, "bf16_matmul_ms": b_ms,
                       "decode_step_ms": 1e3 * float(np.mean(step_s)), **check}
        del qm, w
        torch.cuda.empty_cache()
    runs["bf16_weight_gb"] = bf16_bytes / 1e9
    return runs


def phase_zoo(torch, card):
    """Phase 15 (a)-(d), after the served model is freed ((e) runs on it
    before): each part's results by name."""
    out = {}
    for name, part in (("moe_block", moe_block), ("moe_train", moe_train),
                       ("moe_serve", moe_serve), ("lora", lora_train)):
        out[name] = part(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def check_grad(torch, name, g, ref, plain, what):
    """The FA gradient contract for one gradient against the fp32 truth
    `ref`, with the low-precision plain twin's error as the yardstick."""
    err, yard = max_abs(torch, g, ref), max_abs(torch, plain, ref)
    ok = err <= GRAD_ERROR_MUL * yard + GRAD_ERROR_BIAS
    if not ok and name in ("dv", "dbias"):
        ok = float((g.float() - ref.float()).abs().sum()) < DV_SUM_WAIVER
    if not ok:
        raise AssertionError(f"{what} {name}: err {err:.3e} > 3 x plain err {yard:.3e} + 1e-5")
    return err, yard


def check_fp32_grad(torch, name, g, plain, what):
    err = max_abs(torch, g, plain)
    bound = FP32_GRAD_RTOL * (1.0 + float(plain.float().abs().max()))
    if not err <= bound:
        raise AssertionError(f"{what} {name}: fp32 err {err:.3e} > {bound:.3e}")
    return err


def profiled(torch, fn, iters, ok, attempts=3):
    """torch.profiler's key averages over `iters` calls of `fn` (after one
    more), recorded again, up to `attempts` windows, until `ok(events)`:
    late in this long process the profiler can drop every launch of a
    window (phase 14 (d)'s GPT-2 forward, 0 of 5, where CUDA events timed
    every call). Returns the last window's events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if ok(events):
            break
        print(f"[profiler] window {attempt + 1} of {attempts} recorded too few launches")
    return events


def _device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernel_ms(torch, fn, names, iters=5, stand_in=True):
    """Device time per launch of each named kernel (kernel names contain
    `names`; each launches once per call of `fn`), from torch.profiler over
    `iters` calls: the mean over the launches it recorded, printed with
    their count. In this long process it can miss a launch that ran (the
    packed forward with dropout: 4 of 5, while CUDA events time every call
    at one launch); `acc_events` does not bring it back. A window with no
    launch of some name is recorded again (`profiled`), up to 5 windows.
    Where all of them miss a name (the packed forward, 0 of 5 in 3
    windows, once), the whole call's CUDA-event time stands in for that
    kernel's, an upper bound of it, and the line says so; `stand_in=False`
    raises instead."""
    def counts(events):
        return {name: sum(e.count for e in events if name in e.key) for name in names}

    windows = 5
    events = profiled(torch, fn, iters, lambda ev: all(counts(ev).values()), attempts=windows)
    out = {}
    for name, n in counts(events).items():
        us = sum(_device_us(e) for e in events if name in e.key)
        if n == 0 and stand_in:
            out[name] = cuda_ms(torch, fn, iters=iters)
            print(f"[profiler] {name}: no launch recorded in {windows} windows of {iters} calls; "
                  f"the whole call's CUDA-event time {out[name]:.3f} ms stands in (an upper bound)")
            continue
        if not (us > 0 and 0 < n <= iters):
            raise AssertionError(f"the profiler recorded {n} launches of {name} in {iters} calls, "
                                 f"{us:.1f} us of device time")
        out[name] = us / n / 1e3
        print(f"[profiler] {name}: {out[name]:.3f} ms per launch over {n} of {iters} launches "
              f"recorded")
    return out


def attn_inputs(torch, gen, dev, S):
    B, Hq, Hkv, D = 2, 32, 8, 128
    q32 = torch.randn((B, S, Hq, D), generator=gen, device=dev) * 0.5
    k32 = torch.randn((B, S, Hkv, D), generator=gen, device=dev) * 0.5
    v32 = torch.randn((B, S, Hkv, D), generator=gen, device=dev) * 0.5
    do32 = torch.randn((B, S, Hq, D), generator=gen, device=dev)
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
    return q32, k32, v32, do32, lens


def phase_bwd_kernels(torch):
    """dq and dk/dv kernels vs the plain backward at the training shape
    (no padding, causal), fp32 and bf16; times at bf16."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    S, D = BWD_SEQ, 128
    bhsd = lambda x: x.transpose(1, 2)
    q32, k32, v32, do32, lens = (x if x.dtype == torch.int32 else bhsd(x)
                                 for x in attn_inputs(torch, gen, dev, S))
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(q32, k32, v32, lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(q32, k32, v32, do32, o32, lse32, lens, **kw)
    names = ("dq", "dk", "dv")
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
        o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
        grads = flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw)
        plains = flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, **kw)
        torch.cuda.synchronize()
        if dt == torch.float32:
            errs = {n: check_fp32_grad(torch, n, g, pl, "flash_bwd fp32")
                    for n, g, pl in zip(names, grads, plains)}
            rule = f"vs fp32 plain, <= {FP32_GRAD_RTOL} x (1 + max|grad|)"
        else:
            errs = {}
            for n, g, r, pl in zip(names, grads, refs, plains):
                errs[n], yard = check_grad(torch, n, g, r, pl, "flash_bwd bf16")
                errs[n + " plain"] = yard
            rule = "vs fp32 truth, FA gradient contract (<= 3 x plain bf16 err + 1e-5)"
        print(f"[bwd] B=2 Hq=32 Hkv=8 D={D} S={S} causal {str(dt)[6:]}: max abs errs "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" ({rule})")
    seq = [S, S]
    pairs = causal_pairs(seq)
    lib_fwd, _, lib_bwd = library_attention(torch, *(tight(torch, bhsd(x), seq) for x in (q, k, v)),
                                            seq, seq, True, kw["softmax_scale"])
    fwd_ms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw))
    fwd_pms = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw))
    fwd_bound = attn_bound("fwd", pairs, 2 * S, 32, 8, D, 2)
    print(f"[bwd] bf16 forward at the training shape (both rows full): kernel {fwd_ms:.3f} ms, "
          f"plain {fwd_pms:.3f} ms, library {cuda_ms(torch, lib_fwd):.3f} ms, bound "
          f"{fwd_bound['bound_ms']:.3f} ms ({fwd_bound['bound_by']})")
    run = lambda: flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw)
    split = kernel_ms(torch, run, ("dq_mma_kernel", "dkdv_mma_kernel"))
    ms = cuda_ms(torch, run, iters=5)
    pms = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse, lens, **kw),
                  iters=3, warmup=1)
    flops = 2 * 2 * 32 * (S * (S + 1) // 2) * D * 7   # 7 causal S x S x D products per head
    lib_run = lib_bwd(tight(torch, bhsd(do), seq))
    lib_errs = [check_library(torch, f"flash_bwd {n}", g, tight(torch, bhsd(r), seq), errs[n + " plain"])
                for n, g, r in zip(names, lib_run(), refs)]
    lib_ms = cuda_ms(torch, lib_run, iters=5)
    print(f"[bwd] library backward (aten varlen flash: dq, dk, dv in one call) {lib_ms:.3f} ms, "
          f"errs {', '.join(f'{e:.3e}' for e in lib_errs)}")
    out = {}
    for name, kernel, products in (("dq", "dq_mma_kernel", "dq"), ("dkdv", "dkdv_mma_kernel", "dkdv")):
        bound = attn_bound(products, pairs, 2 * S, 32, 8, D, 2)
        fma = float(FMA_DESIGN_MS[name])
        print(f"[bwd] {kernel} B 2 x S {S} bf16: {split[kernel]:.3f} ms (profiler; the FMA design: "
              f"{FMA_DESIGN_MS[name]} ms), bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
              f"{100 * bound['bound_ms'] / split[kernel]:.1f} % of the bound; library (the whole "
              f"aten backward) {lib_ms:.3f} ms")
        if not split[kernel] * 3 <= fma:
            raise AssertionError(f"{kernel} {split[kernel]:.3f} ms is not 3x faster than the FMA "
                                 f"design's {fma} ms")
        errs_of = (errs["dq"],) if name == "dq" else (errs["dk"], errs["dv"])
        out[f"flash_bwd_{name}"] = {"max_abs_err": max(errs_of), "ms": split[kernel],
                                    "plain_ms": pms, "library_ms": lib_ms, **bound}
    print(f"[bwd] bf16 backward {ms:.3f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s): dq kernel "
          f"{split['dq_mma_kernel']:.3f} ms, dk/dv kernel {split['dkdv_mma_kernel']:.3f} ms "
          f"(profiler); plain backward {pms:.3f} ms")
    return out


def phase_bias(torch):
    """The bias path through `flash_attn_func` at the training shape: a
    trainable per-head bias [1, 32, S, S] (ALiBi-style), bf16."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    S, D = BWD_SEQ, 128
    q32, k32, v32, do32, lens = attn_inputs(torch, gen, dev, S)
    b32 = torch.randn((1, 32, S, S), generator=gen, device=dev)
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in (q32, k32, v32, b32)]
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves[:3], attention_bias=leaves[3], causal=True, return_lse=True)
    out.backward(do32.to(torch.bfloat16))
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    print(f"[bias] flash_attn_func + backward with a trainable [1, 32, {S}, {S}] bias: launches {launches}")
    if any(n != 1 for n in launches.values()):
        raise AssertionError(f"the bias path did not launch every kernel once: {launches}")

    bhsd = lambda x: x.transpose(1, 2)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    q, k, v, b = (x.detach() for x in leaves)
    do = do32.to(torch.bfloat16)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens, 0, 0, b32, **kw)
    o_pl, _ = flash_fwd.flash_attn_forward_plain(bhsd(q), bhsd(k), bhsd(v), lens, 0, 0, b, **kw)
    out_err, pl_err = max_abs(torch, bhsd(out), o32), max_abs(torch, o_pl, o32)
    if not out_err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
        raise AssertionError(f"bias forward: err {out_err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
    refs = flash_bwd.flash_attn_backward_plain(
        bhsd(q32), bhsd(k32), bhsd(v32), bhsd(do32), o32, lse32, lens, 0, 0, b32,
        compute_dbias=True, **kw)
    plains = flash_bwd.flash_attn_backward_plain(
        bhsd(q), bhsd(k), bhsd(v), bhsd(do), bhsd(out.detach()), lse.detach(), lens, 0, 0, b,
        compute_dbias=True, **kw)
    grads = [bhsd(x.grad) for x in leaves[:3]] + [leaves[3].grad]
    errs = {}
    for n, g, r, pl in zip(("dq", "dk", "dv", "dbias"), grads, refs, plains):
        errs[n], _ = check_grad(torch, n, g, r, pl, "bias path")
    print(f"[bias] out err {out_err:.3e} (<= 2 x plain {pl_err:.3e} + 5e-5); grad errs vs fp32 "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (FA gradient contract)")
    args = (bhsd(q), bhsd(k), bhsd(v), bhsd(do), bhsd(out.detach()), lse.detach(), lens, 0, 0, b)
    run = lambda: flash_bwd.flash_attn_backward(*args, compute_dbias=True, **kw)
    split = kernel_ms(torch, run, ("dbias_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel"))
    pms = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(*args, compute_dbias=True, **kw),
                  iters=3, warmup=1)
    extra = {"library_ms": None, **dbias_bound(2, 32, 8, S, D)}
    share = check_dbias_ms(split["dbias_mma_kernel"], extra, "dbias", "bias")
    print(f"[bias] plain backward with dbias {pms:.3f} ms; library: none (no PyTorch call "
          f"computes a bias gradient alone); the dq and dk/dv kernels' bias instantiations "
          f"{split['dq_mma_kernel']:.3f} + {split['dkdv_mma_kernel']:.3f} ms")
    return launches, {"max_abs_err": errs["dbias"], "ms": split["dbias_mma_kernel"],
                      "plain_ms": pms, "bound_share_pct": share,
                      "pair_bias_ms": [split["dq_mma_kernel"], split["dkdv_mma_kernel"]], **extra}


def phase_train_grads(torch, what="train", preset="mistral-7b-v0.3", want=None, **overrides):
    """`preset`'s widths (Mistral-7B-v0.3's; its heads as `overrides` cut
    them), 2 layers, bf16: every parameter gradient of loss_fn through the
    kernels and through the plain attention (the fp32 oracle, output in
    bf16), both held to an fp32 plain run. `want`: the launches, the
    backward schedules' as "bwd_<name>" (default the dq + dk/dv pair's)."""
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import LlamaModel, init_params, loss_fn
    from fa2_triton_tpu_torch.ops import flash_attn_reference, flash_bwd, flash_fwd

    cfg = preset_config(preset, torch.bfloat16, n_layers=2, **overrides)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, TRAIN_SEQ))).cuda()

    def plain_attn(q, k, v):
        return flash_attn_reference(q, k, v, causal=True, softmax_scale=cfg.scale)

    def grads_of(m, attention_fn=None):
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, tokens, attention_fn)
        loss.backward()
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return loss.item(), grads

    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    loss_k, g_k = grads_of(model)
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES,
                **{f"bwd_{n}": c for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c}}
    want = want or {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkdv": 2, "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"2-layer loss_fn backward launches {launches} != {want}")
    loss_p, g_p = grads_of(model, plain_attn)
    m32 = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    m32.load_state_dict(model.state_dict())
    del model
    loss_32, g_32 = grads_of(m32, plain_attn)
    del m32
    worst, worst_name = 0.0, None
    for name in g_32:
        err, yard = check_grad(torch, name, g_k[name], g_32[name], g_p[name], "2-layer grads")
        ratio = err / (GRAD_ERROR_MUL * yard + GRAD_ERROR_BIAS)
        if ratio >= worst:
            worst, worst_name = ratio, name
    print(f"[{what}] {preset} widths, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.hd}, 2 layers, bf16, batch 2 x {TRAIN_SEQ}: loss kernels "
          f"{loss_k:.5f}, plain {loss_p:.5f}, fp32 {loss_32:.5f}; all {len(g_32)} parameter "
          f"gradients within the FA contract vs fp32 (worst {worst_name}: {worst:.2f} of the bound); "
          f"launches {launches}")


def run_trainer(torch, card: str, argv, reset, tag: str, on_grads=None):
    """Full-depth training steps through `examples/train.py` with the launch
    counts reset (`reset`) after its warm-up (`on_grads` sees its
    gradients): every loss finite and the last below the first. Returns (the
    parsed args, train.run's result)."""
    from fa2_triton_tpu_torch.examples import train

    args = train.parse_args(argv)
    res = train.run(args, on_warm=reset, on_grads=on_grads)
    cfg, losses = res["config"], res["losses"]
    print(f"[{tag}] {args.config} widths, {cfg.n_layers} layers, {res['n_params'] / 1e9:.2f} B "
          f"params bf16, remat, AdamW(lr {args.lr}, wd 0.01) + clip {args.grad_clip}, {args.steps} "
          f"steps of {args.batch} x {args.seq} on one repeated batch: losses "
          f"{[round(x, 4) for x in losses]}; step s {[round(x, 3) for x in res['step_s']]}, "
          f"{res['tokens_per_s']:.0f} tokens/s (median step), peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite or not falling: {losses}")
    return args, res


def phase_train(torch, card: str):
    """Full-depth training steps through `examples/train.py`."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    def reset():
        flash_fwd.LAUNCHES = 0
        flash_bwd.reset_launches()

    args, res = run_trainer(torch, card, TRAIN_ARGV, reset, "train")
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    L, steps = res["config"].n_layers, args.steps
    print(f"[train] launches: {launches}")
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want} (layers x steps, x2 for remat)")
    return launches


def varlen_docs():
    """Document lengths of the packed batch (see VARLEN_DOC_RANGE)."""
    rng = np.random.default_rng(0)
    lens, T = [], 0
    while True:
        n = int(np.exp(rng.uniform(*np.log(VARLEN_DOC_RANGE))))
        ext = -(-n // VARLEN_BLOCK) * VARLEN_BLOCK
        if T + ext > VARLEN_T_MAX:
            return lens
        lens.append(n)
        T += ext


def blocksparse_mask():
    """Block (i, j) is kept when i - BS_BAND <= j <= i, or j = 0."""
    n = BS_SEQ // VARLEN_BLOCK
    i, j = np.arange(n)[:, None], np.arange(n)[None]
    return ((j >= i - BS_BAND) & (j <= i)) | (j == 0)


def check_packed_path(torch, what, inputs, grads, out, lse, do32, packed32, seg, keep_block, live,
                      **drop):
    """The kernels' output, lse and gradients of one packed run against the
    plain twins: the fp32 truth and the bf16 plain yardstick (FA rules),
    and exact zeros at the dead positions. The bf16 `inputs` (q, k, v),
    their `grads`, `out` and the fp32 `packed32` / `do32` are [1, T, H, D],
    lse [1, Hq, T]; `seg` is (starts, lens); `drop` the dropout arguments
    of the run. Returns the errors, the fp32 output and the fp32 gradients."""
    from fa2_triton_tpu_torch.ops import varlen

    bhsd = lambda x: x.transpose(1, 2)
    pkw = dict(causal=True, softmax_scale=inputs[0].shape[-1] ** -0.5, block_q=VARLEN_BLOCK,
               block_kv=VARLEN_BLOCK, keep_block=keep_block, **drop)
    args = (seg[0], seg[1], seg[1])
    with torch.no_grad():
        q32, k32, v32 = (bhsd(x) for x in packed32)
        o32, lse32 = varlen.flash_attn_varlen_forward_plain(q32, k32, v32, *args, **pkw)
        refs = varlen.flash_attn_varlen_backward_plain(q32, k32, v32, bhsd(do32), o32, lse32,
                                                       *args, **pkw)
        del q32, k32, v32
        q, k, v, do = (bhsd(x) for x in (*inputs, do32.to(torch.bfloat16)))
        o_pl, lse_pl = varlen.flash_attn_varlen_forward_plain(q, k, v, *args, **pkw)
        plains = varlen.flash_attn_varlen_backward_plain(q, k, v, do, o_pl, lse_pl, *args, **pkw)
    err, pl_err = max_abs(torch, bhsd(out), o32), max_abs(torch, o_pl, o32)
    if not err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
        raise AssertionError(f"{what} forward: err {err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
    lse_err = check_lse(torch, lse, lse_pl, what)
    errs = {"o": err, "o plain": pl_err, "lse": lse_err}
    for n, g, r, pl in zip(("dq", "dk", "dv"), (bhsd(x) for x in grads), refs, plains):
        errs[n], errs[n + " plain"] = check_grad(torch, n, g, r, pl, what)
    dead = ~live
    if out[0, dead].any() or not torch.all(lse[0][:, dead] == float("-inf")):
        raise AssertionError(f"{what}: dead positions hold a nonzero output or a finite lse")
    if any(g[0, dead].any() for g in grads):
        raise AssertionError(f"{what}: dead positions hold a nonzero gradient")
    print(f"[{what}] max abs errs vs fp32 plain: " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + " (FA rules; lse vs the bf16 plain twin); dead positions exactly 0")
    return errs, o32, refs


# The packed kernels' names in the profiler for bf16 inputs: the tensor-core
# forward, dq and dk/dv (fp32 inputs keep the FMA varlen_fwd_kernel /
# varlen_dq_kernel / varlen_dkdv_kernel).
VARLEN_KERNEL_NAMES = {"varlen_fwd": "varlen_mma_fwd_kernel", "varlen_dq": "varlen_mma_dq_kernel",
                       "varlen_dkdv": "varlen_mma_dkdv_kernel"}


def time_packed_kernels(torch, inputs, do, seg, keep_block, **drop):
    """Device time of each varlen kernel (profiler, keyed by the names of
    VARLEN_KERNEL_NAMES), the whole wrapper calls (CUDA events, host work
    lists included) and the plain twins, bf16."""
    from fa2_triton_tpu_torch.ops import varlen

    bhsd = lambda x: x.transpose(1, 2)
    pkw = dict(causal=True, softmax_scale=inputs[0].shape[-1] ** -0.5, block_q=VARLEN_BLOCK,
               block_kv=VARLEN_BLOCK, keep_block=keep_block, **drop)
    args = (seg[0], seg[1], seg[1])
    q, k, v, do = (bhsd(x) for x in (*inputs, do))
    with torch.no_grad():
        o, lse = varlen.flash_attn_varlen_forward(q, k, v, *args, **pkw)
        fwd = lambda: varlen.flash_attn_varlen_forward(q, k, v, *args, **pkw)
        bwd = lambda: varlen.flash_attn_varlen_backward(q, k, v, do, o, lse, *args, **pkw)
        t = kernel_ms(torch, fwd, (VARLEN_KERNEL_NAMES["varlen_fwd"],))
        t.update(kernel_ms(torch, bwd, (VARLEN_KERNEL_NAMES["varlen_dq"],
                                        VARLEN_KERNEL_NAMES["varlen_dkdv"])))
        t["fwd call"], t["bwd call"] = cuda_ms(torch, fwd, iters=5), cuda_ms(torch, bwd, iters=5)
        t["plain fwd"] = cuda_ms(torch, lambda: varlen.flash_attn_varlen_forward_plain(
            q, k, v, *args, **pkw), iters=2, warmup=1)
        t["plain bwd"] = cuda_ms(torch, lambda: varlen.flash_attn_varlen_backward_plain(
            q, k, v, do, o, lse, *args, **pkw), iters=2, warmup=1)
    return t


def varlen_entries(t, errs, lib, pairs, tokens, Hq=32, Hkv=8, D=128):
    """The kernels-line entries of the three varlen kernels, each with its
    share of the bound and its time over the library's (the whole backward
    for dq and dk/dv; None where the library has no time)."""
    b = lambda kernel: attn_bound(kernel, pairs, tokens, Hq, Hkv, D, 2)
    out = {
        "varlen_fwd": {"max_abs_err": errs["o"], "plain_ms": t["plain fwd"],
                       "library_ms": lib["fwd"], **b("fwd")},
        "varlen_dq": {"max_abs_err": errs["dq"], "plain_ms": t["plain bwd"],
                      "library_ms": lib["bwd"], **b("dq")},
        "varlen_dkdv": {"max_abs_err": max(errs["dk"], errs["dv"]), "plain_ms": t["plain bwd"],
                        "library_ms": lib["bwd"], **b("dkdv")},
    }
    for name, e in out.items():
        e["ms"] = ms = t[VARLEN_KERNEL_NAMES[name]]
        e["kernel"] = VARLEN_KERNEL_NAMES[name]
        e["bound_share"] = e["bound_ms"] / ms
        e["over_library"] = ms / e["library_ms"] if e["library_ms"] else None
    return out


def print_packed_times(what, t, lib, entries):
    bwd = entries["varlen_dq"]["ms"] + entries["varlen_dkdv"]["ms"]
    print(f"[{what}] bf16 kernels (profiler): " + ", ".join(
        f"{e['kernel']} {e['ms']:.3f} ms (bound {e['bound_ms']:.3f} ms, {e['bound_by']}: "
        f"{100 * e['bound_share']:.1f} % of it; {e['over_library']:.2f}x the library)"
        for e in entries.values())
        + f"; dq + dk/dv {bwd:.3f} ms = {bwd / lib['bwd']:.2f}x the library's whole backward"
        + f"; whole calls (CUDA events, host work lists included): forward {t['fwd call']:.3f} ms, "
          f"backward {t['bwd call']:.3f} ms; plain forward {t['plain fwd']:.3f} ms, plain backward "
          f"{t['plain bwd']:.3f} ms; library ({lib['name']}) forward {lib['fwd']:.3f} ms, "
          f"backward {lib['bwd']:.3f} ms")


def beats_packed_fma(what, entries):
    """Fail unless the packed tensor-core kernels (forward, dq, dk/dv) are
    VARLEN_SPEEDUP times faster than their FMA design at this phase's shape
    (the log line gives both)."""
    for name in VARLEN_KERNEL_NAMES:
        key = f"{what}_{name.split('_')[1]}"
        print(f"[{what}] {VARLEN_KERNEL_NAMES[name]}: {entries[name]['ms']:.3f} ms (the FMA design: "
              f"{FMA_DESIGN_MS[key]} ms, to beat {VARLEN_SPEEDUP}x)")
        beats_fma_design(key, [entries[name]["ms"]], by=VARLEN_SPEEDUP)


def launch_table_ms(torch, starts, lens, T, Hq, Hkv, reps=3):
    """Host ms of the packed layout's q-major launch table (the forward's,
    which dq takes) and of the kv-major one (dk/dv's), each built `reps`
    times: `_build_schedule`, the row pointer, `_tile_order` and the copy
    to the card, synchronized."""
    from fa2_triton_tpu_torch.ops import varlen

    blk, dev = VARLEN_BLOCK, torch.device("cuda")
    segs = varlen._segments(starts, T, lens, lens, blk, blk)
    out = {}
    for name, kv_major in (("q-major", False), ("kv-major", True)):
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            varlen._launch_table(segs, blk, blk, True, None, T, dev, kv_major=kv_major,
                                 group=Hq // Hkv if kv_major else 1, order=True)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[name] = runs
    return out


def phase_varlen(torch, card: str):
    """Packed varlen at Mistral-7B-v0.3 attention widths: the documents of
    `varlen_docs` packed with `pack_padded_batch`, forward and backward
    through `flash_attn_varlen_func` (launch counts reset just before),
    checked, timed, and compared with the same documents right-padded to
    [n_docs, 4096] through `flash_attn_func(attention_mask=...)`."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, varlen

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    lens = varlen_docs()
    n, S_pad, Hq, Hkv, D, blk = len(lens), VARLEN_DOC_RANGE[1], 32, 8, 128, VARLEN_BLOCK
    padded = [torch.randn((n, S_pad, h, D), generator=gen, device=dev) * sd
              for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    packed32, starts, T = varlen.pack_padded_batch(padded, lens, align=blk)
    starts = [int(s) for s in starts]
    cu = starts + [T]
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, l in zip(starts, lens):
        live[s0:s0 + l] = True
    bf = lambda x: x.to(torch.bfloat16)
    leaves = [bf(x).requires_grad_() for x in packed32[:3]]
    do = bf(packed32[3])
    print(f"[varlen] {n} documents, lengths {lens} (log-uniform in {VARLEN_DOC_RANGE}, seed 0): "
          f"{sum(lens)} tokens packed into T = {T} (starts aligned to {blk}); Hq {Hq}, Hkv {Hkv}, "
          f"D {D}, bf16, causal, block_q = block_kv = {blk}")

    varlen.reset_launches()
    out, lse = varlen.flash_attn_varlen_func(*leaves, cu, seqlens=lens, causal=True, block_q=blk,
                                             block_kv=blk, return_lse=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[varlen] flash_attn_varlen_func + backward: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"the packed path did not launch each varlen kernel once: {launches}")
    inputs = [x.detach() for x in leaves]
    errs, o32, refs = check_packed_path(torch, "varlen", inputs, [x.grad for x in leaves], out, lse,
                                        packed32[3], packed32[:3], (starts, lens), None, live)
    del out, lse
    t = time_packed_kernels(torch, inputs, do, (starts, lens), None)

    # Library yardstick: PyTorch's varlen flash attention on the same
    # documents packed back to back.
    tq, tk, tv, tdo = (tight(torch, bf(x), lens) for x in padded)
    lib_fwd, lib_out, lib_bwd = library_attention(torch, tq, tk, tv, lens, lens, True, D ** -0.5)
    live_rows = lambda x: x.transpose(1, 2)[0][live]      # [1, H, T, D] -> [sum(lens), H, D]
    check_library(torch, "varlen fwd", lib_out[0], live_rows(o32), errs["o plain"])
    lib_run = lib_bwd(tdo)
    for name, g, r in zip(("dq", "dk", "dv"), lib_run(), refs):
        check_library(torch, f"varlen {name}", g, live_rows(r), errs[name + " plain"])
    lib = {"name": "aten varlen flash attention", "fwd": cuda_ms(torch, lib_fwd),
           "bwd": cuda_ms(torch, lib_run, iters=5)}
    del tq, tk, tv, tdo, lib_out, o32, refs
    entries = varlen_entries(t, errs, lib, causal_pairs(lens), sum(lens))
    print_packed_times("varlen", t, lib, entries)
    beats_packed_fma("varlen", entries)
    tables = launch_table_ms(torch, starts, lens, T, Hq, Hkv)
    print(f"[varlen] host launch tables (host clock, 3 builds each): q-major (the forward's, "
          f"which dq takes) {' / '.join(f'{x:.3f}' for x in tables['q-major'])} ms, kv-major "
          f"(dk/dv's, built in the backward) {' / '.join(f'{x:.3f}' for x in tables['kv-major'])} ms")
    entries["varlen_fwd"]["host_table_ms"] = tables["q-major"]
    entries["varlen_dkdv"]["host_table_ms"] = tables["kv-major"]

    # The same documents right-padded to [n_docs, S_pad] through the dense
    # kernels with a padding mask: what packing saves (bench.py --mode varlen).
    mask = torch.arange(S_pad, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
    pad_leaves = [bf(x).requires_grad_() for x in padded[:3]]
    pad_do = bf(padded[3])
    del padded

    def padded_step():
        o = flash_attn_func(*pad_leaves, attention_mask=mask, causal=True)
        torch.autograd.grad(o, pad_leaves, pad_do)

    def packed_step():
        o = varlen.flash_attn_varlen_func(*leaves, cu, seqlens=lens, causal=True, block_q=blk,
                                          block_kv=blk)
        torch.autograd.grad(o, leaves, do)

    pad_ms, pack_ms = cuda_ms(torch, padded_step, iters=3), cuda_ms(torch, packed_step, iters=3)
    pad_ms2, pack_ms2 = cuda_ms(torch, padded_step, iters=3), cuda_ms(torch, packed_step, iters=3)
    print(f"[varlen] forward + backward, bf16 [{card}]: packed (T = {T}) {pack_ms:.3f} / "
          f"{pack_ms2:.3f} ms vs right-padded [{n}, {S_pad}] through flash_attn_func "
          f"{pad_ms:.3f} / {pad_ms2:.3f} ms: padded / packed = {pad_ms / pack_ms:.2f} / "
          f"{pad_ms2 / pack_ms2:.2f}")
    return launches, entries


def phase_blocksparse(torch):
    """Block-sparse attention at Mistral-7B-v0.3 attention widths: a local
    band plus an attention sink, through `flash_attn_blocksparse_func`
    (launch counts reset just before), checked and timed like phase_varlen;
    the library yardstick is flex_attention (compiled) with the same
    block mask."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from fa2_triton_tpu_torch.ops import varlen

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S, Hq, Hkv, D, blk = BS_BATCH, BS_SEQ, 32, 8, 128, VARLEN_BLOCK
    mask = blocksparse_mask()
    x32 = [torch.randn((B, S, h, D), generator=gen, device=dev) * sd
           for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    bf = lambda x: x.to(torch.bfloat16)
    leaves = [bf(x).requires_grad_() for x in x32[:3]]
    do = bf(x32[3])
    n_kept = int(np.tril(mask).sum())
    print(f"[blocksparse] B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, causal, block {blk}: "
          f"band of {BS_BAND} blocks below the diagonal + column 0, {n_kept} of "
          f"{mask.shape[0] * (mask.shape[0] + 1) // 2} causal blocks kept")

    varlen.reset_launches()
    out, lse = varlen.flash_attn_blocksparse_func(*leaves, mask, causal=True, block_q=blk,
                                                  block_kv=blk, return_lse=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[blocksparse] flash_attn_blocksparse_func + backward: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"the block-sparse path did not launch each kernel once: {launches}")

    # The packed view the entry point hands the kernels: [1, B * S, H, D].
    flat = lambda x: x.reshape(1, B * S, *x.shape[2:])
    seg = ([b * S for b in range(B)], [S] * B)
    keep = varlen._mask_keep_fn(varlen.encode_block_mask(mask))
    inputs = [flat(x.detach()) for x in leaves]
    lse_packed = lse.transpose(0, 1).reshape(1, Hq, B * S)
    errs, o32, refs = check_packed_path(
        torch, "blocksparse", inputs, [flat(x.grad) for x in leaves], flat(out), lse_packed,
        flat(x32[3]), [flat(x) for x in x32[:3]], seg, keep,
        torch.ones(B * S, dtype=torch.bool, device=dev))
    del out, lse
    t = time_packed_kernels(torch, inputs, flat(do), seg, keep)

    def mask_mod(b, h, qi, ki):
        return (ki <= qi) & ((qi // blk - ki // blk <= BS_BAND) | (ki < blk))

    block_mask = create_block_mask(mask_mod, None, None, S, S, device=dev, BLOCK_SIZE=blk)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in leaves)
    doh = do.transpose(1, 2).contiguous()
    t0 = time.perf_counter()
    lib_o = flex(qh, kh, vh, block_mask=block_mask, scale=D ** -0.5, enable_gqa=True)
    lib_grads = torch.autograd.grad(lib_o, (qh, kh, vh), doh, retain_graph=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    bhsd_flat = lambda x: x.transpose(1, 2).reshape(1, B * S, *x.shape[1:2], D).transpose(1, 2)
    check_library(torch, "blocksparse fwd", bhsd_flat(lib_o), o32, errs["o plain"])
    for name, g, r in zip(("dq", "dk", "dv"), lib_grads, refs):
        check_library(torch, f"blocksparse {name}", bhsd_flat(g), r, errs[name + " plain"])
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(torch, lambda: flex(qh, kh, vh, block_mask=block_mask,
                                                 scale=D ** -0.5, enable_gqa=True), iters=5)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(lib_o, (qh, kh, vh), doh,
                                                            retain_graph=True), iters=5)
    lib = {"name": f"flex_attention with the block mask, compiled in {compile_s:.1f} s",
           "fwd": lib_fwd_ms, "bwd": lib_bwd_ms}
    pairs = B * sum(blk * blk if j < i else blk * (blk + 1) // 2
                    for i in range(mask.shape[0]) for j in range(i + 1) if mask[i, j])
    entries = varlen_entries(t, errs, lib, pairs, B * S)
    print_packed_times("blocksparse", t, lib, entries)
    beats_packed_fma("blocksparse", entries)
    return launches, entries


# Phase 10: attention dropout at Mistral-7B-v0.3 attention widths (bf16).
DROPOUT_P = 0.1
DROPOUT_SEED = 1234567
# The drop share over the 2 x 32 x 2048^2 mask grid: the binomial sigma is
# sqrt(p (1 - p) / n) = 1.8e-5 at p = 0.1, so 1e-4 is ~5.5 sigma.
DROP_SHARE_TOL = 1e-4
# The dense probes sit at q_off 37 / kv_off 11 of sequences whose real
# lengths (the dropout counter's) are 4096.
PROBE_Q_OFF, PROBE_KV_OFF, PROBE_REAL = 37, 11, 4096
LAYER_STEPS = 3


def dropout_probes(torch, dev):
    """Every kernel's applied mask read by `utils/mask_probes.py`, held to
    the rng mask bit for bit, at D 64 / 128 / 256 and GQA groups 1 and 4."""
    from fa2_triton_tpu_torch.utils import mask_probes

    worst, bits = 0.0, 0
    for D in (64, 128, 256):
        for G in (1, 4):
            got = mask_probes.dense_probes(
                2, 8, 8 // G, D, DROPOUT_P, DROPOUT_SEED + D + G, device=dev, q_off=PROBE_Q_OFF,
                kv_off=PROBE_KV_OFF, seqlen_q_real=PROBE_REAL, seqlen_k_real=PROBE_REAL)
            got.update(mask_probes.packed_probes(8, 8 // G, D, DROPOUT_P, -DROPOUT_SEED - D - G,
                                                 device=dev))
            for name, (read, want, resid) in got.items():
                if not torch.equal(read, want):
                    raise AssertionError(f"dropout probe {name} D={D} G={G}: "
                                         f"{int((read != want).sum())} bits differ from the rng mask")
                if not resid <= mask_probes.RESIDUAL_TOL:
                    raise AssertionError(f"dropout probe {name} D={D} G={G}: residual {resid:.3e} > "
                                         f"{mask_probes.RESIDUAL_TOL} (the mask is right, its scale not)")
                worst, bits = max(worst, resid), bits + read.numel()
    print(f"[dropout] mask probes (fwd, dq, dk/dv, dbias at q_off {PROBE_Q_OFF} / kv_off "
          f"{PROBE_KV_OFF} of real lengths {PROBE_REAL}; varlen fwd, dq, dk/dv on 3 documents at "
          f"packed offsets; D 64/128/256 x GQA group 1/4; B 2, 8 q heads; bf16): {bits} bits equal "
          f"to utils/rng.py's mask, largest residual {worst:.2e} (tol {mask_probes.RESIDUAL_TOL})")


def dense_dropout(torch, card):
    """flash_attn_func(causal, dropout) forward + backward at B 2 x S 2048,
    32 / 8 heads, D 128, bf16: launches, errors against the fp32 oracle fed
    the same mask (FA rules, the bf16 plain twin as yardstick), the drop
    share, determinism in the seed, the bias path with dropout, and times
    with and without dropout."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_attn_reference, flash_bwd, flash_fwd
    from fa2_triton_tpu_torch.utils import dropout_keep_mask_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    S, D, Hq, Hkv, B = TRAIN_SEQ, 128, 32, 8, 2
    scale = D ** -0.5
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    q32, k32, v32, do32, lens = attn_inputs(torch, gen, dev, S)
    bf = lambda x: x.to(torch.bfloat16)
    bhsd = lambda x: x.transpose(1, 2)
    leaves = [bf(x).requires_grad_() for x in (q32, k32, v32)]
    do = bf(do32)
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True, **drop)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    print(f"[dropout] flash_attn_func(causal, dropout_p {DROPOUT_P}, seed {DROPOUT_SEED}) + backward, "
          f"B {B} x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16: launches {launches}")
    if launches != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}:
        raise AssertionError(f"the dropout path did not launch each kernel once: {launches}")

    keep = dropout_keep_mask_reference(DROPOUT_SEED, DROPOUT_P, B, Hq, S, S, device=dev)
    share = 1.0 - float(keep.float().mean())
    print(f"[dropout] drop share over the {keep.numel()} elements of the mask grid: {share:.7f} "
          f"(p {DROPOUT_P}, tol {DROP_SHARE_TOL})")
    if not abs(share - DROPOUT_P) <= DROP_SHARE_TOL:
        raise AssertionError(f"drop share {share} is not within {DROP_SHARE_TOL} of p")
    ref_leaves = [x.clone().requires_grad_() for x in (q32, k32, v32)]
    o_ref = flash_attn_reference(*ref_leaves, causal=True, dropout_p=DROPOUT_P, dropout_mask=keep)
    o_ref.backward(do32)
    refs = [x.grad for x in ref_leaves]
    del keep, ref_leaves
    kw = dict(causal=True, softmax_scale=scale, **drop)
    q, k, v = (bhsd(x.detach()) for x in leaves)
    with torch.no_grad():
        o_pl, _ = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
        plains = flash_bwd.flash_attn_backward_plain(q, k, v, bhsd(do), bhsd(out.detach()),
                                                     lse.detach(), lens, **kw)
    out_err, pl_err = max_abs(torch, out, o_ref), max_abs(torch, bhsd(o_pl), o_ref)
    if not out_err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
        raise AssertionError(f"dropout forward: err {out_err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
    errs = {"o": out_err, "o plain": pl_err}
    for n, x, r, pl in zip(("dq", "dk", "dv"), leaves, refs, plains):
        errs[n], errs[n + " plain"] = check_grad(torch, n, x.grad, r, bhsd(pl), "dropout")
    print("[dropout] errors vs the fp32 oracle (flash_attn_reference, dropout_mask = the rng mask): "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + " (FA rules)")
    del o_ref, refs, plains, o_pl

    def run(seed):
        ls = [x.detach().requires_grad_() for x in leaves]
        o = flash_attn_func(*ls, causal=True, dropout_p=DROPOUT_P, dropout_seed=seed)
        o.backward(do)
        return [o.detach()] + [x.grad for x in ls]

    first = [out.detach()] + [x.grad for x in leaves]
    again, other = run(DROPOUT_SEED), run(DROPOUT_SEED + 1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("dropout: the same seed gave different o / dq / dk / dv")
    if any(torch.equal(a, b) for a, b in zip(first, other)):
        raise AssertionError("dropout: seed + 1 left o, dq, dk or dv unchanged")
    print("[dropout] the same seed gives bitwise-equal o, dq, dk, dv; seed + 1 changes each")
    del again, other

    # Times: no dropout, dropout, dropout, no dropout, in turns.
    with torch.no_grad():
        o_nd, lse_nd = flash_fwd.flash_attn_forward(q, k, v, lens, causal=True, softmax_scale=scale)
        o_d, lse_d = flash_fwd.flash_attn_forward(q, k, v, lens, **kw)
        fwd = {False: lambda: flash_fwd.flash_attn_forward(q, k, v, lens, causal=True,
                                                           softmax_scale=scale),
               True: lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw)}
        bwd = {False: lambda: flash_bwd.flash_attn_backward(q, k, v, bhsd(do), o_nd, lse_nd, lens,
                                                            causal=True, softmax_scale=scale),
               True: lambda: flash_bwd.flash_attn_backward(q, k, v, bhsd(do), o_d, lse_d, lens, **kw)}
        t = {False: [], True: []}
        for d in (False, True, True, False):
            t[d].append({"fwd": cuda_ms(torch, fwd[d]),
                         **kernel_ms(torch, bwd[d], ("dq_mma_kernel", "dkdv_mma_kernel"))})
        plain_fwd = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw),
                            iters=2, warmup=1)
        plain_bwd = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(
            q, k, v, bhsd(do), o_d, lse_d, lens, **kw), iters=2, warmup=1)
    seq = [S, S]
    lib = {}
    for name, dp in (("no dropout", 0.0), ("dropout", DROPOUT_P)):
        lib_fwd, _, lib_bwd = library_attention(torch, *(tight(torch, bhsd(x), seq) for x in (q, k, v)),
                                                seq, seq, True, scale, dropout_p=dp)
        lib[name] = (cuda_ms(torch, lib_fwd), cuda_ms(torch, lib_bwd(tight(torch, do, seq)), iters=5))
    pairs = causal_pairs(seq)
    mean = lambda d, n: sum(x[n] for x in t[d]) / len(t[d])
    for n, label in (("fwd", "forward"), ("dq_mma_kernel", "dq"), ("dkdv_mma_kernel", "dk/dv")):
        print(f"[dropout] {label} kernel at S {S} [{card}]: no dropout "
              f"{' / '.join(f'{x[n]:.3f}' for x in t[False])} ms, dropout "
              f"{' / '.join(f'{x[n]:.3f}' for x in t[True])} ms "
              f"({100 * (mean(True, n) / mean(False, n) - 1):+.1f} %)")
    print(f"[dropout] plain twins with dropout: forward {plain_fwd:.3f} ms, backward {plain_bwd:.3f} ms; "
          f"library (aten varlen flash, its own Philox mask): forward {lib['no dropout'][0]:.3f} ms "
          f"-> {lib['dropout'][0]:.3f} ms with dropout, backward {lib['no dropout'][1]:.3f} -> "
          f"{lib['dropout'][1]:.3f} ms")
    entries = {}
    for name, n, kernel, err in (("flash_fwd_dropout", "fwd", "fwd", errs["o"]),
                                 ("flash_bwd_dropout_dq", "dq_mma_kernel", "dq", errs["dq"]),
                                 ("flash_bwd_dropout_dkdv", "dkdv_mma_kernel", "dkdv",
                                  max(errs["dk"], errs["dv"]))):
        entries[name] = {
            "max_abs_err": err, "ms": t[True][0][n], "ms_runs": [x[n] for x in t[True]],
            "ms_without_dropout": [x[n] for x in t[False]],
            "plain_ms": plain_fwd if n == "fwd" else plain_bwd,
            "library_ms": lib["dropout"][0 if n == "fwd" else 1],
            **attn_bound(kernel, pairs, 2 * S, Hq, Hkv, D, 2)}
    del q, k, v, o_nd, o_d, lse_nd, lse_d, first, out, lse

    # The bias path with dropout: the dbias kernel regenerates the mask.
    b32 = torch.randn((1, Hq, S, S), generator=gen, device=dev)
    leaves = [bf(x).requires_grad_() for x in (q32, k32, v32, b32)]
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves[:3], attention_bias=leaves[3], causal=True, return_lse=True,
                               **drop)
    out.backward(do)
    torch.cuda.synchronize()
    bias_launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    if any(n != 1 for n in bias_launches.values()):
        raise AssertionError(f"the bias + dropout path did not launch every kernel once: {bias_launches}")
    with torch.no_grad():
        o32, lse32 = flash_fwd.flash_attn_forward_plain(bhsd(q32), bhsd(k32), bhsd(v32), lens, 0, 0,
                                                        b32, **kw)
        refs = flash_bwd.flash_attn_backward_plain(bhsd(q32), bhsd(k32), bhsd(v32), bhsd(do32), o32,
                                                   lse32, lens, 0, 0, b32, compute_dbias=True, **kw)
        del o32, lse32
        qb, kb, vb, bb = (x.detach() for x in leaves)
        args = (bhsd(qb), bhsd(kb), bhsd(vb), bhsd(do), bhsd(out.detach()), lse.detach(), lens, 0, 0, bb)
        plains = flash_bwd.flash_attn_backward_plain(*args, compute_dbias=True, **kw)
    grads = [bhsd(x.grad) for x in leaves[:3]] + [leaves[3].grad]
    berrs = {n: check_grad(torch, n, g, r, pl, "bias + dropout")[0]
             for n, g, r, pl in zip(("dq", "dk", "dv", "dbias"), grads, refs, plains)}
    del refs, plains, grads
    split = kernel_ms(torch, lambda: flash_bwd.flash_attn_backward(*args, compute_dbias=True, **kw),
                      ("dbias_mma_kernel",))
    print(f"[dropout] bias path (a trainable [1, {Hq}, {S}, {S}] bias) with dropout: launches "
          f"{bias_launches}; grad errs vs the fp32 plain twin " + ", ".join(
              f"{n} {e:.3e}" for n, e in berrs.items()) + " (FA gradient contract)")
    bound = dbias_bound(B, Hq, Hkv, S, D)
    share = check_dbias_ms(split["dbias_mma_kernel"], bound, "dbias_dropout", "dropout")
    entries["flash_bwd_dbias_dropout"] = {"max_abs_err": berrs["dbias"],
                                          "ms": split["dbias_mma_kernel"],
                                          "bound_share_pct": share, **bound}
    return {"flash_attn_func": launches, "bias path": bias_launches}, entries


def packed_dropout(torch, card):
    """Phase 8's packed batch through flash_attn_varlen_func with dropout:
    launches, FA rules against the plain twins with the same seed, dead
    positions exactly 0, times with and without dropout, and each
    tensor-core kernel VARLEN_SPEEDUP times faster than its FMA design with
    dropout."""
    from fa2_triton_tpu_torch.ops import varlen

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    lens = varlen_docs()
    n, S_pad, Hq, Hkv, D, blk = len(lens), VARLEN_DOC_RANGE[1], 32, 8, 128, VARLEN_BLOCK
    padded = [torch.randn((n, S_pad, h, D), generator=gen, device=dev) * sd
              for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    packed32, starts, T = varlen.pack_padded_batch(padded, lens, align=blk)
    starts = [int(s) for s in starts]
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, l in zip(starts, lens):
        live[s0:s0 + l] = True
    bf = lambda x: x.to(torch.bfloat16)
    leaves = [bf(x).requires_grad_() for x in packed32[:3]]
    do = bf(packed32[3])
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    varlen.reset_launches()
    out, lse = varlen.flash_attn_varlen_func(*leaves, starts + [T], seqlens=lens, causal=True,
                                             block_q=blk, block_kv=blk, return_lse=True, **drop)
    out.backward(do)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[dropout varlen] phase 8's {n} documents (T = {T}) through flash_attn_varlen_func with "
          f"dropout: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"the packed dropout path did not launch each kernel once: {launches}")
    inputs = [x.detach() for x in leaves]
    errs, _, _ = check_packed_path(torch, "dropout varlen", inputs, [x.grad for x in leaves], out,
                                   lse, packed32[3], packed32[:3], (starts, lens), None, live, **drop)
    del out, lse, packed32
    t_nd = time_packed_kernels(torch, inputs, do, (starts, lens), None)
    t_d = time_packed_kernels(torch, inputs, do, (starts, lens), None, **drop)
    t_d2 = time_packed_kernels(torch, inputs, do, (starts, lens), None, **drop)
    t_nd2 = time_packed_kernels(torch, inputs, do, (starts, lens), None)
    tq, tk, tv, tdo = (tight(torch, bf(x), lens) for x in padded)
    lib_fwd, _, lib_bwd = library_attention(torch, tq, tk, tv, lens, lens, True, D ** -0.5,
                                            dropout_p=DROPOUT_P)
    lib = {"name": "aten varlen flash attention with dropout (its own Philox mask)",
           "fwd": cuda_ms(torch, lib_fwd), "bwd": cuda_ms(torch, lib_bwd(tdo), iters=5)}
    del tq, tk, tv, tdo, padded
    entries = varlen_entries(t_d, errs, lib, causal_pairs(lens), sum(lens))
    for name, key in VARLEN_KERNEL_NAMES.items():
        entries[name]["ms_runs"] = [t_d[key], t_d2[key]]
        entries[name]["ms_without_dropout"] = [t_nd[key], t_nd2[key]]
        print(f"[dropout varlen] {name} [{card}]: no dropout {t_nd[key]:.3f} / {t_nd2[key]:.3f} ms, "
              f"dropout {t_d[key]:.3f} / {t_d2[key]:.3f} ms "
              f"({100 * ((t_d[key] + t_d2[key]) / (t_nd[key] + t_nd2[key]) - 1):+.1f} %)")
    print_packed_times("dropout varlen", t_d, lib, entries)
    beats_packed_fma("varlen_dropout", entries)
    return launches, {f"{k}_dropout": e for k, e in entries.items()}


def layer_dropout(torch, card):
    """`FlashSelfAttention` at Mistral-7B-v0.3 attention widths (4096 -> 32 /
    8 heads, head_dim 128, RoPE theta 1e6, causal, dropout 0.1; bf16 compute,
    fp32 params), B 2 x S 2048: LAYER_STEPS AdamW steps in training mode with
    the launch counts reset just before; eval equal to flash_attn_func
    without dropout bit for bit; one step's gradients equal under
    torch.utils.checkpoint bit for bit."""
    from torch.utils.checkpoint import checkpoint

    from fa2_triton_tpu_torch import FlashSelfAttention
    from fa2_triton_tpu_torch.models.llama import apply_rope, rope_cos_sin
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S, F = 2, TRAIN_SEQ, 4096
    torch.manual_seed(0)     # the layer's init and its per-call dropout seeds
    layer = FlashSelfAttention(F, 32, num_kv_heads=8, head_dim=128, causal=True,
                               dropout_p=DROPOUT_P, use_rope=True, rope_theta=1e6,
                               dtype=torch.bfloat16, dropout_rng=torch.default_generator, device=dev)
    opt = torch.optim.AdamW(layer.parameters(), lr=1e-4, weight_decay=0.01)
    x = torch.randn((B, S, F), generator=gen, device=dev).to(torch.bfloat16)
    target = torch.randn((B, S, F), generator=gen, device=dev)
    loss_of = lambda out: (out.float() - target).square().mean()
    layer.train()
    flash_fwd.LAUNCHES = 0
    flash_bwd.reset_launches()
    losses, step_ms = [], []
    for _ in range(LAYER_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_of(layer(x))
        loss.backward()
        if not all(torch.isfinite(p.grad).all() for p in layer.parameters()):
            raise AssertionError("layer: a non-finite gradient")
        opt.step()
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}
    n_params = sum(p.numel() for p in layer.parameters())
    print(f"[dropout layer] FlashSelfAttention {F} -> 32 / 8 heads x 128, RoPE 1e6, causal, dropout "
          f"{DROPOUT_P}, bf16 compute / fp32 params ({n_params / 1e6:.1f} M), B {B} x S {S}, "
          f"{LAYER_STEPS} AdamW steps: losses {[round(v, 5) for v in losses]}, step ms "
          f"{[round(v, 2) for v in step_ms]} [{card}]; launches {launches}")
    want = {"flash_fwd": LAYER_STEPS, "flash_bwd_dq": LAYER_STEPS, "flash_bwd_dkdv": LAYER_STEPS,
            "flash_bwd_dbias": 0}
    if not np.isfinite(losses).all() or launches != want:
        raise AssertionError(f"layer steps: losses {losses}, launches {launches} != {want}")

    layer.eval()
    with torch.no_grad():
        got = layer(x)
        q, k, v = layer.q_proj(x), layer.k_proj(x), layer.v_proj(x)
        cos, sin = rope_cos_sin(torch.arange(S, device=dev), 128, 1e6)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
        att = flash_attn_func(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, causal=True)
        want_out = layer.o_proj(att.reshape(B, S, F))
    if not torch.equal(got, want_out):
        raise AssertionError("layer eval differs from flash_attn_func without dropout")
    del got, want_out, q, k, v, att

    layer.train()

    def grads(remat):
        layer.zero_grad(set_to_none=True)
        torch.manual_seed(11)
        out = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
        loss_of(out).backward()
        return [p.grad.clone() for p in layer.parameters()]

    plain, remat = grads(False), grads(True)
    if not all(torch.equal(a, b) for a, b in zip(plain, remat)):
        raise AssertionError("layer: gradients under checkpoint differ from those without it")
    print("[dropout layer] eval output equal to flash_attn_func without dropout bit for bit; one "
          "step's gradients under torch.utils.checkpoint equal to those without it bit for bit")
    return launches


def phase_dropout(torch, card):
    """Phase 10: the mask probes, the dense and packed dropout paths and the
    full-width FlashSelfAttention. Returns (launches by run, entries)."""
    t0 = time.perf_counter()
    dropout_probes(torch, torch.device("cuda"))
    runs, entries = dense_dropout(torch, card)
    torch.cuda.empty_cache()
    runs["varlen"], packed = packed_dropout(torch, card)
    entries.update(packed)
    torch.cuda.empty_cache()
    runs["layer"] = layer_dropout(torch, card)
    print(f"[dropout] phase 10 took {time.perf_counter() - t0:.1f} s")
    return runs, entries


# Phase 11: long-context causal schedules at Mistral-7B-v0.3 attention widths
# (32 / 8 heads, D 128, bf16, causal, no mask), B 1.
LONG_SEQ = 4096                  # the 1 x 4096 trainer feeds attention 4095 tokens: the split
STRIP_SEQ = 6144                 # the strip's default route (S 2049-3072 and 4097-7168)
SHIFT_SQ, SHIFT_SK = 2048, 4096  # a 2048-token chunk against a 4096-token context: the strip
LEAF = 2048                      # split_leaf_t(128, 2): the diag leaves at S 4096
LONG_TRAIN_ARGV = ["--config", "mistral-7b-v0.3", "--steps", "3", "--batch", "1",
                   "--seq", str(LONG_SEQ), "--remat", "--repeat-batch", "--lr", "3e-4",
                   "--grad-clip", "1.0"]


def sched_bound(pairs: int, rows: int, cols: int, extra_bytes: int = 0, Hq: int = 32,
                Hkv: int = 8, D: int = 128, elt: int = 2) -> dict:
    """Bound of a forward over `pairs` kept (query, key) pairs per q head (B
    1): 4 D operations per pair and head; q / o of `rows` rows, k / v of
    `cols` columns and the fp32 lse read or written once, + `extra_bytes`."""
    nbytes = 2 * rows * Hq * D * elt + 2 * cols * Hkv * D * elt + rows * Hq * 4 + extra_bytes
    return roofline(4 * D * pairs * Hq, nbytes)


def shifted_pairs(Sq: int, Sk: int) -> int:
    """Kept pairs of a bottom-right causal Sq x Sk problem (Sq <= Sk)."""
    return sum(Sk - Sq + i + 1 for i in range(Sq))


def hold_to_plain(torch, what, kernel, plain, x32, dtypes=None):
    """kernel(q, k, v) against plain(q, k, v), each -> (o, lse), on the BHSD
    views x32 cast to each dtype: fp32 within FP32_TOL of the plain twin,
    bf16 within 2 x the bf16 plain twin's error + 5e-5 of the fp32 truth;
    lse within LSE_TOL of the plain twin's, with its -inf pattern. Returns
    {"err", "plain_err"} at bf16 (at fp32 when only fp32 is asked)."""
    dtypes = dtypes or (torch.float32, torch.bfloat16)
    o_ref = plain(*x32)[0]
    res = {}
    for dt in dtypes:
        x = [t.to(dt) for t in x32]
        o, lse = kernel(*x)
        o_pl, lse_pl = plain(*x)
        torch.cuda.synchronize()
        lse_err = check_lse(torch, lse, lse_pl, f"{what} {dt}")
        if dt == torch.float32:
            pl_err, err = 0.0, max_abs(torch, o, o_pl)
            bound, rule = FP32_TOL, "vs the fp32 plain twin"
        else:
            pl_err, err = max_abs(torch, o_pl, o_ref), max_abs(torch, o, o_ref)
            bound = OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS
            rule = f"vs fp32 truth, <= 2 x plain bf16 err {pl_err:.3e} + 5e-5"
        print(f"[schedules] {what} {str(dt)[6:]}: max abs err {err:.3e} ({rule}), lse err "
              f"{lse_err:.3e}")
        if not err <= bound:
            raise AssertionError(f"{what} {dt}: err {err:.3e} > {bound:.3e}")
        res = {"err": err, "plain_err": pl_err}
        del x, o, lse, o_pl, lse_pl
    return res


def sched_launches(flash_fwd):
    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES}


def expect_launches(flash_fwd, what, run, **want):
    """Reset the counts, run, and require exactly `want` (0 for the rest)."""
    flash_fwd.reset_launches()
    out = run()
    got = sched_launches(flash_fwd)
    want = {n: want.get(n, 0) for n in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return out, got


def turns(torch, fns, order, iters=5):
    """CUDA-event ms of each named call, measured in the given order."""
    t = {name: [] for name in fns}
    for name in order:
        t[name].append(cuda_ms(torch, fns[name], iters=iters, warmup=1))
    return t


def schedule_kernels(torch, card):
    """Each schedule kernel held against its plain twin (fp32 and bf16, and
    fp32 with dropout fed the same mask), the strip against the generic
    kernel bit for bit, launches of each default route, and times: kernel,
    plain, library, the generic kernel at the same shape, bound."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from fa2_triton_tpu_torch.ops import flash_fwd as ff

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    Hq, Hkv, D = 32, 8, 128
    scale = D ** -0.5
    kw = dict(softmax_scale=scale)
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    bhsd = lambda x: x.transpose(1, 2)
    bf = lambda x: x.to(torch.bfloat16)

    def inputs(Sq, Sk):
        x = [bhsd(torch.randn((1, s, h, D), generator=gen, device=dev) * 0.5)
             for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))]
        return x, torch.tensor([[Sq, Sk]], dtype=torch.int32, device=dev)

    def library(x, Sq, Sk, causal):
        fwd, out, _ = library_attention(torch, *(bhsd(t)[0].contiguous() for t in x), [Sq], [Sk],
                                        causal, scale)
        return fwd, out[0]

    entries = {}
    # -- the split at S 4095 and 4096: flash_attn_forward's default route ----
    for S in (LONG_SEQ - 1, LONG_SEQ):
        x32, lens = inputs(S, S)
        route = ff.forward_route(S, S, D, 2, causal=True, static_skip=True)
        if route != "split":
            raise AssertionError(f"S {S}: route {route}, not the split")
        split = lambda q, k, v, **d: ff.flash_attn_forward(q, k, v, lens, causal=True,
                                                           static_skip=True, **kw, **d)
        causal_plain = lambda q, k, v, **d: ff.flash_attn_forward_plain(q, k, v, lens, causal=True,
                                                                        **kw, **d)
        xb = [bf(t) for t in x32]
        _, got = expect_launches(ff, f"split S {S}", lambda: split(*xb), causal_diag=1,
                                 rect_merge=1)
        print(f"[schedules] flash_attn_forward(causal, static_skip) B 1 x S {S}, Hq {Hq}, Hkv {Hkv}, "
              f"D {D}, bf16: route {route}, launches {got}")
        split_err = hold_to_plain(torch, f"split S {S}", split, causal_plain, x32)
    # S 4096 from here on: the split against the generic kernel, and its two
    # launches (the diag, the rectangle merged into the diag's (o, lse)),
    # each timed on its own call by CUDA events: all three run flash_fwd.cu's
    # tensor-core kernel, under one name in a profile. Every split run must
    # beat its FMA design SPLIT_SPEEDUP times.
    generic = lambda q, k, v: ff.flash_attn_forward(q, k, v, lens, causal=True, **kw)
    diag = lambda q, k, v, **d: ff.flash_attn_forward_causal_diag(q, k, v, lens, T=LEAF, **kw, **d)
    region = dict(row0=LEAF, col0=0, nrows=LEAF, ncols=LEAF)
    prev = diag(*xb)
    t = turns(torch, {"generic": lambda: generic(*xb), "split": lambda: split(*xb),
                      "diag": lambda: diag(*xb),
                      "rect_merge": lambda: ff.flash_attn_forward_rect(*xb, lens, **region,
                                                                       merge_prev=prev, **kw)},
              ("generic", "split", "diag", "rect_merge", "rect_merge", "diag", "split", "generic"))
    split_over_generic = min(t["split"]) / min(t["generic"])
    print(f"[schedules] split S {S} bf16 [{card}]: "
          f"{' / '.join(f'{v:.3f}' for v in t['split'])} ms (the FMA design: "
          f"{FMA_DESIGN_MS['split_fwd']} ms, to beat {SPLIT_SPEEDUP}x): diag "
          f"{' / '.join(f'{v:.3f}' for v in t['diag'])} ms (FMA {FMA_DESIGN_MS['diag_fwd']}), "
          f"rect_merge {' / '.join(f'{v:.3f}' for v in t['rect_merge'])} ms (FMA "
          f"{FMA_DESIGN_MS['rect_merge_fwd']}); generic kernel "
          f"{' / '.join(f'{v:.3f}' for v in t['generic'])} ms; split / generic "
          f"{split_over_generic:.3f} (CUDA events, one call each)")
    beats_fma_design("split_fwd", t["split"], by=SPLIT_SPEEDUP)
    split_plain = cuda_ms(torch, lambda: causal_plain(*xb), iters=2, warmup=1)
    lib_fwd, lib_o = library(xb, S, S, True)
    o_ref = causal_plain(*x32)[0]
    check_library(torch, "split S 4096", lib_o, bhsd(o_ref)[0], split_err["plain_err"])
    split_lib = cuda_ms(torch, lib_fwd)
    split_bound = sched_bound(causal_pairs([S]), S, S)
    print(f"[schedules] split S {S} bf16: plain {split_plain:.3f} ms; library (aten flash, causal) "
          f"{split_lib:.3f} ms; bound {split_bound['bound_ms']:.3f} ms ({split_bound['bound_by']}): "
          f"{100 * split_bound['bound_ms'] / min(t['split']):.1f} % of the bound")
    del o_ref, lib_o

    # -- the diag leaves alone (T 2048 on the S 4096 inputs) -----------------
    diag_plain = lambda q, k, v, **d: ff.flash_attn_forward_causal_diag_plain(q, k, v, lens, T=LEAF,
                                                                              **kw, **d)
    diag_err = hold_to_plain(torch, f"diag T {LEAF}", diag, diag_plain, x32)
    diag_ms = min(t["diag"])
    diag_pms = cuda_ms(torch, lambda: diag_plain(*xb), iters=2, warmup=1)

    def leaf_mask(b, h, qi, ki):
        return (ki <= qi) & (qi // LEAF == ki // LEAF)

    block_mask = create_block_mask(leaf_mask, None, None, S, S, device=dev, BLOCK_SIZE=128)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (t.contiguous() for t in xb)
    t0 = time.perf_counter()
    lib_o = flex(qh, kh, vh, block_mask=block_mask, scale=scale, enable_gqa=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    check_library(torch, "diag", lib_o, diag_plain(*x32)[0], diag_err["plain_err"])
    diag_lib = cuda_ms(torch, lambda: flex(qh, kh, vh, block_mask=block_mask, scale=scale,
                                           enable_gqa=True))
    diag_bound = sched_bound(causal_pairs([LEAF] * (S // LEAF)), S, S)
    print(f"[schedules] diag T {LEAF}, S {S} bf16 [{card}]: kernel {diag_ms:.3f} ms, plain "
          f"{diag_pms:.3f} ms, library (flex_attention, block-diagonal causal mask, compiled in "
          f"{compile_s:.1f} s) {diag_lib:.3f} ms, bound {diag_bound['bound_ms']:.4f} ms "
          f"({diag_bound['bound_by']})")
    entries["flash_fwd_causal_diag"] = {
        "max_abs_err": diag_err["err"], "ms": diag_ms, "plain_ms": diag_pms,
        "library_ms": diag_lib, **diag_bound,
        "split_S4096": {"max_abs_err": split_err["err"], "ms": min(t["split"]),
                        "ms_runs": t["split"], "generic_kernel_ms_runs": t["generic"],
                        "split_over_generic": split_over_generic, "diag_ms_runs": t["diag"],
                        "rect_merge_ms_runs": t["rect_merge"], "plain_ms": split_plain,
                        "library_ms": split_lib, "bound_ms": split_bound["bound_ms"]}}
    del lib_o, qh, kh, vh

    # -- the split with split_leaf 1024: four leaves, three rectangles -------
    split4 = lambda q, k, v: ff.flash_attn_forward(q, k, v, lens, causal=True, static_skip=True,
                                                   split_leaf=1024, **kw)
    expect_launches(ff, "split_leaf 1024", lambda: split4(*xb), causal_diag=1, rect_merge=3)
    hold_to_plain(torch, "split split_leaf 1024", split4, causal_plain, x32)
    split4_ms = cuda_ms(torch, lambda: split4(*xb))
    print(f"[schedules] split with split_leaf 1024 (1 diag + 3 merged rects): {split4_ms:.3f} ms "
          f"[{card}]")

    # -- one rectangle: rows [2048, 4096) x columns [0, 2048) ---------------
    rect = lambda q, k, v, **d: ff.flash_attn_forward_rect(q, k, v, lens, **region, **kw, **d)
    rect_plain = lambda q, k, v, **d: ff.flash_attn_forward_rect_plain(q, k, v, lens, **region,
                                                                       **kw, **d)
    rect_err = hold_to_plain(torch, "rect", rect, rect_plain, x32)
    rect_ms = cuda_ms(torch, lambda: rect(*xb))
    rect_pms = cuda_ms(torch, lambda: rect_plain(*xb), iters=2, warmup=1)
    lib_fwd, lib_o = library([xb[0][:, :, LEAF:], xb[1][:, :, :LEAF], xb[2][:, :, :LEAF]], LEAF,
                             LEAF, False)
    check_library(torch, "rect", lib_o, bhsd(rect_plain(*x32)[0])[0], rect_err["plain_err"])
    rect_lib = cuda_ms(torch, lib_fwd)
    rect_bound = sched_bound(LEAF * LEAF, LEAF, LEAF)
    print(f"[schedules] rect {LEAF} x {LEAF} bf16 [{card}]: kernel {rect_ms:.3f} ms, plain "
          f"{rect_pms:.3f} ms, library (aten flash on the region, not causal) {rect_lib:.3f} ms, "
          f"bound {rect_bound['bound_ms']:.4f} ms ({rect_bound['bound_by']})")
    entries["flash_fwd_rect"] = {"max_abs_err": rect_err["err"], "ms": rect_ms, "plain_ms": rect_pms,
                                 "library_ms": rect_lib, **rect_bound}
    del lib_o

    # -- the same rectangle merged into the diag leaves' (o, lse) -----------
    def merged(rect_fn):
        """The rectangle merged into the diag kernel's (o, lse), made anew."""
        def run(q, k, v, **d):
            return rect_fn(q, k, v, lens, **region, merge_prev=diag(q, k, v, **d), **kw, **d)
        return run
    merge, merge_plain = merged(ff.flash_attn_forward_rect), merged(ff.flash_attn_forward_rect_plain)
    merge_err = hold_to_plain(torch, "rect_merge", merge, merge_plain, x32)
    prev = diag(*xb)
    merge_ms = min(t["rect_merge"])
    merge_pms = cuda_ms(torch, lambda: ff.flash_attn_forward_rect_plain(
        *xb, lens, **region, merge_prev=prev, **kw), iters=2, warmup=1)
    # + the previous o and lse of the region's rows, read once.
    merge_bound = sched_bound(LEAF * LEAF, LEAF, LEAF, extra_bytes=LEAF * Hq * (D * 2 + 4))
    print(f"[schedules] rect_merge {LEAF} x {LEAF} bf16 [{card}]: kernel {merge_ms:.3f} ms, plain "
          f"{merge_pms:.3f} ms, library none (no PyTorch call merges two (o, lse) partials), bound "
          f"{merge_bound['bound_ms']:.4f} ms ({merge_bound['bound_by']})")
    entries["flash_fwd_rect_merge"] = {"max_abs_err": merge_err["err"], "ms": merge_ms,
                                       "plain_ms": merge_pms, "library_ms": None, **merge_bound}

    # -- dropout: fp32 against the plain twins fed the same mask -----------
    for what, k_fn, p_fn in (("split", split, causal_plain), ("diag", diag, diag_plain),
                             ("rect", rect, rect_plain), ("rect_merge", merge, merge_plain)):
        hold_to_plain(torch, f"{what} dropout p {DROPOUT_P} (the same mask)",
                      functools.partial(k_fn, **drop), functools.partial(p_fn, **drop), x32,
                      (torch.float32,))
    del x32, xb, prev

    # -- the strip: S 6144, and Sq 2048 against Sk 4096 ---------------------
    strip_entry = {}
    for Sq, Sk in ((STRIP_SEQ, STRIP_SEQ), (SHIFT_SQ, SHIFT_SK)):
        x32, lens = inputs(Sq, Sk)
        route = ff.forward_route(Sq, Sk, D, 2, causal=True, static_skip=True)
        if route != "strip":
            raise AssertionError(f"Sq {Sq} / Sk {Sk}: route {route}, not the strip")
        strip = lambda q, k, v, **d: ff.flash_attn_forward(q, k, v, lens, causal=True,
                                                           static_skip=True, **kw, **d)
        generic = lambda q, k, v, **d: ff.flash_attn_forward(q, k, v, lens, causal=True, **kw, **d)
        causal_plain = lambda q, k, v, **d: ff.flash_attn_forward_plain(q, k, v, lens, causal=True,
                                                                        **kw, **d)
        xb = [bf(t) for t in x32]
        expect_launches(ff, f"strip {Sq} / {Sk}", lambda: strip(*xb), causal_strip=1)
        err = hold_to_plain(torch, f"strip {Sq} / {Sk}", strip, causal_plain, x32)
        if Sq == SHIFT_SQ:
            hold_to_plain(torch, f"strip {Sq} / {Sk} dropout p {DROPOUT_P} (the same mask)",
                          functools.partial(strip, **drop), functools.partial(causal_plain, **drop),
                          x32, (torch.float32,))
        for extra in ({}, drop):
            for dt in (torch.float32, torch.bfloat16):
                x = [t.to(dt) for t in x32]
                o_s, l_s = strip(*x, **extra)
                o_g, l_g = generic(*x, **extra)
                torch.cuda.synchronize()
                if not (torch.equal(o_s, o_g) and torch.equal(l_s, l_g)):
                    raise AssertionError(f"strip {Sq} / {Sk} {dt} {extra}: not the generic kernel's "
                                         f"o / lse bit for bit")
                del x, o_s, l_s, o_g, l_g
        t = turns(torch, {"generic": lambda: generic(*xb), "strip": lambda: strip(*xb)},
                  ("generic", "strip", "strip", "generic"))
        pms = cuda_ms(torch, lambda: causal_plain(*xb), iters=2, warmup=1)
        lib_fwd, lib_o = library(xb, Sq, Sk, True)
        check_library(torch, f"strip {Sq} / {Sk}", lib_o, bhsd(causal_plain(*x32)[0])[0],
                      err["plain_err"])
        lib_ms = cuda_ms(torch, lib_fwd)
        bound = sched_bound(shifted_pairs(Sq, Sk), Sq, Sk)
        print(f"[schedules] strip Sq {Sq} / Sk {Sk} bf16 [{card}]: o and lse equal to the generic "
              f"kernel's bit for bit (fp32, bf16, with and without dropout); strip "
              f"{' / '.join(f'{v:.3f}' for v in t['strip'])} ms, generic "
              f"{' / '.join(f'{v:.3f}' for v in t['generic'])} ms, plain {pms:.3f} ms, library "
              f"(aten flash, causal) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})")
        strip_entry[(Sq, Sk)] = {"max_abs_err": err["err"], "ms": min(t["strip"]),
                                 "ms_runs": t["strip"], "generic_kernel_ms_runs": t["generic"],
                                 "plain_ms": pms, "library_ms": lib_ms, **bound}
        del x32, xb, lib_o
    entries["flash_fwd_causal_strip"] = dict(strip_entry[(STRIP_SEQ, STRIP_SEQ)],
                                             shifted_2048_4096=strip_entry[(SHIFT_SQ, SHIFT_SK)])
    return entries


def long_flash_attn_func(torch):
    """flash_attn_func forward + backward at B 1 x S 4096 (bf16, causal, no
    mask), launch counts reset just before: the split forward, then the
    ported dq and dk/dv kernels on its o and lse; output and gradients meet
    the FA rules against the fp32 plain twins."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    S, D = LONG_SEQ, 128
    x32 = [torch.randn((1, S, h, D), generator=gen, device=dev) * 0.5 for h in (32, 8, 8)]
    do32 = torch.randn((1, S, 32, D), generator=gen, device=dev)
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in x32]
    do = do32.to(torch.bfloat16)
    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {**sched_launches(flash_fwd), **flash_bwd.LAUNCHES}
    print(f"[schedules] flash_attn_func(causal) + backward, B 1 x S {S}, Hq 32, Hkv 8, D {D}, "
          f"bf16: launches {launches}")
    want = {"flash_fwd": 0, "causal_strip": 0, "causal_diag": 1, "rect": 0, "rect_merge": 1,
            "flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"flash_attn_func at S {S}: launches {launches} != {want}")
    bhsd = lambda x: x.transpose(1, 2)
    lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    with torch.no_grad():
        o32, lse32 = flash_fwd.flash_attn_forward_plain(*(bhsd(x) for x in x32), lens, **kw)
        q, k, v = (bhsd(x.detach()) for x in leaves)
        o_pl, _ = flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw)
        out_err, pl_err = max_abs(torch, bhsd(out), o32), max_abs(torch, o_pl, o32)
        if not out_err <= OUT_ERROR_MUL * pl_err + OUT_ERROR_BIAS:
            raise AssertionError(f"S {S} forward: err {out_err:.3e} > 2 x plain {pl_err:.3e} + 5e-5")
        refs = flash_bwd.flash_attn_backward_plain(*(bhsd(x) for x in x32), bhsd(do32), o32, lse32,
                                                   lens, **kw)
        del o32, lse32, o_pl
        plains = flash_bwd.flash_attn_backward_plain(q, k, v, bhsd(do), bhsd(out.detach()),
                                                     lse.detach(), lens, **kw)
    errs = {n: check_grad(torch, n, bhsd(x.grad), r, pl, f"S {S}")[0]
            for n, x, r, pl in zip(("dq", "dk", "dv"), leaves, refs, plains)}
    print(f"[schedules] S {S} through the split: out err {out_err:.3e} (<= 2 x plain {pl_err:.3e} + "
          f"5e-5); grad errs vs fp32 " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + " (FA gradient contract)")
    del refs, plains
    # The attention of one layer of the 1 x 4096 trainer (PERF.md's step
    # breakdown): the split's diag and merged rectangle by CUDA events, one
    # call each (both are flash_fwd.cu's kernel, one name in a profile), and
    # the backward's dq and dk/dv kernels by the profiler.
    scale = dict(softmax_scale=D ** -0.5)
    prev = flash_fwd.flash_attn_forward_causal_diag(q, k, v, lens, T=LEAF, **scale)
    per = {"diag": cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_causal_diag(
               q, k, v, lens, T=LEAF, **scale)),
           "rect_merge": cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_rect(
               q, k, v, lens, row0=LEAF, col0=0, nrows=LEAF, ncols=LEAF, merge_prev=prev, **scale))}
    per.update(kernel_ms(torch, lambda: flash_attn_func(*leaves, causal=True).backward(do),
                         ("dq_mma_kernel", "dkdv_mma_kernel")))
    fwd_ms = per["diag"] + per["rect_merge"]
    pair_ms = per["dq_mma_kernel"] + per["dkdv_mma_kernel"]
    print(f"[schedules] flash_attn_func fwd + bwd B 1 x S {S} bf16 kernels (per launch): "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in per.items())
          + f"; attention of one layer {sum(per.values()):.3f} ms; of a remat step of the 32-layer "
          f"trainer 32 x (2 x {fwd_ms:.3f} (split forward) + {pair_ms:.3f} (dq + dk/dv)) = "
          f"{32 * (2 * fwd_ms + pair_ms) / 1e3:.3f} s")
    return launches


def strip_and_rect_paths(torch):
    """The strip's default routes through flash_attn_func (forward, S 6144
    and a 2048-query chunk against 4096 keys) and the rectangle through its
    own entry point (the split always merges, as in JAX), each with the
    launch counts reset just before. Returns their launches."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_fwd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    D, runs = 128, {}
    for Sq, Sk in ((STRIP_SEQ, STRIP_SEQ), (SHIFT_SQ, SHIFT_SK)):
        q, k, v = (torch.randn((1, s, h, D), generator=gen, device=dev).to(torch.bfloat16)
                   for s, h in ((Sq, 32), (Sk, 8), (Sk, 8)))
        with torch.no_grad():
            out, got = expect_launches(flash_fwd, f"flash_attn_func {Sq} / {Sk}",
                                       lambda: flash_attn_func(q, k, v, causal=True),
                                       causal_strip=1)
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attn_func {Sq} / {Sk}: non-finite output")
        runs[f"flash_attn_func {Sq} / {Sk}"] = got
        del q, k, v, out
    q, k, v = (torch.randn((1, h, LONG_SEQ, D), generator=gen, device=dev).to(torch.bfloat16)
               for h in (32, 8, 8))
    lens = torch.tensor([[LONG_SEQ, LONG_SEQ]], dtype=torch.int32, device=dev)
    (o, lse), got = expect_launches(flash_fwd, "flash_attn_forward_rect", lambda: (
        flash_fwd.flash_attn_forward_rect(q, k, v, lens, row0=LEAF, col0=0, nrows=LEAF, ncols=LEAF,
                                          softmax_scale=D ** -0.5)), rect=1)
    if o.shape != (1, 32, LEAF, D) or not torch.isfinite(lse).all():
        raise AssertionError("flash_attn_forward_rect: bad region output")
    runs["flash_attn_forward_rect"] = got
    print(f"[schedules] launches by run: {runs}")
    return runs


def long_train(torch, card: str):
    """The trainer at batch 1 x seq 4096, full depth: attention over 4095
    tokens takes the split (diag + one merged rectangle per layer call)."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    def reset():
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()

    args, res = run_trainer(torch, card, LONG_TRAIN_ARGV, reset, "schedules train")
    launches = {**sched_launches(flash_fwd), **flash_bwd.LAUNCHES}
    L, steps = res["config"].n_layers, args.steps
    print(f"[schedules train] launches: {launches}")
    want = {"flash_fwd": 0, "causal_strip": 0, "causal_diag": 2 * L * steps, "rect": 0,
            "rect_merge": 2 * L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"1 x {LONG_SEQ} training launches {launches} != {want} (layers x "
                             f"steps, x2 for remat)")
    return launches


def phase_schedules(torch, card: str):
    """Phase 11: the causal forward schedules. Returns (launches by run,
    kernel entries)."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    t0 = time.perf_counter()
    if any(flash_fwd.SCHEDULE_LAUNCHES.values()):
        raise AssertionError(f"phases 1-10 launched a schedule kernel: {flash_fwd.SCHEDULE_LAUNCHES}")
    print("[schedules] phases 1-10 launched no schedule kernel: "
          f"{dict(flash_fwd.SCHEDULE_LAUNCHES)}")
    entries = schedule_kernels(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"flash_attn_func S 4096": long_flash_attn_func(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(strip_and_rect_paths(torch))
    gc.collect()
    torch.cuda.empty_cache()
    runs["train"] = long_train(torch, card)
    print(f"[schedules] phase 11 took {time.perf_counter() - t0:.1f} s")
    return runs, entries


# Phase 12: the causal backward schedules at Qwen1.5-7B attention widths (32 /
# 32 heads, D 128, bf16, causal, no mask). The trainer feeds attention seq - 1
# tokens: 2 x 2047 takes the tri-square backward (B13), 1 x 8191 (padded 8192)
# the work list (B14) with four strips of 2048.
QWEN_H, QWEN_D = 32, 128
TRI_B, TRI_S = 2, 2047
WL_S = 8191
SPLIT_S, SPLIT_LEAF = 4096, 2048  # the split forced: one diag launch over two leaves, one rect
QWEN_STEPS = 3
# Batch x seq of the two Qwen training runs; if 1 x 8192 runs out of memory,
# 1 x 6144 (6143 tokens pad to 6144: the same work-list route, three strips).
QWEN_SHAPES = ((2, 2048), (1, 8192))
QWEN_FALLBACK_SEQ = 6144
BWD_NAMES = ("dq", "dk", "dv")


def qwen_train_argv(batch: int, seq: int):
    return ["--config", "qwen1.5-7b", "--steps", str(QWEN_STEPS), "--batch", str(batch), "--seq",
            str(seq), "--remat", "--repeat-batch", "--lr", "3e-4", "--grad-clip", "1.0"]


def fused_bound(pairs: int, q_rows: int, kv_rows: int, Hq: int = QWEN_H, Hkv: int = QWEN_H,
                D: int = QWEN_D, elt: int = 2) -> dict:
    """Bound of a fused backward over `pairs` kept (query, key) pairs per q
    head: 10 D operations per pair and head (s, dp, dv, dk, dq); q, o, do,
    dq of `q_rows` rows and k, v, dk, dv of `kv_rows` rows read or written
    once, with the fp32 lse and delta of the q rows."""
    nbytes = 4 * q_rows * Hq * D * elt + 4 * kv_rows * Hkv * D * elt + 2 * q_rows * Hq * 4
    return roofline(10 * D * pairs * Hq, nbytes)


def bwd_launches(flash_fwd, flash_bwd):
    """Every launch count; the backward schedules' under "bwd_<name>" (the
    forward's have a causal_diag and a rect too)."""
    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES, **flash_bwd.LAUNCHES,
            **{f"bwd_{n}": c for n, c in flash_bwd.SCHEDULE_LAUNCHES.items()}}


def hold_bwd(torch, what, kernel, plain, inputs):
    """kernel(*inputs(dtype), **drop) and plain(...) -> (dq, dk, dv): fp32
    within FP32_GRAD_RTOL x (1 + max|g|) of the plain twin, bf16 within the
    FA gradient contract of the fp32 plain (the truth, dV waiver), fp32 with
    dropout p DROPOUT_P against the plain twin fed the same mask, and two
    bf16 runs equal bit for bit. Returns the bf16 errors by gradient."""
    drop = dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    x32 = inputs(torch.float32)
    truth = plain(*x32)
    errs = {}
    for extra in ({}, drop):
        got = kernel(*x32, **extra)
        ref = truth if not extra else plain(*x32, **extra)
        torch.cuda.synchronize()
        errs32 = [check_fp32_grad(torch, n, g, r, f"{what} fp32{' dropout' if extra else ''}")
                  for n, g, r in zip(BWD_NAMES, got, ref)]
        del got, ref
        print(f"[causal bwd] {what} fp32{f' dropout p {DROPOUT_P} (the same mask)' if extra else ''}"
              f": max abs errs vs the plain twin "
              + ", ".join(f"{n} {e:.3e}" for n, e in zip(BWD_NAMES, errs32))
              + f" (<= {FP32_GRAD_RTOL} x (1 + max|grad|))")
    xb = inputs(torch.bfloat16)
    got, again = kernel(*xb), kernel(*xb)
    pl = plain(*xb)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two bf16 runs differ")
    for n, g, r, p in zip(BWD_NAMES, got, truth, pl):
        errs[n], errs[n + " plain"] = check_grad(torch, n, g, r, p, f"{what} bf16")
    print(f"[causal bwd] {what} bf16: errs vs fp32 truth " + ", ".join(
        f"{n} {errs[n]:.3e} (plain {errs[n + ' plain']:.3e})" for n in BWD_NAMES)
        + " (FA gradient contract); two runs equal bit for bit")
    return errs, truth


def profiler_split(torch, fn, names):
    """Device ms per launch of each named kernel from torch.profiler, or
    None where it recorded no launch: late in this long process it can drop
    every launch of a call (0 of 3 of the tri-square's, once), so phase 12's
    kernel times are CUDA events over whole calls and this split is extra."""
    try:
        return kernel_ms(torch, fn, names, iters=3, stand_in=False)
    except AssertionError as e:
        print(f"[causal bwd] no profiler split: {e}")
        return None


def forward_ms(torch, x, card):
    """The forward the trainer runs at these inputs' shape (the generic
    kernel, `flash_attn_forward`'s route for 2047 and 8191 tokens): its
    CUDA-event ms (with the backward's time, one layer's attention per
    step), its bound, aten flash's causal forward on the same inputs and the
    share of the bound. Returns those numbers."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    q, k, v, _, _, _, lens = x
    B, Hq, S, _ = q.shape
    if flash_fwd.forward_route(S, S, QWEN_D, 2, causal=True, static_skip=True) not in (
            "tri_square", "generic"):
        raise AssertionError(f"S {S}: the trainer's forward is not the generic kernel")
    run = lambda: flash_fwd.flash_attn_forward(q, k, v, lens, causal=True,  # noqa: E731
                                               softmax_scale=QWEN_D ** -0.5)
    t = turns(torch, {"kernel": run}, ("kernel",) * 3, iters=3)["kernel"]
    seq = [S] * B
    lib_fwd, _, _ = library_attention(torch, *(tight(torch, t_.transpose(1, 2), seq)
                                               for t_ in (q, k, v)), seq, seq, True,
                                      QWEN_D ** -0.5)
    lib_ms = cuda_ms(torch, lib_fwd, iters=3)
    bound = attn_bound("fwd", causal_pairs(seq), sum(seq), Hq, k.shape[1], QWEN_D, 2)
    share = bound["bound_ms"] / min(t)
    print(f"[causal bwd] generic forward kernel B {B} x S {S} bf16 [{card}]: "
          f"{' / '.join(f'{v:.3f}' for v in t)} ms (the FMA design: "
          f"{FWD_FMA_DESIGN_MS.get((B, S), 'not measured')} ms), library (aten flash, causal) "
          f"{lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
          f"{100 * share:.1f} % of the bound")
    return {"ms": min(t), "ms_runs": t, "library_ms": lib_ms, **bound, "bound_share": share}


def bwd_kernel_inputs(torch, gen, B, S, Hq=QWEN_H, Hkv=QWEN_H):
    """inputs(dtype) -> (q, k, v, do, o, lse, lens) BHSD at the given
    widths: fp32 randoms cast to dtype, o and lse from the generic forward
    kernel in that dtype."""
    from fa2_triton_tpu_torch.ops import flash_fwd

    dev = torch.device("cuda")
    bhsd = lambda x: x.transpose(1, 2)
    x32 = [bhsd(torch.randn((B, S, h, QWEN_D), generator=gen, device=dev) * 0.5)
           for h in (Hq, Hkv, Hkv)]
    do32 = bhsd(torch.randn((B, S, Hq, QWEN_D), generator=gen, device=dev))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
    cache = {}

    def inputs(dt):
        if dt not in cache:
            q, k, v, do = (x.to(dt) for x in (*x32, do32))
            o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, causal=True,
                                                  softmax_scale=QWEN_D ** -0.5)
            cache[dt] = (q, k, v, do, o, lse, lens)
        return cache[dt]
    return inputs


def library_bwd(torch, what, x, seq_q, seq_k, causal, truth, errs, rows=None, cols=None):
    """aten's flash backward (`aten._flash_attention_backward`, after its
    own forward) on the same bf16 tensors (tight-packed rows), checked to
    compute the fp32 `truth` (its error near the bf16 plain twin's):
    CUDA-event ms of one call."""
    q, k, v, do = x[:4]
    rows, cols = rows or slice(None), cols or slice(None)
    bshd = lambda t, sl: t[:, :, sl].transpose(1, 2)
    pack = lambda t, sl, lens: tight(torch, bshd(t, sl), lens)
    B = q.shape[0]
    lq, lk = [seq_q] * B, [seq_k] * B
    _, _, lib = library_attention(torch, pack(q, rows, lq), pack(k, cols, lk), pack(v, cols, lk),
                                  lq, lk, causal, QWEN_D ** -0.5)
    run = lib(pack(do, rows, lq))
    for n, g, r in zip(BWD_NAMES, run(), truth):
        check_library(torch, f"{what} {n}", g, tight(torch, r.transpose(1, 2), lq if n == "dq"
                                                     else lk), errs[n + " plain"])
    return cuda_ms(torch, run, iters=5)


# The bf16 times of these kernels' earlier design (fp32 FMA tiles, one block
# per batch row and kv head or per strip) at these shapes, measured by this
# phase on an NVIDIA H100 80GB HBM3 at 700.00 W (CUDA events, four runs; dq
# and dk/dv: phase 5's profiler times at B 2 x S 2047, 32 / 8 heads),
# printed beside this run's in the log only: the kernels line holds numbers
# this run measured. Each redesigned kernel must beat its FMA time (the dq
# and dk/dv pair by 3x).
FMA_DESIGN_MS = {"tri_square": "20.331-20.379", "causal_diag": "19.939-20.105",
                 "worklist": "138.520-139.322", "rect": "11.696-11.819", "dq": "5.399",
                 "dkdv": "8.425"}
# The split forward's FMA design (B9 diag + B11 / B1 merge as fp32 FMA tiles)
# at B 1 x S 4096, 32 / 8 heads, D 128, bf16, measured by phase 11 on an
# NVIDIA H100 80GB HBM3 at 700.00 W (CUDA events over whole calls; the two
# kernels by the profiler inside the split). Every split run on tensor cores
# must beat the top of its range SPLIT_SPEEDUP times.
FMA_DESIGN_MS.update({"split_fwd": "6.576-6.607", "diag_fwd": "3.388-3.445",
                      "rect_merge_fwd": "3.152-3.185"})
SPLIT_SPEEDUP = 3
# The packed backward's FMA design (fp32 FMA tiles for every input type) on
# phase 8's packed batch (T 14592) and phase 9's block-sparse batch, bf16,
# 32 / 8 heads, D 128, measured by those phases on an NVIDIA H100 80GB HBM3
# at 700.00 W (profiler, two to four runs). Every tensor-core run must beat
# the top of its range VARLEN_SPEEDUP times.
FMA_DESIGN_MS.update({"varlen_dq": "17.334-17.387", "varlen_dkdv": "41.094-41.138",
                      "blocksparse_dq": "5.176-5.204", "blocksparse_dkdv": "15.3-19.7"})
# The packed forward's FMA design (B7 as fp32 FMA tiles for every input
# type), measured the same way by the earlier builds' runs of phases 8 and 9.
FMA_DESIGN_MS.update({"varlen_fwd": "10.898-11.412", "blocksparse_fwd": "3.315-3.353"})
# The same on phase 10's packed batch with dropout p 0.1 (the earlier builds' runs).
FMA_DESIGN_MS.update({"varlen_dropout_fwd": "11.174-11.336", "varlen_dropout_dq": "17.29-17.53",
                      "varlen_dropout_dkdv": "26.35-27.59"})
VARLEN_SPEEDUP = 3
# The dbias kernel's FMA design (fp32 FMA tiles for every input type, 64 x 32
# bias tiles), bf16, measured by phase 6 (B 2 x S 2047) and by phase 10's
# bias path with dropout (B 2 x S 2048) on an NVIDIA H100 80GB HBM3 at
# 700.00 W (profiler). The tensor-core kernel must beat the top of each
# DBIAS_SPEEDUP times.
FMA_DESIGN_MS.update({"dbias": "5.268", "dbias_dropout": "5.404-5.475"})
DBIAS_SPEEDUP = 3

# The 16-bit tensor-core kernels: the fused backward (csrc/bwd_mma.cuh's
# tiles), the forward (csrc/flash_fwd.cu), the dq + dk/dv pair and dbias
# (csrc/flash_bwd.cu) and the packed forward and backward (csrc/varlen.cu,
# the forward on csrc/fwd_mma.cuh's tiles like flash_fwd.cu's); the template
# flag after DROP of the forward's and the pair's puts bias and softcap in
# their own instantiations, and the forward's last one (MERGE) the split's
# merged rectangle. A mangled name gives each name its length just before
# it, so the pattern asks for a digit there: the pair's names are not read
# inside a longer one.
MMA_KERNELS = ("bwd_tri_mma_kernel", "bwd_wl_mma_kernel", "flash_fwd_mma_kernel", "dq_mma_kernel",
               "dkdv_mma_kernel", "dbias_mma_kernel", "varlen_mma_fwd_kernel",
               "varlen_mma_dq_kernel", "varlen_mma_dkdv_kernel")
# Kernels none of whose instantiations may spill.
NO_SPILL_KERNELS = ("varlen_mma_fwd_kernel",)
MMA_EXTRA = ("flash_fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel")
_MMA_NAME = re.compile(r"\d(" + "|".join(MMA_KERNELS) + r")I(13__nv_bfloat16|6__half)Li(\d+)ELb([01])E"
                       r"(?:Lb([01])E)?(?:Lb([01])E)?")
# The forward's (bias / softcap, merge) instantiations: a merge has neither.
FWD_FLAGS = ((False, False), (True, False), (False, True))
# The forward's times at the Qwen shapes in its earlier design (fp32 FMA
# tiles for every input type), measured by this phase on an NVIDIA H100 80GB
# HBM3 at 700.00 W (CUDA events, four runs), for the log line only.
FWD_FMA_DESIGN_MS = {(2, 2047): "3.462-3.509", (1, 8191): "25.271-25.795"}


def mma_instance(mangled: str):
    """(kernel, dtype, D, dropout, bias / softcap, merge) of a 16-bit
    kernel's mangled name (False for a flag the kernel does not have), else
    None."""
    m = _MMA_NAME.search(mangled)
    return (m[1], "bf16" if "bfloat" in m[2] else "fp16", int(m[3]), m[4] == "1",
            m[5] == "1", m[6] == "1") if m else None


def ptxas_table(report: str) -> dict:
    """{instance: (registers, spill store bytes, spill load bytes)} of the
    16-bit tensor-core kernels, from nvcc -Xptxas -v's report."""
    regs, spills, cur, prop = {}, {}, None, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = m[1]
        elif m := re.search(r"Function properties for (\S+)", line):
            prop = m[1]
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and prop:
            spills[prop] = (int(m[1]), int(m[2]))
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            regs[cur] = int(m[1])
    return {mma_instance(n): (r, *spills.get(n, (0, 0))) for n, r in regs.items()
            if mma_instance(n)}


# The background cuobjdump -sass of the built library: (process, its
# output file, start time), started by start_sass.
_SASS_RUN = {}


def start_sass(lib_path) -> None:
    """Start cuobjdump -sass on the built library in the background, its
    output to a file beside the library, so that the card runs phases 1-7
    while it reads (some 90 s on the H100's host when run in line after
    the build)."""
    from fa2_triton_tpu_torch.ops import _build

    lib_path = Path(lib_path)
    if lib_path in _SASS_RUN:
        return
    tool = _build.find_cuobjdump()
    if tool is None:
        raise AssertionError("no cuobjdump beside nvcc or in Triton's package")
    out = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.sass")
    with open(out, "w") as fh:
        proc = subprocess.Popen([tool, "-sass", str(lib_path)], stdout=fh,
                                stderr=subprocess.DEVNULL)
    _SASS_RUN[lib_path] = (proc, out, time.perf_counter())


@functools.lru_cache(maxsize=1)
def sass_hmma(lib_path) -> dict:
    """{mangled kernel name: HMMA instructions} in the SASS of the built
    library: one cuobjdump -sass for the tensor-core and the decode reports
    (two took some 100 s more of the smoke's build), started by start_sass
    (here if it was not) and waited for."""
    lib_path = Path(lib_path)
    start_sass(lib_path)
    proc, out, t0 = _SASS_RUN.pop(lib_path)
    t_wait = time.perf_counter()
    if proc.wait() != 0:
        raise AssertionError(f"cuobjdump -sass failed ({proc.returncode})")
    sass = out.read_text()
    out.unlink()
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ", 1)[1].split()[0]
            counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    print(f"[build] cuobjdump -sass and its HMMA count: {time.perf_counter() - t0:.1f} s since "
          f"its start, {time.perf_counter() - t_wait:.1f} s waited for, {len(counts)} kernels")
    return counts


def hmma_counts(lib_path) -> dict:
    """{instance: HMMA instructions} of the 16-bit tensor-core kernels in
    the SASS of the built library."""
    return {inst: n for name, n in sass_hmma(lib_path).items() if (inst := mma_instance(name))}


def mma_build_report() -> dict:
    """Registers, spills and tensor-core instructions of every 16-bit
    instantiation of the two fused backward kernels, the forward, the dq
    + dk/dv pair, dbias and the packed kernels (bf16 / fp16 x D 64 / 128 /
    256 / 384 / 512 x dropout; for the forward and the pair
    with and without bias / softcap, for the forward also the split's merge;
    the packed forward, dq and dk/dv); fails where one has no HMMA, or a
    bf16 D 128 one of the trainers' (the Qwen and Mistral shapes': no bias,
    no softcap; the merge included), any one at D 384 / 512 or any one of
    NO_SPILL_KERNELS spills.
    Returns {kernel: {instance: numbers}}."""
    from fa2_triton_tpu_torch.ops import _build

    table = ptxas_table(_build.ptxas_report or "")
    hmma = hmma_counts(_build.build())
    out = {k: {} for k in MMA_KERNELS}
    for kernel in MMA_KERNELS:
        flags = (FWD_FLAGS if kernel == "flash_fwd_mma_kernel" else
                 ((False, False), (True, False)) if kernel in MMA_EXTRA else ((False, False),))
        dims = (64, 128, 256) + WIDE_DIMS
        for dt, D, drop, (extra, merge) in itertools.product(("bf16", "fp16"), dims,
                                                             (False, True), flags):
            inst = (kernel, dt, D, drop, extra, merge)
            if inst not in table or inst not in hmma:
                raise AssertionError(f"{inst}: not in the ptxas report / the SASS")
            regs, st, ld = table[inst]
            n = hmma[inst]
            what = (f"{dt} D {D}{' dropout' if drop else ''}{' bias / softcap' if extra else ''}"
                    f"{' merge' if merge else ''}")
            print(f"[tensor cores] {kernel} {what}: {regs} registers, spill stores {st} B / "
                  f"loads {ld} B, {n} HMMA in the SASS")
            if n == 0:
                raise AssertionError(f"{inst}: no tensor-core instruction")
            if (st or ld) and (kernel in NO_SPILL_KERNELS or D > 256
                               or (dt == "bf16" and D == 128 and not extra)):
                raise AssertionError(f"{inst}: spills {st} / {ld} bytes")
            out[kernel][f"{dt} D{D}{' drop' if drop else ''}{' extra' if extra else ''}"
                        f"{' merge' if merge else ''}"] = {
                "registers": regs, "spill_store_bytes": st, "spill_load_bytes": ld, "hmma": n}
    return out


def decode_build_report() -> dict:
    """Registers and spills of every `decode_kernel` instantiation (T x
    cache x layout x D x G: 3 x 3 x 2 x 5 x 4 = 360) from nvcc -Xptxas -v's
    report, and the HMMA count of the 16-bit ones in the SASS; fails on any
    spill, on another count or on a 16-bit instantiation without
    tensor-core instructions. Returns the summary."""
    from fa2_triton_tpu_torch.ops import _build, decode

    regs, spills, cur, prop = {}, {}, None, None
    for line in (_build.ptxas_report or "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = m[1] if "decode_kernel" in m[1] else None
        elif m := re.search(r"Function properties for (\S+)", line):
            prop = m[1] if "decode_kernel" in m[1] else None
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and prop:
            spills[prop] = int(m[1]) + int(m[2])
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            regs[cur] = int(m[1])
    hmma = {n: c for n, c in sass_hmma(_build.build()).items() if "decode_kernel" in n}
    sixteen = [n for n in regs if "decode_kernelIf" not in n]   # q bf16 / fp16
    spilled = {n: b for n, b in spills.items() if b}
    no_mma = [n for n in sixteen if not hmma.get(n)]
    # bf16 q over a bf16 contiguous cache, D 128, G 4 (the served shape).
    bf16 = next((n for n in regs
                 if re.search(r"decode_kernelI13__nv_bfloat16S\d*_Lb0ELi128ELi4E", n)), None)
    summary = {"instantiations": len(regs), "registers_min": min(regs.values(), default=0),
               "registers_max": max(regs.values(), default=0), "spilled": len(spilled),
               "sixteen_bit": len(sixteen), "sixteen_bit_without_hmma": len(no_mma),
               "bf16_D128_G4_registers": regs.get(bf16), "bf16_D128_G4_hmma": hmma.get(bf16)}
    print(f"[decode build] {summary['instantiations']} decode_kernel instantiations: "
          f"{summary['registers_min']}-{summary['registers_max']} registers, "
          f"{len(spilled)} spill; {len(sixteen)} 16-bit, each with HMMA in the SASS "
          f"({len(no_mma)} without); bf16 contiguous D 128 G 4: {regs.get(bf16)} registers, "
          f"{hmma.get(bf16)} HMMA")
    want = 3 * 3 * 2 * len(decode.HEAD_DIMS) * len(decode.GROUPS)
    if len(regs) != want or spilled or no_mma or not sixteen:
        raise AssertionError(f"decode build: {len(regs)} instantiations, spills {spilled}, "
                             f"16-bit without HMMA {no_mma[:4]}")
    return summary


def fused_over_pair(fused_runs, pair_runs) -> float:
    """The fused schedule's best time over the dq + dk/dv pair's best."""
    return min(fused_runs) / min(pair_runs)


def beats_fma_design(name, runs, by=1):
    """Fail unless every run is `by` times faster than the kernel's FMA
    design (the top of its FMA_DESIGN_MS range): what the fused tensor-core
    kernels must hold now that the pair runs on tensor cores as well and may
    rightly beat them, and the split forward (by SPLIT_SPEEDUP)."""
    fma = float(FMA_DESIGN_MS[name].split("-")[-1])
    if not max(runs) * by < fma:
        raise AssertionError(f"{name} {runs} ms is not {by}x faster than its FMA design's {fma} ms")


def print_partition(what, loads, heads_x_batch, sms):
    """Blocks launched, blocks per (leaf, kv head, batch row) and the
    largest / mean work of a partition."""
    blocks = len(loads) * heads_x_batch
    ratio = max(loads) * len(loads) / sum(loads)
    print(f"[causal bwd] {what}: {blocks} blocks ({len(loads)} per kv head and batch row; "
          f"{sms} SMs), largest / mean work {ratio:.3f} (work per block {list(loads)})")
    if blocks < sms or ratio > 1.25:
        raise AssertionError(f"{what}: {blocks} blocks, largest / mean {ratio:.3f}")
    return {"blocks": blocks, "blocks_per_head": len(loads), "largest_over_mean": ratio}


def causal_bwd_kernels(torch, card):
    """Each backward schedule kernel held against its plain twin, with
    launches through `flash_attn_backward`'s routing, times (kernel, plain,
    library, the generic dq + dk/dv pair at the same shape) and bounds.
    Returns (launches by run, kernel entries)."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    gen = torch.Generator(device="cuda").manual_seed(12)
    scale = QWEN_D ** -0.5
    kw = dict(softmax_scale=scale)
    entries, runs = {}, {}

    def routed(x, **extra):
        return fb.flash_attn_backward(*x, causal=True, static_skip=True, **kw, **extra)

    def generic(x):
        return fb.flash_attn_backward(*x, causal=True, **kw)

    def launches_of(what, run, **want):
        ff.reset_launches()
        fb.reset_launches()
        run()
        torch.cuda.synchronize()
        got = bwd_launches(ff, fb)
        want = {n: want.get(n, 0) for n in got}
        print(f"[causal bwd] {what}: launches {got}")
        if got != want:
            raise AssertionError(f"{what}: launches {got} != {want}")
        return got

    # -- B13 tri-square at the 2 x 2048 trainer's shape ------------------------
    inputs = bwd_kernel_inputs(torch, gen, TRI_B, TRI_S)
    if fb.backward_route(TRI_S, TRI_S, QWEN_D, 2, causal=True, static_skip=True) != "tri_square":
        raise AssertionError("B 2 x S 2047 MHA does not route to the tri-square")
    tri = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_tri_square(
        q, k, v, do, o, lse, lens, **kw, **d)
    tri_plain = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_plain(
        q, k, v, do, o, lse, lens, causal=True, **kw, **d)
    errs, truth = hold_bwd(torch, f"tri_square B {TRI_B} x S {TRI_S}", tri, tri_plain, inputs)
    xb = inputs(torch.bfloat16)
    runs["tri_square"] = launches_of(f"flash_attn_backward(causal, static_skip) B {TRI_B} x S "
                                     f"{TRI_S}", lambda: routed(xb), bwd_tri_square=1)
    sms = fb.sm_count(xb[0].device)
    P, _, _, loads = fb.tri_partition(TRI_S, TRI_S, 0, 0, 1, TRI_B, QWEN_H, QWEN_D, sms)
    part = print_partition(f"tri_square B {TRI_B} x S {TRI_S} partition (P {P})", loads,
                           TRI_B * QWEN_H, sms)
    t = turns(torch, {"generic": lambda: generic(xb), "tri": lambda: tri(*xb)},
              ("generic", "tri", "tri", "generic"), iters=3)
    per = profiler_split(torch, lambda: tri(*xb), ("fused_delta", "bwd_tri_mma_kernel",
                                                   "tri_dq_reduce"))
    fwd = forward_ms(torch, xb, card)
    pms = cuda_ms(torch, lambda: tri_plain(*xb), iters=2, warmup=1)
    lib_ms = library_bwd(torch, "tri_square", xb, TRI_S, TRI_S, True, truth, errs)
    bound = fused_bound(TRI_B * causal_pairs([TRI_S]), TRI_B * TRI_S, TRI_B * TRI_S)
    print(f"[causal bwd] tri_square B {TRI_B} x S {TRI_S} bf16 [{card}]: call (delta prologue, "
          f"kernel, dq reduction; CUDA events) {' / '.join(f'{v:.3f}' for v in t['tri'])} ms"
          + (f" (profiler: delta {per['fused_delta']:.3f}, kernel {per['bwd_tri_mma_kernel']:.3f}, "
             f"dq reduction {per['tri_dq_reduce']:.3f} ms)" if per else "")
          + f" (the FMA design: {FMA_DESIGN_MS['tri_square']} ms), generic dq + dk/dv "
          f"pair {' / '.join(f'{v:.3f}' for v in t['generic'])} ms (fused / pair "
          f"{fused_over_pair(t['tri'], t['generic']):.3f}), plain {pms:.3f} ms, library "
          f"(aten flash backward, causal) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})")
    beats_fma_design("tri_square", t["tri"])
    entries["flash_bwd_tri_square"] = {
        "max_abs_err": max(errs[n] for n in BWD_NAMES), "ms": min(t["tri"]),
        "ms_runs": t["tri"], "profiler_ms": per, "generic_pair_ms_runs": t["generic"],
        "fused_over_pair": fused_over_pair(t["tri"], t["generic"]),
        "plain_ms": pms, "library_ms": lib_ms, "forward_kernel": fwd, "partition": part,
        **bound}
    del inputs, xb, truth
    gc.collect()
    torch.cuda.empty_cache()

    # -- B14 work list at the 1 x 8192 trainer's shape: four strips ------------
    inputs = bwd_kernel_inputs(torch, gen, 1, WL_S)
    if fb.backward_route(WL_S, WL_S, QWEN_D, 2, causal=True, static_skip=True) != "worklist":
        raise AssertionError("B 1 x S 8191 MHA does not route to the work list")
    wl_kw = dict(sub=512, block_kv=2048)
    wl = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_fused_wl(
        q, k, v, do, o, lse, lens, **wl_kw, **kw, **d)
    key = fb._wl_geometry(WL_S, WL_S, 1, 0, 512, 2048)
    schedule = (key[0], 512, key[1], key[2], 1, 0, (-1, -1), True, key[3], key[4])
    table, starts = fb._worklist(*schedule)
    print(f"[causal bwd] work list at S {WL_S}: {len(table)} steps per head in {len(starts) - 1} "
          f"strips of {[int(b - a) for a, b in zip(starts[:-1], starts[1:])]} steps, dq_whole "
          f"{key[4]}")
    sms = fb.sm_count(torch.device("cuda"))
    chunk_starts, _, _, loads = fb.wl_partition(schedule, WL_S, WL_S, 1, QWEN_H, QWEN_D, sms)
    part = print_partition(f"worklist B 1 x S {WL_S} chunks (at most "
                           f"{int(max(np.diff(chunk_starts)))} steps)", loads, QWEN_H, sms)
    wl_plain = lambda q, k, v, do, o, lse, lens, **d: fb.flash_attn_backward_fused_wl_plain(
        q, k, v, do, o, lse, lens, schedule=schedule, **kw, **d)
    errs, truth = hold_bwd(torch, f"worklist B 1 x S {WL_S}", wl, wl_plain, inputs)
    xb = inputs(torch.bfloat16)
    runs["worklist"] = launches_of(f"flash_attn_backward(causal, static_skip) B 1 x S {WL_S}",
                                   lambda: routed(xb), bwd_worklist=1)
    t = turns(torch, {"generic": lambda: generic(xb), "wl": lambda: wl(*xb)},
              ("generic", "wl", "wl", "generic"), iters=2)
    fwd = forward_ms(torch, xb, card)
    per = profiler_split(torch, lambda: wl(*xb), ("bwd_wl_mma_kernel", "wl_mma_reduce"))
    pms = cuda_ms(torch, lambda: wl_plain(*xb), iters=1, warmup=1)
    lib_ms = library_bwd(torch, "worklist", xb, WL_S, WL_S, True, truth, errs)
    bound = fused_bound(causal_pairs([WL_S]), WL_S, WL_S)
    print(f"[causal bwd] worklist B 1 x S {WL_S} bf16 [{card}]: call (the host's k prescale and "
          f"delta, the kernel, the dk / dv / dq reduction; CUDA events) "
          f"{' / '.join(f'{v:.3f}' for v in t['wl'])} ms"
          + (f" (profiler: kernel {per['bwd_wl_mma_kernel']:.3f}, reduction "
             f"{per['wl_mma_reduce']:.3f} ms)" if per else "")
          + f" (the FMA design: {FMA_DESIGN_MS['worklist']} ms), generic dq + dk/dv pair "
          f"{' / '.join(f'{v:.3f}' for v in t['generic'])} ms (fused / pair "
          f"{fused_over_pair(t['wl'], t['generic']):.3f}), plain (the table walk) {pms:.3f} ms, "
          f"library (aten flash backward, causal) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']})")
    beats_fma_design("worklist", t["wl"])
    entries["flash_bwd_worklist"] = {
        "max_abs_err": max(errs[n] for n in BWD_NAMES), "ms": min(t["wl"]), "ms_runs": t["wl"],
        "profiler_ms": per, "generic_pair_ms_runs": t["generic"],
        "fused_over_pair": fused_over_pair(t["wl"], t["generic"]), "plain_ms": pms,
        "library_ms": lib_ms, "forward_kernel": fwd, "partition": part, **bound}
    del inputs, xb, truth
    gc.collect()
    torch.cuda.empty_cache()

    # -- B13 split forced with split_leaf 2048 at B 1 x S 4096 -----------------
    inputs = bwd_kernel_inputs(torch, gen, 1, SPLIT_S)
    split = lambda q, k, v, do, o, lse, lens, **d: routed((q, k, v, do, o, lse, lens),
                                                          causal_split=True, split_leaf=SPLIT_LEAF,
                                                          **d)
    xb = inputs(torch.bfloat16)
    runs["split"] = launches_of(f"flash_attn_backward(causal_split, split_leaf {SPLIT_LEAF}) B 1 x "
                                f"S {SPLIT_S}", lambda: split(*xb), bwd_causal_diag=1,
                                bwd_rect=1)
    hold_bwd(torch, f"split S {SPLIT_S}", split, tri_plain, inputs)
    split_ms = cuda_ms(torch, lambda: split(*xb), iters=3)

    def prescaled(x):
        q, k, v, do, o, lse, lens = x
        return q, fb._prescale_k(k, scale), v, do, lse, fb.compute_delta(o, do, lse), lens

    region = dict(row0=SPLIT_LEAF, col0=0, nrows=SPLIT_LEAF, ncols=SPLIT_LEAF)
    diag = lambda *x, **d: fb.flash_attn_backward_causal_diag(*prescaled(x), T=SPLIT_LEAF,
                                                              **kw, **d)
    diag_plain = lambda *x, **d: fb.flash_attn_backward_causal_diag_plain(
        *prescaled(x), T=SPLIT_LEAF, **kw, **d)
    rect = lambda *x, **d: fb.flash_attn_backward_rect(*prescaled(x), **region, **kw, **d)
    rect_plain = lambda *x, **d: fb.flash_attn_backward_rect_plain(*prescaled(x), **region,
                                                                   **kw, **d)
    pb = prescaled(xb)
    P, _, _, loads = fb.tri_partition(SPLIT_S, SPLIT_S, 0, SPLIT_LEAF, 1, 1, QWEN_H, QWEN_D,
                                      fb.sm_count(xb[0].device))
    diag_part = print_partition(f"causal_diag S {SPLIT_S} leaves {SPLIT_LEAF} partition (P {P} "
                                f"per leaf)", loads, QWEN_H, fb.sm_count(xb[0].device))
    for name, kern, plain_fn, lib in (("causal_diag", diag, diag_plain, "flex"),
                                      ("rect", rect, rect_plain, "aten")):
        errs, truth = hold_bwd(torch, f"{name} S {SPLIT_S}", kern, plain_fn, inputs)
        if name == "causal_diag":
            run = lambda: fb.flash_attn_backward_causal_diag(*pb, T=SPLIT_LEAF, **kw)
            ms = cuda_ms(torch, run, iters=3)
            pms = cuda_ms(torch, lambda: fb.flash_attn_backward_causal_diag_plain(
                *pb, T=SPLIT_LEAF, **kw), iters=2, warmup=1)
            lib_ms = flex_diag_bwd(torch, xb, local_truth(torch, "diag", inputs), errs)
            bound = fused_bound(causal_pairs([SPLIT_LEAF] * (SPLIT_S // SPLIT_LEAF)), SPLIT_S,
                                SPLIT_S)
        else:
            run = lambda: fb.flash_attn_backward_rect(*pb, **region, **kw)
            ms = cuda_ms(torch, run, iters=3)
            pms = cuda_ms(torch, lambda: fb.flash_attn_backward_rect_plain(
                *pb, **region, **kw), iters=2, warmup=1)
            lib_ms = library_bwd(torch, "rect", xb, SPLIT_LEAF, SPLIT_LEAF, False,
                                 local_truth(torch, "rect", inputs), errs,
                                 rows=slice(SPLIT_LEAF, SPLIT_S), cols=slice(0, SPLIT_LEAF))
            bound = fused_bound(SPLIT_LEAF * SPLIT_LEAF, SPLIT_LEAF, SPLIT_LEAF)
        how = (f"; the FMA design: {FMA_DESIGN_MS[name]} ms" if name == "causal_diag"
               else f": its dq and dk/dv kernels; the FMA design: {FMA_DESIGN_MS[name]} ms")
        beats_fma_design(name, [ms])
        print(f"[causal bwd] {name} (split_leaf {SPLIT_LEAF}, S {SPLIT_S}) bf16 [{card}]: kernel "
              f"{ms:.3f} ms (CUDA events over whole calls{how}), plain {pms:.3f} ms, library "
              f"({lib}) {lib_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        entries[f"flash_bwd_{name}"] = {"max_abs_err": max(errs[n] for n in BWD_NAMES), "ms": ms,
                                       "plain_ms": pms, "library_ms": lib_ms, **bound}
        del truth
    entries["flash_bwd_causal_diag"].update(split_S4096_call_ms=split_ms, partition=diag_part)
    print(f"[causal bwd] the whole split backward at S {SPLIT_S}: {split_ms:.3f} ms [{card}]")
    del inputs, xb, pb
    gc.collect()
    torch.cuda.empty_cache()
    return runs, entries


def local_truth(torch, kind, inputs):
    """The fp32 gradients of the function the diag's and the rect's library
    yardsticks compute: attention over the leaves alone (flex's
    block-diagonal mask) or over the region alone (aten on the sliced
    tensors), each normalised by its own softmax. The split's kernels take
    the global lse and delta instead (their share of the whole causal
    gradient), which no PyTorch call accepts; the work is the same, so the
    yardstick is held to the twin fed its own statistics."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    q, k, v, do, _, lse, lens = inputs(torch.float32)
    kw = dict(softmax_scale=QWEN_D ** -0.5)
    k_p = fb._prescale_k(k, kw["softmax_scale"])
    if kind == "diag":
        o_d, lse_d = ff.flash_attn_forward_causal_diag_plain(q, k, v, lens, T=SPLIT_LEAF, **kw)
        return fb.flash_attn_backward_causal_diag_plain(
            q, k_p, v, do, lse_d, fb.compute_delta(o_d, do, lse_d), lens, T=SPLIT_LEAF, **kw)
    region = dict(row0=SPLIT_LEAF, col0=0, nrows=SPLIT_LEAF, ncols=SPLIT_LEAF)
    rows = slice(SPLIT_LEAF, SPLIT_S)
    o_r, lse_r = ff.flash_attn_forward_rect_plain(q, k, v, lens, **region, **kw)
    lse_full, delta_full = lse.clone(), torch.zeros_like(lse)
    lse_full[:, :, rows] = lse_r
    delta_full[:, :, rows] = fb.compute_delta(o_r, do[:, :, rows], lse_r)
    return fb.flash_attn_backward_rect_plain(q, k_p, v, do, lse_full, delta_full, lens, **region,
                                             **kw)


def flex_diag_bwd(torch, xb, truth, errs):
    """Compiled flex_attention's backward with a block-diagonal causal
    mask_mod (the diag leaves) on the same bf16 tensors: checked against
    `local_truth`, CUDA-event ms of one backward."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    q, k, v, do = (t.contiguous() for t in xb[:4])

    def leaf_mask(b, h, qi, ki):
        return (ki <= qi) & (qi // SPLIT_LEAF == ki // SPLIT_LEAF)

    block_mask = create_block_mask(leaf_mask, None, None, SPLIT_S, SPLIT_S, device=q.device,
                                   BLOCK_SIZE=128)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (t.detach().requires_grad_() for t in (q, k, v))
    out = flex(qh, kh, vh, block_mask=block_mask, scale=QWEN_D ** -0.5)
    grads = torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)
    for n, g, r in zip(BWD_NAMES, grads, truth):
        check_library(torch, f"diag {n}", g, r, errs[n + " plain"])
    return cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True),
                   iters=5)


def qwen_train(torch, card: str):
    """The full-depth Qwen1.5-7B-width trainer at 2 x 2048 (attention over
    2047 tokens: the tri-square backward) and 1 x 8192 (8191: the work
    list), launch counts reset after each warm-up. Returns the launches by
    shape."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    def reset():
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()

    runs = {}
    for batch, seq in QWEN_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        oom = None
        try:
            args, res = run_trainer(torch, card, qwen_train_argv(batch, seq), reset,
                                    f"qwen train {batch} x {seq}")
        except torch.cuda.OutOfMemoryError as e:
            if seq != 8192:
                raise
            oom = (torch.cuda.max_memory_allocated() / 2**30, str(e).splitlines()[0])
        if oom is not None:
            # The memory rule: the same work-list route at 1 x 6144.
            print(f"[qwen train] 1 x {seq} ran out of memory (peak {oom[0]:.2f} GiB [{card}]): "
                  f"{oom[1]}; running 1 x {QWEN_FALLBACK_SEQ}")
            gc.collect()
            torch.cuda.empty_cache()
            seq = QWEN_FALLBACK_SEQ
            args, res = run_trainer(torch, card, qwen_train_argv(batch, seq), reset,
                                    f"qwen train {batch} x {seq}")
        got = bwd_launches(flash_fwd, flash_bwd)
        L, steps = res["config"].n_layers, args.steps
        fwd_route = flash_fwd.forward_route(seq - 1, seq - 1, QWEN_D, 2, causal=True,
                                            static_skip=True)
        want = dict.fromkeys(got, 0)
        want["causal_strip" if fwd_route == "strip" else "flash_fwd"] = 2 * L * steps
        want["bwd_tri_square" if seq == 2048 else "bwd_worklist"] = L * steps
        print(f"[qwen train] {batch} x {seq} launches: {got}")
        if got != want:
            raise AssertionError(f"qwen {batch} x {seq} training launches {got} != {want}")
        runs[f"{batch} x {seq}"] = got
    return runs


def phase_causal_bwd(torch, card: str, mma=None):
    """Phase 12: the causal backward schedules (`mma`: mma_build_report's
    table, made here when not given). Returns (launches by run, kernel
    entries)."""
    from fa2_triton_tpu_torch.ops import flash_bwd

    t0 = time.perf_counter()
    if any(flash_bwd.SCHEDULE_LAUNCHES.values()):
        raise AssertionError(f"phases 1-11 launched a backward schedule kernel: "
                             f"{flash_bwd.SCHEDULE_LAUNCHES}")
    print("[causal bwd] phases 1-11 (Mistral-7B-v0.3 widths) launched no backward schedule "
          f"kernel: {dict(flash_bwd.SCHEDULE_LAUNCHES)}")
    mma = mma or mma_build_report()
    runs, entries = causal_bwd_kernels(torch, card)
    entries["flash_bwd_tri_square"]["build"] = mma["bwd_tri_mma_kernel"]
    entries["flash_bwd_worklist"]["build"] = mma["bwd_wl_mma_kernel"]
    runs["train"] = qwen_train(torch, card)
    print(f"[causal bwd] phase 12 took {time.perf_counter() - t0:.1f} s")
    return runs, entries


# Phase 16: the runtime and training extras at Mistral-7B-v0.3 widths, cut
# to EXTRAS_LAYERS layers (full width, 1.14 B parameters: each checkpoint of
# the bf16 weights and both AdamW moments is ~6.8 GB; at 32 layers it would
# be 43.5 GB). The corpus: EXTRAS_WINDOWS windows of TRAIN_SEQ tokens from
# numpy.random.RandomState(0), written by encode_corpus; the trainer reads
# windows of TRAIN_SEQ - 1 tokens plus their target, 32 steps an epoch.
EXTRAS_LAYERS, EXTRAS_WINDOWS = 4, 64
EXTRAS_ARGV = ["--config", "mistral-7b-v0.3", "--layers", str(EXTRAS_LAYERS), "--batch", "2",
               "--seq", str(TRAIN_SEQ), "--remat"]
EXTRAS_FIRST, EXTRAS_STEPS, EXTRAS_SAVE_EVERY = 4, 6, 2
EXTRAS_EVAL_BATCHES = 2
# device_time of one flash_attn_func call against cuda_ms of the same call.
DEVICE_TIME_RATIO = (0.5, 2.0)


def train_counts():
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES}


def extras_resume(torch, card, work, corpus):
    """(a) 4 steps with checkpoints every 2, then a fresh trainer resumed from
    the same directory to 6, against an uninterrupted 6-step run: losses bit
    for bit, launches of the resumed steps."""
    from fa2_triton_tpu_torch.examples import train

    ckpt = os.path.join(work, "ckpt")
    base = EXTRAS_ARGV + ["--data", corpus]
    ck = ["--ckpt-dir", ckpt, "--save-every", str(EXTRAS_SAVE_EVERY)]
    first = train.run(train.parse_args(base + ck + ["--steps", str(EXTRAS_FIRST)]))
    saved = sorted(os.listdir(ckpt))
    if saved != ["2.pt", "4.pt"]:
        raise AssertionError(f"checkpoints after {EXTRAS_FIRST} steps: {saved}")
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, f"{EXTRAS_FIRST}.pt"))
    os.remove(os.path.join(ckpt, "2.pt"))        # disk room: the resume reads step 4
    gc.collect()
    torch.cuda.empty_cache()
    resumed = train.run(train.parse_args(base + ck + ["--steps", str(EXTRAS_STEPS)]),
                        on_warm=reset_counts)
    launches = train_counts()
    gc.collect()
    torch.cuda.empty_cache()
    whole = train.run(train.parse_args(base + ["--steps", str(EXTRAS_STEPS)]))
    gc.collect()
    torch.cuda.empty_cache()
    rep = resumed["report"]
    print(f"[extras] (a) {train.PRESETS['mistral-7b-v0.3']['n_layers']}-layer Mistral-7B-v0.3 "
          f"widths cut to {EXTRAS_LAYERS} layers, {whole['n_params'] / 1e9:.3f} B params, 2 x "
          f"{TRAIN_SEQ} corpus windows: steps 0-{EXTRAS_FIRST - 1} {first['losses']}, resumed at "
          f"step {resumed['start']}: {resumed['losses']}; uninterrupted {whole['losses']}")
    print(f"[extras] (a) checkpoint of step {EXTRAS_FIRST}: {ckpt_bytes} bytes "
          f"({ckpt_bytes / 1e9:.3f} GB); save calls (host copy) "
          f"{[round(x, 3) for x in first['report'].save_s]} s, writes to disk "
          f"{[round(x, 3) for x in first['report'].write_s]} s; the resumed run's restore "
          f"{rep.restore_s:.3f} s, its save {[round(x, 3) for x in rep.save_s]} s, write "
          f"{[round(x, 3) for x in rep.write_s]} s; step s of the uninterrupted run "
          f"{[round(x, 4) for x in whole['step_s']]}, {whole['tokens_per_s']:.0f} tokens/s "
          f"(median step), peak memory {whole['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    if resumed["start"] != EXTRAS_FIRST or rep.resumed_from != EXTRAS_FIRST:
        raise AssertionError(f"resumed at {resumed['start']}, want {EXTRAS_FIRST}")
    if first["losses"] + resumed["losses"] != whole["losses"]:
        raise AssertionError("the resumed run's losses differ from the uninterrupted run's: "
                             f"{first['losses'] + resumed['losses']} vs {whole['losses']}")
    if not np.isfinite(whole["losses"]).all():
        raise AssertionError(f"non-finite losses {whole['losses']}")
    L, steps = EXTRAS_LAYERS, EXTRAS_STEPS - EXTRAS_FIRST
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dbias": 0}
    if launches != want:
        raise AssertionError(f"resumed launches {launches} != {want}")
    return ckpt, {
        "launches": launches, "losses": whole["losses"], "resumed_at": resumed["start"],
        "checkpoint_bytes": ckpt_bytes, "save_s": first["report"].save_s + rep.save_s,
        "write_s": first["report"].write_s + rep.write_s, "restore_s": rep.restore_s,
        "step_s": whole["step_s"], "peak_gib": whole["peak_bytes"] / 2**30,
        "n_params": whole["n_params"],
        "tokens_per_step": whole["tokens_per_step"]}


def extras_guard_eval(torch, card, ckpt, corpus):
    """(b) a step whose loss is multiplied by NaN, on the state restored from
    the newest checkpoint, leaves it bit for bit; (c) examples/eval.py on that
    checkpoint against loss_fn on the same state and windows. Returns the
    restored state (for (d)) and the results."""
    from fa2_triton_tpu_torch.examples import eval as evalmod
    from fa2_triton_tpu_torch.examples import train
    from fa2_triton_tpu_torch.models import init_params, loss_fn
    from fa2_triton_tpu_torch.utils.data import TokenLoader, open_corpus
    from fa2_triton_tpu_torch.utils.resilience import ResilientTrainer

    args = train.parse_args(EXTRAS_ARGV + ["--data", corpus, "--steps", str(EXTRAS_STEPS)])
    cfg = train.build_config(args)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    state = {"model": model, "opt": train.make_optimizer(model, args.lr), "step": 0}

    def lr_fn(step):
        return train.lr_at(step, args.lr, args.steps, args.warmup)

    def nan_loss(m, tokens):
        return loss_fn(m, tokens) * float("nan")

    guard = ResilientTrainer(*train.step_fns(cfg, lr_fn, args.grad_clip, loss=nan_loss), ckpt,
                             save_every=10 ** 9)
    state, start = guard.restore_or_init(state)
    if start != EXTRAS_STEPS or state["step"] != EXTRAS_STEPS:
        raise AssertionError(f"restored step {start} / {state['step']}, want {EXTRAS_STEPS}")
    corpus_data = open_corpus(corpus, cfg.vocab_size)
    tokens = torch.from_numpy(next(TokenLoader(corpus_data, 2, TRAIN_SEQ - 1).stream(start))).cuda()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = [{k: v.clone() for k, v in state["opt"].state[p].items()}
               for p in model.parameters()]
    loss, ok = guard.step(state, tokens, start)
    guard.close()
    changed = [n for n, p in model.named_parameters() if not torch.equal(p, params[n])]
    changed += [f"{i}.{k}" for i, (p, m) in enumerate(zip(model.parameters(), moments))
                for k, v in m.items() if not torch.equal(state["opt"].state[p][k], v)]
    print(f"[extras] (b) a step with the loss x NaN on the restored step {start}: loss {loss}, "
          f"ok {ok}, steps_skipped {guard.report.steps_skipped}; {len(params)} parameters and "
          f"their exp_avg / exp_avg_sq / step, changed: {changed or 'none'}; step count "
          f"{state['step']}")
    if ok or guard.report.steps_skipped != 1 or changed or state["step"] != EXTRAS_STEPS:
        raise AssertionError("the non-finite step was not skipped cleanly")
    del params, moments
    torch.cuda.empty_cache()

    reset_counts()
    ev = evalmod.main(["--config", "mistral-7b-v0.3", "--layers", str(EXTRAS_LAYERS),
                       "--data", corpus, "--ckpt-dir", ckpt, "--batches",
                       str(EXTRAS_EVAL_BATCHES), "--batch", "2", "--seq", str(TRAIN_SEQ)])
    launches = train_counts()
    gc.collect()
    torch.cuda.empty_cache()
    loader = TokenLoader(corpus_data, 2, TRAIN_SEQ, seed=0)
    with torch.no_grad():
        direct = [float(loss_fn(model, torch.from_numpy(b).cuda().long()))
                  for b in itertools.islice(loader, EXTRAS_EVAL_BATCHES)]
    mean = sum(direct) / len(direct)
    print(f"[extras] (c) examples/eval.py on the step-{ev['step']} checkpoint: cross-entropy "
          f"{ev['nll']!r} over {ev['batches']} batches of 2 x {TRAIN_SEQ}; loss_fn on the "
          f"restored model over the same windows {mean!r}; launches {launches}")
    want = {"flash_fwd": EXTRAS_LAYERS * EXTRAS_EVAL_BATCHES, "flash_bwd_dq": 0,
            "flash_bwd_dkdv": 0, "flash_bwd_dbias": 0}
    if ev["step"] != EXTRAS_STEPS or ev["nll"] != mean or launches != want:
        raise AssertionError(f"eval: step {ev['step']}, {ev['nll']!r} vs loss_fn {mean!r}, "
                             f"launches {launches} (want {want})")
    return state, cfg, args, {"nll": ev["nll"], "launches": launches}


def extras_probes(torch, card, work, state, cfg, args, resume):
    """(d) the device probe, a profiler trace of one step, device_time
    against CUDA events, and the trainer's roofline line."""
    from fa2_triton_tpu_torch.examples import train
    from fa2_triton_tpu_torch.ops.attention import flash_attn_func
    from fa2_triton_tpu_torch.utils.benchmarking import device_time
    from fa2_triton_tpu_torch.utils.profiling import detect_chip, profile_trace, roofline
    from fa2_triton_tpu_torch.utils.resilience import ResilientTrainer, devices_healthy

    t0 = time.perf_counter()
    healthy = devices_healthy()
    probe_s = time.perf_counter() - t0
    if not healthy:
        raise AssertionError("devices_healthy() is False")
    step_fn = ResilientTrainer(*train.step_fns(
        cfg, lambda s: train.lr_at(s, args.lr, args.steps, args.warmup), args.grad_clip), None)
    tokens = torch.from_numpy(next(train.host_batches(args, cfg.vocab_size, 0))).cuda()
    logdir = os.path.join(work, "trace")
    with profile_trace(logdir):
        loss, ok = step_fn.step(state, tokens, state["step"])
        torch.cuda.synchronize()
    traces = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    sizes = [os.path.getsize(f) for f in traces]
    with open(traces[0]) as f:
        text = f.read()
    kernels = [n for n in ("flash_fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel")
               if n in text]
    print(f"[extras] (d) devices_healthy() True in {probe_s:.2f} s (a subprocess); "
          f"profile_trace of one step (loss {loss:.4f}, ok {ok}): {len(traces)} file of "
          f"{sizes} bytes, naming {kernels}")
    if not ok or len(traces) != 1 or not sizes[0]:
        raise AssertionError("profile_trace wrote no trace")
    del step_fn, tokens
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(16)
    q32, k32, v32, _, _ = attn_inputs(torch, gen, "cuda", TRAIN_SEQ)
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))

    def call(q, k, v):
        return flash_attn_func(q, k, v, causal=True)

    dt_ms = device_time(call, q, k, v) * 1e3
    ev_ms = cuda_ms(torch, lambda: call(q, k, v), iters=20)
    ratio = dt_ms / ev_ms
    print(f"[extras] (d) flash_attn_func B 2 x S {TRAIN_SEQ}, 32 / 8 heads, D 128, bf16, causal: "
          f"device_time {dt_ms:.4f} ms, cuda_ms {ev_ms:.4f} ms (ratio {ratio:.3f}) [{card}]")
    if not DEVICE_TIME_RATIO[0] <= ratio <= DEVICE_TIME_RATIO[1]:
        raise AssertionError(f"device_time / cuda_ms {ratio:.3f} outside {DEVICE_TIME_RATIO}")
    med = float(np.median(resume["step_s"]))
    report = roofline(time_s=med, flops=6 * resume["n_params"] * resume["tokens_per_step"],
                      bytes_moved=2 * resume["n_params"] * 2)
    print(f"[extras] (d) the trainer's roofline line ({EXTRAS_LAYERS} layers, median step "
          f"{med:.4f} s): per-step {report.summary()} (detect_chip {detect_chip()!r}) [{card}]")
    return {"probe_s": probe_s, "trace_bytes": sizes[0], "trace_kernels": kernels,
            "device_time_ms": dt_ms, "cuda_ms": ev_ms, "roofline": report.summary()}


def extras_demo(torch, card):
    """(e) the serving demo: 8 requests of 16 new tokens, its JSON line."""
    from fa2_triton_tpu_torch.ops import decode, flash_fwd
    from fa2_triton_tpu_torch.runtime import serving_demo

    reset_counts()
    res = serving_demo.main(["--requests", "8", "--new-tokens", "16"])
    launches = {"flash_fwd": flash_fwd.LAUNCHES, "decode": decode.LAUNCHES}
    stats = res["stats"]
    print(f"[extras] (e) serving_demo --requests 8 --new-tokens 16: {res['value']} tokens/s "
          f"({stats.decode_tokens} decode tokens in {stats.wall_s:.3f} s, {stats.decode_steps} "
          f"steps, {stats.prefill_dispatches} prefill dispatches); launches with its warm-up "
          f"{launches} [{card}]")
    if not res["value"] > 0 or not all(launches.values()):
        raise AssertionError(f"serving demo: {res['value']} tokens/s, launches {launches}")
    return {"tokens_per_s": res["value"], "launches": launches,
            "decode_steps": stats.decode_steps}


def phase_extras(torch, card: str):
    """Phase 16: corpus training with checkpoints and a resume, the guarded
    step, eval, the probes and timers, and the serving demo."""
    import shutil
    import tempfile

    from fa2_triton_tpu_torch.examples import train
    from fa2_triton_tpu_torch.utils.data import encode_corpus

    t0 = time.perf_counter()
    root = os.path.join(HERE, "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase16-", dir=root)
    try:
        corpus = os.path.join(work, "corpus.bin")
        vocab = train.PRESETS["mistral-7b-v0.3"]["vocab_size"]
        encode_corpus(np.random.RandomState(0).randint(
            0, vocab, size=EXTRAS_WINDOWS * TRAIN_SEQ + 1), corpus, vocab)
        ckpt, resume = extras_resume(torch, card, work, corpus)
        state, cfg, args, ev = extras_guard_eval(torch, card, ckpt, corpus)
        probes = extras_probes(torch, card, work, state, cfg, args, resume)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    demo = extras_demo(torch, card)
    seconds = time.perf_counter() - t0
    print(f"[extras] phase 16: {seconds:.1f} s")
    return {"resume": resume, "eval": ev, "probes": probes, "demo": demo, "seconds": seconds}


ROUTING_HEADS = 4                # phase 17: B 1, 4 query heads, 4 / group kv heads
MISS_KEY = ("fwd_route", 128, 256)  # phase 17's tune-on-miss: a key the shipped table lacks


def routing_launches(flash_fwd, flash_bwd):
    return ({n: c for n, c in flash_fwd.SCHEDULE_LAUNCHES.items() if c}, flash_fwd.LAUNCHES,
            {n: c for n, c in flash_bwd.SCHEDULE_LAUNCHES.items() if c},
            {n: c for n, c in flash_bwd.LAUNCHES.items() if c})


def route_launches(f_route, b_route, S, D, group):
    """The launch counts of one flash_attn_func forward + backward at S x S
    that took these routes (routing_launches' form)."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    fwd = ({"causal_diag": 1, "rect_merge": 1} if f_route == "split" else
           {"causal_strip": 1} if f_route == "strip" else {})
    pair = {"flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
    if b_route in ("strip", "generic"):
        bwd = {}
    elif b_route == "split":
        Sq_p, _, Dp = flash_fwd.jax_padded_shape(S, S, D, 2)
        n = -(-Sq_p // flash_bwd.bwd_split_leaf_t(Dp, group))
        bwd, pair = {"causal_diag": 1, "rect": len(flash_fwd.causal_split_rects(n))}, {}
    else:
        bwd, pair = {b_route: 1}, {}
    return fwd, int(f_route in ("tri_square", "generic")), bwd, pair


def routed_call(torch, x32, do32, table: bool):
    """flash_attn_func forward + backward in bf16, with the tuning table or
    without it (FA2_DISABLE_TUNING_TABLE=1); (out, lse, grads, launches)."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd
    from fa2_triton_tpu_torch.ops.attention import flash_attn_func

    if table:
        os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)
    else:
        os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"
    try:
        leaves = [t.to(torch.bfloat16).requires_grad_() for t in x32]
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()
        out, lse = flash_attn_func(*leaves, causal=True, return_lse=True)
        out.backward(do32.to(torch.bfloat16))
        torch.cuda.synchronize()
        return out.detach(), lse.detach(), [x.grad for x in leaves], routing_launches(
            flash_fwd, flash_bwd)
    finally:
        os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)


def routing_shape(torch, table, chip, D, bucket, group, dev="cuda"):
    """(a) one (head dim, bucket, group) of the table: the table's routes
    and the prior's, each run through flash_attn_func with its launches
    checked and held against the fp32 plain twins (bf16 FA rules)."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    S, dev = bucket - 1, torch.device(dev)
    routes = {}
    for which, c in (("table", chip), ("prior", None)):
        routes[which] = (flash_fwd.forward_route(S, S, D, 2, causal=True, static_skip=True,
                                                 chip=c),
                         flash_bwd.backward_route(S, S, D, 2, causal=True, static_skip=True,
                                                  group=group, chip=c))
    want = (table.get(f"fwd_route:1:{D}:{bucket}", [routes["prior"][0]])[0],
            table.get(f"bwd_route+g{group}:1:{D}:{bucket}", [routes["prior"][1]])[0])
    if routes["table"] != want:
        raise AssertionError(f"routing D {D} bucket {bucket} g{group}: the table names {want}, "
                             f"the routes are {routes['table']}")
    g = torch.Generator(device=dev).manual_seed(bucket + D + group)
    Hq, Hkv = ROUTING_HEADS, ROUTING_HEADS // group
    x32 = [torch.randn(1, S, h, D, generator=g, device=dev) * 0.5 for h in (Hq, Hkv, Hkv)]
    do32 = torch.randn(1, S, Hq, D, generator=g, device=dev)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    refs = flash_bwd.flash_attn_backward_plain(*(t(x) for x in x32), t(do32), o32, lse32, lens,
                                               **kw)
    xb = [t(x.to(torch.bfloat16)) for x in x32]
    o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*xb, lens, **kw)
    plains = flash_bwd.flash_attn_backward_plain(*xb, t(do32.to(torch.bfloat16)), o_pl, lse_pl,
                                                 lens, **kw)
    row = {"routes": {w: list(r) for w, r in routes.items()}, "errs": {}}
    for which in ("table", "prior"):
        out, lse, grads, got = routed_call(torch, x32, do32, which == "table")
        expected = route_launches(*routes[which], S, D, group)
        if got != expected:
            raise AssertionError(f"routing D {D} bucket {bucket} g{group} {which} "
                                 f"{routes[which]}: launches {got} != {expected}")
        err, yard = max_abs(torch, t(out), o32), max_abs(torch, o_pl, o32)
        if not err <= OUT_ERROR_MUL * yard + OUT_ERROR_BIAS:
            raise AssertionError(f"routing D {D} bucket {bucket} g{group} {which}: out err "
                                 f"{err:.3e} > 2 x {yard:.3e} + 5e-5")
        check_lse(torch, lse, lse_pl, f"routing D {D} bucket {bucket} {which}")
        gerrs = [check_grad(torch, n, t(gr), r, p, f"routing D {D} bucket {bucket} {which}")[0]
                 for n, gr, r, p in zip(BWD_NAMES, grads, refs, plains)]
        row["errs"][which] = [err] + gerrs
        del out, lse, grads
    del o32, refs, plains, o_pl
    torch.cuda.empty_cache()
    return row


def routing_tune_on_miss(torch, card):
    """(b) FA2_TUNE_ON_MISS=1 into a temporary FA2_TUNING_DIR: a call at a
    key the shipped table lacks sweeps it once and persists its winner,
    which must be a candidate of the key and either the prior's route or
    faster than it by more than the spread."""
    import shutil
    import tempfile

    from fa2_triton_tpu_torch.ops import autotune, microsweep
    from fa2_triton_tpu_torch.ops.attention import flash_attn_func

    kind, D, bucket = MISS_KEY
    root = os.path.join(HERE, "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase17-", dir=root)
    saved = os.environ.get("FA2_TUNING_DIR")
    os.environ.update(FA2_TUNING_DIR=work, FA2_TUNE_ON_MISS="1")
    autotune._load_table.cache_clear()
    try:
        t0 = time.perf_counter()
        S = bucket - 1
        q = torch.randn(max(1, 4096 // bucket), S, 32, D, device="cuda", dtype=torch.bfloat16)
        flash_attn_func(q, q, q, causal=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path = os.path.join(work, f"tuning_{autotune.detect_chip()}.json")
        persisted = json.loads(open(path).read())
        key = autotune._key(kind, True, D, bucket)
        winner = persisted.get(key)
        cands = [c[0] for c in microsweep.candidates(kind, True, D, bucket)]
        prior = microsweep.prior_route(kind, D, bucket)
        print(f"[routing] (b) tune-on-miss {key}: persisted {winner} in {seconds:.1f} s "
              f"(candidates {cands}, prior {prior}), table {persisted} [{card}]")
        if winner is None or len(winner) != 1 or winner[0] not in cands:
            raise AssertionError(f"tune-on-miss persisted {winner} for {key}, not one of {cands}")
        return {"key": key, "winner": winner[0], "prior": prior, "candidates": cands,
                "seconds": seconds}
    finally:
        os.environ.pop("FA2_TUNE_ON_MISS", None)
        if saved is None:
            os.environ.pop("FA2_TUNING_DIR", None)
        else:
            os.environ["FA2_TUNING_DIR"] = saved
        autotune._load_table.cache_clear()
        shutil.rmtree(work, ignore_errors=True)


def routing_fp16(torch, card):
    """(c) fp16 through flash_attn_func: by default the fp32 kernels (no
    tensor-core kernel in the profile), with fp16_compute_dtype=bfloat16
    the tensor-core ones; the fp16 output against the fp32 plain twin under
    the FA rule, the yardstick the plain twin on the inputs as each call
    computes them (fp16, or fp16 cast to bf16)."""
    from fa2_triton_tpu_torch.ops import flash_fwd
    from fa2_triton_tpu_torch.ops.attention import flash_attn_func

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    S, D = 2047, 128
    x32 = [torch.randn(2, S, h, D, generator=g, device=dev) * 0.5 for h in (32, 8, 8)]
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    lens = torch.tensor([[S, S]] * 2, dtype=torch.int32, device=dev)
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, _ = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)
    res = {}
    for compute in (None, torch.bfloat16):
        x16 = [x.half() for x in x32]
        o_pl, _ = flash_fwd.flash_attn_forward_plain(
            *(t(x if compute is None else x.to(compute)) for x in x16), lens, **kw)
        yard = max_abs(torch, o_pl, o32)
        fn = lambda: flash_attn_func(*x16, causal=True, fp16_compute_dtype=compute)  # noqa
        events = profiled(torch, fn, 1, lambda ev: any(
            "flash_fwd" in e.key and _device_us(e) for e in ev), attempts=5)
        names = sorted({e.key for e in events if "flash_fwd" in e.key})
        mma = any("flash_fwd_mma_kernel" in n for n in names)
        out = fn()
        err = max_abs(torch, t(out), o32)
        ms = cuda_ms(torch, fn, iters=5)
        what = "default (fp32)" if compute is None else "fp16_compute_dtype=bfloat16"
        print(f"[routing] (c) fp16 flash_attn_func B 2 x S {S}, 32 / 8 heads, {what}: kernels "
              f"{names}, err vs fp32 {err:.3e} (plain twin {yard:.3e}), {ms:.3f} ms [{card}]")
        if out.dtype != torch.float16 or mma != (compute is not None):
            raise AssertionError(f"fp16 {what}: dtype {out.dtype}, kernels {names}")
        if not err <= OUT_ERROR_MUL * yard + OUT_ERROR_BIAS:
            raise AssertionError(f"fp16 {what}: err {err:.3e} > 2 x {yard:.3e} + 5e-5")
        res["fp32" if compute is None else "bf16"] = {"kernels": names, "err": err, "ms": ms}
    return res


def phase_routing(torch, card):
    """Phase 17: the card's tuning table. (a) every (head dim, bucket,
    group) of the shipped table through flash_attn_func with the table and
    without it; (b) one tune-on-miss; (c) fp16's kernels."""
    from fa2_triton_tpu_torch.ops import autotune

    t0 = time.perf_counter()
    os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)   # set for phases 1-16
    chip = autotune.detect_chip()
    path = autotune.table_paths(chip)[0]
    table = json.loads(path.read_text())
    print(f"[routing] detect_chip() {chip!r}, table {os.path.relpath(path, HERE)}: "
          f"{len(table)} entries {json.dumps(table, sort_keys=True)} [{card}]")
    shapes = sorted({(int(k.split(":")[2]), int(k.split(":")[3]),
                      int(k.split(":")[0].partition("+g")[2] or 1)) for k in table})
    rows, changed = {}, 0
    for D, bucket, group in shapes:
        row = routing_shape(torch, table, chip, D, bucket, group)
        rows[f"D {D} bucket {bucket} g{group}"] = row
        changed += row["routes"]["table"] != row["routes"]["prior"]
        print(f"[routing] (a) D {D} bucket {bucket} g{group} (B 1 x S {bucket - 1}, "
              f"{ROUTING_HEADS} / {ROUTING_HEADS // group} heads): table {row['routes']['table']}"
              f", prior {row['routes']['prior']}; errs (out, dq, dk, dv) table "
              f"{['%.2e' % e for e in row['errs']['table']]}, prior "
              f"{['%.2e' % e for e in row['errs']['prior']]}")
    miss = routing_tune_on_miss(torch, card)
    fp16 = routing_fp16(torch, card)
    seconds = time.perf_counter() - t0
    print(f"[routing] phase 17: {len(shapes)} shapes, {changed} routed off the prior by the "
          f"table, {seconds:.1f} s [{card}]")
    return {"chip": chip, "entries": len(table), "shapes": rows, "changed_shapes": changed,
            "tune_on_miss": miss, "fp16": fp16, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 18: the parallel layer (`parallel/`), ranks spawned on this one card.

PAR_RANKS = 4                    # (a) / (b): seq 4, or data 2 x model 2
PAR_SEQ = 8192                   # zigzag chunks of PAR_SEQ / (2 x 4) = 1024
PAR_DROPOUT = (0.1, 20231018)    # p, seed
# (c)'s depth: 8 of Mistral's 32 layers. At 32 the TP-2 Engine took 26-31 s
# a mode on an H100 (4480 all-reduces staged through the host, 7.9 GB of
# them) and the phase 163 s; the aim is about 90 s.
PAR_LAYERS = int(os.environ.get("CHIP_SMOKE_PAR_LAYERS", "8"))
PAR_TIE = 4.0                    # a divergence passes within 4x the measured drift
PAR_CASES = (
    ("ring causal zigzag", "ring", {"causal": True}),
    ("ring causal zigzag dropout", "ring", {"causal": True, "dropout": True}),
    ("ring causal zigzag lse", "ring", {"causal": True, "lse": True}),
    ("ring non-causal contiguous", "ring", {"causal": False}),
    ("ulysses causal", "ulysses", {"causal": True}),
    ("tp attention causal", "tp", {"causal": True}),
)
# (c)'s Engine options per mode (qdtype by torch dtype name).
PAR_SERVE_MODES = {"contiguous": {}, "paged": {"paged": True}, "int8": {"qdtype": "int8"}}


def no_jax_here():
    if any(n == "jax" or n.startswith(("jax.", "fa2_triton_tpu.")) for n in sys.modules):
        raise RuntimeError("a rank imported jax or the JAX package")


def par_inputs(torch, kind):
    """(q, k, v, do, dlse) in fp32 at Mistral-7B-v0.3 attention widths, the
    same on every rank (one seed on the card): B 1 (2 for TP attention, whose
    data axis cuts it) x PAR_SEQ, 32 / 8 heads, D 128."""
    B, S, Hq, Hkv, D = (2 if kind == "tp" else 1), PAR_SEQ, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(18)
    q = torch.randn((B, S, Hq, D), generator=gen, device="cuda") * 0.5
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda") * 0.5
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda") * 0.5
    do = torch.randn((B, S, Hq, D), generator=gen, device="cuda")
    dlse = torch.randn((B, Hq, S), generator=gen, device="cuda")
    return q, k, v, do, dlse


def par_keep(torch, B, heads, S, p, seed, Hq, rows=2048):
    """The dropout keep mask [B, len(heads), S, S] of the single-device
    stream, built a block of rows at a time (`utils/rng.py`)."""
    from fa2_triton_tpu_torch.utils.rng import counter_hash_uint32, dropout_counters
    from fa2_triton_tpu_torch.utils import dropout_threshold

    dev = heads.device
    cols = torch.arange(S, device=dev).view(1, 1, 1, -1)
    b = torch.arange(B, device=dev).view(-1, 1, 1, 1)
    h = heads.view(1, -1, 1, 1)
    out = []
    for r0 in range(0, S, rows):
        r = torch.arange(r0, min(S, r0 + rows), device=dev).view(1, 1, -1, 1)
        out.append(counter_hash_uint32(seed, dropout_counters(b, h, r, cols, Hq, S, S))
                   >= dropout_threshold(p))
    return torch.cat(out, dim=2)


def par_check(torch, name, kind, kw, o, lse, grads, x32):
    """Rank 0's check of one case: the gathered out (and lse) and the
    gradients against `flash_attn_reference` on one card, a kv head and its
    q heads at a time, under the FA rules (tests/utils.py:
    compare_results_fa): the fp32 truth (upcast) and the bf16 reference
    computed in bf16 (upcast=False) as the yardstick, fed the ring's
    dropout mask. Returns the errors and yardsticks."""
    from fa2_triton_tpu_torch.ops.reference import flash_attn_reference

    q32, k32, v32, do32, dlse32 = x32
    B, S, Hq, D = q32.shape
    Hkv = k32.shape[2]
    g = Hq // Hkv
    p, seed = PAR_DROPOUT if kw.get("dropout") else (0.0, 0)
    worst = {n: [0.0, 0.0] for n in ("out", "lse", "dq", "dk", "dv")}
    dv_sum = 0.0
    for j in range(Hkv):
        hs = slice(j * g, (j + 1) * g)
        mask = (par_keep(torch, B, torch.arange(j * g, (j + 1) * g, device="cuda"), S, p, seed, Hq)
                if p else None)
        runs = {}
        for tag, dt, upcast in (("ref", torch.float32, True), ("yard", torch.bfloat16, False)):
            xs = [t[:, :, hs if i == 0 else slice(j, j + 1)].to(dt).requires_grad_()
                  for i, t in enumerate((q32, k32, v32))]
            out, l = flash_attn_reference(*xs, causal=kw["causal"], dropout_p=p, dropout_mask=mask,
                                          upcast=upcast, return_lse=True)
            loss = (out.float() * do32[:, :, hs]).sum()
            if kw.get("lse"):
                loss = loss + (l.float() * dlse32[:, hs]).sum()
            loss.backward()
            runs[tag] = (out.detach(), l.detach(), [t.grad for t in xs])
            del out, l, loss, xs
        (o_r, l_r, g_r), (o_y, l_y, g_y) = runs["ref"], runs["yard"]
        pairs = [("out", o[:, :, hs], o_r, o_y)]
        if lse is not None:
            pairs.append(("lse", lse[:, hs], l_r, l_y))
        for n, got, r, y in zip(("dq", "dk", "dv"), (grads[0][:, :, hs], grads[1][:, :, j:j + 1],
                                                       grads[2][:, :, j:j + 1]), g_r, g_y):
            pairs.append((n, got, r, y))
            if n == "dv":
                dv_sum += float((got.float() - r.float()).abs().sum())
        for n, got, r, y in pairs:
            worst[n][0] = max(worst[n][0], max_abs(torch, got, r))
            worst[n][1] = max(worst[n][1], max_abs(torch, y, r))
        del runs, pairs, mask
        torch.cuda.empty_cache()
    for n, (err, yard) in worst.items():
        if n == "lse" and lse is None:
            continue
        mul, bias = ((OUT_ERROR_MUL, OUT_ERROR_BIAS) if n in ("out", "lse")
                     else (GRAD_ERROR_MUL, GRAD_ERROR_BIAS))
        ok = err <= mul * yard + bias or (n == "dv" and dv_sum < DV_SUM_WAIVER)
        print(f"[parallel] {name} {n}: max abs err {err:.3e} vs fp32, bf16 reference "
              f"{yard:.3e}: {'ok' if ok else 'FAILS'} (<= {mul:g} x + {bias:g})", flush=True)
        if not ok:
            raise AssertionError(f"{name} {n}: err {err:.3e} > {mul:g} x {yard:.3e} + {bias:g}")
    return {n: {"err": e, "yardstick": y} for n, (e, y) in worst.items()
            if not (n == "lse" and lse is None)}


# The kernels the parallel cases reach, by profiler name (a substring).
PAR_KERNELS = ("flash_fwd", "dq_mma_kernel", "dkdv_mma_kernel", "dq_kernel", "dkdv_kernel",
               "bwd_tri", "tri_dq_reduce", "bwd_wl", "wl_mma_reduce", "fused_delta")


def par_profiled(torch, fn):
    """fn() under torch.profiler; returns (its result, the device ms of the
    port's attention kernels it launched on this rank)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if any(k in e.key for k in PAR_KERNELS))
    return out, us / 1e3


def parallel_attention_rank(rank, world):
    """(a) ring and (b) Ulysses / TP attention on one rank of PAR_RANKS: each
    case forward + backward in bf16 on the same global inputs, the ranks
    lined up by a barrier first, its kernel launches counted (reset just
    before), its wall times, its kernels' device time (torch.profiler) and
    its host staging; rank 0 checks every case (`par_check`)."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd
    from fa2_triton_tpu_torch.parallel import (
        collectives as coll, make_mesh, make_ring_attention, make_tp_attention,
        make_ulysses_attention,
    )

    seq_mesh, dm_mesh = make_mesh(seq=world), make_mesh(data=2, model=world // 2)
    par_profiled(torch, lambda: None)   # the profiler's start-up (~13 s), outside the cases
    out = []
    for name, kind, kw in PAR_CASES:
        x32 = par_inputs(torch, kind)
        x = [t.to(torch.bfloat16).requires_grad_() for t in x32[:3]]
        drop = dict(zip(("dropout_p", "dropout_seed"), PAR_DROPOUT)) if kw.get("dropout") else {}
        if kind == "ring":
            fn = make_ring_attention(seq_mesh, causal=kw["causal"], return_lse=True, **drop)
        elif kind == "ulysses":
            fn = make_ulysses_attention(seq_mesh, causal=kw["causal"])
        else:
            fn = make_tp_attention(dm_mesh, causal=kw["causal"])
        dist.barrier()
        reset_counts()
        coll.reset_staging()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, fwd_dev = par_profiled(torch, lambda: fn(*x))
        o, lse = res if kind == "ring" else (res, None)
        t1 = time.perf_counter()
        loss = (o.float() * x32[3]).sum()
        if kw.get("lse"):
            loss = loss + (lse * x32[4]).sum()
        _, bwd_dev = par_profiled(torch, loss.backward)
        t2 = time.perf_counter()
        launches = {n: c for n, c in bwd_launches(flash_fwd, flash_bwd).items() if c}
        fwd = sum(c for n, c in launches.items() if not n.startswith(("bwd_", "flash_bwd")))
        bwd = sum(c for n, c in launches.items() if n.startswith(("bwd_", "flash_bwd")))
        if not (fwd and bwd):
            raise AssertionError(f"rank {rank} {name}: launches {launches}, a kernel of the "
                                 f"forward or the backward never ran")
        rec = {"case": name, "fwd_ms": 1e3 * (t1 - t0), "bwd_ms": 1e3 * (t2 - t1),
               "fwd_kernel_ms": fwd_dev, "bwd_kernel_ms": bwd_dev,
               "launches": launches, "staging": dict(coll.STAGING)}
        if rank == 0:
            rec["check"] = par_check(torch, name, kind, kw, o.detach(),
                                     lse.detach() if lse is not None else None,
                                     [t.grad for t in x], x32)
        out.append(rec)
        del x32, x, res, o, lse, loss, fn
        torch.cuda.empty_cache()
    no_jax_here()
    return out


def par_config(torch):
    from fa2_triton_tpu_torch.examples.train import preset_config

    return preset_config("mistral-7b-v0.3", torch.bfloat16, n_layers=PAR_LAYERS)


def par_engine_kw(torch, mode):
    return {k: getattr(torch, v) if k == "qdtype" else v for k, v in PAR_SERVE_MODES[mode].items()}


def par_served(torch, engine, prompts):
    """Serve phase 3's prompts through `engine` with the counts reset just
    before; returns the tokens, log-probs, launches and times."""
    from fa2_triton_tpu_torch.ops import decode, flash_fwd
    from fa2_triton_tpu_torch.parallel import collectives as coll

    reqs = [engine.submit(p, NEW_TOKENS) for p in prompts]
    reset_counts()
    coll.reset_staging()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.out_tokens) == NEW_TOKENS for r in reqs):
        raise AssertionError("not every request finished with its tokens")
    return {"tokens": [list(r.out_tokens) for r in reqs],
            "logprobs": [list(r.out_logprobs) for r in reqs],
            "launches": {"flash_fwd": flash_fwd.LAUNCHES, "decode": decode.LAUNCHES,
                         "decode_variants": dict(decode.VARIANT_LAUNCHES)},
            "staging": dict(coll.STAGING), "wall_s": wall, "decode_steps": stats.decode_steps,
            "prefill_dispatches": stats.prefill_dispatches,
            "replica_of": dict(getattr(engine, "replica_of", {}))}


def parallel_serve_rank(rank, world, kind):
    """(c) on one rank: the seeded model at PAR_LAYERS, then phase 3's
    prompts through a TP Engine (kind "tp": model axis of `world`) or a
    `DataParallelEngine` (kind "dp": data axis of `world`, 4 slots a
    replica) for each of PAR_SERVE_MODES."""
    import torch

    from fa2_triton_tpu_torch.models import init_params
    from fa2_triton_tpu_torch.parallel import make_mesh
    from fa2_triton_tpu_torch.runtime import DataParallelEngine, Engine

    with torch.inference_mode():
        cfg = par_config(torch)
        model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        mesh = make_mesh(model=world) if kind == "tp" else make_mesh(data=world)
        prompts = served_prompts(cfg)
        out = {}
        for mode in PAR_SERVE_MODES:
            kw = par_engine_kw(torch, mode)
            if kind == "tp":
                engine = Engine(model, cfg, n_slots=8, max_seq=4096, mesh=mesh, **kw)
            else:
                engine = DataParallelEngine(model, cfg, mesh, n_slots=4, max_seq=4096, **kw)
            out[mode] = par_served(torch, engine, prompts)
            launches = out[mode]["launches"]
            if not (launches["flash_fwd"] and launches["decode"]):
                raise AssertionError(f"rank {rank} {kind} {mode}: launches {launches}")
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    no_jax_here()
    return out


def par_hold_tokens(what, got, ref):
    """`got`'s greedy tokens against the single-device Engine's `ref`, the
    rule of phase 14 (b) on log-probs: the log-probs of the tokens both
    chose on a shared prefix give the drift between the two; a request may
    diverge only where its two chosen tokens' log-probs sit within PAR_TIE x
    that drift of each other (a near tie both engines see), and is not
    compared past it. Returns the counts."""
    drift, divergences, equal = 0.0, [], 0
    for i, (tg, lg, tr, lr) in enumerate(zip(got["tokens"], got["logprobs"], ref["tokens"],
                                             ref["logprobs"])):
        n = next((j for j, (a, b) in enumerate(zip(tg, tr)) if a != b), len(tr))
        drift = max([drift] + [abs(a - b) for a, b in zip(lg[:n], lr[:n])])
        if n == len(tr):
            equal += 1
        else:
            divergences.append((i, n, abs(lg[n] - lr[n])))
    bound = PAR_TIE * max(drift, 1e-3)
    bad = [d for d in divergences if d[2] > bound]
    print(f"[parallel] {what}: {equal} of {len(ref['tokens'])} requests equal to the single-device "
          f"Engine's tokens; log-prob drift on shared prefixes {drift:.3e}; divergences "
          f"(request, token, log-prob gap) {[(i, n, round(g, 4)) for i, n, g in divergences]} "
          f"(bound {bound:.3e})", flush=True)
    if bad or drift > 0.1:
        raise AssertionError(f"{what}: divergences {bad} past the tie bound {bound:.3e}, or drift "
                             f"{drift:.3e} > 0.1")
    return {"equal": equal, "drift": drift, "divergences": len(divergences)}


def par_rank_lines(tag, ranks, card):
    for r, res in enumerate(ranks):
        st = res["staging"]
        hop = 1e3 * (st["copy_s"] + st["comm_s"]) / st["ops"] if st["ops"] else 0.0
        print(f"[parallel] {tag} rank {r}: launches {res['launches']}; host staging {st['ops']} "
              f"ops, {st['bytes'] / 1e6:.1f} MB to the host, copies {1e3 * st['copy_s']:.1f} ms, "
              f"gloo {1e3 * st['comm_s']:.1f} ms, {hop:.3f} ms an op [{card}]", flush=True)


def phase_parallel(torch, card):
    """Phase 18 (the parallel layer): (a) ring and (b) Ulysses / TP
    attention on PAR_RANKS ranks sharing this card over gloo, every case
    held to one card's references by rank 0; (c) phase 3's prompts through
    a TP-2 Engine and a data-2 `DataParallelEngine`, contiguous, paged and
    int8 KV, held to the single-device Engine's tokens. Returns the
    launches per kernel summed over the ranks and the measurements."""
    from fa2_triton_tpu_torch.models import init_params
    from fa2_triton_tpu_torch.parallel import spawn_ranks
    from fa2_triton_tpu_torch.runtime import Engine

    t_phase = time.perf_counter()
    print(f"[parallel] transport: gloo, {PAR_RANKS} ranks on one card; CUDA tensors staged "
          f"through host memory (NCCL refuses two ranks on one device) [{card}]", flush=True)
    t0 = time.perf_counter()
    att = spawn_ranks(parallel_attention_rank, PAR_RANKS, timeout_s=600)
    att_s = time.perf_counter() - t0
    totals, cases = {}, {}
    for i, (name, kind, kw) in enumerate(PAR_CASES):
        per_rank = [r[i] for r in att]
        for r, rec in enumerate(per_rank):
            print(f"[parallel] {name} rank {r}: forward {rec['fwd_ms']:.1f} ms, backward "
                  f"{rec['bwd_ms']:.1f} ms (wall, {PAR_RANKS} ranks sharing the card); its "
                  f"kernels' device time {rec['fwd_kernel_ms']:.3f} + {rec['bwd_kernel_ms']:.3f} "
                  f"ms (torch.profiler)", flush=True)
        par_rank_lines(name, per_rank, card)
        drop = "dropout" if kw.get("dropout") else ""
        for rec in per_rank:
            for n, c in rec["launches"].items():
                totals[(n, drop)] = totals.get((n, drop), 0) + c
        st = [rec["staging"] for rec in per_rank]
        cases[name] = {"check": per_rank[0]["check"],
                       "fwd_ms": [rec["fwd_ms"] for rec in per_rank],
                       "bwd_ms": [rec["bwd_ms"] for rec in per_rank],
                       "fwd_kernel_ms": [rec["fwd_kernel_ms"] for rec in per_rank],
                       "bwd_kernel_ms": [rec["bwd_kernel_ms"] for rec in per_rank],
                       "launches": [rec["launches"] for rec in per_rank],
                       "staging_ms_per_op": [1e3 * (s["copy_s"] + s["comm_s"]) / s["ops"]
                                             if s["ops"] else 0.0 for s in st]}
    print(f"[parallel] (a) + (b): {att_s:.1f} s with the ranks' start", flush=True)

    with torch.inference_mode():
        cfg = par_config(torch)
        model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        prompts = served_prompts(cfg)
        refs = {}
        for mode in PAR_SERVE_MODES:
            refs[mode] = par_served(torch, Engine(model, cfg, n_slots=8, max_seq=4096,
                                                  **par_engine_kw(torch, mode)), prompts)
            print(f"[parallel] single-device {mode}: {refs[mode]['wall_s']:.2f} s, "
                  f"{refs[mode]['decode_steps']} decode steps", flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    serving = {}
    for kind in ("tp", "dp"):
        t0 = time.perf_counter()
        ranks = spawn_ranks(parallel_serve_rank, 2, (kind,), timeout_s=900)
        spent = time.perf_counter() - t0
        for mode in PAR_SERVE_MODES:
            what = f"{kind} {mode} ({PAR_LAYERS} layers)"
            for r, res in enumerate(ranks):
                rec = res[mode]
                print(f"[parallel] {what} rank {r}: {rec['wall_s']:.2f} s, {rec['decode_steps']} "
                      f"decode steps, {rec['prefill_dispatches']} prefill dispatches", flush=True)
            par_rank_lines(what, [res[mode] for res in ranks], card)
            got = ranks[0][mode]
            if kind == "dp":
                if any(res[mode]["tokens"] != got["tokens"] for res in ranks):
                    raise AssertionError(f"{what}: the ranks disagree on the served tokens")
                print(f"[parallel] {what}: replica of each request {got['replica_of']}", flush=True)
            held = par_hold_tokens(what, got, refs[mode])
            for res in ranks:
                for n in ("flash_fwd", "decode"):
                    key = (n if not (n == "decode" and mode != "contiguous") else
                           "paged_decode" if mode == "paged" else "decode_quant", "")
                    totals[key] = totals.get(key, 0) + res[mode]["launches"][n]
            serving[what] = {**held, "wall_s": [res[mode]["wall_s"] for res in ranks],
                             "single_device_wall_s": refs[mode]["wall_s"],
                             "staging_ms_per_op": [
                                 1e3 * (res[mode]["staging"]["copy_s"]
                                        + res[mode]["staging"]["comm_s"])
                                 / max(1, res[mode]["staging"]["ops"]) for res in ranks]}
        print(f"[parallel] (c) {kind}: {spent:.1f} s with the ranks' start, peak "
              f"{[round(res['peak_gib'], 1) for res in ranks]} GiB a rank", flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"[parallel] phase 18: {seconds:.1f} s [{card}]", flush=True)
    return {"launches": totals, "cases": cases, "serving": serving, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 19: parallel training (`parallel/fsdp.py`, `parallel/pipeline.py`,
# `models/moe.py:make_ep_mlp`, `examples/train.py --dp / --tp / --fsdp`),
# ranks spawned on this one card over gloo, CUDA tensors staged through
# host memory.

PT_RANKS = 4                     # (a) data 2 x model 2; (b) pipe 2 x model 2
# (a) / (b)'s depth: 4 of Mistral's 32 layers (1.141 B parameters); cut it
# before any width.
PT_LAYERS = int(os.environ.get("CHIP_SMOKE_PAR_TRAIN_LAYERS", "4"))
PT_ARGV = ["--config", "mistral-7b-v0.3", "--layers", str(PT_LAYERS), "--batch", "2", "--seq",
           str(TRAIN_SEQ), "--steps", "2", "--remat"]
PT_MODES = (("dp 2 x tp 2", ["--dp", "2", "--tp", "2"]),
            ("dp 2 x tp 2 fsdp", ["--dp", "2", "--tp", "2", "--fsdp"]))
PP_TOKENS = (4, 1024)            # (b): B x S, 2 microbatches
PP_M = 2
PP_CASES = ("pipeline pipe 2", "3d pipe 2 x model 2")
EP_LAYERS = 2                    # (c): Mixtral-8x7B-v0.1 at 2 of 32 layers, model 2
EP_TOKENS = (1, TRAIN_SEQ)
# (c)'s routing rule: the EP step's tokens whose expert choices differ from
# the fp32 one-rank step's own at most 3 x the bf16 one-rank step's + 8.
EP_FLIP_MUL, EP_FLIP_BIAS = 3, 8
# Kernel names (profiler substrings) of the training path, most specific first.
PT_KERNELS = ("flash_fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel", "bwd_tri_mma_kernel",
              "flash_fwd_kernel", "dq_kernel", "dkdv_kernel")


def pt_kernel_ms(events) -> dict:
    """{kernel: [launches recorded, device ms per launch]} of the training
    kernels among torch.profiler's key averages."""
    out = {}
    for e in events:
        name = next((k for k in PT_KERNELS if k in e.key), None)
        if name is None:
            continue
        n, us = out.get(name, (0, 0.0))
        out[name] = (n + e.count, us + _device_us(e))
    return {k: [n, us / n / 1e3] for k, (n, us) in out.items() if n}


def pt_profiled(torch, fn):
    """fn() under torch.profiler (CUDA activity); returns (its result, the
    training kernels' launches and device ms per launch on this rank)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, pt_kernel_ms(prof.key_averages())


def pt_launches(what, rank):
    """The forward / backward launch counts since the last reset; fails
    where the forward or the backward kernels never ran."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    launches = {n: c for n, c in bwd_launches(flash_fwd, flash_bwd).items() if c}
    fwd = sum(c for n, c in launches.items() if not n.startswith(("bwd_", "flash_bwd")))
    bwd = sum(c for n, c in launches.items() if n.startswith(("bwd_", "flash_bwd")))
    if not (fwd and bwd):
        raise AssertionError(f"rank {rank} {what}: launches {launches}, a kernel of the forward "
                             f"or the backward never ran")
    return launches


def pt_keep(spec, coords) -> bool:
    """Whether this rank saves its piece of a leaf: a piece the ranks along
    a cutting axis hold apart, or the one copy at coordinate 0 of every axis
    that does not cut it."""
    return all(coords.get(a, 0) == 0 for a in coords if a not in spec)


def pt_save_grads(work, tag, par, tokens):
    """`on_grads` of the trainer on a rank: its gradient pieces (before
    clipping), with their specs and its coordinates, to `work`."""
    import torch
    import torch.distributed as dist

    grads = {n: p.grad.detach().to("cpu") for n, p in zip(par.names, par.params)
             if p.grad is not None and pt_keep(par.specs.get(n, ()), par.coords)}
    torch.save({"coords": dict(par.coords), "specs": par.specs, "grads": grads},
               os.path.join(work, f"{tag}-r{dist.get_rank()}.pt"))


def pt_model(torch, cfg):
    from fa2_triton_tpu_torch.models import init_params

    return init_params(torch.Generator(device="cuda").manual_seed(0), cfg)


def pt_tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=shape)


def pt_pipeline_case(torch, rank, case, work):
    """(b) on one rank: the case's forward over `make_mesh(pipe=2, model=2)`
    on PP_TOKENS (seed 19) and loss_fn's cross-entropy of its logits, forward
    and backward with the counts reset just before; rank 0 saves the logits,
    and the pieces of every gradient go to `work`."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.parallel import collectives as coll
    from fa2_triton_tpu_torch.parallel import make_mesh
    from fa2_triton_tpu_torch.parallel import pipeline as pl
    from fa2_triton_tpu_torch.parallel.mesh import AXIS_MODEL, AXIS_PIPE, shard_tensor

    cfg = preset_config("mistral-7b-v0.3", torch.bfloat16, n_layers=PT_LAYERS)
    model = pt_model(torch, cfg)
    tokens = torch.from_numpy(pt_tokens(cfg, PP_TOKENS, 19)).cuda()
    mesh = make_mesh(pipe=2, model=2)
    three_d = case.startswith("3d")
    if three_d:
        fwd = pl.make_llama_3d_forward(mesh, cfg, PP_M)
    else:
        fwd = pl.make_llama_pipeline_forward(mesh, cfg, PP_M)
    pp = pl.pipeline_params_from_llama(model, mesh, tp=three_d)
    dist.barrier()
    reset_counts()
    coll.reset_staging()
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def step():
        logits = fwd(pp, tokens[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
        loss.backward()
        return logits.detach(), float(loss)

    (logits, loss), kms = pt_profiled(torch, step)
    wall = time.perf_counter() - t0
    launches = pt_launches(case, rank)
    p_rank, m_rank = mesh.get_local_rank(AXIS_PIPE), mesh.get_local_rank(AXIS_MODEL)
    specs = pl._stacked_3d_specs({n: None for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                   "w_down", "attn_norm", "mlp_norm")})
    per = cfg.n_layers // 2
    grads, pieces = {}, {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        parts = name.split(".")
        if parts[0] != "layers":
            if rank == 0:
                grads[name] = p.grad.to("cpu")
            continue
        if int(parts[1]) // per != p_rank:
            continue
        spec = specs[parts[2]][1:] if three_d else ()
        if AXIS_MODEL in spec:
            grads[name] = shard_tensor(p.grad, spec, mesh).to("cpu")
            pieces[name] = (spec.index(AXIS_MODEL), m_rank)
        elif m_rank == 0:
            grads[name] = p.grad.to("cpu")
    torch.save({"loss": loss, "logits": logits.to("cpu") if rank == 0 else None, "grads": grads,
                "pieces": pieces}, os.path.join(work, f"{case}-r{rank}.pt"))
    out = {"wall_s": wall, "launches": launches, "kernel_ms": kms,
           "staging": dict(coll.STAGING), "loss": loss}
    del model, pp, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_train_rank(rank, world, work):
    """(a) and (b) on one rank of PT_RANKS: the trainer in each of PT_MODES
    (`examples/train.py:run_rank`, the gradients of its warm-up, which are
    step 0's before clipping, saved by `pt_save_grads`; the counts reset
    after the warm-up; the whole run under torch.profiler), then each
    pipeline case."""
    import functools

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from fa2_triton_tpu_torch.examples import train

    pt_profiled(torch, lambda: None)    # the profiler's start-up, outside the cases
    out = {"train": [], "pipelines": []}
    for tag, extra in PT_MODES:
        args = train.parse_args(PT_ARGV + extra)
        dist.barrier()
        t0 = time.perf_counter()
        res, kms = pt_profiled(torch, lambda: train.run_rank(
            args, on_warm=reset_counts, on_grads=functools.partial(pt_save_grads, work, tag)))
        wall = time.perf_counter() - t0
        out["train"].append({"tag": tag, "losses": res["losses"], "wall_s": wall,
                             "launches": pt_launches(tag, rank), "kernel_ms": kms,
                             "transport": res["transport"], **res["rank"]})
        del res
        gc.collect()
        torch.cuda.empty_cache()
    for case in PP_CASES:
        out["pipelines"].append(pt_pipeline_case(torch, rank, case, work))
    no_jax_here()
    return out


def moe_recording_route(moe, log):
    """`moe._route` that also appends each call's expert choices [T, k]
    (on the host) to `log`."""
    orig = moe._route

    def route(h2d, router, cfg):
        out = orig(h2d, router, cfg)
        log.append(out[1].detach().to("cpu"))
        return out

    return route


def moe_forced_route(torch, choices, own):
    """`moe._route` that takes the expert choices of each call from
    `choices` (in call order) and weighs them by this run's own router
    probabilities, renormalized: the same routing evaluated at this run's
    precision (as phase 15 (b) holds the block). Each call's own top-k
    choices [T, k] (on the host) are appended to `own`."""
    it = iter(choices)

    def route(h2d, router, cfg):
        probs = torch.softmax(h2d.float() @ router, dim=-1)
        idx = next(it).to(probs.device)
        own.append(torch.topk(probs, idx.shape[1], dim=-1).indices.to("cpu"))
        w = probs.gather(1, idx)
        return w / w.sum(dim=-1, keepdim=True), idx, probs

    return route


def par_ep_rank(rank, world, work):
    """(c) on one rank of 2: Mixtral-8x7B-v0.1 at EP_LAYERS layers, cut by
    `moe_param_pspecs` over `make_mesh(model=2)` (4 experts a rank, half
    the heads), one `moe.loss_fn` forward and backward with `make_ep_mlp`
    and TP attention on EP_TOKENS (seed 20) under torch.profiler, the
    counts reset just before; the gradient pieces, and the routing of every
    layer (rank 0), go to `work`."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from fa2_triton_tpu_torch.examples.train import preset_config
    from fa2_triton_tpu_torch.models import moe
    from fa2_triton_tpu_torch.parallel import collectives as coll
    from fa2_triton_tpu_torch.parallel import make_mesh
    from fa2_triton_tpu_torch.parallel.mesh import AXIS_MODEL, axis_group, shard_params

    cfg = preset_config("mixtral-8x7b-v0.1", torch.bfloat16, n_layers=EP_LAYERS)
    mesh = make_mesh(model=world)
    full = pt_model(torch, cfg)
    specs = moe.moe_param_pspecs(full)
    local = shard_params(full, mesh, specs)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(pt_tokens(cfg, EP_TOKENS, 20)).cuda()
    mlp = moe.make_ep_mlp(mesh)
    params = [p for p in local.parameters()]
    names = [n for n, _ in local.named_parameters()]
    choices = []
    plain_route, moe._route = moe._route, moe_recording_route(moe, choices)
    dist.barrier()
    reset_counts()
    coll.reset_staging()
    torch.cuda.synchronize()

    def step():
        loss = moe.loss_fn(local, tokens, mlp_fn=mlp, tp_group=axis_group(mesh, AXIS_MODEL))
        return loss, torch.autograd.grad(loss, params)

    pt_profiled(torch, lambda: None)    # the profiler's start-up, outside the step
    t0 = time.perf_counter()
    try:
        (loss, grads), kms = pt_profiled(torch, step)
    finally:
        moe._route = plain_route
    wall = time.perf_counter() - t0
    launches = pt_launches("ep", rank)
    coords = {AXIS_MODEL: rank}
    torch.save({"coords": coords, "specs": specs, "choices": choices,
                "grads": {n: g.to("cpu") for n, g in zip(names, grads)
                          if pt_keep(specs.get(n, ()), coords)}},
               os.path.join(work, f"ep-r{rank}.pt"))
    out = {"loss": float(loss.detach()), "wall_s": wall, "launches": launches, "kernel_ms": kms,
           "staging": dict(coll.STAGING), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "param_bytes": sum(p.numel() * p.element_size() for p in params)}
    no_jax_here()
    return out


def pt_whole(torch, files, name):
    """A leaf from the ranks' saved pieces (`pt_keep`): along each axis that
    cuts it, the pieces of the ranks that differ only there, in order."""
    have = [f for f in files if name in f["grads"]]
    spec = have[0]["specs"].get(name, ())
    axes = [a for a in ("data", "model") if a in spec and any(f["coords"].get(a, 0) for f in have)]
    if not axes:
        return have[0]["grads"][name]

    def along(pool, axis_i):
        if axis_i == len(axes):
            return pool[0]["grads"][name]
        a = axes[axis_i]
        parts = [along([f for f in pool if f["coords"][a] == i], axis_i + 1)
                 for i in range(1 + max(f["coords"][a] for f in pool))]
        return torch.cat(parts, dim=spec.index(a))

    return along(have, 0)


def pt_reference(torch, cfg, tokens, loss_fn, choices=None, owns=None):
    """The single-rank step's (loss, {name: gradient}) twice: the bf16 model
    through the kernels, and the fp32 truth (the same weights upcast, the
    plain attention in fp32). With `choices` (an MoE model's expert choices
    of each layer) both take that routing (`moe_forced_route`; `owns`, two
    lists, get each run's own top-k choices of each layer)."""
    from fa2_triton_tpu_torch.models import LlamaModel, moe
    from fa2_triton_tpu_torch.ops import flash_attn_reference

    def plain(q, k, v):
        return flash_attn_reference(q, k, v, causal=True, softmax_scale=cfg.scale)

    def run(model, attention_fn, i):
        plain_route = moe._route
        if choices is not None:
            moe._route = moe_forced_route(torch, choices, owns[i])
        try:
            loss = loss_fn(model, tokens, attention_fn)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        finally:
            moe._route = plain_route
        return float(loss), dict(zip([n for n, _ in model.named_parameters()], grads))

    model = pt_model(torch, cfg)
    bf16 = run(model, None, 0)
    m32 = LlamaModel(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    m32.load_state_dict(model.state_dict())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fp32 = run(m32, plain, 1)
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    return bf16, fp32


def pt_hold(torch, what, loss, grads, bf16, fp32):
    """The FA rules: the loss, and every gradient against the fp32 truth
    within 3x the bf16 single-rank step's error + 1e-5. Returns the worst
    leaf's share of its bound and the loss errors."""
    (loss16, g16), (loss32, g32) = bf16, fp32
    if set(grads) != set(g32):
        raise AssertionError(f"{what}: gradients of {sorted(set(g32) ^ set(grads))[:4]} missing")
    loss_err, loss_yard = abs(loss - loss32), abs(loss16 - loss32)
    if not loss_err <= OUT_ERROR_MUL * loss_yard + OUT_ERROR_BIAS:
        raise AssertionError(f"{what}: loss {loss} vs fp32 {loss32}: err {loss_err:.3e} > "
                             f"{OUT_ERROR_MUL} x the bf16 step's {loss_yard:.3e} + {OUT_ERROR_BIAS}")
    worst, worst_name = 0.0, None
    for name, g in grads.items():
        err, yard = check_grad(torch, name, g.cuda(), g32[name], g16[name], what)
        ratio = err / (GRAD_ERROR_MUL * yard + GRAD_ERROR_BIAS)
        if ratio >= worst:
            worst, worst_name = ratio, name
    print(f"[parallel train] {what}: loss {loss:.5f} (bf16 one rank {loss16:.5f}, fp32 {loss32:.5f}); "
          f"all {len(grads)} gradients within the FA rule vs fp32 (worst {worst_name}: "
          f"{worst:.2f} of the bound)", flush=True)
    return {"loss": loss, "loss_err": loss_err, "loss_yardstick": loss_yard,
            "worst_grad": worst_name, "worst_share": worst}


def pt_rank_line(what, r, card):
    st = r["staging"]
    hop = 1e3 * (st["copy_s"] + st["comm_s"]) / st["ops"] if st["ops"] else 0.0
    kms = ", ".join(f"{k} {n} x {ms:.3f} ms" for k, (n, ms) in sorted(r["kernel_ms"].items())) \
        or "not profiled"
    extra = (f"parameters {r['param_bytes'] / 1e9:.3f} GB, AdamW moments "
             f"{r['moment_bytes'] / 1e9:.3f} GB, step s {[round(x, 2) for x in r['step_s']]}, "
             if "moment_bytes" in r else "")
    print(f"[parallel train] {what} rank {r.get('rank', '?')}: {extra}wall {r['wall_s']:.1f} s; "
          f"launches {r['launches']}; kernels (torch.profiler, launches x device ms each) {kms}; "
          f"host staging {st['ops']} ops, {st['bytes'] / 1e6:.1f} MB to the host, "
          f"{hop:.3f} ms an op [{card}]", flush=True)


def phase_parallel_train(torch, card):
    """Phase 19: (a) the trainer at Mistral-7B-v0.3 widths (PT_LAYERS layers,
    bf16, 2 x 2048, remat) over data 2 x model 2, without and with FSDP, 2
    steps each: step 0's loss and every gradient (before clipping) held to
    the single-rank step under the FA rules, step 1's loss finite, the FSDP
    cut in each rank's bytes; (b) the GPipe and 3-D pipelines at the same
    widths, logits and gradients held likewise; (c) expert parallelism at
    Mixtral-8x7B-v0.1 widths, held likewise on its own routing, whose
    choices may differ from the fp32 step's own on at most EP_FLIP_MUL x
    the bf16 one-rank step's flips + EP_FLIP_BIAS tokens; (d)
    `dryrun_multichip(4)` on the card.
    Returns the launches summed over the ranks and the measurements."""
    import shutil

    from fa2_triton_tpu_torch.examples.train import model_loss, preset_config
    from fa2_triton_tpu_torch.models import llama, moe
    from fa2_triton_tpu_torch.parallel import spawn_ranks
    from fa2_triton_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    work = os.path.join(HERE, "build", f"phase19-{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    print(f"[parallel train] transport: gloo, {PT_RANKS} ranks on one card; CUDA tensors staged "
          f"through host memory (NCCL refuses two ranks on one device). Cuts: Mistral-7B-v0.3 at "
          f"{PT_LAYERS} of 32 layers, Mixtral-8x7B-v0.1 at {EP_LAYERS} of 32 [{card}]", flush=True)
    totals, out = {}, {}
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(par_train_rank, PT_RANKS, (work,), timeout_s=900)
        out["ab_world_s"] = time.perf_counter() - t0
        print(f"[parallel train] (a) + (b) ranks: {out['ab_world_s']:.1f} s with their start",
              flush=True)

        def count(launches):
            for n, c in launches.items():
                totals[n] = totals.get(n, 0) + c

        # (a) the trainer against one rank.
        cfg = preset_config("mistral-7b-v0.3", torch.bfloat16, n_layers=PT_LAYERS, remat=True)
        tokens = torch.from_numpy(pt_tokens(cfg, (2, TRAIN_SEQ), 0)).cuda()
        bf16, fp32 = pt_reference(torch, cfg, tokens, llama.loss_fn)
        out["train"] = {}
        for i, (tag, _) in enumerate(PT_MODES):
            per_rank = [r["train"][i] for r in ranks]
            for r in per_rank:
                pt_rank_line(f"(a) {tag}", r, card)
                count(r["launches"])
            losses = per_rank[0]["losses"]
            if any(r["losses"] != losses for r in per_rank):
                raise AssertionError(f"(a) {tag}: the ranks' losses differ")
            if not np.isfinite(losses).all():
                raise AssertionError(f"(a) {tag}: losses {losses}")
            files = [torch.load(os.path.join(work, f"{tag}-r{r}.pt"), mmap=True)
                     for r in range(PT_RANKS)]
            grads = {n: pt_whole(torch, files, n) for n in bf16[1]}
            held = pt_hold(torch, f"(a) {tag} step 0", losses[0], grads, bf16, fp32)
            del files, grads
            gc.collect()
            if "fsdp" in tag:
                ref = [r["param_bytes"] for r in out["train"]["dp 2 x tp 2"]["ranks"]]
                cut = [r["param_bytes"] / b for r, b in zip(per_rank, ref)]
                if not all(0.45 < c < 0.6 for c in cut):
                    raise AssertionError(f"(a) {tag}: parameter bytes {cut} of the TP-only run's")
                if any(r["moment_bytes"] != 2 * r["param_bytes"] for r in per_rank):
                    raise AssertionError(f"(a) {tag}: AdamW moments are not 2 x the parameters")
                print(f"[parallel train] (a) {tag}: each rank's parameters "
                      f"{[round(c, 3) for c in cut]} of the TP-only run's, AdamW moments 2 x its "
                      f"parameters", flush=True)
            out["train"][tag] = {**held, "losses": losses, "ranks": [
                {k: r[k] for k in ("rank", "coords", "param_bytes", "moment_bytes", "step_s",
                                   "wall_s", "staging_ms_per_op", "kernel_ms", "launches",
                                   "peak_bytes")} for r in per_rank]}
        del bf16, fp32
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the pipelines against one rank.
        cfg_b = preset_config("mistral-7b-v0.3", torch.bfloat16, n_layers=PT_LAYERS)
        tokens_b = torch.from_numpy(pt_tokens(cfg_b, PP_TOKENS, 19)).cuda()
        with torch.no_grad():
            m = pt_model(torch, cfg_b)
            logits16 = llama.forward(m, tokens_b[:, :-1])
            m32 = llama.LlamaModel(dataclasses.replace(cfg_b, dtype=torch.float32), device="cuda")
            m32.load_state_dict(m.state_dict())
            del m
            from fa2_triton_tpu_torch.ops import flash_attn_reference

            logits32 = llama.forward(m32, tokens_b[:, :-1], lambda q, k, v: flash_attn_reference(
                q, k, v, causal=True, softmax_scale=cfg_b.scale))
            del m32
        bf16, fp32 = pt_reference(torch, cfg_b, tokens_b, llama.loss_fn)
        out["pipelines"] = {}
        for i, case in enumerate(PP_CASES):
            per_rank = [r["pipelines"][i] for r in ranks]
            for r, rec in enumerate(per_rank):
                pt_rank_line(f"(b) {case}", {**rec, "rank": r}, card)
                count(rec["launches"])
            files = [torch.load(os.path.join(work, f"{case}-r{r}.pt"), mmap=True)
                     for r in range(PT_RANKS)]
            logits = files[0]["logits"].cuda()
            err, yard = max_abs(torch, logits, logits32), max_abs(torch, logits16, logits32)
            if not err <= OUT_ERROR_MUL * yard + OUT_ERROR_BIAS:
                raise AssertionError(f"(b) {case} logits: err {err:.3e} > {OUT_ERROR_MUL} x "
                                     f"{yard:.3e} + {OUT_ERROR_BIAS}")
            print(f"[parallel train] (b) {case}: logits max abs err {err:.3e} vs fp32, bf16 one "
                  f"rank {yard:.3e}: ok", flush=True)
            grads = {}
            for f in files:
                for n, g in f["grads"].items():
                    if n in f["pieces"]:
                        grads.setdefault(n, {})[f["pieces"][n][1]] = (f["pieces"][n][0], g)
                    else:
                        grads[n] = g
            grads = {n: (torch.cat([g[k][1] for k in sorted(g)], dim=g[0][0])
                         if isinstance(g, dict) else g) for n, g in grads.items()}
            held = pt_hold(torch, f"(b) {case}", files[0]["loss"], grads, bf16, fp32)
            out["pipelines"][case] = {**held, "logits_err": err, "logits_yardstick": yard,
                                      "ranks": per_rank}
            del files, grads, logits
            gc.collect()
        del bf16, fp32, logits16, logits32
        gc.collect()
        torch.cuda.empty_cache()

        # (c) expert parallelism against one rank.
        t0 = time.perf_counter()
        ep = spawn_ranks(par_ep_rank, 2, (work,), timeout_s=600)
        out["ep_world_s"] = time.perf_counter() - t0
        cfg_c = preset_config("mixtral-8x7b-v0.1", torch.bfloat16, n_layers=EP_LAYERS)
        for r, rec in enumerate(ep):
            pt_rank_line("(c) ep model 2", {**rec, "rank": r}, card)
            count(rec["launches"])
        files = [torch.load(os.path.join(work, f"ep-r{r}.pt"), mmap=True) for r in range(2)]
        tokens_c = torch.from_numpy(pt_tokens(cfg_c, EP_TOKENS, 20)).cuda()
        # The routing of the EP step (a flip of a near tie, or a drop moved
        # by one, is no rounding error): the one-rank steps take it. Its
        # choices are held to the fp32 step's own: they may differ on no
        # more tokens than EP_FLIP_MUL x those on which the bf16 one-rank
        # step's own choices differ from the fp32 step's, + EP_FLIP_BIAS.
        owns = [[], []]
        ep_choices = files[0]["choices"]
        bf16, fp32 = pt_reference(torch, cfg_c, tokens_c, model_loss(cfg_c), ep_choices, owns)

        def flips(a, b):
            return sum(int((x != y).any(dim=-1).sum()) for x, y in zip(a, b))

        ep_flips, yard_flips = flips(ep_choices, owns[1]), flips(owns[0], owns[1])
        n_routed = EP_LAYERS * (EP_TOKENS[1] - 1)
        print(f"[parallel train] (c) routing: the EP step's expert choices differ from the fp32 "
              f"one-rank step's own on {ep_flips} of {n_routed} tokens, the bf16 one-rank step's "
              f"own on {yard_flips} (from the EP step's on {flips(ep_choices, owns[0])}); both "
              f"one-rank steps take the EP step's", flush=True)
        if not ep_flips <= EP_FLIP_MUL * yard_flips + EP_FLIP_BIAS:
            raise AssertionError(f"(c) routing: the EP step flips {ep_flips} tokens against the "
                                 f"fp32 step, more than {EP_FLIP_MUL} x the bf16 one-rank step's "
                                 f"{yard_flips} + {EP_FLIP_BIAS}")
        grads = {n: pt_whole(torch, files, n) for n in bf16[1]}
        out["ep"] = {**pt_hold(torch, "(c) ep model 2 (Mixtral-8x7B-v0.1)", ep[0]["loss"], grads,
                               bf16, fp32),
                     "wall_s": [r["wall_s"] for r in ep], "peak_gib": [r["peak_gib"] for r in ep],
                     "world_s": out["ep_world_s"], "route_flips_ep_vs_fp32": ep_flips,
                     "route_flips_bf16_vs_fp32": yard_flips,
                     "kernel_ms": [r["kernel_ms"] for r in ep]}
        del files, grads, bf16, fp32
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the dry run on the card.
        t0 = time.perf_counter()
        dry = dryrun_multichip(4, device="cuda")
        out["dryrun"] = {**dry, "seconds": time.perf_counter() - t0}
        print(f"[parallel train] (d) {dry['line']} ({out['dryrun']['seconds']:.1f} s with the "
              f"ranks' start) [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[parallel train] phase 19: {out['seconds']:.1f} s [{card}]", flush=True)
    return {"launches": totals, **out}


# ---------------------------------------------------------------------------
# Phase 20 (head dims 384 and 512): the forward, the dq + dk/dv pair and
# decode at D 384 / 512, each against its plain twin; their times at the
# model's shapes; Mistral-7B-v0.3's widths with the attention cut into heads
# of 512 (8 query heads, 2 KV heads: wq / wk / wv / wo keep the preset's
# shapes and the attention FLOPs per token, since Hq x D = 4096), served and
# trained; and Phi-3-mini-4k-instruct's widths (head_dim 96), whose decode
# runs only because the caches are allocated at the kernels' head dim 128.

WIDE_DIMS = (384, 512)
WIDE_HEADS = (8, 2)              # Hq, Hkv of (a) / (b): Mistral's 4096 / 1024 in heads of 512
WIDE_CHECK_SEQ = 1024            # (a): split and strip gates pass at bf16 S 1024, tri-square at 256
WIDE_TIME_B, WIDE_TIME_SEQ = 2, 2048
WIDE_DECODE_SLOTS, WIDE_DECODE_ROWS = 8, 4096
WIDE_REQUESTS = 8                # (c) serves the first 8 of phase 3's prompts
WIDE_TRAIN_STEPS = 3
# Phi-3-mini-4k-instruct (huggingface.co/microsoft/Phi-3-mini-4k-instruct,
# config.json): hidden 3072, 32 layers, 32 heads (MHA), intermediate 8192,
# vocab 32064, rope_theta 1e4, rms_norm_eps 1e-5, 4096 positions; its
# sliding_window 2047 as JAX's loader takes it (window 2046 keys back).
PHI3_WIDTHS = dict(vocab_size=32064, dim=3072, n_layers=32, n_heads=32, n_kv_heads=32,
                   hidden_dim=8192, head_dim=96, rope_theta=1e4, norm_eps=1e-5, max_seq_len=4096,
                   sliding_window=2046)
SERVE_MODES.update({"serve wide": {}, "serve wide paged int8": {"paged": True, "qdtype": "int8"},
                    "serve phi3": {}, "serve phi3 paged int8": {"paged": True, "qdtype": "int8"}})


def wide_counts():
    from fa2_triton_tpu_torch.ops import decode, flash_bwd, flash_fwd

    return {"flash_fwd": flash_fwd.LAUNCHES + sum(flash_fwd.SCHEDULE_LAUNCHES.values()),
            "flash_bwd_dq": flash_bwd.LAUNCHES["flash_bwd_dq"],
            "flash_bwd_dkdv": flash_bwd.LAUNCHES["flash_bwd_dkdv"], "decode": decode.LAUNCHES}


def wide_reset():
    from fa2_triton_tpu_torch.ops import decode, flash_bwd, flash_fwd

    flash_fwd.reset_launches()
    flash_bwd.reset_launches()
    decode.reset_launches()


def fa_check(torch, what, got, ref32, plain, fp32=False):
    """The FA contract of one output: fp32 within FP32_TOL of the fp32
    plain twin, 16-bit within 2 x the 16-bit plain twin's error + 5e-5."""
    err = max_abs(torch, got, ref32)
    bound = FP32_TOL if fp32 else OUT_ERROR_MUL * max_abs(torch, plain, ref32) + OUT_ERROR_BIAS
    if not (torch.isfinite(got).all() and err <= bound):
        raise AssertionError(f"{what}: max abs err {err:.3e} > {bound:.3e}")
    return err


def wide_forward_checks(torch, D, x32, lens, worst, split_leaf=None):
    """(a)'s forward at head dim D: every route forced by name (tri-square
    at S 256, the split with its merge, the strip and the generic kernel at
    S 1024), dropout, a bias, softcap and a window, in bf16; fp32 and fp16
    (the tensor-core kernel, and through flash_attn_func the fp32 and bf16
    compute of JAX's fp16 rule). `split_leaf`: the split's leaves where its
    default leaf is 0 (past D 512); where JAX's gate refuses the strip (D
    1024: K and V strips at S 1024 do not fit its VMEM budget), its own
    entry point (`flash_attn_forward_causal_strip`, the same launch)."""
    from fa2_triton_tpu_torch.ops import flash_attn_func, flash_fwd

    t = lambda x: x.transpose(1, 2)
    q32, k32, v32 = x32
    S = q32.shape[1]
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    strip_gate = flash_fwd.forward_gates(S, S, D, 2, causal=True, static_skip=True)["strip"]
    bias32 = (torch.randn(1, q32.shape[2], S, S, generator=torch.Generator(device="cuda")
                          .manual_seed(D), device="cuda") * 0.5)
    cases = {"route tri_square S 256": dict(route="tri_square", static_skip=True, rows=256),
             "route split": dict(route="split", static_skip=True, split_leaf=split_leaf),
             "route strip": (dict(route="strip", static_skip=True) if strip_gate
                             else dict(strip_call=True)),
             "route generic": dict(route="generic", static_skip=True),
             "dropout": dict(dropout_p=0.1, dropout_seed=D),
             "bias": dict(bias=True), "softcap": dict(softcap=5.0),
             "window": dict(window=(300, 0))}
    want = {"route tri_square S 256": "flash_fwd", "route split": "causal_diag",
            "route strip": "causal_strip"}
    for name, c in cases.items():
        c = dict(c)
        rows = c.pop("rows", S)
        bias = bias32[:, :, :rows, :rows] if c.pop("bias", False) else None
        args32 = [t(x[:, :rows]) for x in (q32, k32, v32)]
        lens_c = torch.tensor([[rows, rows]] * q32.shape[0], dtype=torch.int32, device="cuda")
        strip_call = c.pop("strip_call", False)
        plain_kw = {k: v for k, v in c.items() if k not in ("route", "static_skip", "split_leaf")}
        ref = flash_fwd.flash_attn_forward_plain(*args32, lens_c, 0, 0, bias, **kw, **plain_kw)[0]
        xb = [a.to(torch.bfloat16) for a in args32]
        bb = None if bias is None else bias.to(torch.bfloat16)
        plain = flash_fwd.flash_attn_forward_plain(*xb, lens_c, 0, 0, bb, **kw, **plain_kw)[0]
        before = {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES}
        if strip_call:
            o, _ = flash_fwd.flash_attn_forward_causal_strip(*xb, lens_c,
                                                             softmax_scale=kw["softmax_scale"])
        else:
            o, _ = flash_fwd.flash_attn_forward(*xb, lens_c, 0, 0, bb, **kw, **c)
        torch.cuda.synchronize()
        after = {"flash_fwd": flash_fwd.LAUNCHES, **flash_fwd.SCHEDULE_LAUNCHES}
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        expect = ({"causal_diag": 1, "rect_merge": 1} if name == "route split"
                  else {want.get(name, "flash_fwd"): 1})
        if delta != expect:
            raise AssertionError(f"D {D} forward {name}: launches {delta}, not {expect}")
        worst["forward"] = max(worst["forward"], fa_check(torch, f"D {D} forward {name}", o, ref,
                                                          plain))
    ref = flash_fwd.flash_attn_forward_plain(*(t(x) for x in x32), lens, **kw)[0]
    o = flash_fwd.flash_attn_forward(*(t(x) for x in x32), lens, **kw)[0]
    fa_check(torch, f"D {D} forward fp32", o, ref, None, fp32=True)
    xh = [t(x.half()) for x in x32]
    o = flash_fwd.flash_attn_forward(*xh, lens, **kw)[0]
    fa_check(torch, f"D {D} forward fp16 (tensor cores)", o, ref,
             flash_fwd.flash_attn_forward_plain(*xh, lens, **kw)[0])
    for compute in (None, torch.bfloat16):
        o = flash_attn_func(*(x.half() for x in x32), causal=True, fp16_compute_dtype=compute)
        xc = [t(x.half().to(compute or torch.float32)) for x in x32]
        fa_check(torch, f"D {D} flash_attn_func fp16 computing in {compute or torch.float32}",
                 t(o), ref, flash_fwd.flash_attn_forward_plain(*xc, lens, **kw)[0].half(),
                 fp32=False)


def wide_backward_checks(torch, D, x32, do32, lens, worst):
    """(a)'s backward at head dim D: the pair (dq_mma_kernel + dkdv_mma_kernel)
    on the generic route and, where its gate passes (D 384), the strip's,
    with dropout and with EXTRA (a bias that needs no gradient, softcap), in
    bf16, and the FMA pair in fp32, each against the fp32 plain backward
    (the FA gradient contract)."""
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    t = lambda x: x.transpose(1, 2)
    S, Hq = x32[0].shape[1], x32[0].shape[2]
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    bias32 = torch.randn(1, Hq, S, S, generator=torch.Generator(device="cuda").manual_seed(D + 1),
                         device="cuda") * 0.5
    strip_ok = flash_bwd.backward_route(S, S, D, 2, causal=True, group=Hq // x32[1].shape[2],
                                        static_skip=True) == "strip"
    cases = {"generic": {}, "dropout": dict(dropout_p=0.1, dropout_seed=D + 3),
             "bias": dict(bias=True), "softcap": dict(softcap=5.0)}
    if strip_ok:
        cases["route strip"] = dict(static_skip=True, route="strip")
        cases["route strip dropout"] = dict(static_skip=True, route="strip", dropout_p=0.1,
                                            dropout_seed=D + 5)
    for name, c in list(cases.items()) + [("fp32", dict(fp32=True))]:
        c = dict(c)
        fp32 = c.pop("fp32", False)
        bias = bias32 if c.pop("bias", False) else None
        plain_kw = {k: v for k, v in c.items() if k not in ("route", "static_skip")}
        a32 = [t(x) for x in x32]
        o32, lse32 = flash_fwd.flash_attn_forward_plain(*a32, lens, 0, 0, bias, **kw, **plain_kw)
        refs = flash_bwd.flash_attn_backward_plain(*a32, t(do32), o32, lse32, lens, 0, 0, bias,
                                                   **kw, **plain_kw)
        dt = torch.float32 if fp32 else torch.bfloat16
        xb, dob = [a.to(dt) for a in a32], t(do32.to(dt))
        bb = None if bias is None else bias.to(dt)
        o, lse = flash_fwd.flash_attn_forward(*xb, lens, 0, 0, bb, **kw, **plain_kw)
        before = dict(flash_bwd.LAUNCHES)
        grads = flash_bwd.flash_attn_backward(*xb, dob, o, lse, lens, 0, 0, bb, **kw, **c)
        torch.cuda.synchronize()
        delta = {k: flash_bwd.LAUNCHES[k] - before[k] for k in before}
        if delta != {"flash_bwd_dq": 1, "flash_bwd_dkdv": 1, "flash_bwd_dbias": 0}:
            raise AssertionError(f"D {D} backward {name}: launches {delta}")
        o_pl, lse_pl = flash_fwd.flash_attn_forward_plain(*xb, lens, 0, 0, bb, **kw, **plain_kw)
        plains = flash_bwd.flash_attn_backward_plain(*xb, dob, o_pl, lse_pl, lens, 0, 0, bb, **kw,
                                                     **plain_kw)
        for gname, g, r, pl in zip(("dq", "dk", "dv"), grads, refs, plains):
            if fp32:
                check_fp32_grad(torch, gname, g, r, f"D {D} backward fp32")
            else:
                err, _ = check_grad(torch, gname, g, r, pl, f"D {D} backward {name}")
                worst["backward"] = max(worst["backward"], err)
    return strip_ok


def wide_decode_checks(torch, D, worst, heads=WIDE_HEADS):
    """(a)'s decode at head dim D: 8 slots, Hq 8 / Hkv 2, 2048 cache rows at
    phase 2's lengths up to 2048: contiguous bf16, fp16, fp32, int8 and fp8
    caches and paged bf16 and int8 (page 128) against the plain twins at
    matched bit-width; paged equal to contiguous bit for bit."""
    from fa2_triton_tpu_torch.ops import decode
    from fa2_triton_tpu_torch.ops.quant import quantize_tensor

    gen = torch.Generator(device="cuda").manual_seed(D + 7)
    lens = [n for n in DECODE_LENS if n <= 2048]
    B, (Hq, Hkv), S = len(lens), heads, 2048
    q32 = torch.randn(B, Hq, D, generator=gen, device="cuda") * 0.5
    k32, v32 = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda") * 0.5 for _ in range(2))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        ref = decode.decode_attention_plain(q32, k32, v32, kv_lens)
        xs = [x.to(dt) for x in (q32, k32, v32)]
        o = decode.decode_attention(*xs, kv_lens)
        err = fa_check(torch, f"D {D} decode {dt}", o, ref,
                       decode.decode_attention_plain(*xs, kv_lens), fp32=dt == torch.float32)
        if dt == torch.bfloat16:
            worst["decode"] = max(worst["decode"], err)
            pools, tables = page_pool(torch, (xs[1], xs[2], None, None), lens, 128, seed=D,
                                      fill=float("nan"))
            op = decode.paged_decode_attention(xs[0], pools[0], pools[1], tables, kv_lens)
            if not torch.equal(op, o):
                raise AssertionError(f"D {D} paged bf16 decode differs from contiguous")
    q = q32.to(torch.bfloat16)
    for name, qd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        (kq, ks), (vq, vs) = (quantize_tensor(x, qd) for x in (k32, v32))
        scales = [s.transpose(-1, -2).contiguous() for s in (ks, vs)]
        ref = decode.decode_attention_plain(q32, kq, vq, kv_lens, *scales)
        o = decode.decode_attention(q, kq, vq, kv_lens, *scales)
        err = fa_check(torch, f"D {D} decode {name} cache", o, ref,
                       decode.decode_attention_plain(q, kq, vq, kv_lens, *scales))
        worst["decode"] = max(worst["decode"], err)
        if name == "int8":
            pools, tables = page_pool(torch, (kq, vq, *scales), lens, 128, seed=D + 1, fill=0.0)
            op = decode.paged_decode_attention(q, pools[0], pools[1], tables, kv_lens, *pools[2:])
            if not torch.equal(op, o):
                raise AssertionError(f"D {D} paged int8 decode differs from contiguous")


def wide_kernel_checks(torch, dims=WIDE_DIMS, heads=WIDE_HEADS, split_leaf=None, tag="wide"):
    """(a): each kernel at D 384 and 512 (or `dims`, at `heads`) against its
    plain twin; the launch count of every family at each D must be
    positive."""
    dev = torch.device("cuda")
    Hq, Hkv = heads
    worst = {"forward": 0.0, "backward": 0.0, "decode": 0.0}
    launches, strip = {}, {}
    for D in dims:
        gen = torch.Generator(device=dev).manual_seed(D)
        S = WIDE_CHECK_SEQ
        x32 = [torch.randn(1, S, h, D, generator=gen, device=dev) * 0.5 for h in (Hq, Hkv, Hkv)]
        do32 = torch.randn(1, S, Hq, D, generator=gen, device=dev)
        lens = torch.tensor([[S, S]], dtype=torch.int32, device=dev)
        totals = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "decode"), 0)

        def tally(fn, *args):
            wide_reset()
            out = fn(*args)
            for k, n in wide_counts().items():
                totals[k] += n
            return out
        tally(wide_forward_checks, torch, D, x32, lens, worst, split_leaf)
        strip[D] = tally(wide_backward_checks, torch, D, x32, do32, lens, worst)
        tally(wide_decode_checks, torch, D, worst, heads)
        if not all(totals.values()):
            raise AssertionError(f"D {D}: a kernel family never launched: {totals}")
        launches[D] = totals
        del x32, do32
        torch.cuda.empty_cache()
    print(f"[{tag} kernels] D {list(dims)}: every forward route (tri-square, split + merge, "
          f"strip, generic), dropout, bias, softcap, window; bf16 / fp16 / fp32; the pair with "
          f"dropout and EXTRA (strip route at D {[d for d in strip if strip[d]]}); decode "
          f"bf16 / fp16 / fp32 / int8 / fp8, paged bf16 / int8 == contiguous: within the FA "
          f"contract (worst bf16 errors {({k: float(f'{v:.3e}') for k, v in worst.items()})}); "
          f"launches {launches}")
    return launches, worst


def library_sdpa(torch, q, k, v, causal, scale):
    """One PyTorch call for the attention of BHSD q / k / v (GQA by
    repeating k / v) on SDPA's memory-efficient backend, which takes head
    dims past 256 (its flash backend stops there). Returns (backend name,
    call), or (None, the reason it refused)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[1] // k.shape[1]
    kr, vr = (x.repeat_interleave(g, 1) for x in (k, v))

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=causal, scale=scale)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"EFFICIENT_ATTENTION: {str(e).splitlines()[0][:120]}"
    return "EFFICIENT_ATTENTION", call


# The profiler names of the forward, dq, dk/dv and decode kernels up to D
# 512, and past it (csrc/flash_fwd_any.cu, flash_bwd_any.cu, decode_any.cuh).
WIDE_NAMES = ("flash_fwd_mma_kernel", "dq_mma_kernel", "dkdv_mma_kernel", "decode_kernel")
WIDER_NAMES = ("fwd_any_mma_kernel", "dq_any_mma_kernel", "dkdv_any_mma_kernel",
               "decode_any_kernel")


def wide_times(torch, card, dims=(512, 384), heads=WIDE_HEADS, names=WIDE_NAMES, tag="wide"):
    """(b): the forward and the pair at B 2 x S 2048, causal, Hq 8 / Hkv 2,
    D 512 and 384, and decode over 8 slots x 4096 rows at D 512 (2 KV
    heads, G 4), bf16 (or `dims`, decode at the first, at `heads`, the
    kernels named `names`): kernel device time (profiler), the plain twin's
    and the library's (SDPA's memory-efficient backend), and each bound."""
    from fa2_triton_tpu_torch.ops import decode, flash_bwd, flash_fwd

    dev = torch.device("cuda")
    Hq, Hkv = heads
    B, S = WIDE_TIME_B, WIDE_TIME_SEQ
    fwd_name, dq_name, dkdv_name, decode_name = names
    out = {}
    for D in dims:
        gen = torch.Generator(device=dev).manual_seed(D + 11)
        q, k, v = ((torch.randn(B, S, h, D, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                   .transpose(1, 2) for h in (Hq, Hkv, Hkv))
        do = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
        lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device=dev)
        kw = dict(causal=True, softmax_scale=D ** -0.5)
        route = flash_fwd.forward_route(S, S, D, 2, causal=True, static_skip=True)
        fwd = lambda: flash_fwd.flash_attn_forward(q, k, v, lens, static_skip=True, **kw)
        o, lse = fwd()
        bwd = lambda: flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, static_skip=True,
                                                    **kw)
        ms = {"fwd": kernel_ms(torch, fwd, [fwd_name])[fwd_name]}
        ms.update(kernel_ms(torch, bwd, [dq_name, dkdv_name]))
        # The calls by CUDA events, host work included (delta, layouts).
        ms.update(fwd_call=cuda_ms(torch, fwd, iters=5), bwd_call=cuda_ms(torch, bwd, iters=5))
        plain_f = cuda_ms(torch, lambda: flash_fwd.flash_attn_forward_plain(q, k, v, lens, **kw),
                          iters=3, warmup=1)
        plain_b = cuda_ms(torch, lambda: flash_bwd.flash_attn_backward_plain(q, k, v, do, o, lse,
                                                                             lens, **kw),
                          iters=3, warmup=1)
        pairs = B * causal_pairs([S])
        bounds = {"fwd": attn_bound("fwd", pairs, B * S, Hq, Hkv, D, 2),
                  dq_name: attn_bound("dq", pairs, B * S, Hq, Hkv, D, 2),
                  dkdv_name: attn_bound("dkdv", pairs, B * S, Hq, Hkv, D, 2)}
        backend, lib = library_sdpa(torch, q, k, v, True, D ** -0.5)
        lib_f = lib_fb = None
        if backend is not None:
            lib_f = cuda_ms(torch, lib, iters=5)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            _, lib_g = library_sdpa(torch, qg, kg, vg, True, D ** -0.5)
            lib_fb = cuda_ms(torch, lambda: lib_g().backward(do), iters=3)
        entry = {"route": route, "ms": ms, "plain_fwd_ms": plain_f, "plain_bwd_ms": plain_b,
                 "bounds": bounds, "library": backend or lib, "library_fwd_ms": lib_f,
                 "library_fwd_bwd_ms": lib_fb}
        out[D] = entry
        print(f"[{tag} times] B {B} x S {S} causal, Hq {Hq} / Hkv {Hkv}, D {D}, bf16 [{card}]: "
              f"forward ({route}) {ms['fwd']:.3f} ms, bound {bounds['fwd']['bound_ms']:.3f} ms "
              f"({100 * bounds['fwd']['bound_ms'] / ms['fwd']:.1f} %); dq "
              f"{ms[dq_name]:.3f} ms, bound {bounds[dq_name]['bound_ms']:.3f} "
              f"ms; dk/dv {ms[dkdv_name]:.3f} ms, bound "
              f"{bounds[dkdv_name]['bound_ms']:.3f} ms; the calls (CUDA events, 5 "
              f"runs) {ms['fwd_call']:.3f} / {ms['bwd_call']:.3f} ms; plain {plain_f:.3f} / "
              f"{plain_b:.3f} ms; library "
              + (f"SDPA {backend}: forward {lib_f:.3f} ms, forward + backward {lib_fb:.3f} ms"
                 if backend else f"none: {lib}"))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    D = dims[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    slots, rows = WIDE_DECODE_SLOTS, WIDE_DECODE_ROWS
    q = (torch.randn(slots, Hq, D, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    kc, vc = ((torch.randn(slots, Hkv, rows, D, generator=gen, device=dev) * 0.5)
              .to(torch.bfloat16) for _ in range(2))
    kv_lens = torch.full((slots,), rows, dtype=torch.int32, device=dev)
    run = lambda: decode.decode_attention(q, kc, vc, kv_lens)
    dms = kernel_ms(torch, run, [decode_name], iters=10)[decode_name]
    plain = cuda_ms(torch, lambda: decode.decode_attention_plain(q, kc, vc, kv_lens), iters=3)
    nbytes = 2 * slots * rows * Hkv * D * 2 + 2 * slots * Hq * D * 2
    dbound = roofline(4 * D * Hq * slots * rows, nbytes)
    backend, lib = library_sdpa(torch, q[:, :, None], kc, vc, False, D ** -0.5)
    lib_ms = library_mean_ms(torch, lib) if backend else None
    out["decode"] = {"ms": dms, "plain_ms": plain, **dbound, "library": backend or lib,
                     "library_ms": lib_ms}
    print(f"[{tag} times] decode {slots} slots x {rows} rows, Hq {Hq} / Hkv {Hkv}, D {D}, bf16 "
          f"[{card}]: kernel {dms:.4f} ms, bound {dbound['bound_ms']:.4f} ms "
          f"({dbound['bound_by']}, {100 * dbound['bound_ms'] / dms:.1f} %), plain {plain:.3f} ms, "
          f"library " + (f"SDPA {backend} {lib_ms:.4f} ms" if backend else f"none: {lib}"))
    return out


def wide_model(torch, card, over=None, tag="wide"):
    """(c): Mistral-7B-v0.3's widths, heads cut to 8 x 512 / 2 x 512 (or
    `over`), full depth, random weights (seed 0): 8 of phase 3's prompts
    served through a contiguous bf16 and a paged int8 cache (phase 3's
    log-prob check), the 2-layer gradients against fp32, then
    WIDE_TRAIN_STEPS trainer steps at 2 x 2048 (the forward's and the
    pair's launches held to the layers and steps)."""
    from fa2_triton_tpu_torch.examples import train
    from fa2_triton_tpu_torch.models import init_params
    from fa2_triton_tpu_torch.ops import flash_bwd, flash_fwd

    over = over or dict(n_heads=8, n_kv_heads=2, head_dim=512)
    cfg = train.preset_config("mistral-7b-v0.3", torch.bfloat16, **over)
    res = {}
    with torch.inference_mode():
        model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        prompts = served_prompts(cfg)[:WIDE_REQUESTS]
        for what, tol in ((f"serve {tag}", (LOGPROB_MEAN_TOL, LOGPROB_MAX_TOL)),
                          (f"serve {tag} paged int8", QUANT_LOGPROB_TOL["int8"])):
            reqs, stats, launches = serve(torch, model, cfg, prompts, card, what)[:3]
            errs = check_logprobs(torch, model, cfg, reqs, prompts, what, *tol)
            res[what] = {"launches": launches, "decode_tokens_per_s": stats.decode_tokens_per_s,
                         "logprob_err_max": float(max(e.max() for e in errs))}
        del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_grads(torch, what=f"{tag} train", **over)
    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--config", "mistral-7b-v0.3", "--steps", str(WIDE_TRAIN_STEPS), "--batch", "2",
            "--seq", str(TRAIN_SEQ), "--remat", "--repeat-batch", "--lr", "3e-4",
            "--grad-clip", "1.0"]

    def reset():
        flash_fwd.reset_launches()
        flash_bwd.reset_launches()

    preset = train.build_config
    # The preset's widths with the attention cut into heads of 512 (or
    # `over`'s): the trainer's own config, its heads replaced (no flag of the
    # trainer names a head count).
    train.build_config = lambda args: dataclasses.replace(preset(args), **over)
    try:
        args, run = run_trainer(torch, card, argv, reset, f"{tag} train")
    finally:
        train.build_config = preset
    L = run["config"].n_layers
    launches = {"flash_fwd": flash_fwd.LAUNCHES + sum(flash_fwd.SCHEDULE_LAUNCHES.values()),
                **flash_bwd.LAUNCHES}
    want = {"flash_fwd": 2 * L * args.steps, "flash_bwd_dq": L * args.steps,
            "flash_bwd_dkdv": L * args.steps, "flash_bwd_dbias": 0}
    if run["config"].hd != over["head_dim"] or launches != want:
        raise AssertionError(f"{tag} training: head_dim {run['config'].hd}, launches {launches} "
                             f"!= {want}")
    res["train"] = {"layers": L, "losses": run["losses"], "step_s": run["step_s"],
                    "tokens_per_s": run["tokens_per_s"], "peak_gib": run["peak_bytes"] / 2**30,
                    "launches": launches}
    return res


def phi3_serve(torch, card):
    """(d): Phi-3-mini-4k-instruct's widths (head_dim 96), random weights
    (seed 0), phase 3's 16 requests through a contiguous bf16 and a paged
    int8 cache, each held to phase 3's log-prob check: the caches are 128
    wide, the decode kernel's head dim."""
    from fa2_triton_tpu_torch.models import LlamaConfig, init_params
    from fa2_triton_tpu_torch.ops.attention import kernel_head_dim

    cfg = LlamaConfig(dtype=torch.bfloat16, **PHI3_WIDTHS)
    res = {}
    with torch.inference_mode():
        model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[phi3] Phi-3-mini-4k-instruct widths, {n_params / 1e9:.2f} B params bf16, random "
              f"(seed 0), head_dim {cfg.hd}: the caches are {kernel_head_dim(cfg.hd)} wide, the "
              f"decode kernel's head dim")
        prompts = served_prompts(cfg)
        for what, tol in (("serve phi3", (LOGPROB_MEAN_TOL, LOGPROB_MAX_TOL)),
                          ("serve phi3 paged int8", QUANT_LOGPROB_TOL["int8"])):
            reqs, stats, launches = serve(torch, model, cfg, prompts, card, what)[:3]
            errs = check_logprobs(torch, model, cfg, reqs, prompts, what, *tol)
            res[what] = {"launches": launches, "decode_tokens_per_s": stats.decode_tokens_per_s,
                         "logprob_err_max": float(max(e.max() for e in errs))}
        del model
    return res


def phase_wide(torch, card):
    """Phase 20: head dims 384 and 512 ((a)-(d) above)."""
    t0 = time.perf_counter()
    os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"   # the prior's routes, as phases 1-16
    try:
        with torch.inference_mode():
            launches, worst = wide_kernel_checks(torch)
        times = wide_times(torch, card)   # the library's backward records a graph
        gc.collect()
        torch.cuda.empty_cache()
        model = wide_model(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        phi3 = phi3_serve(torch, card)
    finally:
        os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)
    seconds = time.perf_counter() - t0
    print(f"[wide] phase 20 in {seconds:.1f} s")
    return {"launches": launches, "worst": worst, "times": times, "model": model, "phi3": phi3,
            "seconds": seconds}



# ---------------------------------------------------------------------------
# Phase 21 (the fused causal backward schedules and dbias at head dims 384
# and 512): B13 tri-square and diag, B14 work list and B4 dbias on their
# tilings past D 256 (csrc/bwd_mma.cuh FusedKv: 32 kv rows, 32-row q tiles,
# 4 warps along D; dbias with one buffer of a step's tiles; FmaTile's 32 x
# 16 tiles for fp32), each against its plain twin and reached by JAX's
# routes; their times at Qwen1.5-7B's widths cut into heads of 512 (8 / 8
# heads: Hq x D = 4096, so wq / wk / wv / wo keep the preset's shapes); that
# model's 2-layer gradients against fp32, and its trainer at 2 x 2048 (the
# work list) and 8 x 512 (the tri-square).

SCHED_WIDE_H = 8                 # query heads of (a) and (b)
SCHED_WIDE_LEAF = 512            # (a): the split forced with leaves of 512 at S 1024
SCHED_WIDE_WL_SEQ = {384: 4096, 512: 2048}   # (a): shapes where JAX's gate takes the work list
SCHED_WIDE_B, SCHED_WIDE_SEQ = 2, 2048        # (b): the work list against the pair, and dbias
SCHED_WIDE_TRI = (8, 512)                     # (b): the tri-square, B x S
QWEN_WIDE = dict(n_heads=8, n_kv_heads=8, head_dim=512)
QWEN_WIDE_SHAPES = ((2, 2048, "worklist"), (8, 512, "tri_square"))   # (c): batch, seq, route
SCHED_WIDE_KERNELS = ("tri_square", "causal_diag", "rect", "worklist", "flash_bwd_dbias")


def sched_wide_case(torch, what, D, B, S, Hkv, dtype, call, want, dropout_p=0.0, bias_shape=None):
    """One backward call at head dim D through the kernels, `call(x, do, o,
    lse, lens, bias, **kw)` -> grads (+ dbias with a bias), on B x S, 8 / Hkv
    heads, causal, from the fp32 plain forward's o and lse: its launches
    exactly `want` (flash_bwd's counts, the schedules' as "bwd_<name>"),
    and each gradient against the fp32 plain twin: fp32 within
    FP32_GRAD_RTOL x (1 + max |grad|), 16-bit the FA gradient contract.
    Returns (the largest error, the launches)."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    gen = torch.Generator(device="cuda").manual_seed(D + S + Hkv)
    t = lambda x: x.transpose(1, 2)
    x32 = [t(torch.randn(B, S, h, D, generator=gen, device="cuda") * 0.5)
           for h in (SCHED_WIDE_H, Hkv, Hkv)]
    do32 = t(torch.randn(B, S, SCHED_WIDE_H, D, generator=gen, device="cuda"))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device="cuda")
    b32 = (None if bias_shape is None else
           torch.randn(*bias_shape, generator=gen, device="cuda") * 0.5)
    kw = dict(causal=True, softmax_scale=D ** -0.5, dropout_p=dropout_p, dropout_seed=DROPOUT_SEED)
    extra = dict(compute_dbias=True) if b32 is not None else {}
    o32, lse32 = ff.flash_attn_forward_plain(*x32, lens, 0, 0, b32, **kw)
    refs = fb.flash_attn_backward_plain(*x32, do32, o32, lse32, lens, 0, 0, b32, **kw, **extra)
    x, do, o = [a.to(dtype) for a in x32], do32.to(dtype), o32.to(dtype)
    bias = None if b32 is None else b32.to(dtype)
    ff.reset_launches()
    fb.reset_launches()
    grads = call(x, do, o, lse32, lens, bias, **kw, **extra)
    torch.cuda.synchronize()
    counts = {**fb.LAUNCHES, **{f"bwd_{n}": c for n, c in fb.SCHEDULE_LAUNCHES.items()}}
    got = {n: c for n, c in counts.items() if c}
    if got != want:
        raise AssertionError(f"D {D} {what}: launches {got} != {want}")
    names = BWD_NAMES + (("dbias",) if bias is not None else ())
    label = f"D {D} {what} {str(dtype)[6:]}"
    if dtype == torch.float32:
        errs = [check_fp32_grad(torch, n, g, r, label) for n, g, r in zip(names, grads, refs)]
    else:
        plains = fb.flash_attn_backward_plain(*x, do, o, lse32, lens, 0, 0, bias, **kw, **extra)
        errs = [check_grad(torch, n, g, r, pl, label)[0]
                for n, g, r, pl in zip(names, grads, refs, plains)]
    return max(errs), got


def sched_wide_checks(torch):
    """(a): at D 384 and 512, the tri-square (bf16 at S 512 MHA and S 256
    GQA 2, fp32 at S 256), the split forced with leaves of 512 at S 1024
    (diag + rect), the work list (bf16 MHA where JAX's gate takes it, and one
    direct fp32 call) and dbias ([1, 8, S, S] and [2, 1, S, S] biases, bf16
    / fp16 / fp32), with and without dropout (dbias with it), each against
    its plain twin. Fails unless every family launched at each D."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb

    def routed(x, do, o, lse, lens, bias, **kw):
        return fb.flash_attn_backward(*x, do, o, lse, lens, 0, 0, bias, static_skip=True, **kw)

    def split(x, do, o, lse, lens, bias, **kw):
        return fb.flash_attn_backward(*x, do, o, lse, lens, static_skip=True, causal_split=True,
                                      split_leaf=SCHED_WIDE_LEAF, **kw)

    def direct_wl(x, do, o, lse, lens, bias, **kw):
        return fb.flash_attn_backward_fused_wl(*x, do, o, lse, lens, sub=256, block_kv=512, **kw)

    p = DROPOUT_P
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    tri, pair_db = {"bwd_tri_square": 1}, {"flash_bwd_dq": 1, "flash_bwd_dkdv": 1,
                                           "flash_bwd_dbias": 1}
    launches, worst = {}, {}
    for D in WIDE_DIMS:
        S_wl = SCHED_WIDE_WL_SEQ[D]
        cases = [("tri_square S 512", 1, 512, 8, bf16, routed, tri, 0.0, None),
                 ("tri_square S 512 dropout", 1, 512, 8, bf16, routed, tri, p, None),
                 ("tri_square S 256 GQA 2", 2, 256, 4, bf16, routed, tri, 0.0, None),
                 ("tri_square S 256 GQA 2 dropout", 2, 256, 4, bf16, routed, tri, p, None),
                 ("tri_square S 256", 1, 256, 8, f32, routed, tri, 0.0, None),
                 ("tri_square S 256 dropout", 1, 256, 8, f32, routed, tri, p, None),
                 ("split S 1024", 1, 1024, 8, bf16, split,
                  {"bwd_causal_diag": 1, "bwd_rect": 1}, 0.0, None),
                 ("split S 1024 dropout", 1, 1024, 8, bf16, split,
                  {"bwd_causal_diag": 1, "bwd_rect": 1}, p, None),
                 (f"worklist S {S_wl}", 1, S_wl, 8, bf16, routed, {"bwd_worklist": 1}, 0.0, None),
                 (f"worklist S {S_wl} dropout", 1, S_wl, 8, bf16, routed, {"bwd_worklist": 1}, p,
                  None),
                 ("worklist S 1024 sub 256 strips of 512 (direct)", 1, 1024, 8, f32, direct_wl,
                  {"bwd_worklist": 1}, p, None)]
        for dt in (bf16, f16, f32):
            for shape in ((1, SCHED_WIDE_H, 512, 512), (2, 1, 512, 512)):
                cases.append((f"dbias {list(shape)} dropout", 2, 512, 2, dt, routed, pair_db, p,
                              shape))
        totals = dict.fromkeys(("bwd_tri_square", "bwd_causal_diag", "bwd_rect", "bwd_worklist",
                                "flash_bwd_dbias"), 0)
        for what, B, S, Hkv, dt, call, want, drop, bias_shape in cases:
            err, got = sched_wide_case(torch, what, D, B, S, Hkv, dt, call, want, drop, bias_shape)
            for n, c in got.items():
                if n in totals:
                    totals[n] += c
            if dt != f32:
                family = what.split(" ")[0]
                worst[family] = max(worst.get(family, 0.0), err)
            gc.collect()
            torch.cuda.empty_cache()
        if not all(totals.values()):
            raise AssertionError(f"D {D}: a kernel family never launched: {totals}")
        launches[D] = totals
    print(f"[wide schedules] D {list(WIDE_DIMS)}: tri-square (bf16 S 512 MHA, S 256 GQA 2, fp32 S "
          f"256), split (leaves {SCHED_WIDE_LEAF}, diag + rect), work list (bf16 at S "
          f"{SCHED_WIDE_WL_SEQ}, fp32 direct), dbias (bf16 / fp16 / fp32, two bias shapes), with "
          f"and without dropout, each through JAX's route: within the FA contract (worst 16-bit "
          f"errors {({k: float(f'{v:.3e}') for k, v in worst.items()})}); launches {launches}")
    return launches, worst


def sdpa_backward_ms(torch, x, truth, plain_errs, what):
    """SDPA's memory-efficient backend (the one that takes D > 256) on the
    same bf16 BHSD q / k / v / do, causal: its gradients checked against the
    fp32 truth (check_library), then the CUDA-event ms of its backward alone
    (autograd.grad over a kept graph). Returns (ms, None) or (None, the
    reason it refused)."""
    q, k, v, do = (a.detach() for a in x[:4])
    qg, kg, vg = (a.requires_grad_() for a in (q.clone(), k.clone(), v.clone()))
    backend, lib = library_sdpa(torch, qg, kg, vg, True, q.shape[-1] ** -0.5)
    if backend is None:
        return None, lib
    out = lib()
    grads = torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    for n, g, r in zip(BWD_NAMES, grads, truth):
        check_library(torch, f"{what} SDPA {n}", g, r, plain_errs[n])
    ms = cuda_ms(torch, lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                 iters=3)
    return ms, None


def sched_wide_time(torch, card, what, B, S, kernel, names, route):
    """(b): `route` (the work list or the tri-square) at B x S, 8 / 8 heads of
    512, causal, bf16, against the dq + dk/dv pair in the same call (CUDA
    events, in turns, whole calls), the profiler's split of its kernels,
    the plain backward, SDPA's backward and the bound (5 products)."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    D, H = 512, SCHED_WIDE_H
    gen = torch.Generator(device="cuda").manual_seed(S + 21)
    t = lambda x: x.transpose(1, 2)
    x32 = [t(torch.randn(B, S, H, D, generator=gen, device="cuda") * 0.5) for _ in range(3)]
    do32 = t(torch.randn(B, S, H, D, generator=gen, device="cuda"))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o32, lse32 = ff.flash_attn_forward_plain(*x32, lens, **kw)
    truth = fb.flash_attn_backward_plain(*x32, do32, o32, lse32, lens, **kw)
    xb, dob = [a.to(torch.bfloat16) for a in x32], do32.to(torch.bfloat16)
    o, lse = ff.flash_attn_forward(*xb, lens, **kw)
    def plain():
        return fb.flash_attn_backward_plain(*xb, dob, o, lse, lens, **kw)

    def fused():
        return fb.flash_attn_backward(*xb, dob, o, lse, lens, static_skip=True, **kw)

    def pair():
        return fb.flash_attn_backward(*xb, dob, o, lse, lens, **kw)

    plain_errs = {n: max_abs(torch, g, r) for n, g, r in zip(BWD_NAMES, plain(), truth)}
    fb.reset_launches()
    fused()
    if fb.SCHEDULE_LAUNCHES[route] != 1 or any(fb.LAUNCHES.values()):
        raise AssertionError(f"{what}: not one {route} launch: {fb.SCHEDULE_LAUNCHES}")
    runs = turns(torch, {"pair": pair, "fused": fused}, ("pair", "fused", "fused", "pair"),
                 iters=3)
    per = profiler_split(torch, fused, names)
    pms = cuda_ms(torch, plain, iters=2, warmup=1)
    lib_ms, lib_why = sdpa_backward_ms(torch, (*xb, dob), truth, plain_errs, what)
    bound = fused_bound(B * causal_pairs([S]), B * S, B * S, Hq=H, Hkv=H, D=D)
    print(f"[wide schedules] {what} B {B} x S {S}, {H} / {H} heads of {D}, causal, bf16 [{card}]: "
          f"call (CUDA events) {' / '.join(f'{v:.3f}' for v in runs['fused'])} ms"
          + (f" (profiler: " + ", ".join(f"{n} {per[n]:.3f}" for n in names) + " ms)" if per
             else "")
          + f", the dq + dk/dv pair {' / '.join(f'{v:.3f}' for v in runs['pair'])} ms (fused / "
          f"pair {fused_over_pair(runs['fused'], runs['pair']):.3f}), plain {pms:.3f} ms, library "
          + (f"SDPA EFFICIENT_ATTENTION backward {lib_ms:.3f} ms" if lib_ms else f"none: {lib_why}")
          + f", bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
          f"{100 * bound['bound_ms'] / min(runs['fused']):.1f} % of the bound")
    res = {"kernel": kernel, "ms": min(runs["fused"]), "ms_runs": runs["fused"], "profiler_ms": per,
           "pair_ms_runs": runs["pair"], "fused_over_pair": fused_over_pair(runs["fused"],
                                                                            runs["pair"]),
           "plain_ms": pms, "library_ms": lib_ms, "library": "SDPA EFFICIENT_ATTENTION backward"
           if lib_ms else lib_why, **bound}
    del x32, do32, truth, xb, dob, o, lse
    return res



def sched_wide_split_time(torch, card):
    """(b): the split's two launches alone at B 2 x S 2048, 8 / 8 heads of
    512, leaves of 1024, bf16, from the prescaled k and the global delta (as
    the split hands them over): the diag over both leaves and the rect (rows
    1024-2047 x columns 0-1023), each by CUDA events beside its plain twin
    and its bound (5 products)."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    B, S, D, H, T = SCHED_WIDE_B, SCHED_WIDE_SEQ, 512, SCHED_WIDE_H, SCHED_WIDE_SEQ // 2
    gen = torch.Generator(device="cuda").manual_seed(2122)
    t = lambda x: x.transpose(1, 2)
    q, k, v, do = (t((torch.randn(B, S, H, D, generator=gen, device="cuda") * 0.5)
                     .to(torch.bfloat16)) for _ in range(4))
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device="cuda")
    scale = D ** -0.5
    o, lse = ff.flash_attn_forward(q, k, v, lens, causal=True, softmax_scale=scale)
    args = (q, fb._prescale_k(k, scale), v, do, lse, fb.compute_delta(o, do, lse), lens)
    region = dict(row0=T, col0=0, nrows=T, ncols=T)
    runs = {"causal_diag": (lambda: fb.flash_attn_backward_causal_diag(*args, T=T,
                                                                       softmax_scale=scale),
                            lambda: fb.flash_attn_backward_causal_diag_plain(*args, T=T,
                                                                             softmax_scale=scale),
                            fused_bound(B * causal_pairs([T] * (S // T)), B * S, B * S, Hq=H,
                                        Hkv=H, D=D)),
            "rect": (lambda: fb.flash_attn_backward_rect(*args, **region, softmax_scale=scale),
                     lambda: fb.flash_attn_backward_rect_plain(*args, **region,
                                                               softmax_scale=scale),
                     fused_bound(B * T * T, B * T, B * T, Hq=H, Hkv=H, D=D))}
    why = ("no PyTorch call takes the global lse and delta: the split's launches compute "
           "their share of the whole causal gradient")
    out = {}
    for name, (kern, plain, bound) in runs.items():
        fb.reset_launches()
        kern()
        torch.cuda.synchronize()
        if {n: c for n, c in fb.SCHEDULE_LAUNCHES.items() if c} != {name: 1}:
            raise AssertionError(f"wide {name}: launches {fb.SCHEDULE_LAUNCHES}")
        ms = cuda_ms(torch, kern, iters=3)
        pms = cuda_ms(torch, plain, iters=2, warmup=1)
        print(f"[wide schedules] {name} (leaves {T}) B {B} x S {S}, {H} / {H} heads of {D}, bf16 "
              f"[{card}]: {ms:.3f} ms (CUDA events, whole calls), plain {pms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
              f"{100 * bound['bound_ms'] / ms:.1f} % of the bound; library none: {why}")
        out[name] = {"ms": ms, "plain_ms": pms, "library_ms": None, "library": why, **bound}
    del q, k, v, do, o, lse, args
    return out


def sched_wide_dbias_time(torch, card):
    """(b): dbias at B 2 x S 2048, 8 / 8 heads of 512, causal, bf16, a [1, 8,
    S, S] bias: the kernel's device time (profiler), the plain backward's
    (CUDA events), and the bound (dbias_bound)."""
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    B, S, D, H = SCHED_WIDE_B, SCHED_WIDE_SEQ, 512, SCHED_WIDE_H
    gen = torch.Generator(device="cuda").manual_seed(2121)
    t = lambda x: x.transpose(1, 2)
    xb = [t((torch.randn(B, S, H, D, generator=gen, device="cuda") * 0.5).to(torch.bfloat16))
          for _ in range(4)]
    bias = (torch.randn(1, H, S, S, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    lens = torch.tensor([[S, S]] * B, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    o, lse = ff.flash_attn_forward(*xb[:3], lens, 0, 0, bias, **kw)
    def run():
        return fb.flash_attn_backward(*xb, o, lse, lens, 0, 0, bias, compute_dbias=True, **kw)

    ms = kernel_ms(torch, run, ["dbias_mma_kernel"])["dbias_mma_kernel"]
    pms = cuda_ms(torch, lambda: fb.flash_attn_backward_plain(*xb, o, lse, lens, 0, 0, bias,
                                                              compute_dbias=True, **kw),
                  iters=2, warmup=1)
    bound = dbias_bound(B, H, H, S, D)
    why = ("no PyTorch call computes dbias alone: SDPA's backward returns a bias gradient only "
           "with dq, dk and dv")
    print(f"[wide schedules] dbias_mma_kernel B {B} x S {S}, {H} / {H} heads of {D}, causal, "
          f"[1, {H}, S, S] bf16 bias [{card}]: {ms:.3f} ms (profiler), plain backward with dbias "
          f"{pms:.3f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
          f"{100 * bound['bound_ms'] / ms:.1f} % of the bound; library none: {why}")
    del xb, bias, o, lse
    return {"ms": ms, "plain_ms": pms, "library_ms": None, "library": why, **bound}


def qwen_wide_train(torch, card):
    """(c): Qwen1.5-7B's widths, heads cut to 8 x 512 / 8 x 512, random
    weights (seed 0): the 2-layer gradients against fp32 (2 x 2048: the work
    list), then QWEN_STEPS trainer steps at 2 x 2048 (the work list) and 8 x
    512 (the tri-square) at the preset's depth, launch counts reset after
    each warm-up and held to the route. Returns the runs by shape."""
    from fa2_triton_tpu_torch.examples import train
    from fa2_triton_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff

    phase_train_grads(torch, what="wide qwen train", preset="qwen1.5-7b",
                      want={"flash_fwd": 2, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0,
                            "flash_bwd_dbias": 0, "bwd_worklist": 2}, **QWEN_WIDE)
    gc.collect()
    torch.cuda.empty_cache()

    def reset():
        ff.reset_launches()
        fb.reset_launches()

    preset = train.build_config
    # The preset's widths with the attention cut into heads of 512: the
    # trainer's own config, its heads replaced (no flag of the trainer
    # names a head count).
    train.build_config = lambda args: dataclasses.replace(preset(args), **QWEN_WIDE)
    runs = {}
    try:
        for batch, seq, route in QWEN_WIDE_SHAPES:
            gc.collect()
            torch.cuda.empty_cache()
            args, res = run_trainer(torch, card, qwen_train_argv(batch, seq), reset,
                                    f"wide qwen train {batch} x {seq}")
            got = bwd_launches(ff, fb)
            L, steps = res["config"].n_layers, args.steps
            fwd_route = ff.forward_route(seq - 1, seq - 1, 512, 2, causal=True, static_skip=True)
            want = dict.fromkeys(got, 0)
            want["causal_strip" if fwd_route == "strip" else "flash_fwd"] = 2 * L * steps
            want[f"bwd_{route}"] = L * steps
            print(f"[wide qwen train] {batch} x {seq} launches: {got}")
            if res["config"].hd != 512 or got != want:
                raise AssertionError(f"wide qwen {batch} x {seq}: head_dim {res['config'].hd}, "
                                     f"launches {got} != {want}")
            runs[f"{batch} x {seq}"] = {
                "route": route, "layers": L, "losses": res["losses"], "step_s": res["step_s"],
                "tokens_per_s": res["tokens_per_s"], "peak_gib": res["peak_bytes"] / 2**30,
                "launches": {n: c for n, c in got.items() if c}}
    finally:
        train.build_config = preset
    return runs


def phase_wide_schedules(torch, card):
    """Phase 21 ((a)-(c) above)."""
    t0 = time.perf_counter()
    os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"   # the prior's routes (no table key past 256)
    try:
        with torch.inference_mode():
            launches, worst = sched_wide_checks(torch)
        times = {"worklist": sched_wide_time(torch, card, "worklist", SCHED_WIDE_B, SCHED_WIDE_SEQ,
                                             "bwd_wl_mma_kernel",
                                             ("bwd_wl_mma_kernel", "wl_mma_reduce"), "worklist")}
        gc.collect()
        torch.cuda.empty_cache()
        times["tri_square"] = sched_wide_time(
            torch, card, "tri_square", *SCHED_WIDE_TRI, "bwd_tri_mma_kernel",
            ("fused_delta", "bwd_tri_mma_kernel", "tri_dq_reduce"), "tri_square")
        gc.collect()
        torch.cuda.empty_cache()
        with torch.inference_mode():
            times["dbias"] = sched_wide_dbias_time(torch, card)
            gc.collect()
            torch.cuda.empty_cache()
            times.update(sched_wide_split_time(torch, card))
        gc.collect()
        torch.cuda.empty_cache()
        train = qwen_wide_train(torch, card)
    finally:
        os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)
    seconds = time.perf_counter() - t0
    print(f"[wide schedules] phase 21 in {seconds:.1f} s")
    return {"launches": launches, "worst": worst, "times": times, "train": train,
            "seconds": seconds}


# Phase 22: the packed kernels (B7, B8) at head dims 384 and 512.
WIDE_PACKED_LENS = (300, 1, 128, 77)        # (a): ragged, length 1, a block multiple
# (a)'s blocks: rectangular both ways, so that the 32-row halves of a 64-row
# host tile (the 16-bit dk/dv blocks, the fp32 blocks) sit at both ends of
# a user block.
WIDE_PACKED_BLOCKS = {384: (128, 64), 512: (64, 128)}
# (a)'s block mask over one 512-token segment (blocks of 128): q block 2
# keeps no kv block and no q block keeps kv block 1.
WIDE_PACKED_MASK = np.array([[1, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 1, 1]], bool)


def packed_starts(lens, align):
    """(segment starts, T) of documents of `lens` packed back to back at
    starts aligned to `align` (`pack_padded_batch`'s layout)."""
    starts = [0]
    for n in lens:
        starts.append(starts[-1] + -(-max(n, 1) // align) * align)
    return starts[:-1], starts[-1]


def wide_packed_case(torch, what, D, dtype, lens, blocks, keep_block=None, seed=0, **drop):
    """(a): one forward + backward through the launchers at head dim D, 8 /
    2 heads, causal, with NaN in the gaps of the packed stream: one launch
    of each kernel, o / lse / gradients against the fp32 plain twin (fp32
    within FP32_TOL and FP32_GRAD_RTOL, 16-bit the FA rules against the
    16-bit plain twin's error), dead positions exactly 0. Returns the
    largest error."""
    from fa2_triton_tpu_torch.ops import varlen

    dev = torch.device("cuda")
    Hq, Hkv = WIDE_HEADS
    starts, T = packed_starts(lens, max(blocks))
    gen = torch.Generator(device=dev).manual_seed(seed)
    x32 = [(torch.randn(1, T, h, D, generator=gen, device=dev) * sd).transpose(1, 2)
           for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, n in zip(starts, lens):
        live[s0:s0 + n] = True
    kw = dict(causal=True, softmax_scale=D ** -0.5, block_q=blocks[0], block_kv=blocks[1],
              keep_block=keep_block, **drop)
    args = (starts, lens, lens)
    o32, lse32 = varlen.flash_attn_varlen_forward_plain(*x32[:3], *args, **kw)
    refs = varlen.flash_attn_varlen_backward_plain(*x32, o32, lse32, *args, **kw)
    x = [a.to(dtype) for a in x32]
    for a in x:
        a[:, :, ~live] = float("nan")
    varlen.reset_launches()
    o, lse = varlen.flash_attn_varlen_forward(*x[:3], *args, **kw)
    grads = varlen.flash_attn_varlen_backward(*x[:3], x[3], o, lse, *args, **kw)
    torch.cuda.synchronize()
    if varlen.LAUNCHES != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"D {D} {what}: launches {varlen.LAUNCHES}")
    label = f"wide packed D {D} {what} {str(dtype)[6:]}"
    fp32 = dtype == torch.float32
    if fp32:
        o_pl, lse_pl = o32, lse32
        errs = [check_fp32_grad(torch, n, g, r, label) for n, g, r in zip(BWD_NAMES, grads, refs)]
    else:
        o_pl, lse_pl = varlen.flash_attn_varlen_forward_plain(*x[:3], *args, **kw)
        plains = varlen.flash_attn_varlen_backward_plain(*x[:3], x[3], o_pl, lse_pl, *args, **kw)
        errs = [check_grad(torch, n, g, r, pl, label)[0]
                for n, g, r, pl in zip(BWD_NAMES, grads, refs, plains)]
    errs.append(fa_check(torch, f"{label} o", o, o32, o_pl, fp32=fp32))
    check_lse(torch, lse, lse_pl, label)
    dead_o = o[:, :, ~live].any() or not torch.all(lse[:, :, ~live] == float("-inf"))
    if dead_o or any(g[:, :, ~live].any() or not torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"{label}: a dead position holds a nonzero value, or NaN leaked")
    return max(errs)


def wide_packed_checks(torch):
    """(a): at D 384 and 512, in bf16, fp16 and fp32, the packed kernels on
    WIDE_PACKED_LENS (causal), with dropout, and block-sparse over two
    segments with WIDE_PACKED_MASK, each against its plain twin. Returns
    {D: launches} and the worst 16-bit error."""
    from fa2_triton_tpu_torch.ops import varlen

    keep = varlen._mask_keep_fn(varlen.encode_block_mask(WIDE_PACKED_MASK))
    worst, launches = 0.0, {}
    for D in WIDE_DIMS:
        runs = 0
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            cases = (("varlen", WIDE_PACKED_LENS, WIDE_PACKED_BLOCKS[D], None, {}),
                     ("varlen dropout", WIDE_PACKED_LENS, WIDE_PACKED_BLOCKS[D], None,
                      dict(dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED + D)),
                     ("blocksparse", (512, 400), (128, 128), keep, {}))
            for i, (what, lens, blocks, kb, drop) in enumerate(cases):
                err = wide_packed_case(torch, what, D, dtype, lens, blocks, kb, seed=D + i, **drop)
                if dtype != torch.float32:
                    worst = max(worst, err)
                runs += 1
        launches[D] = dict.fromkeys(VARLEN_KERNEL_NAMES, runs)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[wide packed] D {list(WIDE_DIMS)}: forward, dq and dk/dv (bf16 / fp16 / fp32; "
          f"varlen {WIDE_PACKED_LENS} at blocks {WIDE_PACKED_BLOCKS}, with dropout p "
          f"{DROPOUT_P}, block-sparse with a filtered row and kv block; NaN in the gaps): one "
          f"launch each a call, within the FA contract (worst 16-bit error {worst:.3e}), dead "
          f"positions exactly 0")
    return launches, worst


def library_efficient(torch, q, k, v, lens, scale, dropout_p=0.0):
    """SDPA's memory-efficient kernel (`aten._efficient_attention_forward`
    / `_backward`, the only PyTorch attention that takes D 512) with
    `cu_seqlens`, causal, on tight-packed bf16 rows [1, sum(lens), H, D], k
    and v already expanded to q's heads: the yardstick, called nowhere in the
    port. With `dropout_p` it draws its own Philox mask (a timing yardstick
    only). Returns (forward call, its output, backward call given do), or
    (None, the reason it refused, None)."""
    cu = torch.tensor(np.cumsum([0, *lens]), dtype=torch.int32, device=q.device)
    n = max(lens)

    def fwd():
        return torch.ops.aten._efficient_attention_forward(q, k, v, None, cu, cu, n, n, dropout_p,
                                                           1, True, scale=scale)
    try:
        out = fwd()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"_efficient_attention_forward: {str(e).splitlines()[0][:160]}", None

    def bwd(do):
        o, lse, seed, offset = out[:4]
        return lambda: torch.ops.aten._efficient_attention_backward(
            do, q, k, v, None, o, cu, cu, n, n, lse, dropout_p, seed, offset, 1, False,
            scale=scale)
    return fwd, out[0], bwd


def flex_blocksparse(torch, x, mask_mod, S, blk, D, truth, errs):
    """flex_attention (compiled) with the block mask, the block-sparse
    yardstick: its output and gradients held against the fp32 truth like
    check_library, then (forward ms, backward ms, how), or (None, None, the
    reason it refused)."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    B = x[0].shape[0]
    try:
        block_mask = create_block_mask(mask_mod, None, None, S, S, device="cuda", BLOCK_SIZE=blk)
        flex = torch.compile(flex_attention, dynamic=False)
        qh, kh, vh = (a.detach().transpose(1, 2).contiguous().requires_grad_() for a in x[:3])
        doh = x[3].transpose(1, 2).contiguous()
        t0 = time.perf_counter()
        out = flex(qh, kh, vh, block_mask=block_mask, scale=D ** -0.5, enable_gqa=True)
        grads = torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)
        torch.cuda.synchronize()
    except Exception as e:   # a refusal of the compiler or the kernel: the reason is the result
        return None, None, f"flex_attention: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    compile_s = time.perf_counter() - t0
    flat = lambda a: a.transpose(1, 2).reshape(1, B * S, a.shape[1], D).transpose(1, 2)
    check_library(torch, "wide blocksparse fwd", flat(out), truth[0], errs["o plain"])
    for name, g, r in zip(BWD_NAMES, grads, truth[1]):
        check_library(torch, f"wide blocksparse {name}", flat(g), r, errs[name + " plain"])
    with torch.no_grad():
        fms = cuda_ms(torch, lambda: flex(qh, kh, vh, block_mask=block_mask, scale=D ** -0.5,
                                          enable_gqa=True), iters=5)
    bms = cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                  iters=5)
    return fms, bms, f"flex_attention with the block mask, compiled in {compile_s:.1f} s"


def wide_packed_dropout_times(torch, card, inputs, do, seg, tight_rows, pairs, tokens):
    """(b)'s documents at D 512 with dropout (p DROPOUT_P; (a) checks the
    kernels' masks): each kernel's device ms, the calls', the plain twins'
    and SDPA's memory-efficient kernel with its own dropout. Returns
    {kernel: numbers}."""
    Hq, Hkv = WIDE_HEADS
    t = time_packed_kernels(torch, inputs, do, seg, None, dropout_p=DROPOUT_P,
                            dropout_seed=DROPOUT_SEED)
    tq, tk, tv, tdo = tight_rows
    fwd, _, lib_bwd = library_efficient(torch, tq, tk, tv, seg[1], tq.shape[-1] ** -0.5,
                                        dropout_p=DROPOUT_P)
    lib = ({"fwd": cuda_ms(torch, fwd), "bwd": cuda_ms(torch, lib_bwd(tdo), iters=5)}
           if fwd is not None else {"fwd": None, "bwd": None})
    out = {}
    for name, kernel, plain, lib_ms in (("varlen_fwd", "fwd", t["plain fwd"], lib["fwd"]),
                                        ("varlen_dq", "dq", t["plain bwd"], lib["bwd"]),
                                        ("varlen_dkdv", "dkdv", t["plain bwd"], lib["bwd"])):
        out[name] = {"ms": t[VARLEN_KERNEL_NAMES[name]], "plain_ms": plain, "library_ms": lib_ms,
                     **attn_bound(kernel, pairs, tokens, Hq, Hkv, 512, 2)}
    print(f"[wide varlen D 512] with dropout p {DROPOUT_P} [{card}]: " + ", ".join(
        f"{VARLEN_KERNEL_NAMES[n]} {e['ms']:.3f} ms" for n, e in out.items())
        + f"; whole calls forward {t['fwd call']:.3f} ms, backward {t['bwd call']:.3f} ms; plain "
          f"forward {t['plain fwd']:.3f} ms, backward {t['plain bwd']:.3f} ms; library "
        + (f"(SDPA memory-efficient, its own dropout) forward {lib['fwd']:.3f} ms, backward "
           f"{lib['bwd']:.3f} ms" if lib["fwd"] is not None else "none: it refused"))
    return out


def wide_packed_run(torch, card, D, kind):
    """(b) at head dim D, 8 / 2 heads, bf16, causal, blocks of 128: `kind`
    "varlen" (phase 8's documents through `flash_attn_varlen_func`) or
    "blocksparse" (phase 9's B 2 x S 4096 band + sink through
    `flash_attn_blocksparse_func`). The public forward + backward with the
    launch counts reset just before and read just after (one launch of each
    kernel), checked against the fp32 / bf16 plain twins, then timed: each
    kernel's device ms (profiler), the calls', the plain twins' and the
    library's (SDPA's memory-efficient kernel with cu_seqlens; flex_attention
    for block-sparse), and its bound. Returns (launches, entries)."""
    from fa2_triton_tpu_torch.ops import varlen

    dev = torch.device("cuda")
    Hq, Hkv = WIDE_HEADS
    blk = VARLEN_BLOCK
    gen = torch.Generator(device=dev).manual_seed(D + (22 if kind == "varlen" else 23))
    bf = lambda a: a.to(torch.bfloat16)
    if kind == "varlen":
        lens = varlen_docs()
        starts, T = packed_starts(lens, blk)
        keep, mask = None, None
        seg = (starts, lens)
        pairs, tokens = causal_pairs(lens), sum(lens)
    else:
        B, S = BS_BATCH, BS_SEQ
        T, mask = B * S, blocksparse_mask()
        keep = varlen._mask_keep_fn(varlen.encode_block_mask(mask))
        seg = ([b * S for b in range(B)], [S] * B)
        pairs = B * sum(blk * blk if j < i else blk * (blk + 1) // 2
                        for i in range(mask.shape[0]) for j in range(i + 1) if mask[i, j])
        tokens = T
    live = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, n in zip(*seg):
        live[s0:s0 + n] = True
    packed32 = [torch.randn(1, T, h, D, generator=gen, device=dev) * sd
                for h, sd in ((Hq, 0.5), (Hkv, 0.5), (Hkv, 0.5), (Hq, 1.0))]
    leaves = [bf(a).requires_grad_() for a in packed32[:3]]
    do = bf(packed32[3])
    what = f"wide {kind} D {D}"

    varlen.reset_launches()
    if kind == "varlen":
        out, lse = varlen.flash_attn_varlen_func(*leaves, starts + [T], seqlens=lens, causal=True,
                                                 block_q=blk, block_kv=blk, return_lse=True)
        out.backward(do)
    else:
        split = lambda a: a.view(B, S, *a.shape[2:])
        out, lse = varlen.flash_attn_blocksparse_func(*(split(a) for a in leaves), mask,
                                                      causal=True, block_q=blk, block_kv=blk,
                                                      return_lse=True)
        out.backward(split(do))
        out = out.reshape(1, T, Hq, D)
        lse = lse.transpose(0, 1).reshape(1, Hq, T)
    torch.cuda.synchronize()
    launches = dict(varlen.LAUNCHES)
    print(f"[{what}] {len(seg[1])} segments, {tokens} tokens in T = {T}, {Hq} / {Hkv} heads of "
          f"{D}, bf16, causal, blocks of {blk}; public forward + backward: launches {launches}")
    if launches != {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkdv": 1}:
        raise AssertionError(f"{what}: the path did not launch each packed kernel once")
    inputs = [a.detach() for a in leaves]
    errs, o32, refs = check_packed_path(torch, what, inputs, [a.grad for a in leaves], out, lse,
                                        packed32[3], packed32[:3], seg, keep, live)
    del out, lse, leaves
    t = time_packed_kernels(torch, inputs, do, seg, keep)

    scale = D ** -0.5
    if kind == "varlen":
        rows = lambda a: a[0][live][None]                      # [1, sum(lens), H, D]
        g = Hq // Hkv
        tq, tdo = rows(inputs[0]), rows(do)
        tk, tv = (rows(a).repeat_interleave(g, 2).contiguous() for a in inputs[1:])
        fwd, lib_out, lib_bwd = library_efficient(torch, tq, tk, tv, lens, scale)
        if fwd is None:
            lib, how = {"fwd": None, "bwd": None}, lib_out
        else:
            live_rows = lambda a: a.transpose(1, 2)[0][live]  # [1, H, T, D] -> [sum, H, D]
            check_library(torch, f"{what} library fwd", lib_out[0], live_rows(o32),
                          errs["o plain"])
            run = lib_bwd(tdo)
            dq_l, dk_l, dv_l = run()[:3]
            for name, gr, r in (("dq", dq_l[0], refs[0]),
                                ("dk", dk_l[0].view(-1, Hkv, g, D).sum(2), refs[1]),
                                ("dv", dv_l[0].view(-1, Hkv, g, D).sum(2), refs[2])):
                check_library(torch, f"{what} library {name}", gr, live_rows(r),
                              errs[name + " plain"])
            lib = {"fwd": cuda_ms(torch, fwd), "bwd": cuda_ms(torch, run, iters=5)}
            how = "SDPA memory-efficient (aten._efficient_attention_forward / _backward, cu_seqlens)"
        if D == 512:
            drop = wide_packed_dropout_times(torch, card, inputs, do, seg, (tq, tk, tv, tdo),
                                             pairs, tokens)
        del tq, tk, tv, tdo
    else:
        def mask_mod(b, h, qi, ki):
            return (ki <= qi) & ((qi // blk - ki // blk <= BS_BAND) | (ki < blk))
        split = lambda a: a.view(B, S, *a.shape[2:])
        fms, bms, how = flex_blocksparse(torch, [split(a) for a in (*inputs, do)], mask_mod, S,
                                         blk, D, (o32, refs), errs)
        lib = {"fwd": fms, "bwd": bms}
    del o32, refs
    out = varlen_entries(t, errs, lib, pairs, tokens, Hq, Hkv, D)
    for name, e in out.items():
        e["library"] = how if lib["fwd"] is not None else f"none: {how}"
        if kind == "varlen" and D == 512:
            e["dropout"] = drop[name]
    print(f"[{what}] bf16 kernels (profiler) [{card}]: " + ", ".join(
        f"{e['kernel']} {e['ms']:.3f} ms (bound {e['bound_ms']:.4f} ms, {e['bound_by']}: "
        f"{100 * e['bound_share']:.1f} % of it)" for e in out.values())
        + f"; whole calls (CUDA events): forward {t['fwd call']:.3f} ms, backward "
          f"{t['bwd call']:.3f} ms; plain forward {t['plain fwd']:.3f} ms, backward "
          f"{t['plain bwd']:.3f} ms; library "
        + (f"({how}) forward {lib['fwd']:.3f} ms, backward {lib['bwd']:.3f} ms"
           if lib["fwd"] is not None else f"none: {how}"))
    return launches, out


def phase_wide_packed(torch, card):
    """Phase 22 ((a), (b) above)."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        checks, worst = wide_packed_checks(torch)
    launches, times = {}, {}
    for D in WIDE_DIMS:
        launches[D], times[D] = wide_packed_run(torch, card, D, "varlen")
        gc.collect()
        torch.cuda.empty_cache()
    bs_launches, times["blocksparse"] = wide_packed_run(torch, card, 512, "blocksparse")
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"[wide packed] phase 22 in {seconds:.1f} s")
    return {"checks": checks, "launches": launches, "launches_blocksparse_512": bs_launches,
            "worst": worst, "times": times, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 23 (head dims past 512): the forward on every route, the dq + dk/dv
# pair and decode at any multiple of 128, on csrc/any_tiles.cuh's column
# split (flash_fwd_any.cu, flash_bwd_any.cu, decode_any.cuh):
# (a) each family at D 640 and 1024 against its plain twin (phase 20's
#     checks: every forward route, the split with leaves of 512, dropout,
#     bias, softcap, window; the pair with dropout and EXTRA, fp32 FMA;
#     decode bf16 / fp16 / fp32 / int8 / fp8, paged bf16 / int8 equal to
#     contiguous), launches counted; the column chunks' lse equal bit for
#     bit, and 5-run bitwise repeats (`wider_repeats`);
# (b) the times at B 2 x S 2048, causal, bf16, 4 / 1 heads of 1024, and
#     decode over 8 slots x 4096 rows: kernel (profiler), bound, plain and
#     library (SDPA's memory-efficient backend, or why it refused);
# (c) Mistral-7B-v0.3's widths with the attention cut into 4 / 1 heads of
#     1024 (Hq x D = 4096 and Hkv x D = 1024, the preset's, so wq / wk / wv
#     / wo keep their shapes and a token's attention FLOPs and KV bytes),
#     full depth, random weights: served contiguous bf16 and paged int8
#     (phase 3's log-prob check), the 2-layer gradients against fp32, and
#     trainer steps at 2 x 2048 (forward generic, backward the pair);
# and the build report of every instantiation past 512 (`any_build_report`):
# 0 spills, HMMA in every 16-bit one.

WIDER_DIMS = (640, 1024)
WIDER_HEADS = (4, 1)
WIDER_SPLIT_LEAF = 512           # (a): the split's default leaf is 0 past D 512
WIDER_OVER = dict(n_heads=4, n_kv_heads=1, head_dim=1024)
SERVE_MODES.update({"serve wider": {}, "serve wider paged int8": {"paged": True,
                                                                  "qdtype": "int8"}})
# The instantiations past D 512: the forward (bf16 / fp16 x dropout x (plain,
# bias / softcap, merge)), dq and dk/dv (x dropout x EXTRA), their fp32 FMA
# kernels, and decode (3 q dtypes x 3 caches x 2 layouts x 4 groups).
ANY_KERNELS = {"fwd_any_mma_kernel": 12, "dq_any_mma_kernel": 8, "dkdv_any_mma_kernel": 8,
               "fwd_any_fma_kernel": 4, "dq_any_fma_kernel": 2, "dkdv_any_fma_kernel": 2,
               "decode_any_kernel": 72}


def any_build_report() -> dict:
    """Registers and spills of every instantiation past D 512 from nvcc
    -Xptxas -v's report, and the HMMA count of the tensor-core ones in the
    SASS; fails on any spill, on another count, or on a tensor-core kernel
    without HMMA. Returns {kernel: summary}."""
    from fa2_triton_tpu_torch.ops import _build

    regs, spills, cur, prop = {}, {}, None, None
    for line in (_build.ptxas_report or "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = m[1] if "_any_" in m[1] else None
        elif m := re.search(r"Function properties for (\S+)", line):
            prop = m[1] if "_any_" in m[1] else None
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and prop:
            spills[prop] = int(m[1]) + int(m[2])
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            regs[cur] = int(m[1])
    hmma = sass_hmma(_build.build())
    out = {}
    for kernel, want in ANY_KERNELS.items():
        names = [n for n in regs if re.search(r"\d" + kernel + "I", n)]
        spilled = {n: spills[n] for n in names if spills.get(n)}
        no_mma = [n for n in names if "_mma_" in kernel and not hmma.get(n)]
        out[kernel] = {"instantiations": len(names),
                       "registers": [min((regs[n] for n in names), default=0),
                                     max((regs[n] for n in names), default=0)],
                       "spilled": len(spilled),
                       "hmma_min": min((hmma.get(n, 0) for n in names), default=0)}
        print(f"[any build] {kernel}: {len(names)} instantiations, "
              f"{out[kernel]['registers'][0]}-{out[kernel]['registers'][1]} registers, "
              f"{len(spilled)} spill" + (f", at least {out[kernel]['hmma_min']} HMMA in the SASS"
                                         if "_mma_" in kernel else ""))
        if len(names) != want or spilled or no_mma:
            raise AssertionError(f"{kernel}: {len(names)} instantiations (not {want}), spills "
                                 f"{spilled}, without HMMA {no_mma[:2]}")
    return out


def wider_repeats(torch):
    """(a): at D 1024, bf16, 4 / 1 heads, S 1024: every column chunk of the
    forward computes the call's lse bit for bit (`chunk_lse`), and 5 runs
    each of the forward with dropout, the forced split (its merges read the
    previous lse from a copy while the chunks write the new one), the pair
    with dropout and decode give identical outputs."""
    from fa2_triton_tpu_torch.ops import decode, flash_bwd, flash_fwd

    D, S, (Hq, Hkv) = WIDER_OVER["head_dim"], WIDE_CHECK_SEQ, WIDER_HEADS
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = ((torch.randn(1, h, S, D, generator=gen, device="cuda") * 0.5)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    lens = torch.tensor([[S, S]], dtype=torch.int32, device="cuda")
    kw = dict(causal=True, softmax_scale=D ** -0.5)
    drop = dict(dropout_p=0.1, dropout_seed=D)
    _, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw, **drop)
    _, per_chunk = flash_fwd._flash_fwd_launch(q, k, v, lens, 0, 0, None, window=(-1, -1),
                                               softcap=0.0, seqlen_q_real=None,
                                               seqlen_k_real=None, chunk_lse=True, **kw, **drop)
    if not all(torch.equal(c.view(torch.int32), lse.view(torch.int32)) for c in per_chunk):
        raise AssertionError(f"D {D}: the column chunks' lse differ")
    o, lse = flash_fwd.flash_attn_forward(q, k, v, lens, **kw, **drop)
    qd = q[0, :, -1].contiguous()[None].expand(8, Hq, D).contiguous()
    kc, vc = (x.expand(8, Hkv, S, D).contiguous() for x in (k, v))
    kv_lens = torch.tensor([1, 100, 511, 512, 513, 700, 1000, 1024], dtype=torch.int32,
                           device="cuda")
    runs = {"forward dropout": lambda: flash_fwd.flash_attn_forward(q, k, v, lens, **kw, **drop),
            "forced split": lambda: flash_fwd.flash_attn_forward(
                q, k, v, lens, static_skip=True, route="split", split_leaf=WIDER_SPLIT_LEAF,
                **kw),
            "pair dropout": lambda: flash_bwd.flash_attn_backward(q, k, v, do, o, lse, lens, **kw,
                                                                  **drop),
            "decode": lambda: (decode.decode_attention(qd, kc, vc, kv_lens),)}
    for name, run in runs.items():
        first = run()
        for _ in range(4):
            if not all(torch.equal(a, b) for a, b in zip(run(), first)):
                raise AssertionError(f"D {D} {name}: 5 runs differ")
    print(f"[wider kernels] D {D}: the {per_chunk.shape[0]} column chunks' lse equal bit for bit; "
          f"5 runs each of {', '.join(runs)} identical")


def phase_wider(torch, card):
    """Phase 23: head dims past 512 ((a)-(c) above)."""
    t0 = time.perf_counter()
    build = any_build_report()
    os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"   # the prior's routes, as phases 1-16
    try:
        with torch.inference_mode():
            launches, worst = wide_kernel_checks(torch, WIDER_DIMS, WIDER_HEADS,
                                                 WIDER_SPLIT_LEAF, tag="wider")
            wider_repeats(torch)
        times = wide_times(torch, card, (WIDER_OVER["head_dim"],), WIDER_HEADS, WIDER_NAMES,
                           tag="wider")
        gc.collect()
        torch.cuda.empty_cache()
        model = wide_model(torch, card, WIDER_OVER, tag="wider")
    finally:
        os.environ.pop("FA2_DISABLE_TUNING_TABLE", None)
    seconds = time.perf_counter() - t0
    print(f"[wider] phase 23 in {seconds:.1f} s")
    return {"build": build, "launches": launches, "worst": worst, "times": times,
            "model": model, "seconds": seconds}


def main() -> int:
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(what):
        """Prints the seconds since the last lap and since the start, so a
        later phase can choose which earlier one to cut."""
        now = time.perf_counter()
        print(f"[time] {what}: {now - t_lap[0]:.1f} s, {now - t_start:.1f} s in all", flush=True)
        t_lap[0] = now

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import fa2_triton_tpu_torch  # noqa: F401  (raises beside a lone chip_smoke.py)

    if not os.path.abspath(fa2_triton_tpu_torch.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"fa2_triton_tpu_torch imported from {fa2_triton_tpu_torch.__file__}, "
                           f"not from this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    # Phases 1-16 assert the prior's routes (JAX's gates); phase 17 runs the
    # card's tuning table against them.
    os.environ["FA2_DISABLE_TUNING_TABLE"] = "1"
    print("phases 1-16: FA2_DISABLE_TUNING_TABLE=1 (the prior's routes); phase 17: the table")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card)

    phase_build()
    from fa2_triton_tpu_torch.ops import _build
    start_sass(_build.build())   # read by the reports before phase 8, while the card works
    lap('build')
    with torch.inference_mode():
        kernels = phase_kernels(torch)
        lap('phase 1 (kernels)')
        torch.cuda.empty_cache()
        model, cfg, reqs, prompts, launches = phase_serve(torch, card)
        phase_check(torch, model, cfg, reqs, prompts)
        lap('phases 2-3 (serve, check)')
        torch.cuda.empty_cache()
        served = phase_serve_modes(torch, card, model, cfg, reqs, prompts)
        lap('phase 4 (serve modes)')
        torch.cuda.empty_cache()
        chunked = phase_chunked(torch, card, model, cfg, prompts)
        lap('phase 13 (chunked, prefix)')
        torch.cuda.empty_cache()
        spec = phase_speculative(torch, card, model, cfg, prompts)
        lap('phase 14 (speculative)')
        torch.cuda.empty_cache()
        wquant = wquant_serve(torch, card, model, cfg, prompts)
        lap('phase 15 (e) (weight-quantized serving)')
    del model, reqs  # the served model and its cache make way for training
    gc.collect()
    torch.cuda.empty_cache()
    zoo = phase_zoo(torch, card)
    lap('phase 15 (model zoo)')
    gpt2_run = phase_gpt2(torch, card)
    lap('phase 14 (d) (GPT-2)')
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(phase_bwd_kernels(torch))
    lap('phase 5 (backward kernels)')
    torch.cuda.empty_cache()
    bias_launches, kernels["flash_bwd_dbias"] = phase_bias(torch)
    lap('phase 6 (bias)')
    torch.cuda.empty_cache()
    phase_train_grads(torch)
    lap('phase 7 (gradients)')
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, card)
    lap('phase 7 (trainer)')
    mma = mma_build_report()
    decode_build = decode_build_report()
    kernels["flash_fwd"]["build"] = mma["flash_fwd_mma_kernel"]
    lap('build reports (cuobjdump since the build)')
    gc.collect()
    torch.cuda.empty_cache()
    varlen_launches, varlen_kernels = phase_varlen(torch, card)
    lap('phase 8 (varlen)')
    for name in VARLEN_KERNEL_NAMES:
        varlen_kernels[name]["build"] = mma[VARLEN_KERNEL_NAMES[name]]
    torch.cuda.empty_cache()
    bs_launches, bs_kernels = phase_blocksparse(torch)
    lap('phase 9 (block-sparse)')
    gc.collect()
    torch.cuda.empty_cache()
    dropout_runs, dropout_kernels = phase_dropout(torch, card)
    lap('phase 10 (dropout)')
    gc.collect()
    torch.cuda.empty_cache()
    sched_runs, sched_kernels = phase_schedules(torch, card)
    lap('phase 11 (forward schedules)')
    gc.collect()
    torch.cuda.empty_cache()
    bwd_runs, bwd_kernels = phase_causal_bwd(torch, card, mma)
    lap('phase 12 (backward schedules)')
    gc.collect()
    torch.cuda.empty_cache()
    extras = phase_extras(torch, card)
    lap('phase 16 (extras)')
    gc.collect()
    torch.cuda.empty_cache()
    routing = phase_routing(torch, card)
    lap('phase 17 (routing)')
    gc.collect()
    torch.cuda.empty_cache()
    parallel = phase_parallel(torch, card)
    lap('phase 18 (parallel)')
    gc.collect()
    torch.cuda.empty_cache()
    parallel_train = phase_parallel_train(torch, card)
    lap('phase 19 (parallel training)')
    gc.collect()
    torch.cuda.empty_cache()
    wide = phase_wide(torch, card)
    lap('phase 20 (wide)')
    gc.collect()
    torch.cuda.empty_cache()
    sched_wide = phase_wide_schedules(torch, card)
    lap('phase 21 (wide schedules)')
    gc.collect()
    torch.cuda.empty_cache()
    wide_packed = phase_wide_packed(torch, card)
    lap('phase 22 (wide packed)')
    gc.collect()
    torch.cuda.empty_cache()
    wider = phase_wider(torch, card)
    lap('phase 23 (wider)')

    if any(name == "jax" or name.startswith(("jax.", "fa2_triton_tpu.")) for name in sys.modules):
        raise RuntimeError("the port imported jax or the JAX package")
    table = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_fwd.py:56",
         "also_replaces": "fa2_triton_tpu/ops/flash_fwd.py:454",
         "launches": launches["flash_fwd"], "launches_train": train_launches["flash_fwd"],
         "launches_bias_path": bias_launches["flash_fwd"],
         "launches_chunked": chunked["chunked"]["flash_fwd"],
         "launches_prefix": chunked["prefix"]["flash_fwd"], **kernels["flash_fwd"],
         "chunk_call": chunked["chunk"],
         "serve_chunked": {k: chunked[k] for k in ("steps", "draws", "prefix_cached_tokens")},
         "launches_speculative": sum(spec["full"][d]["launches"]
                                     for d in ("2-layer draft", "perfect draft")),
         "launches_speculative_sampled": spec["sampled"]["launches"],
         "launches_gpt2_train": gpt2_run["launches"]["flash_fwd"],
         "launches_gpt2_cached": gpt2_run["cached_launches"],
         "spec_verify_call": spec["full"]["verify_call"],
         "speculative": {"exact": spec["exact"], "sampled": spec["sampled"],
                         **{k: v for k, v in spec["full"].items() if k != "verify_call"}},
         "gpt2": {k: gpt2_run[k] for k in ("routes", "losses", "step_ms", "peak_gib",
                                           "grads_worst", "cache_err", "decode_ms")},
         "gpt2_forward_d64": gpt2_run["attention"]["forward"],
         "launches_moe_train": zoo["moe_train"]["launches"]["flash_fwd"],
         "launches_moe_serve": zoo["moe_serve"]["launches"]["flash_fwd"],
         "launches_lora": zoo["lora"]["launches"]["flash_fwd"]
         + zoo["lora"]["serve_launches"]["flash_fwd"],
         "launches_wquant": sum(wquant[q]["launches"]["flash_fwd"] for q in ("int8", "fp8")),
         "launches_resume": extras["resume"]["launches"]["flash_fwd"],
         "launches_eval": extras["eval"]["launches"]["flash_fwd"],
         "launches_demo": extras["demo"]["launches"]["flash_fwd"],
         "runtime_extras": {
             "resume": {k: v for k, v in extras["resume"].items() if k != "launches"},
             "eval_nll": extras["eval"]["nll"], "probes": extras["probes"],
             "demo_tokens_per_s": extras["demo"]["tokens_per_s"], "seconds": extras["seconds"]},
         "routing": routing,
         "model_zoo": {
             "moe_train": {k: zoo["moe_train"][k] for k in (
                 "losses", "step_s", "tokens_per_s", "peak_gib", "free_gib", "capacity",
                 "dropped", "tokens_dropped")},
             "moe_block": zoo["moe_block"],
             "moe_serve": {k: v for k, v in zoo["moe_serve"].items() if k != "launches"},
             "lora": {k: zoo["lora"][k] for k in ("losses", "step_s", "peak_gib", "differ",
                                                  "lp_mean")},
             "wquant": {q: {k: v for k, v in r.items() if k != "launches"} if isinstance(r, dict)
                        else r for q, r in wquant.items()}}},
        {"name": "decode", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/decode.cuh",
         "replaces": "fa2_triton_tpu/ops/decode.py:158",
         "launches": launches["decode"], "launches_chunked": chunked["chunked"]["decode"],
         "launches_lora": zoo["lora"]["serve_launches"]["decode"],
         "launches_demo": extras["demo"]["launches"]["decode"],
         **kernels["decode"], "build": decode_build},
        {"name": "decode_quant", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/decode.cuh",
         "replaces": "fa2_triton_tpu/ops/decode.py:74",
         "launches": sum(n for run in served.values() for v, n in run.items() if "contiguous" in v),
         "launches_by_run": {r: v for r, v in served.items() if r.startswith("contiguous")},
         **kernels["decode_quant"]},
        {"name": "paged_decode", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/decode.cuh",
         "replaces": "fa2_triton_tpu/ops/decode.py:273",
         "also_replaces": "fa2_triton_tpu/ops/decode.py:280",
         "launches": sum(n for run in served.values() for v, n in run.items() if "paged" in v),
         "launches_by_run": {r: v for r, v in served.items() if r.startswith("paged")},
         "launches_prefix": chunked["prefix"]["decode"],
         "launches_moe_serve": zoo["moe_serve"]["launches"]["decode"],
         "launches_wquant": sum(wquant[q]["launches"]["decode"] for q in ("int8", "fp8")),
         **kernels["paged_decode"]},
        {"name": "flash_bwd_dq", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_bwd.py:159",
         "also_replaces": "fa2_triton_tpu/ops/flash_bwd.py:602 (B12), fa2_triton_tpu/ops/flash_bwd.py:376 (B2)",
         "launches": train_launches["flash_bwd_dq"],
         "launches_moe_train": zoo["moe_train"]["launches"]["flash_bwd_dq"],
         "launches_lora": zoo["lora"]["launches"]["flash_bwd_dq"],
         "launches_resume": extras["resume"]["launches"]["flash_bwd_dq"],
         "launches_eval": extras["eval"]["launches"]["flash_bwd_dq"], **kernels["flash_bwd_dq"]},
        {"name": "flash_bwd_dkdv", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_bwd.py:263",
         "also_replaces": "fa2_triton_tpu/ops/flash_bwd.py:602 (B12), fa2_triton_tpu/ops/flash_bwd.py:376 (B2)",
         "launches": train_launches["flash_bwd_dkdv"],
         "launches_moe_train": zoo["moe_train"]["launches"]["flash_bwd_dkdv"],
         "launches_lora": zoo["lora"]["launches"]["flash_bwd_dkdv"],
         "launches_resume": extras["resume"]["launches"]["flash_bwd_dkdv"],
         "launches_eval": extras["eval"]["launches"]["flash_bwd_dkdv"], **kernels["flash_bwd_dkdv"]},
        {"name": "flash_bwd_dbias", "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "fa2_triton_tpu/ops/flash_bwd.py:1357",
         "launches": bias_launches["flash_bwd_dbias"], **kernels["flash_bwd_dbias"],
         "dropout": dropout_kernels["flash_bwd_dbias_dropout"], "build": mma["dbias_mma_kernel"]},
    ]}
    for name, line in (("varlen_fwd", 233), ("varlen_dq", 385), ("varlen_dkdv", 454)):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": "fa2_triton_tpu_torch/csrc/varlen.cu",
            "replaces": f"fa2_triton_tpu/ops/varlen.py:{line}",
            "launches": varlen_launches[name], "launches_blocksparse": bs_launches[name],
            **varlen_kernels[name],
            "blocksparse": {k: bs_kernels[name][k] for k in
                            ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}})
    layer, dense = dropout_runs["layer"], dropout_runs["flash_attn_func"]
    for name, source, replaces, key in (
            ("flash_fwd_dropout", "flash_fwd.cu", "flash_fwd.py:56", "flash_fwd"),
            ("flash_bwd_dropout_dq", "flash_bwd.cu", "flash_bwd.py:159", "flash_bwd_dq"),
            ("flash_bwd_dropout_dkdv", "flash_bwd.cu", "flash_bwd.py:263", "flash_bwd_dkdv")):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"fa2_triton_tpu_torch/csrc/{source}",
            "replaces": f"fa2_triton_tpu/ops/{replaces}",
            "also_replaces": ("fa2_triton_tpu/ops/flash_fwd.py:454 (B9, dropout l.546-554)"
                              if key == "flash_fwd" else
                              "fa2_triton_tpu/ops/flash_bwd.py:45 (_recompute_p_and_ds, dropout "
                              "l.133-156, in B2 / B3 / B12)"),
            "launches": layer[key], "launches_flash_attn_func": dense[key],
            "launches_bias_path": dropout_runs["bias path"][key], **dropout_kernels[name]})
    for name, line in (("varlen_fwd", 233), ("varlen_dq", 385), ("varlen_dkdv", 454)):
        table["kernels"].append({
            "name": f"{name}_dropout", "route": "cuda",
            "source": "fa2_triton_tpu_torch/csrc/varlen.cu",
            "replaces": f"fa2_triton_tpu/ops/varlen.py:{line}",
            "also_replaces": "fa2_triton_tpu/ops/varlen.py:214 (_packed_dropout_bits)",
            "launches": dropout_runs["varlen"][name], **dropout_kernels[f"{name}_dropout"]})
    for name, source, replaces, also, launches, extra in (
            ("flash_fwd_causal_strip", "flash_fwd.cu", "flash_fwd.py:640",
             "fa2_triton_tpu/ops/flash_fwd.py:779 (flash_attn_forward_causal_strip)",
             sched_runs[f"flash_attn_func {STRIP_SEQ} / {STRIP_SEQ}"]["causal_strip"],
             {"launches_shifted_2048_4096":
              sched_runs[f"flash_attn_func {SHIFT_SQ} / {SHIFT_SK}"]["causal_strip"]}),
            ("flash_fwd_causal_diag", "flash_fwd.cu", "flash_fwd.py:454",
             "diag_stride / leaf_subs mode of fa2_triton_tpu/ops/flash_fwd.py:969 "
             "(flash_attn_forward_causal_diag)", sched_runs["train"]["causal_diag"],
             {"launches_flash_attn_func": sched_runs["flash_attn_func S 4096"]["causal_diag"]}),
            ("flash_fwd_rect", "flash_fwd.cu", "flash_fwd.py:1041",
             "fa2_triton_tpu/ops/flash_fwd.py:434 (_fwd_kernel_nobias on a rectangle)",
             sched_runs["flash_attn_forward_rect"]["rect"], {}),
            ("flash_fwd_rect_merge", "flash_fwd.cu", "flash_fwd.py:447",
             "fa2_triton_tpu/ops/flash_fwd.py:367-381 (the merge finaliser), driven by "
             "_causal_split_forward l.1165", sched_runs["train"]["rect_merge"],
             {"launches_flash_attn_func": sched_runs["flash_attn_func S 4096"]["rect_merge"]})):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"fa2_triton_tpu_torch/csrc/{source}",
            "replaces": f"fa2_triton_tpu/ops/{replaces}", "also_replaces": also,
            "launches": launches, **extra, **sched_kernels[name]})
    train_runs = bwd_runs["train"]
    long_run = next(r for name, r in train_runs.items() if name.startswith("1 x"))
    for name, source, replaces, also, launches, extra in (
            ("flash_bwd_tri_square", "flash_bwd_tri.cu", "flash_bwd.py:845",
             "fa2_triton_tpu/ops/flash_bwd.py:985 (flash_attn_backward_tri_square)",
             train_runs["2 x 2048"]["bwd_tri_square"],
             {"launches_flash_attn_backward": bwd_runs["tri_square"]["bwd_tri_square"],
              "launches_gpt2_train": gpt2_run["launches"]["bwd_tri_square"],
              "gpt2_d64": gpt2_run["attention"]["backward"]}),
            ("flash_bwd_causal_diag", "flash_bwd_tri.cu", "flash_bwd.py:1060",
             "the diag_stride / leaf_subs mode of fa2_triton_tpu/ops/flash_bwd.py:845, driven by "
             "_causal_split_backward l.1278", bwd_runs["split"]["bwd_causal_diag"], {}),
            ("flash_bwd_rect", "flash_bwd.cu", "flash_bwd.py:1138",
             "fa2_triton_tpu/ops/flash_bwd.py:376 (_bwd_fused_kernel on a rectangle), driven by "
             "_causal_split_backward l.1278", bwd_runs["split"]["bwd_rect"], {}),
            ("flash_bwd_worklist", "flash_bwd_wl.cu", "flash_bwd.py:1849",
             "fa2_triton_tpu/ops/flash_bwd.py:1986 (flash_attn_backward_fused_wl), schedule "
             "build_causal_bwd_worklist l.1779", long_run["bwd_worklist"],
             {"launches_flash_attn_backward": bwd_runs["worklist"]["bwd_worklist"],
              "train_shape": next(n for n in train_runs if n.startswith("1 x"))})):
        table["kernels"].append({
            "name": name, "route": "cuda", "source": f"fa2_triton_tpu_torch/csrc/{source}",
            "replaces": f"fa2_triton_tpu/ops/{replaces}", "also_replaces": also,
            "launches": launches, **extra, **bwd_kernels[name]})
    # Phase 18's launches, summed over its ranks, under the entries of the
    # kernels they ran.
    par_entry = {"flash_fwd": "flash_fwd", "causal_strip": "flash_fwd_causal_strip",
                 "causal_diag": "flash_fwd_causal_diag", "rect": "flash_fwd_rect",
                 "rect_merge": "flash_fwd_rect_merge", "flash_bwd_dq": "flash_bwd_dq",
                 "flash_bwd_dkdv": "flash_bwd_dkdv", "bwd_tri_square": "flash_bwd_tri_square",
                 "bwd_causal_diag": "flash_bwd_causal_diag", "bwd_rect": "flash_bwd_rect",
                 "bwd_worklist": "flash_bwd_worklist", "decode": "decode",
                 "paged_decode": "paged_decode", "decode_quant": "decode_quant"}
    by_name = {e["name"]: e for e in table["kernels"]}
    for e in table["kernels"]:
        e["launches_parallel"] = 0
        e["launches_parallel_train"] = 0
    for (counter, drop), n in parallel["launches"].items():
        name = par_entry[counter]
        if drop and f"{name}_dropout" in by_name:
            name = f"{name}_dropout"
        elif drop and name.startswith("flash_bwd_d") and f"flash_bwd_dropout_{name[10:]}" in by_name:
            name = f"flash_bwd_dropout_{name[10:]}"
        by_name[name]["launches_parallel"] += n
    by_name["flash_fwd"]["parallel"] = {k: parallel[k] for k in ("cases", "serving", "seconds")}
    # Phase 19's launches, summed over its ranks and cases.
    for counter, n in parallel_train["launches"].items():
        by_name[par_entry[counter]]["launches_parallel_train"] += n
    by_name["flash_fwd"]["parallel_train"] = {
        k: parallel_train[k] for k in ("train", "pipelines", "ep", "seconds", "ab_world_s")}
    by_name["flash_fwd"]["parallel_train"]["dryrun"] = {
        k: v for k, v in parallel_train["dryrun"].items() if k != "line"}
    # Phase 20: the head dims each kernel is built for, and its launches at
    # D 384 / 512 ((a)'s checks, (c)'s serving and training, (d)'s serving).
    wide_entries = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
                    "flash_bwd_dkdv": "flash_bwd_dkdv", "decode": "decode"}
    wide_built = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "decode", "decode_quant",
                  "paged_decode", "flash_fwd_dropout", "flash_bwd_dropout_dq",
                  "flash_bwd_dropout_dkdv", "flash_fwd_causal_strip", "flash_fwd_causal_diag",
                  "flash_fwd_rect", "flash_fwd_rect_merge", "flash_bwd_rect", "flash_bwd_dbias",
                  "flash_bwd_tri_square", "flash_bwd_causal_diag", "flash_bwd_worklist",
                  *VARLEN_KERNEL_NAMES, *(f"{n}_dropout" for n in VARLEN_KERNEL_NAMES))
    for e in table["kernels"]:
        e["head_dims"] = [64, 128, 256] + (list(WIDE_DIMS) if e["name"] in wide_built else [])
    for name, counter in wide_entries.items():
        for D in WIDE_DIMS:
            by_name[name][f"launches_wide_{D}"] = wide["launches"][D][counter]
    serve_wide, serve_phi3 = wide["model"]["serve wide"], wide["phi3"]["serve phi3"]
    by_name["flash_fwd"]["launches_wide_serve"] = serve_wide["launches"]["flash_fwd"]
    by_name["flash_fwd"]["launches_phi3_serve"] = serve_phi3["launches"]["flash_fwd"]
    by_name["decode"]["launches_wide_serve"] = serve_wide["launches"]["decode"]
    by_name["decode"]["launches_phi3_serve"] = serve_phi3["launches"]["decode"]
    for name, what in (("paged_decode", "serve wide paged int8"),):
        by_name[name]["launches_wide_serve"] = wide["model"][what]["launches"]["decode"]
        by_name[name]["launches_phi3_serve"] = wide["phi3"]["serve phi3 paged int8"]["launches"][
            "decode"]
    for name, counter in (("flash_fwd", "flash_fwd"), ("flash_bwd_dq", "flash_bwd_dq"),
                          ("flash_bwd_dkdv", "flash_bwd_dkdv")):
        by_name[name]["launches_wide_train"] = wide["model"]["train"]["launches"][counter]
    by_name["flash_fwd"]["wide"] = {
        "times": {str(k): v for k, v in wide["times"].items()}, "worst_err": wide["worst"],
        "model": {k: {n: x for n, x in v.items() if n != "launches"}
                  for k, v in wide["model"].items()},
        "phi3": {k: {n: x for n, x in v.items() if n != "launches"}
                 for k, v in wide["phi3"].items()}, "seconds": wide["seconds"]}
    # Phase 21: the fused schedules' and dbias's launches at D 384 / 512 ((a)),
    # their times at 8 / 8 heads of 512 ((b)) and the Qwen-width trainer's
    # launches ((c)).
    for name, counter in (("flash_bwd_tri_square", "bwd_tri_square"),
                          ("flash_bwd_causal_diag", "bwd_causal_diag"),
                          ("flash_bwd_rect", "bwd_rect"), ("flash_bwd_worklist", "bwd_worklist"),
                          ("flash_bwd_dbias", "flash_bwd_dbias")):
        for D in WIDE_DIMS:
            by_name[name][f"launches_wide_{D}"] = sched_wide["launches"][D][counter]
        by_name[name]["launches_wide_train"] = sum(
            r["launches"].get(counter, 0) for r in sched_wide["train"].values())
    for name, key in (("flash_bwd_worklist", "worklist"), ("flash_bwd_tri_square", "tri_square"),
                      ("flash_bwd_dbias", "dbias"), ("flash_bwd_causal_diag", "causal_diag"),
                      ("flash_bwd_rect", "rect")):
        by_name[name]["wide_512"] = sched_wide["times"][key]
    # Phase 22: the packed kernels' launches at D 384 / 512 (the public
    # varlen path at (b)'s timed configuration; block-sparse at 512; (a)'s
    # checks) and (b)'s numbers.
    for name in VARLEN_KERNEL_NAMES:
        by_name[f"{name}_dropout"]["wide_512"] = wide_packed["times"][512][name].pop("dropout")
        for D in WIDE_DIMS:
            by_name[name][f"launches_wide_{D}"] = wide_packed["launches"][D][name]
            by_name[name][f"wide_{D}"] = wide_packed["times"][D][name]
        by_name[name]["launches_wide_blocksparse_512"] = wide_packed["launches_blocksparse_512"][
            name]
        by_name[name]["launches_wide_checks"] = sum(c[name] for c in wide_packed["checks"].values())
        by_name[name]["wide_blocksparse_512"] = wide_packed["times"]["blocksparse"][name]
    by_name["varlen_fwd"]["wide_packed"] = {"worst_err": wide_packed["worst"],
                                            "seconds": wide_packed["seconds"]}
    by_name["flash_bwd_tri_square"]["wide_schedules"] = {
        "worst_err": sched_wide["worst"], "train": {
            k: {n: x for n, x in v.items() if n != "launches"}
            for k, v in sched_wide["train"].items()}, "seconds": sched_wide["seconds"]}
    # Phase 23: past D 512 the ported families take any multiple of 128; their
    # launches at D 640 / 1024 ((a)), in (c)'s serving and training, and (b)'s
    # numbers at D 1024.
    wider_built = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv", "decode", "decode_quant",
                   "paged_decode", "flash_fwd_dropout", "flash_bwd_dropout_dq",
                   "flash_bwd_dropout_dkdv", "flash_fwd_causal_strip", "flash_fwd_causal_diag",
                   "flash_fwd_rect", "flash_fwd_rect_merge", "flash_bwd_rect")
    for e in table["kernels"]:
        if e["name"] in wider_built:
            e["head_dims"] = e["head_dims"] + ["any multiple of 128 past 512"]
    for name, counter in wide_entries.items():
        for D in WIDER_DIMS:
            by_name[name][f"launches_wider_{D}"] = wider["launches"][D][counter]
    serve_wider = wider["model"]["serve wider"]
    for name, counter in (("flash_fwd", "flash_fwd"), ("decode", "decode")):
        by_name[name]["launches_wider_serve"] = serve_wider["launches"][counter]
    by_name["paged_decode"]["launches_wider_serve"] = wider["model"]["serve wider paged int8"][
        "launches"]["decode"]
    for name, counter in (("flash_fwd", "flash_fwd"), ("flash_bwd_dq", "flash_bwd_dq"),
                          ("flash_bwd_dkdv", "flash_bwd_dkdv")):
        by_name[name]["launches_wider_train"] = wider["model"]["train"]["launches"][counter]
    t1024 = wider["times"][WIDER_OVER["head_dim"]]
    for name, key, plain, lib in (("flash_fwd", "fwd", "plain_fwd_ms", "library_fwd_ms"),
                                  ("flash_bwd_dq", "dq_any_mma_kernel", "plain_bwd_ms",
                                   "library_fwd_bwd_ms"),
                                  ("flash_bwd_dkdv", "dkdv_any_mma_kernel", "plain_bwd_ms",
                                   "library_fwd_bwd_ms")):
        by_name[name]["wider_1024"] = {"ms": t1024["ms"][key], "plain_ms": t1024[plain],
                                       "library_ms": t1024[lib], "library": t1024["library"],
                                       **t1024["bounds"][key]}
    by_name["decode"]["wider_1024"] = wider["times"]["decode"]
    by_name["flash_fwd"]["wider"] = {
        "build": wider["build"], "worst_err": wider["worst"], "route": t1024["route"],
        "calls_ms": {k: t1024["ms"][k] for k in ("fwd_call", "bwd_call")},
        "model": {k: {n: x for n, x in v.items() if n != "launches"}
                  for k, v in wider["model"].items()}, "seconds": wider["seconds"]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
