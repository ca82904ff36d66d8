#!/usr/bin/env python3
"""GPU smoke run of desco_tpu_torch, the PyTorch/CUDA port of desco_tpu.

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py [--seed 0]

It imports nothing of JAX or desco_tpu. Phases, each of which exits
nonzero on a failed check (no phase catches its own failure):

  1. environment: the card's name and power limit, torch/CUDA versions;
     build the three CUDA libraries (one nvcc per source, started
     together, sm_90a) and the native host library.
  2. kernels: K1 ``sorted_segment_sum`` (graph pooling), the
     gather-fused K1 ``gather_segment_sum`` and its backward
     ``gather_segment_sum_bwd`` (the gossip and query-tower aggregation),
     K2 ``fused_typed_transform_aggregate``, K3 ``typed_aggregate_bwd``
     (dx and dW of K2) and K4 ``segment_sum_vjp`` against their plain
     PyTorch versions on the card, on f32 and on bf16 rows (rtol 1e-5, atol
     1e-5 * max|ref|: both sides accumulate the same rows in f32, only
     the summation order differs, and K2 / K3 multiply on the tensor
     cores in split TF32, which keeps f32 accuracy, with bf16 operands
     exact in TF32; K3's and the gather-fused backward's bf16 dx are f32
     results rounded to bf16 and may differ by one bf16 step, rtol 2^-7;
     K4's bf16 result must be equal; two gather-fused backward runs must
     be bit-equal), on edge cases (odd widths, K = 1, tiles that N does
     not fill, tiles without a live edge, long runs, all padding, an
     empty stream; K1's narrow layout at K = 1-16, identity and gathered
     rows, f32 and bf16, with empty segments, negative and padding keys
     and segments of 4500 and 40 edges: bit for bit the CPU's sum in the
     layout's fixed fold order, two runs bit-equal; GAT's operand pairs,
     one K1 and one K4 launch, equal to the separate launches) and at the
     shapes of real
     packed batches of the
     phase-3 request and of the phase-6 training set (whose permutation
     derived on the card must equal ``pack_samples``' one); the four
     variants of the K5 probe against their plain versions on the bench
     edge stream (``full`` bit-equal to K1). Times: each function and
     each bare kernel in CUDA graphs (8 launches per graph,
     tools/segsum_inner_ablation.py), the gather-fused K1 also beside the
     ``index_select`` + K1 and K4 + ``index_add_`` composition it
     replaced, and the PyTorch yardstick for the same function the same
     way (one call for K1, K4 and the gather-fused K1, ``sparse.mm`` of
     the unit CSR adjacency or its transpose, the gather-fused K1 also at
     one column, the serving gossip batch's direction degrees; two for
     K2, ``sparse.mm``
     + ``matmul``, and three for K3), the wrapper and the
     plain version with CUDA events over 50 eager calls, and the least
     time the card could take for the same work (products counted at the
     rate of the unit that runs them).
  3. serving at full width: ``CountingService`` on release/r4 (SAGE SHMP,
     8 layers, hidden 64, 6 edge types, 29 queries; 2-layer gossip) over
     random graphs drawn like Syn_1827, made with numpy from ``--seed``
     (desco_tpu_torch/data/synthetic.py): a 16-graph
     warm-up, a 256-graph request (twice) and ``count_stream`` over 4x64
     graphs. Every launch counter is zeroed just before these requests
     and read just after: K2 must have run exactly 8 times per packed
     target batch, K1 once per target batch (the pooling), the
     gather-fused K1 1 + 2 x 29
     times per gossip batch and no backward kernel. Counts must be
     finite and >= 0, verified rows must
     equal a VF2 recount, and CUDA must match the port on the CPU
     (verify_budget=0; the request's first 64 graphs) within rtol 1e-3
     of each count (floored at 1).
     Then the same 256-graph request with ``serve_bf16``: K2 runs 8 times
     per target batch on bf16 rows, counts finite and >= 0, verified rows
     equal the recount, and the raw log2(count + 1) predictions (before
     clamp and verification) stay within BF16_LOG2_ATOL of the f32
     tower's, CUDA bf16 against CUDA f32 on every batch and CUDA bf16
     against CPU bf16 on the first two.
  4. daemon: ``python -m desco_tpu_torch.serve`` answers two JSON lines
     (started before phase 5, collected after it: the two run beside
     each other).
  5. gradients: ``train_loss`` and ``gossip_loss`` gradients through the
     kernels against the same on the CPU through the plain versions, same
     weights and batch, dropout 0: max error <= 1e-4 of each tensor's
     scale; the query tower runs the gather-fused K1 8 times forward and
     backward (its batch has no permutation: derived on the card), the
     gossip loss 1 + 4 x 29 times forward (the checkpoint recomputes
     each query) and 29 backward, K1 and K4 never. Same-seed
     reproducibility: whether two gossip train steps from the same
     weights and dropout seed give bit-equal gradients is printed, and
     the same for two neighborhood train steps; the gather-fused
     backward's own dx must be bit-equal over two runs.
  6. training at full width: a ``SynNp_320`` train set (= valid set) with
     exact VF2 ground truth, ten epochs of the neighborhood stage (paper
     config: batch 512, lr 1e-4; its epoch loss spikes now and then in
     the first epochs, so three are too few to show a fall every time)
     and forty of the gossip stage
     (batch 256, lr 1e-3, dropout 0.01: two steps per epoch; the summed
     loss wanders by a few percent from epoch to epoch and falls by as
     much only over tens of epochs) through ``train_neighborhood_stage``
     / ``train_gossip_stage``, on the compiled steps (the neighborhood
     train and eval steps and the gossip eval step replayed as CUDA
     graphs, utils/cuda_graphs.py; the gossip train step eager). Counters
     zeroed before, read after (a replay adds what its capture counted):
     K3 = 8 x neighborhood train steps, K2 = 8 x (train steps + val batches +
     predict batches), K1 and K4 > 0 in the neighborhood stage, the
     gather-fused K1 at its count in both stages (the query tower; in the
     gossip stage 1 + 4 x 29 per train step and 1 + 2 x 29 per val batch,
     29 backward per train step), K1 once and K4 never in the gossip
     stage; losses finite and falling.
     Then the neighborhood stage again with ``train_bf16``: K3 = 8 x train
     steps, all on bf16 rows; K2's bf16 launches = 8 x train steps and its
     f32 launches = 8 x val batches (validation runs the f32 tower); the
     saved checkpoint is f32; the loss is finite and has fallen.
  7. entry point: ``python -m desco_tpu_torch.main --train_neigh
     --train_gossip --test_gossip`` in a subprocess on a small SynNp set
     at paper width, started before phase 8 and collected after it (the
     two run beside each other); then ``CountingService`` serves one
     request from the two checkpoints it wrote.
  8. datasets and the release/r4 replay: ``load_data`` makes Syn_1827,
     Syn_1827_test and the five TU proxies without networkx, each equal
     to desco_tpu's (graph, node and edge counts and the fingerprint of
     ``data.datasets.fingerprint``, committed below), seconds printed;
     then in a fresh data root ``gen_dataset.main`` (truth and sample
     cache of Syn_1827_test_max40) and ``main.main --test_gossip`` with
     release/r4, both in this process: its six graphlet normed MSE
     figures (neighborhood and gossip, query sizes 3-5) within rtol 1e-2
     of desco_tpu's root main.py on the CPU for the same graphs, its
     per-graph truth equal to that run's and its per-graph counts (the
     neighborhood, gossip and final CSVs) within rtol 1e-3 of that run's
     plus one for the rounding of each graph's sum
     (tests/data/replay_r4_Syn_1827_test_max40.npz), and the counters,
     zeroed before the replay and read
     after it, at serving's counts for the same batches (K2 8 x target
     batches, K1 once per target batch, the gather-fused K1 1 + 2 x 29
     per gossip batch, no backward kernel) plus main's one query-tower
     embedding (8 gather-fused K1, one pooling K1).
  9. ablations, on phase 8's data: (a) K2' and K3' at T = 33 (their
     types in chunks) on a packed order-4 batch of Syn_1827_test_max15
     (graphs of at most 15 nodes: orbit typing is host Python; seconds
     per 1000 neighborhoods printed) and on a random 33-type stream at
     the serving batch's shape, f32 and bf16: against the plain versions
     at phase 2's tolerances, two runs bit-equal, CUDA-graph times, bound
     and yardstick as in phase 2; K1 at GAT's and PNA's use sites ([E,
     64] and [E, 1] rows over a target batch's N*T keys; at one column
     the function and its bare launch in turns), GAT's K1 pair (num and
     den) in turns with K1 on num's rows alone, K4 to [E, 64] in turns
     with GAT's K4 pair, against their plain versions (the pairs equal to
     the separate launches), timed; (b) GIN, GCN, GAT and PNA at the paper
     width (8 layers, hidden 64, 6 types, 29 queries) on the first two
     target batches of the replay set: a forward, counts within rtol
     1e-3 of the CPU (floored as in phase 3), and one train step,
     gradients within phase 5's bound; launches zeroed before and read
     after each, exactly as ``expected_conv_launches`` predicts (GIN /
     GCN: K2 8 per target batch and K3 8 per train step; GAT / PNA: no
     K2 or K3, K1 per PNA sum and pooling, one K1 pair per GAT layer,
     K4 or the K4 pair behind them; no one-column K1 or K4); two same-seed
     train steps bit-equal for GIN and GCN, printed for GAT and PNA; the
     same CUDA-vs-CPU and bit-equality checks for an order-4 (33-type)
     train step; (c) ``ablation_gnns --neigh_conv_type GIN`` and
     ``ablation_wo_canonical`` on the replay set (train = valid = test)
     and ``main --train_neigh --neigh_order 4`` on Syn_1827_test_max15,
     2 epochs each, in this process: finite normed MSE figures, the
     orbit-typing line, launches on the expected kernels.
 10. the rest of serving and the baselines: (a) labeled mode at the
     paper width (SAGE, 8 layers, hidden 64, 6 types) on
     Syn_1827_test_max15 with 2 labels drawn from the seed (one-hot
     ``node_feat``): the labeled truth of the 784 expanded queries and
     the featured samples, 2 epochs of ``train_neighborhood_stage`` from
     scratch, then ``CountingService`` on the checkpoint it wrote serves
     the labeled graphs: counts finite and >= 0, verified rows equal to
     the labeled truth, K2 8 times per target batch and K1 once
     (counters zeroed before, read after), CUDA against the CPU within
     rtol 1e-3 (floored as in phase 3), host seconds of truth, bounds
     and verification printed; (b) ensembles: ``[release/r4]`` equals
     release/r4 bit for bit, and release/r4 with phase 7's checkpoint
     (r4's config), without clamp and verification, equals the
     log2(count + 1)-space mean of the two single services (rtol 1e-6),
     K2 8 times per target batch per member; the guarded ensemble serves
     the request; (c) ``python -m desco_tpu_torch.serve --tcp`` in a
     subprocess with release/r4 answers one request over a localhost
     socket as ``CountingService.count`` does; (d) ``python -m
     desco_tpu_torch.baseline --baseline DIAMNET`` and ``LRP`` at their
     defaults, 2 epochs on the replay set, in this process: finite
     normed MSE, wall seconds, launches; a DIAMNet forward and one train
     step at full width (hidden 64, 3 GIN layers, 4 heads, memory 4) on
     two whole-graph batches: counts within rtol 1e-3 of the CPU,
     gradients within phase 5's bound, launches as ``DIAMNET_FWD`` /
     ``DIAMNET_STEP`` predict (K2 3 per graph-tower forward, K3 3 per
     train step), two same-seed steps bit-equal; K2' and K3' at one
     edge type, f32 and bf16, on the graph tower's batch and on a random
     one-type stream at the serving batch's shape, as in phase 9.
 11. bench and probe: ``python -m desco_tpu_torch.bench`` for float32
     and bfloat16 in subprocesses (one JSON line each, K2 = 8 launches
     per forward, 0 < sol_fraction <= 1.05), and one series of the K5
     probe (tools/segsum_inner_ablation.py) at K = 128 on the bench
     stream, every variant launched through its wrapper.
 13. the halo path (run before the record), 4 shards on the one card, on
     desco_tpu's large-graph recipe (a BA-style graph of 20,000 nodes,
     degree 4, seed 3): (c) ``count_large_graph`` with release/r4 and
     every guard: counts finite and >= 0, wall seconds of stage 1, the
     partition and the halo gossip, n_loc / N, launches (K2 8 per target
     batch, K1 once per target batch, the gather-fused K1 1 + 2 x 29 per
     halo aggregate's streams); (b) ``serve_gossip_counts`` at 4 shards
     against 1 (rtol 1e-4, floored at 1) and against the CPU (rtol 1e-3,
     floored at 1); (a) the halo SHMP core of r4's target tower on the
     graph's whole-graph typed sample against the packed
     ``apply_shmp_core`` on K2' (within 1e-3 of max|out|), and a GAT and
     a PNA tower at width 64 on a ``force_pull`` partition against their
     packed towers, forward (1e-3 of max|out|) and backward (finite,
     error printed), launches exactly as ``expected_halo_conv`` predicts
     (PNA's K1 sums and GAT's K1 pairs, K4 and its pair behind them);
     (d) the direction degrees of a partition
     with push pairs, computed once and kept on its shards (one
     gather-fused K1 per stream, none at the next call), the halo gossip
     loss on it against the packed ``gossip_loss`` (gradients within
     phase 5's 1e-4 of a tensor's scale), launches (the gather-fused K1
     forward and backward per stream, 2 x 29 forward: the degrees are
     kept), and two same-seed halo train steps (dropout 0.01, Adam)
     bit-equal; ``python -m desco_tpu_torch.serve
     --large_threshold 1000`` answering a 2,000-node graph as
     ``count_large_graph`` does (started with the phase, beside (c)-(d));
     (e) every kernel of the path launched,
     and the gather-fused K1 (forward and backward) on a gossip shard's
     interior, boundary and send streams and the 1-column degrees, K1,
     K4 and their pairs at the halo GAT / PNA sums, checked and timed as
     in phase 9 (a).
 14. data parallelism (run before the record), D = 2 and D = 4 replicas
     on the one card: (a) phase 3's 256-graph request through
     ``CountingService(n_devices=2)``, every output bit-equal to phase 3's
     result, and both stages' DP predict at D = 2 and 4 bit-equal to one
     device (K2 8 per padded target batch, the gather-fused K1 1 + 2 x 29
     per padded gossip batch, no backward kernel); (b) a D = 2 step of
     each training stage on the phase-6 set (the neighborhood's weighted
     by valid graphs, the gossip's a sum) against the single-device
     losses (rtol 1e-5) and gradients (1e-4 of a tensor's scale), the
     same on the CPU, two same-seed steps bit-equal (the gossip's also
     with dropout), and 2 epochs of each stage at D = 1 and D = 2 through
     ``train_*_stage(mesh=...)`` (the compiled DP steps) with launches per
     padded batch and the epoch ms; (c) DP x halo on a 2 x 2 grid: phase 13's graph and a
     12,000-node one of the same recipe (seed 4), harmonized partitions,
     the composed gossip loss and gradients against the sum of the
     replicas' (rtol 1e-5, 1e-5 of a tensor's scale), two same-seed
     steps bit-equal, the composed SHMP forward bit-equal to each
     replica's ``halo_shmp_core``; (d) ``graft_entry.dryrun_multichip(4)``,
     and ``enable_compilation_cache`` on a fresh directory: one process
     builds every library there (started first, it runs beside the rest
     of the phase), a second one loads them without nvcc or g++.
 15. the analysis and experimental tools (run before the record), each
     through its ``run`` on the card at the paper width: (a)
     ``tools/serving_bench`` in modes raw and service at the script's
     defaults (64 graphs of 30-120 nodes, seed 7, verify 0.001, fresh
     weights), latency over 32 graphs (cut from 64), stream at 4 requests
     (cut from 8), and service over
     ``--n_devices 2``, bit-equal to one device; (b)
     ``compute_groundtruth --query_sizes 6`` (112 queries) on
     Syn_1827_test_max15, every count >= 0, every size 6, seven ids
     recounted alone and equal; (c) ``verify_sweep`` of release/r4 on
     the replay set at budgets 0, 1e-3, 3e-3 (1e-2 and 3e-2 cut): rows
     verified rise,
     normed MSE falls or stays level, and at r4's budget it is within
     rtol 1e-2 of the stored replay's (tests/data); (d) ``scaling`` at
     its defaults (20,000 nodes, degree 8, 4 layers, hidden 64, metis)
     for ``er`` and ``comm`` at D = 1 and 4 shards on the one card (cut
     from 1, 2, 4, 8), D = 4 within 1e-4 of max|out| of D = 1; (e)
     ``large_graph_serving --nodes 8000 --devices 4`` (cut from 20,000:
     phase 13 serves that one), a fresh service; (f) ``runtime``, (g)
     ``dataset_statistics --sample 300`` (cut from 2,000) with
     release/r4's embeddings and t-SNE on the card (CSV, ``.npy`` and
     SVG written, KL finite) and (h) ``downstream_task`` and
     ``complexity_analysis``, all on Syn_64. Launches zeroed before and
     read after each tool: K1, the gather-fused K1 (K1' on scaling's
     halo streams) and K2 launched, no backward kernel.
 16. the compiled steps (run before the record; phase 18 (b)'s torchrun
     ``main`` runs beside it), on the phase-6 training set from the same
     weights and seed: (a) a read-back under the guard
     the graphed loops run under (``set_sync_debug_mode("error")``)
     raises; (b) 2 neighborhood epochs in f32 and with ``train_bf16``,
     and 3 at a learning rate of 1e-9 with patience 0 (a plateau decay
     reaches the last epoch through the device learning rate), and 2
     with dropout 0.1 (the masks' generator registered with the graph),
     each with the eager steps and with the graphed ones: train and val
     losses, final parameters and Adam's ``.last`` state bit-equal,
     launches equal, every graphed loop under the guard (its debug mode
     read inside) and no eager one; launches per epoch and epoch ms both
     ways printed; (c) the gossip eval pass over phase 6's gossip
     batches and trained model, graphed against eager, bit-equal,
     launches equal (the gather-fused K1 1 + 2 x 29 per batch), ms both
     ways; (d) the gossip train step: 2 epochs on phase 6's gossip
     batches at dropout 0.01 and 0, the same checks as (b), launches the
     gather-fused K1 1 + 4 x 29 forward and 29 backward per train batch
     and 1 + 2 x 29 per val batch; (e) data parallelism at D = 2 on the
     one card, 2 epochs of each stage (the gossip's at dropout 0.01), the
     same checks, launches per padded batch; (f) phase 13's halo gossip
     train step (4 shards) and phase 14's 2 x 2 DP x halo step, dropout
     0.01, four calls each eager and graphed (the first graphed call
     captures, the other three replay under the guard): losses, flags,
     gradients, parameters and Adam's moments bit-equal after every
     call, launches equal, ms per call both ways.
 17. the compiled serving forwards (run before the record; every earlier
     phase already serves, predicts, benches and trains the baselines
     through them, as the port does by default), each against
     ``graphed=False`` on the card: (a) phase 3's 256-graph request
     through a fresh graphed service (twice, the second request timed)
     and a fresh eager one (once), both with phase 3's buckets: counts,
     verified rows and every
     field equal to phase 3's result, launches equal, the stage ms both
     ways (the tracer's spans, utils/trace.py), the service's compiled
     forwards and the bytes of their memory pool; every target batch's
     bounds through the compiled ``_batch_bounds`` (one capture, replays
     under the guard) against the eager ones: bit-equal where under
     2^24, within rtol 1e-6 above (``index_add_`` adds in no fixed
     order); (b) a ``serve_bf16`` request of 32 graphs, a two-member
     ensemble request and phase 10's labeled request (784 queries) both
     ways; (c) D = 2 DP serving on the one
     card both ways; (d) ``count_large_graph`` on phase 18's 8,000-node
     graph, fresh services both ways, the halo serve's capture and gossip
     seconds; (e) ``bench.main`` both ways in this process (forward and
     train-step ms, launches per forward equal); (f) one epoch of the
     DIAMNet driver both ways, its printed losses and figures equal.
     Results are bit-equal both ways except counts of 2^24 and more that
     a bound over 2^24 clamped (rtol 1e-6; the count of such entries is
     printed); about 80-100 s.
 18. data parallelism across processes (run before the record): two
     ranks of a gloo process group on the one card (this script with
     ``--dist_rank``, started by ``file://`` rendezvous, every child
     killed past its timeout): (a) each rank runs the D = 2 DP steps of
     both stages (paper config, phase 6's batches, two groups, the
     gossip's at its dropout), eager and graphed (its part and the sum
     with Adam as two CUDA graphs, the gather between them), both DP
     predicts (phase 6's models, 8 batches each) and phase 14's 2 x 2 DP
     x halo step (two calls each way); every result on both ranks, and
     the D = 2 DP steps graphed in this process, bit-equal to the eager
     D = 2 in this process (its predicts and DP x halo step run eager
     alone); each rank's launches printed, K1, K1', K2, K3 and K4
     launched on both; the step ms of both ways and the gather's ms; (b) ``python -m torch.distributed.run --standalone
     --nproc_per_node 2 -m desco_tpu_torch.main --n_devices 2
     --train_neigh --train_gossip --test_gossip`` at the paper width, 1
     epoch per stage on SynNp_32_3 (test SynNp_16_4), started before
     phase 16 and run beside phases 16-17: exit 0, the mesh
     line printed once (rank 0), one set of checkpoints, finite normed
     MSE; (c) the halo graph axis across the same two ranks, after (a):
     r4's 2-layer gossip train step (29 queries) on phase 14's
     12,000-node graph in 4 shards over ``make_mesh2d(1, 4)``, shards 0-1
     on rank 0 and 2-3 on rank 1, two calls at dropout 0 and two at 0.1;
     the DP x halo step on desco_tpu's 3 x 2 fallback grid (phase 14's
     two graphs and an 8,000-node one), whose middle row crosses the
     ranks, two calls at the gossip's dropout; r4's target tower (SAGE, 8
     layers, hidden 64) sharded over a 1 x 2 grid, ``dp_halo_shmp_forward``
     on the 12,000-node graph's typed sample (two calls); each part runs
     eager and graphed across the ranks, graphed as a chain of CUDA
     graphs split at its collectives (one graph more than its split
     points, no eager note); every result of both ways on both ranks
     bit-equal to the same grids in this process (eager), each rank's
     gather-fused K1 and its backward launched both ways as many times as
     its shards' streams need; per rank and site the eager and graphed ms
     per call, graphs per call, capture seconds, the collectives' ms
     inside each graphed call and the pool's bytes; one exchange's ms,
     whole and split into its device-to-host copy, gloo's all-to-all and
     the host-to-device copy; the phase's seconds.
 12. one JSON line of kernels (K2' and K3' at T = 33 and at T = 1 in
     rows of their own, launched by the order-4 run and the DIAMNet
     driver; every other row's launches count the ablation path, labeled
     serving and the ensembles, the halo path, data parallelism in one
     process and across processes (phase 18, both ranks) and the tools
     too, the gather-fused K1's the baseline entry points as well;
     K1, K4 and the gather-fused K1 carry their halo use sites; GAT's K1
     and K4 pairs have rows of their own, measured at the packed and the
     halo site; the tools' entry is the last of ``launches_per_path`` in
     every row, 0
     where they do not run the row's shape), the card line, then the
     final ok line.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import dataclasses
import faulthandler
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
R4_NEIGH = os.path.join(REPO, "release", "r4", "neigh.best")
R4_GOSSIP = os.path.join(REPO, "release", "r4", "gossip.best")
# H100 SXM data sheet: HBM3 rate, and the f32 rate outside the tensor
# cores (the port runs f32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores (K2 and K3)
PAD_KEY = 2 ** 30  # the padding id of desco_tpu's segment-sum streams
# bf16 target tower against the f32 one, in log2(count + 1) space at the
# paper width (8 layers, hidden 64, release/r4's weights): 0.114 at most
# over the 256-graph request of seed 0 on an H100 (mean 0.0095), 0.073
# between the card and the CPU, so 0.25 leaves a factor of two. desco_tpu's
# own test allows 0.05 at 4 layers, hidden 16 (tests/test_models.py:515).
BF16_LOG2_ATOL = 0.25
# gather-fused K1 launches of one gossip train step (29 queries, 2
# layers): the degrees, two per query forward and two in the checkpoint's
# recomputation; backward behind layer 1 only (layer 0's input is
# detached). A gossip forward without grad: 1 + 2 x 29.
GOSSIP_FWD_PER_STEP = 1 + 4 * 29
GOSSIP_BWD_PER_STEP = 29
GOSSIP_FWD_PER_EVAL = 1 + 2 * 29
# desco_tpu's datasets as desco_tpu makes them (networkx 3.6.1, numpy
# 2.0.2, CPU): graphs, nodes, edges and ``data.datasets.fingerprint``
DATASETS = {
    "Syn_1827": (1827, 246542, 661491, "be4812bf6c8a03a8"),
    "Syn_1827_test": (915, 127309, 348718, "4ec80206fa8ffa4d"),
    "ChemProxy": (188, 3541, 3653, "69ed3dc0de93263b"),
    "ChemBigProxy": (467, 19066, 20077, "7df0d3fe435c1d55"),
    "GeoProxy": (600, 19804, 37277, "c0e744f2a4003d0b"),
    "EgoProxy": (1000, 19990, 100020, "069f99523c2c5da3"),
    "SuperpixelProxy": (563, 47864, 122034, "8571e4d3bef36880"),
}
# release/r4 replayed on Syn_1827_test_max40 (354 graphs, 8,798 nodes) by
# desco_tpu's root main.py on the CPU in f32 (JAX_PLATFORMS=cpu, a fresh
# --data_root): graphlet normed MSE for query sizes 3, 4, 5
REPLAY_SET = "Syn_1827_test_max40"
REPLAY_CPU_MSE = {
    "neighborhood": (0.0052897493740783385, 0.004320016442726204,
                     0.005589552031913191),
    "gossip": (0.0052423874108605195, 0.004299120551611978,
               0.00557261373626193),
}
REPLAY_RTOL = 1e-2
# the same run's per-graph counts (graphlet_truth, neighborhood_graphlet
# and gossip_graphlet CSVs; its graphlet_count CSV equals the gossip one)
REPLAY_CPU_COUNTS = os.path.join(
    REPO, "tests", "data", "replay_r4_Syn_1827_test_max40.npz")
# per-graph counts are round(relu(sum over the graph)): a sum that lies
# within float error of a half flips by one, as it does in 9 of 10,266
# entries between the port and desco_tpu, both on the CPU
REPLAY_COUNT_RTOL = 1e-3
# both baseline drivers at phase 10's arguments (REPLAY_SET, the defaults,
# 2 epochs, seed 0) as desco_tpu's root baseline.py computes them on the
# CPU from the port's seed-0 weights (tests/baseline_reference.py):
# normed MSE and MAE per query size 3, 4, 5. LRP's predictions for this
# set's hub graphs reach the 2^60 log-space clamp in both packages, so
# its figures are huge and move with rounding through training: the port
# on the CPU lies 1.2e-2 from them (DIAMNet: 1e-5), and the card is held
# at four times that spread (DIAMNet: at the counts' rtol).
BASELINE_REFERENCE = {
    "DIAMNET": {"norm_mse": (1.4884052778797154, 1.2380479334485865,
                             1.1475128604839695),
                "mae": (524.3658447265625, 1378.6219482421875,
                        2607.830322265625)},
    "LRP": {"norm_mse": (6.839532193986223e+27, 5.580202810003009e+26,
                         7.021676370061931e+25),
            "mae": (3379890959155200.0, 3887897543442432.0,
                    3018850371108864.0)},
}
BASELINE_RTOL = {"DIAMNET": 1e-3, "LRP": 5e-2}


# the seconds of every phase of this run, in order (``phase_done``)
T_START = time.perf_counter()
# a run still going this many seconds in prints every thread's stack to
# stderr (and goes on): the run must end within 1200 s
STACKS_AFTER_S = 1000
PHASE_S: dict = {}
_PHASE_MARK = [T_START]


def phase_done(name: str) -> None:
    """Print and keep the seconds since the previous phase ended, on
    stdout and, with the run's seconds so far, on stderr: a run stopped
    from outside still shows there how far it came."""
    now = time.perf_counter()
    PHASE_S[name] = now - _PHASE_MARK[0]
    _PHASE_MARK[0] = now
    print(f"phase {name} ended after {PHASE_S[name]:.1f} s", flush=True)
    print(f"chip_smoke: phase {name} ended after {PHASE_S[name]:.1f} s, "
          f"{now - T_START:.1f} s into the run", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------- helpers
def run_teed(fn, argv) -> tuple:
    """(return code, printed text) of ``fn(argv)``, its output shown as it
    runs."""
    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    sys.stdout.flush()
    return rc, buf.getvalue()


# processes started to run beside later phases (``start_beside``); one
# not yet collected when the run exits is killed with its process group
_BESIDE: list = []


def start_beside(cmd, stdin: str = "") -> dict:
    """Start ``cmd`` from the repository root in a session of its own,
    ``stdin`` as its input and its output into files, to run beside the
    phases that follow; ``collect`` waits for it."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    with tempfile.TemporaryFile("w+") as inp:
        inp.write(stdin)
        inp.seek(0)
        proc = subprocess.Popen(cmd, cwd=REPO, stdin=inp, stdout=out,
                                stderr=err, text=True,
                                start_new_session=True)
    _BESIDE.append(proc)
    job = dict(proc=proc, out=out, err=err, t0=time.perf_counter())

    def note_end():
        proc.wait()
        job["t1"] = time.perf_counter()

    job["waiter"] = threading.Thread(target=note_end, daemon=True)
    job["waiter"].start()
    return job


def collect(job: dict, timeout: float, what: str) -> tuple:
    """(stdout, stderr, seconds from its start to its exit) of a process
    from ``start_beside``; fails unless it exits 0 within ``timeout`` s
    of now."""
    proc = job["proc"]
    job["waiter"].join(timeout=timeout)
    if job["waiter"].is_alive():
        fail(f"{what} did not finish within {timeout:.0f} s")
    seconds = job["t1"] - job["t0"]
    texts = []
    for f in (job["out"], job["err"]):
        f.seek(0)
        texts.append(f.read())
        f.close()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n"
          f"{texts[0][-3000:]}\n{texts[1][-3000:]}")
    return texts[0], texts[1], seconds


@atexit.register
def _stop_beside() -> None:
    import signal

    for proc in _BESIDE:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)


def timing_of(text: str, name: str) -> float:
    """The seconds of main.py's ``[timing] <name>: <s>s`` line."""
    for line in text.splitlines():
        if line.startswith(f"[timing] {name}"):
            return float(line.rsplit(" ", 1)[1].rstrip("s"))
    fail(f"no [timing] line for {name!r}")


def cuda_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean time of one call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, out, ref, what: str, rtol: float = 1e-5) -> float:
    """Check out == ref within ``rtol``, atol 1e-5 * max|ref|."""
    check(tuple(out.shape) == tuple(ref.shape),
          f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    check(out.dtype == ref.dtype, f"{what}: {out.dtype} != {ref.dtype}")
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    if ref.numel() == 0:
        return 0.0
    atol = 1e-5 * float(ref.abs().max())
    bad = err > atol + rtol * ref.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements off, max err "
          f"{float(err.max()):.3g} (atol {atol:.3g})")
    return float(err.max())


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S, tensor_ops: float = 0.0) -> tuple:
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over their unit's rate (``ops`` on the f32 units,
    ``tensor_ops`` on the tensor cores in TF32; the two units run side by
    side, so the slower one counts)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ops_per_s, tensor_ops / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_passes(dtype) -> int:
    """Tensor-core passes of a split-TF32 product in K2 / K3: 3 for f32
    operands, 2 where one operand is bf16 and so exact in TF32."""
    return 3 if dname(dtype) == "f32" else 2


def library_yardstick(fn, what: str):
    """The graph time of a library yardstick, or None (with the reason
    printed) where PyTorch refuses it, as cuSPARSE may refuse bf16."""
    try:
        return library_graph_ms(fn)
    except RuntimeError as exc:
        print(f"{what}: no library time ({str(exc).splitlines()[0]})",
              flush=True)
        return None


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "").replace("bfloat16", "bf16") \
        .replace("float32", "f32")


def library_graph_ms(fn) -> float:
    """One PyTorch call timed as the kernels are: 8 calls per CUDA graph."""
    from desco_tpu_torch.tools.segsum_inner_ablation import graph_us

    return graph_us(lambda i: fn()) / 1e3


def graph_ms(graph_rows: dict, key: str, dtype) -> dict:
    """The CUDA-graph times of one case of ``time_cases``, in ms."""
    r = graph_rows[f"{key}_{dname(dtype)}"]
    return {"ms": r["function_us"] / 1e3,
            "kernel_only_ms": r["alone_us"] / 1e3}


# ------------------------------------------------------------ phase 2: K1
def k1_case(torch, cs, rng, dev, dtype, e_live, k, n_seg, pad=0,
            long_seg=0, neg=0):
    ids = np.sort(rng.integers(0, max(n_seg, 1), e_live))
    if long_seg:
        ids = np.sort(np.concatenate([ids, np.full(long_seg, n_seg // 2)]))
    ids = np.concatenate([np.full(neg, -1), ids, np.full(pad, PAD_KEY)])
    seg = torch.as_tensor(ids.astype(np.int32), device=dev)
    msgs = torch.randn(len(ids), k, device=dev).to(dtype)
    return msgs, seg, n_seg


def k1_edge_cases(torch, cs, rng, dev, dtype) -> None:
    cases = {
        "gaps+negative+pad tail, K=64, E=1001":
            dict(e_live=1001 - 64 - 3, k=64, n_seg=700, pad=64, neg=3),
        "long segment (5000 rows), K=128":
            dict(e_live=3000, k=128, n_seg=900, long_seg=5000),
        "odd K=33, E=777": dict(e_live=777, k=33, n_seg=50),
        "all padding, K=64": dict(e_live=0, k=64, n_seg=40, pad=513),
        "empty stream, K=128": dict(e_live=0, k=128, n_seg=17),
        "pooling width K=576": dict(e_live=5000, k=576, n_seg=64, pad=7),
    }
    for name, kw in cases.items():
        msgs, seg, n = k1_case(torch, cs, rng, dev, dtype, **kw)
        out = cs.sorted_segment_sum(msgs, seg, n, cs.segment_offsets(seg, n))
        torch.cuda.synchronize()
        err = max_err(torch, out, cs.sorted_segment_sum_plain(msgs, seg, n),
                      f"K1 {dname(dtype)} {name}")
        print(f"K1 {dname(dtype)} edge case ok: {name} (max err {err:.3g})",
              flush=True)


def k1_main(torch, cs, dev, msgs, seg, n, label, timed: dict) -> dict:
    """Check K1 at one main-path shape on msgs' dtype; time the wrapper
    (on the stream's offsets, derived once), the plain version and, for
    f32 rows, ``index_add_`` (no one PyTorch call sums bf16 rows into
    f32)."""
    offs = cs.segment_offsets(seg, n)
    out = cs.sorted_segment_sum(msgs, seg, n, offs)
    torch.cuda.synchronize()
    err = max_err(torch, out, cs.sorted_segment_sum_plain(msgs, seg, n),
                  f"K1 {dname(msgs.dtype)} {label}")
    library_ms = None
    if msgs.dtype == torch.float32:
        ids = seg.long().masked_fill((seg < 0) | (seg >= n), n)
        lib_out = torch.zeros(n + 1, msgs.shape[1], device=dev)

        def library():
            lib_out.zero_()
            lib_out.index_add_(0, ids, msgs)

        library_ms = library_graph_ms(library)
    e_live = int(((seg >= 0) & (seg < n)).sum())
    k = msgs.shape[1]
    b_ms, b_by = bound(e_live * k * msgs.element_size() + seg.numel() * 4
                       + n * k * 4, e_live * k)
    row = {
        **timed,
        "wrapper_ms": cuda_ms(
            torch, lambda: cs.sorted_segment_sum(msgs, seg, n, offs)),
        "plain_ms": cuda_ms(
            torch, lambda: cs.sorted_segment_sum_plain(msgs, seg, n)),
        "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    print(f"K1 {dname(msgs.dtype)} at {label}: msgs {tuple(msgs.shape)}, "
          f"{n} segments, {e_live} live rows: {json.dumps(row)}", flush=True)
    return row


# ------------------------------------------- phase 2: K1's narrow layout
def narrow_order_sum(x, rows, offs):
    """K1's sum of x[rows[e]] (rows None: x[e]) over each segment
    [offs[r], offs[r+1]) on rows of K <= 16 elements, on the CPU in f32,
    in the narrow layout's fixed order: with lanes the power of two >= K
    and G = 32 / lanes, group g takes edges g, g + G, ... of a segment and
    adds them in order from 0, and the G partials fold as lane l adds
    lane l ^ off for off = 16, 8, ..., lanes."""
    x = np.asarray(x, np.float32)
    k = x.shape[1]
    groups = 32 // (1 << (k - 1).bit_length())
    lo, hi = offs[:-1].astype(np.int64), offs[1:].astype(np.int64)
    lens = hi - lo
    part = np.zeros((len(lo), groups, k), np.float32)
    for j in range(int(lens.max(initial=0))):
        m = np.nonzero(lens > j)[0]
        e = lo[m] + j
        part[m, j % groups] = part[m, j % groups] + x[
            e if rows is None else rows[e]]
    off = groups // 2
    while off >= 1:
        part = part + part[:, np.arange(groups) ^ off]
        off //= 2
    return part[:, 0]


def narrow_edge_cases(torch, cs, rng, dev, dtype) -> None:
    """K1 on rows of K = 1-16 elements (the narrow layout: a group of
    lanes per segment), identity rows and gathered ones: empty segments,
    three negative keys, padding keys, one segment of 4500 edges and one
    of 40 (both summed by their whole warp), the rest short; bit for bit
    the CPU's f32 sum of the up-cast rows in the layout's fold order
    (``narrow_order_sum``), two runs bit-equal, within the plain version's
    tolerance. Then GAT's operand pair at K =
    1, 3, 16, 64 and 128: K1's pair (one launch above 16 columns)
    bit-equal to K1 on each operand and within the tolerance of its plain
    version, K4's pair (one launch) equal to K4 on each and to its plain
    version."""
    n_seg = 300
    ids = np.sort(np.concatenate([rng.integers(0, n_seg - 60, 1200),
                                  np.full(4500, 40), np.full(40, 270)]))
    seg = np.concatenate([np.full(3, -1), ids,
                          np.full(64, PAD_KEY)]).astype(np.int32)
    sd = torch.as_tensor(seg, device=dev)
    offs = cs.segment_offsets(sd, n_seg)
    o = offs.cpu().numpy()
    lens = o[1:] - o[:-1]
    check(o[0] == 3 and (lens == 0).any() and lens[40] >= 4500
          and lens[270] == 40, f"K1 narrow: the stream (offsets {o[:4]})")
    for gather in (False, True):
        rows = (rng.integers(0, 500, len(seg)).astype(np.int32) if gather
                else None)
        rd = None if rows is None else torch.as_tensor(rows, device=dev)
        for k in range(1, 17):
            x = torch.randn(500 if gather else len(seg), k,
                            device=dev).to(dtype)
            outs = [torch.empty(n_seg, k, device=dev) for _ in range(2)]
            for out in outs:
                cs.launch_k1(x, offs, n_seg, out, rows=rd)
            torch.cuda.synchronize()
            what = (f"K1 narrow {dname(dtype)} K={k} "
                    f"{'gather' if gather else 'identity'}")
            check(torch.equal(outs[0], outs[1]),
                  f"{what}: two runs differ")
            max_err(torch, outs[0], cs.gather_rows_segment_sum_plain(
                x, rd, offs, n_seg), what)
            check(torch.equal(outs[0].cpu(), torch.as_tensor(
                narrow_order_sum(x.float().cpu().numpy(), rows, o))),
                f"{what}: not the sum in the narrow layout's fold order")
    print(f"K1 {dname(dtype)} narrow layout ok: K = 1-16, identity and "
          f"gather, the CPU's fold-order sum bit for bit (segments of "
          f"4500 and 40 edges by their warp), two runs bit-equal",
          flush=True)
    g_aux = torch.randn(n_seg, device=dev)
    for k in (1, 3, 16, 64, 128):
        m = torch.randn(len(seg), k, device=dev).to(dtype)
        a = torch.rand(len(seg), device=dev).to(dtype)
        g = torch.randn(n_seg, k, device=dev)
        num, den = cs.sorted_segment_sum_pair(m, a, sd, n_seg, offs)
        d, d_aux = cs.segment_sum_vjp_pair(g, g_aux, sd, n_seg, dtype)
        want = (cs.sorted_segment_sum(m, sd, n_seg, offs),
                cs.sorted_segment_sum(a[:, None], sd, n_seg, offs)[:, 0],
                cs.segment_sum_vjp(g, sd, n_seg, dtype),
                cs.segment_sum_vjp(g_aux[:, None], sd, n_seg, dtype)[:, 0])
        torch.cuda.synchronize()
        what = f"K1 / K4 pair {dname(dtype)} K={k}"
        check(all(x.dtype == y.dtype and torch.equal(x, y)
                  for x, y in zip((num, den, d, d_aux), want)),
              f"{what}: not equal to the separate launches")
        plain = cs.sorted_segment_sum_pair_plain(m, a, sd, n_seg)
        max_err(torch, num, plain[0], f"{what}: num")
        max_err(torch, den, plain[1], f"{what}: den")
        check(all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(
            (d, d_aux),
            cs.segment_sum_vjp_pair_plain(g, g_aux, sd, n_seg, dtype))),
            f"{what}: the cotangents are not the plain version's")
    print(f"K1 / K4 pairs {dname(dtype)} ok: K = 1, 3, 16, 64, 128, equal "
          f"to K1 and K4 on each operand, within the plain versions' "
          f"tolerance", flush=True)


# ------------------------------------------------ phase 2: gather-fused K1
def gather_case(torch, cs, rng, dev, dtype, n, t, k, e_live, pad=64,
                long_dst=0, long_src=0):
    """x [n, k] in ``dtype`` and the ``TypedStreams`` of a
    (dst,type)-sorted stream with desco_tpu's padding (keys (n-1)*T + 63
    from the zero pad node n - 1), the backward streams derived on the
    card; ``long_dst`` / ``long_src`` more edges into / out of node 7."""
    dst = rng.integers(0, n - 1, e_live)
    src = rng.integers(0, n - 1, e_live)
    if long_dst:
        dst = np.concatenate([dst, np.full(long_dst, 7)])
        src = np.concatenate([src, rng.integers(0, n - 1, long_dst)])
    if long_src:
        src = np.concatenate([src, np.full(long_src, 7)])
        dst = np.concatenate([dst, rng.integers(0, n - 1, long_src)])
    keys = dst * t + rng.integers(0, t, len(dst))
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(pad, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(pad, n - 1)])
    x = torch.randn(n, k, device=dev)
    x[n - 1] = 0.0  # the pad node
    st = cs.typed_streams(torch.as_tensor(src.astype(np.int32), device=dev),
                          torch.as_tensor(keys.astype(np.int32), device=dev),
                          t, n, n)
    return x.to(dtype), cs.ensure_backward_streams(st)


# odd K, K = 1 (the direction degrees), rows of 16 (two lane groups),
# K = 576 over few segments, long segments both ways, all padding, and an
# empty stream
GATHER_EDGE_CASES = {
    "gossip width K=128, T=2": dict(n=700, t=2, k=128, e_live=4000),
    "query tower K=64, T=6": dict(n=300, t=6, k=64, e_live=2000),
    "odd K=33, T=3": dict(n=300, t=3, k=33, e_live=999),
    "K=1 (direction degrees)": dict(n=500, t=2, k=1, e_live=3000),
    "K=16 (two lane groups)": dict(n=200, t=2, k=16, e_live=1500),
    "K=576, 4 nodes": dict(n=5, t=2, k=576, e_live=3000),
    "long segments (5000 edges into and out of one node)":
        dict(n=500, t=2, k=128, e_live=900, long_dst=5000, long_src=5000),
    "all padding": dict(n=129, t=2, k=64, e_live=0, pad=512),
    "empty stream": dict(n=40, t=2, k=128, e_live=0, pad=0),
}


def gather_check(torch, cs, x, g, st, what) -> float:
    """The gather-fused K1 forward and backward on the card against their
    plain versions: the forward against ``index_select`` + ``segment_sum``
    (rtol 1e-5), dx against autograd's backward of that (``index_select``
    of g by key, ``index_add_`` by source; f32 rtol 1e-5, bf16 dx one
    bf16 step, 2^-7) and against K1's plain version over the
    source-sorted stream; a second backward must be bit-equal."""
    n_seg, k = st.n_nodes * st.n_types, x.shape[1]
    before = (cs.gather_segment_sum.launches,
              cs.gather_segment_sum_bwd.launches)
    out = cs.gather_segment_sum(x, st)
    dx = cs.gather_segment_sum_bwd(g, st, x.dtype)
    dx2 = cs.gather_segment_sum_bwd(g, st, x.dtype)
    torch.cuda.synchronize()
    want = (before[0] + (n_seg > 0 and k > 0), before[1] + 2 * (k > 0))
    check((cs.gather_segment_sum.launches,
           cs.gather_segment_sum_bwd.launches) == want,
          f"K1' {what}: the kernels did not launch once per call")
    check(dx.dtype == x.dtype, f"K1' {what}: dx not in x's dtype")
    check(torch.equal(dx, dx2), f"K1' {what}: two backward runs differ")
    check(int(st.bwd_soffs[-1]) == int(st.fwd_toffs[-1]),
          f"K1' {what}: the backward stream has another edge count")
    rtol = 1e-5 if x.dtype == torch.float32 else 2.0 ** -7
    what = f"{dname(x.dtype)} {what}"
    return max(
        max_err(torch, out, cs.gather_segment_sum_plain(x, st),
                f"K1' forward, {what}"),
        max_err(torch, dx, cs.gather_segment_sum_bwd_plain(g, st, x.dtype),
                f"K1' dx, {what}", rtol),
        max_err(torch, dx, cs.gather_rows_segment_sum_plain(
            g, st.bwd_keys, st.bwd_soffs, st.n_rows).to(x.dtype),
                f"K1' dx over the source-sorted stream, {what}", rtol))


def gather_edge_cases(torch, cs, rng, dev, dtype) -> None:
    for name, kw in GATHER_EDGE_CASES.items():
        x, st = gather_case(torch, cs, rng, dev, dtype, **kw)
        g = torch.randn(st.n_nodes * st.n_types, kw["k"], device=dev)
        err = gather_check(torch, cs, x, g, st, name)
        # a strided cotangent, as autograd may hand one over
        wide = torch.randn(g.shape[0], 2 * g.shape[1], device=dev)
        err = max(err, gather_check(torch, cs, x, wide[:, :g.shape[1]], st,
                                    name + ", strided g"))
        print(f"K1' {dname(dtype)} edge case ok: {name} (max err "
              f"{err:.3g}; backward bit-equal over two runs)", flush=True)


def gather_bytes(torch, st, k: int, it: int, way: str) -> int:
    """The HBM bytes the gather-fused K1 (``way`` "fwd") or its backward
    ("bwd") must move on this stream with rows of ``it`` bytes per element
    in x and dx: the rows it reads, each once (the distinct live sources
    of x, or the distinct live segments of the f32 cotangent g; dead rows
    are never read), its index and offset arrays, and the whole f32
    output (forward) or dx (backward) written once."""
    e_live = int(st.fwd_toffs[-1])
    if way == "fwd":
        read = int(torch.unique(st.edge_src[:e_live]).numel())
        return (read * k * it + e_live * 4 + st.fwd_toffs.numel() * 4
                + st.n_nodes * st.n_types * k * 4)
    read = int(torch.unique(st.bwd_keys[:e_live]).numel())
    return (read * k * 4 + e_live * 4 + st.bwd_soffs.numel() * 4
            + st.n_rows * k * it)


def gather_main(torch, cs, dev, case, dtype, graph_rows: dict) -> tuple:
    """Check the gather-fused K1 and its backward at the gossip layer-0
    aggregation (the ``gossip`` case of ``kernel_cases``) on x in
    ``dtype``; time the wrappers and plain versions eagerly and take the
    CUDA-graph times (function, bare kernel, the composition it replaced)
    from ``graph_rows``; the yardstick is ``torch.sparse.mm`` of the
    batch's unit CSR adjacency [N*T, N] with x, and of its transpose with
    g; bounds in HBM bytes, and the L2 volume the gather re-reads."""
    x, g, st = case["x"].to(dtype), case["g"], case["st"]
    err = gather_check(torch, cs, x, g, st, "gossip layer-0 batch")
    n_seg, k, n = st.n_nodes * st.n_types, x.shape[1], st.n_rows
    e_live = int(st.fwd_toffs[-1])
    it = x.element_size()
    ones = torch.ones(e_live, dtype=dtype, device=dev)
    csr = torch.sparse_csr_tensor(st.fwd_toffs,
                                  st.edge_src[:e_live].contiguous(), ones,
                                  (n_seg, n))
    csr_t = torch.sparse_csr_tensor(st.bwd_soffs,
                                    st.bwd_keys[:e_live].contiguous(),
                                    ones.float(), (n, n_seg))
    rows = {}
    for way in ("fwd", "bwd"):
        r = graph_rows[f"gather_{way}_{dname(dtype)}"]
        moved = gather_bytes(torch, st, k, it, way)
        if way == "fwd":
            wrapper = lambda: cs.gather_segment_sum(x, st)  # noqa: E731
            plain = lambda: cs.gather_segment_sum_plain(x, st)  # noqa: E731
            library = lambda: torch.sparse.mm(csr, x)  # noqa: E731
        else:
            wrapper = lambda: cs.gather_segment_sum_bwd(  # noqa: E731
                g, st, dtype)
            plain = lambda: cs.gather_segment_sum_bwd_plain(  # noqa: E731
                g, st, dtype)
            library = lambda: torch.sparse.mm(csr_t, g)  # noqa: E731
        b_ms, b_by = bound(moved, e_live * k)
        rows[way] = {
            "ms": r["function_us"] / 1e3,
            "kernel_only_ms": r["alone_us"] / 1e3,
            "replaced_ms": r["old_us"] / 1e3,
            "wrapper_ms": cuda_ms(torch, wrapper),
            "plain_ms": cuda_ms(torch, plain),
            "library_ms": library_yardstick(
                library, f"K1' {way} {dname(dtype)} sparse.mm"),
            "library": "torch.sparse.mm of the unit CSR adjacency"
                       + (" (transposed) with g" if way == "bwd" else
                          " with x"),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved,
            "l2_gather_bytes": e_live * k * (it if way == "fwd" else 4),
            "max_abs_err": err,
        }
        print(f"K1' {way} {dname(dtype)} at the gossip layer-0 aggregation: "
              f"x {tuple(x.shape)}, {st.keys.numel()} edge slots ({e_live} "
              f"live), {n_seg} (node, direction) segments: "
              f"{json.dumps(rows[way])}", flush=True)
    return rows["fwd"], rows["bwd"]


# ------------------------------------------------------------ phase 2: K2
def k2_case(torch, rng, dev, dtype, n, t, h, k, e_live, long_seg=0,
            pad=64, hole=None):
    """A (dst,type)-sorted stream; ``hole`` = (lo, hi) moves every live
    destination and source out of rows [lo, hi), so the tiles there have
    no live edge in either direction."""
    dst = rng.integers(0, n - 1, e_live)
    if long_seg:
        dst = np.concatenate([dst, np.full(long_seg, 7)])
    typ = rng.integers(0, t, len(dst))
    src = rng.integers(0, n - 1, len(dst))
    if hole:
        lo, hi = hole
        dst = np.where((dst >= lo) & (dst < hi), dst + hi - lo, dst)
        src = np.where((src >= lo) & (src < hi), src + hi - lo, src)
    keys = dst * t + typ
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(pad, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(pad, n - 1)])
    x = torch.randn(n, h, device=dev)
    x[n - 1] = 0.0  # the pad node
    w = torch.randn(t, h, k, device=dev) * 0.1
    return (x.to(dtype), torch.as_tensor(src.astype(np.int32), device=dev),
            torch.as_tensor(keys.astype(np.int32), device=dev), w.to(dtype))


# the widths and streams of every K2 / K3 edge case; N = 300, 2000, 500,
# 129 and 333 are no multiple of the 32-row tile
TYPED_EDGE_CASES = {
    "N=300 T=6 K=64, E=1001 with pad keys":
        dict(n=300, t=6, h=64, k=64, e_live=1001 - 64),
    "K=128 (H=64), empty nodes": dict(n=2000, t=6, h=64, k=128,
                                      e_live=700),
    "long segment (5000 edges), T=2": dict(n=500, t=2, h=64, k=64,
                                           e_live=900, long_seg=5000),
    "all padding": dict(n=129, t=6, h=64, k=64, e_live=0, pad=512),
    "odd K=33": dict(n=300, t=3, h=16, k=33, e_live=999),
    "tiles 1-2 without a live edge, N=333":
        dict(n=333, t=6, h=64, k=64, e_live=1500, hole=(32, 96)),
}


def k2_edge_cases(torch, cs, rng, dev, dtype) -> None:
    for name, kw in TYPED_EDGE_CASES.items():
        x, src, keys, w = k2_case(torch, rng, dev, dtype, **kw)
        t, n = kw["t"], kw["n"]
        out = cs.fused_typed_transform_aggregate(x, src, keys, w, t, n)
        torch.cuda.synchronize()
        ref = cs.fused_typed_transform_aggregate_plain(x, src, keys, w, t, n)
        err = max_err(torch, out, ref, f"K2 {dname(dtype)} {name}")
        if kw.get("hole"):
            check(float(out[32:96].abs().max()) == 0.0,
                  f"K2 {dname(dtype)} {name}: rows without edges not zero")
        print(f"K2 {dname(dtype)} edge case ok: {name} (max err {err:.3g})",
              flush=True)


def k2_main(torch, cs, dev, case, dtype, timed: dict) -> dict:
    """Check K2 at a real packed target batch of the main request (the
    ``k2`` case of ``kernel_cases``), x and W in ``dtype``; time its plain
    version and the library yardstick (two calls: ``torch.sparse.mm`` of
    the [N*T, N] CSR of the batch's (dst, type) runs with x, then
    ``torch.matmul`` with W)."""
    x, conv_w, st = case["x"].to(dtype), case["w"].to(dtype), case["st"]
    t, h, k = conv_w.shape
    n, it = st.n_nodes, x.element_size()
    keys, src = st.keys, st.edge_src
    args = (x, src, keys, conv_w, t, n)
    out = cs.fused_typed_transform_aggregate(*args, streams=st)
    torch.cuda.synchronize()
    err = max_err(torch, out, cs.fused_typed_transform_aggregate_plain(*args),
                  f"K2 {dname(dtype)} main-path batch")
    offs = st.fwd_toffs
    e_live = int(offs[-1])
    runs = int((offs[1:] > offs[:-1]).sum())  # non-empty (dst, type) runs
    tiles = cs.tile_edge_ranges(offs, n, t)
    dead = int((tiles[:, 0] == tiles[:, 1]).sum())
    if dtype == torch.bfloat16:
        # desco_tpu's _fused_legacy transforms first and rounds z to bf16;
        # K2 rounds nothing: the size of that difference at this batch
        kl = keys.long()
        d, ty = torch.div(kl, t, rounding_mode="floor"), kl % t
        z = (x.float() @ conv_w.float()).to(dtype).float()  # [T, N, K]
        rows = z[ty[:e_live], src[:e_live].long()]
        zr = torch.zeros(n, z.shape[2], device=dev).index_add_(
            0, d[:e_live], rows)
        print(f"K2 bf16: against z rounded to bf16 (desco_tpu's order), max "
              f"|diff| / max|ref| = "
              f"{float((out - zr).abs().max() / zr.abs().max()):.3e}",
              flush=True)
    csr = torch.sparse_csr_tensor(offs, src[:e_live].contiguous(),
                                  torch.ones(e_live, dtype=dtype, device=dev),
                                  (n * t, x.shape[0]))
    w2 = conv_w.reshape(t * h, k)
    library_ms = library_yardstick(
        lambda: torch.matmul(torch.sparse.mm(csr, x).view(n, t * h), w2),
        f"K2 {dname(dtype)} sparse.mm + matmul")
    # bytes: x, W, the live edges' sources, the run offsets, the f32
    # output; operations: the gather's adds on the f32 units, the
    # non-empty runs' products on the tensor cores in split TF32
    b_ms, b_by = bound(
        (x.numel() + conv_w.numel()) * it + e_live * 4 + offs.numel() * 4
        + n * k * 4, e_live * h,
        tensor_ops=split_passes(dtype) * 2 * runs * h * k)
    row = {
        **timed,
        "wrapper_ms": cuda_ms(
            torch, lambda: cs.fused_typed_transform_aggregate(
                *args, streams=st)),
        "plain_ms": cuda_ms(
            torch, lambda: cs.fused_typed_transform_aggregate_plain(*args)),
        "library_ms": library_ms,
        "library": "torch.sparse.mm + torch.matmul (two calls)",
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    print(f"K2 {dname(dtype)} at the main path: x {tuple(x.shape)}, "
          f"{keys.numel()} edge slots ({e_live} live, {runs} non-empty "
          f"(dst, type) runs), {t} types, {tiles.shape[0]} tiles of "
          f"{cs.TILE_ROWS} rows ({dead} without a live edge): "
          f"{json.dumps(row)}", flush=True)
    return row


# ------------------------------------------------------------ phase 2: K3
def bwd_perm_of(src, keys, t, n):
    """Edge slots in (src, type) order, dead edges last."""
    return np.lexsort((keys % t, src, keys >= n * t)).astype(np.int32)


def k3_streams(torch, cs, dev, src, keys, t, n):
    perm = bwd_perm_of(src.cpu().numpy(), keys.cpu().numpy(), t, n)
    return cs.typed_streams(src, keys, t, n, n,
                            torch.as_tensor(perm, device=dev))


def k3_check(torch, cs, g, x, w, st, what) -> float:
    """dx and dW through the kernels against the plain version; g is the
    f32 cotangent, x and w carry the tower's dtype (a bf16 tower reduces
    the cotangent rows rounded to bf16)."""
    before = cs.typed_aggregate_bwd.launches
    dx, dw = cs.typed_aggregate_bwd(g, x, w, st)
    torch.cuda.synchronize()
    check(cs.typed_aggregate_bwd.launches == before + 1,
          f"K3 {what}: the kernel did not launch")
    dx_ref, dw_ref = cs.typed_aggregate_bwd_plain(g.contiguous(), x, w, st)
    check(dx.dtype == x.dtype and dw.dtype == w.dtype,
          f"K3 {what}: gradients not in the primals' dtypes")
    # bf16 dx / dW are f32 results rounded: one bf16 step apart at most
    rtol = 1e-5 if x.dtype == torch.float32 else 2.0 ** -7
    what = f"{dname(x.dtype)} {what}"
    return max(max_err(torch, dx, dx_ref, f"K3 dx, {what}", rtol),
               max_err(torch, dw, dw_ref, f"K3 dW, {what}", rtol))


def k3_edge_cases(torch, cs, rng, dev, dtype) -> None:
    for name, kw in TYPED_EDGE_CASES.items():
        x, src, keys, w = k2_case(torch, rng, dev, dtype, **kw)
        t, n, k = kw["t"], kw["n"], kw["k"]
        if kw.get("long_seg"):  # k2_case made one long destination row:
            # swap the roles so one source sends the long run instead
            dst = torch.div(keys, t, rounding_mode="floor")
            live = keys < n * t
            new_keys = torch.where(live, src * t + keys % t, keys)
            new_src = torch.where(live, dst, src)
            order = torch.argsort(new_keys, stable=True)
            keys, src = (new_keys[order].contiguous(),
                         new_src[order].contiguous())
        st = k3_streams(torch, cs, dev, src, keys, t, n)
        g = torch.randn(n, k, device=dev)
        err = k3_check(torch, cs, g, x, w, st, name)
        # cotangents as autograd hands them over: a strided view and an
        # expanded scalar
        wide = torch.randn(n, 2 * k, device=dev)[:, :k]
        err = max(err, k3_check(torch, cs, wide, x, w, st,
                                name + ", strided g"))
        ones = torch.ones((), device=dev).expand(n, k)
        err = max(err, k3_check(torch, cs, ones, x, w, st,
                                name + ", expanded g"))
        print(f"K3 {dname(dtype)} edge case ok: {name} (max err {err:.3g})",
              flush=True)


def k3_main(torch, cs, dev, case, dtype, timed: dict) -> dict:
    """Check K3 at a real packed training batch (the ``k3`` case of
    ``kernel_cases``); time its plain version and the library yardstick
    (``torch.sparse.mm`` of the source-keyed [N*T, N] CSR with g, then
    the two einsums)."""
    g, st = case["g"], case["st"]
    x, conv_w = case["x"].to(dtype), case["w"].to(dtype)
    t, h, k = conv_w.shape
    n, it = st.n_nodes, x.element_size()
    err = k3_check(torch, cs, g, x, conv_w, st, "main-path training batch")
    offs = st.bwd_offs
    e_live = int(offs[-1])
    n_seg = st.n_rows * t
    filled = int((offs[1:] > offs[:-1]).sum())  # non-empty (src, type) runs
    table = g.to(dtype)
    csr = torch.sparse_csr_tensor(
        offs, st.bwd_rows[:e_live].contiguous(),
        torch.ones(e_live, dtype=dtype, device=dev), (n_seg, n))
    w32 = conv_w

    def library():
        u = torch.sparse.mm(csr, table).view(st.n_rows, t, k)
        torch.einsum("ntk,thk->nh", u, w32)
        torch.einsum("nh,ntk->thk", x, u)

    library_ms = library_yardstick(
        library, f"K3 {dname(dtype)} sparse.mm + two einsums")
    # bytes: the cotangent table, x, W, the live edges' rows, the run
    # offsets, dx and dW written once (no u); operations: the gather's
    # adds, and dx and dW over the non-empty runs in split TF32
    b_ms, b_by = bound(
        (table.numel() + x.numel() + conv_w.numel()) * it + e_live * 4
        + offs.numel() * 4 + (x.numel() + conv_w.numel()) * it,
        e_live * k, tensor_ops=split_passes(dtype) * 2 * 2 * filled * h * k)
    row = {
        **timed,
        "wrapper_ms": cuda_ms(torch, lambda: cs.typed_aggregate_bwd(
            g, x, conv_w, st)),
        "plain_ms": cuda_ms(torch, lambda: cs.typed_aggregate_bwd_plain(
            g, x, conv_w, st)),
        "library_ms": library_ms,
        "library": "torch.sparse.mm + two torch.einsum",
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    print(f"K3 {dname(dtype)} at the main path: g {tuple(g.shape)}, "
          f"{st.keys.numel()} edge slots ({e_live} live), {filled} of "
          f"{n_seg} (source, type) runs non-empty, {t} types, "
          f"{cs.k3_blocks(*cs.pad_operands(x, conv_w), st)} blocks "
          f"(alone = without the dW reduction launch): {json.dumps(row)}",
          flush=True)
    return row


# ------------------------------------------------------------ phase 2: K4
def k4_edge_cases(torch, cs, rng, dev, dtype) -> None:
    cases = {
        "gaps+negative+pad tail, K=64, E=1001":
            dict(e_live=1001 - 64 - 3, k=64, n_seg=700, pad=64, neg=3),
        "long segment (5000 rows), K=128":
            dict(e_live=3000, k=128, n_seg=900, long_seg=5000),
        "odd K=33, E=777": dict(e_live=777, k=33, n_seg=50),
        "K=2 mod 4 (66)": dict(e_live=500, k=66, n_seg=50, pad=9),
        "all padding, K=64": dict(e_live=0, k=64, n_seg=40, pad=513),
        "empty stream, K=128": dict(e_live=0, k=128, n_seg=17),
        "pooling width K=576": dict(e_live=5000, k=576, n_seg=64, pad=7),
    }
    for name, kw in cases.items():
        _, seg, n = k1_case(torch, cs, rng, dev, torch.float32, **kw)
        k = kw["k"]
        g = torch.randn(n, k, device=dev)
        wide = torch.randn(n, 2 * k, device=dev)[:, :k]  # strided
        for gi, tag in ((g, ""), (wide, ", strided g")):
            out = cs.segment_sum_vjp(gi, seg, n, dtype=dtype)
            torch.cuda.synchronize()
            ref = cs.segment_sum_vjp_plain(gi.contiguous(), seg, n, dtype)
            check(out.dtype == dtype and torch.equal(out, ref),
                  f"K4 {dname(dtype)} {name}{tag}: not equal to the plain "
                  f"version")
        print(f"K4 {dname(dtype)} edge case ok: {name} (equal)", flush=True)


def k4_main(torch, cs, dev, g, seg, dtype, label, timed: dict) -> dict:
    """Check K4 at one main-path shape, the result in ``dtype``; time the
    wrapper, the plain version and, for f32, ``index_select``."""
    n, k = g.shape
    out = cs.segment_sum_vjp(g, seg, n, dtype=dtype)
    torch.cuda.synchronize()
    ref = cs.segment_sum_vjp_plain(g, seg, n, dtype)
    check(torch.equal(out, ref), f"K4 {dname(dtype)} {label}: not equal")
    err = float((out.float() - ref.float()).abs().max())
    library_ms = None
    if dtype == torch.float32:
        ids = seg.long().clamp(0, n - 1)
        lib_out = torch.empty(seg.numel(), k, device=dev)
        library_ms = library_graph_ms(
            lambda: torch.index_select(g, 0, ids, out=lib_out))
    b_ms, b_by = bound(g.numel() * 4 + seg.numel() * 4
                       + seg.numel() * k * out.element_size(), 0)
    row = {
        **timed,
        "wrapper_ms": cuda_ms(
            torch, lambda: cs.segment_sum_vjp(g, seg, n, dtype=dtype)),
        "plain_ms": cuda_ms(
            torch, lambda: cs.segment_sum_vjp_plain(g, seg, n, dtype)),
        "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    print(f"K4 {dname(dtype)} at {label}: g {tuple(g.shape)} -> d "
          f"[{seg.numel()}, {k}]: {json.dumps(row)}", flush=True)
    return row


# ----------------------------------------- phases 9 and 13: GAT / PNA sites
def turns_us(probe, first, second) -> tuple:
    """CUDA-graph us per launch of two functions timed in turns, first,
    second, second, first (a drift of the card's clock between the two
    falls on both): (first's median, second's median, the four times)."""
    a1 = probe.graph_us(first)
    b1 = probe.graph_us(second)
    b2 = probe.graph_us(second)
    a2 = probe.graph_us(first)
    return (a1 + a2) / 2, (b1 + b2) / 2, [a1, b1, b2, a2]


def conv_site_rows(torch, cs, probe, dev, keys, n_seg, offs, gen,
                   where: str) -> dict:
    """K1, K4 and their pairs at one GAT / PNA use site: the stream's keys
    and offsets (derived once, as the aggregators derive them). K1 on
    [E, 64] and [E, 1] rows (PNA's sums; one column was GAT's den and
    PNA's count before they left K1), each as the function in CUDA graphs
    and the bare launch, in turns at one column (the function's time
    beyond its kernel); GAT's pair (num [E, 64] and den [E] in one K1
    launch) in turns with K1 on the [E, 64] rows alone; K4 to [E, 64]
    rows, and its pair (both cotangents in one launch) in turns with it.
    Each is checked: K1 and its pair against their plain versions (the
    pair also bit-equal to the separate launches), K4 and its pair equal
    to their plain versions."""
    rows = {}
    e = keys.shape[0]
    e_live = int(((keys >= 0) & (keys < n_seg)).sum())
    for k in (64, 1):
        msgs = torch.randn(e, k, device=dev, generator=gen)
        res = torch.empty(n_seg, k, device=dev)
        fn_us, k1_us, turns = turns_us(
            probe, lambda i: cs.sorted_segment_sum(msgs, keys, n_seg, offs),
            lambda i: cs.launch_k1(msgs, offs, n_seg, res))
        rows["k1", k] = k1_main(
            torch, cs, dev, msgs, keys, n_seg,
            f"the {where} GAT / PNA sums, K = {k}",
            {"ms": fn_us / 1e3, "kernel_only_ms": k1_us / 1e3,
             "turns_us": turns})
        if k == 64:
            msgs64, k1_64 = msgs, (res, k1_us)
    # GAT's num and den: one K1 launch against K1 on num's rows alone
    aux = torch.rand(e, device=dev, generator=gen)
    res, res_aux = torch.empty(n_seg, 64, device=dev), torch.empty(
        n_seg, device=dev)
    num, den = cs.sorted_segment_sum_pair(msgs64, aux, keys, n_seg, offs)
    torch.cuda.synchronize()
    check(torch.equal(num, cs.sorted_segment_sum(msgs64, keys, n_seg, offs))
          and torch.equal(den, cs.sorted_segment_sum(
              aux[:, None], keys, n_seg, offs)[:, 0]),
          f"K1 pair at the {where} site: not the two sums")
    plain = cs.sorted_segment_sum_pair_plain(msgs64, aux, keys, n_seg)
    pair_err = max(max_err(torch, num, plain[0], f"K1 pair num ({where})"),
                   max_err(torch, den, plain[1], f"K1 pair den ({where})"))
    pair_us, alone_us, turns = turns_us(
        probe, lambda i: cs.launch_k1_pair(msgs64, aux, offs, n_seg, res,
                                           res_aux),
        lambda i: cs.launch_k1(msgs64, offs, n_seg, k1_64[0]))
    b_ms, b_by = bound(e_live * 65 * 4 + e * 4 + n_seg * 65 * 4, e_live * 65)
    rows["k1_pair"] = {
        "ms": probe.graph_us(lambda i: cs.sorted_segment_sum_pair(
            msgs64, aux, keys, n_seg, offs)) / 1e3,
        "kernel_only_ms": pair_us / 1e3, "k1_alone_ms": alone_us / 1e3,
        "ratio_to_k1_alone": pair_us / alone_us, "turns_us": turns,
        "wrapper_ms": cuda_ms(torch, lambda: cs.sorted_segment_sum_pair(
            msgs64, aux, keys, n_seg, offs)),
        "plain_ms": cuda_ms(torch, lambda: cs.sorted_segment_sum_pair_plain(
            msgs64, aux, keys, n_seg)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": pair_err}
    print(f"K1 pair at the {where} GAT num + den: msgs [{e}, 64] + [{e}] -> "
          f"{n_seg} segments, equal to the two sums: "
          f"{json.dumps(rows['k1_pair'])}", flush=True)
    # their cotangents: K4 on [E, 64], and the pair in one launch
    g = torch.randn(n_seg, 64, device=dev, generator=gen)
    g_aux = torch.randn(n_seg, device=dev, generator=gen)
    d = torch.empty(e, 64, device=dev)
    d_aux = torch.empty(e, device=dev)
    pair_us, k4_us, turns = turns_us(
        probe, lambda i: cs.launch_k4_pair(g, g_aux, keys, n_seg, d, d_aux),
        lambda i: cs.launch_k4(g, keys, n_seg, d))
    rows["k4", 64] = k4_main(
        torch, cs, dev, g, keys, torch.float32,
        f"the {where} GAT / PNA sums' backward and PNA's gather, K = 64",
        {"ms": k4_us / 1e3, "kernel_only_ms": k4_us / 1e3})
    dd, dd_aux = cs.segment_sum_vjp_pair(g, g_aux, keys, n_seg)
    torch.cuda.synchronize()
    check(torch.equal(dd, cs.segment_sum_vjp(g, keys, n_seg))
          and torch.equal(dd_aux, cs.segment_sum_vjp(
              g_aux[:, None], keys, n_seg)[:, 0]),
          f"K4 pair at the {where} site: not the two gathers")
    plain = cs.segment_sum_vjp_pair_plain(g, g_aux, keys, n_seg)
    pair_err = max(float((dd - plain[0]).abs().max()),
                   float((dd_aux - plain[1]).abs().max()))
    check(torch.equal(dd, plain[0]) and torch.equal(dd_aux, plain[1]),
          f"K4 pair at the {where} site: not its plain version "
          f"(max err {pair_err:.3g})")
    b_ms, b_by = bound(n_seg * 65 * 4 + e * 4 + e * 65 * 4, 0)
    rows["k4_pair"] = {
        "ms": pair_us / 1e3, "kernel_only_ms": pair_us / 1e3,
        "k4_alone_ms": k4_us / 1e3, "ratio_to_k4_alone": pair_us / k4_us,
        "turns_us": turns,
        "wrapper_ms": cuda_ms(torch, lambda: cs.segment_sum_vjp_pair(
            g, g_aux, keys, n_seg)),
        "plain_ms": cuda_ms(torch, lambda: cs.segment_sum_vjp_pair_plain(
            g, g_aux, keys, n_seg)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": pair_err}
    print(f"K4 pair at the {where} GAT cotangents: g [{n_seg}, 64] + "
          f"[{n_seg}] -> [{e}, 64] + [{e}], equal to the two gathers: "
          f"{json.dumps(rows['k4_pair'])}", flush=True)
    return rows


# ------------------------------------------------------------ phase 2: K5
def k5_checks(torch, cs, probe, dev, seed: int) -> dict:
    """The four variants of the K5 probe against their plain versions on
    the bench edge stream at K = 128 and 64, and on a stream whose length
    no run divides; ``full`` bit-equal to K1. Returns {variant: error and
    plain-version ms at K = 128}."""
    rows = {}
    for k in (128, 64):
        msgs, seg, n = probe.bench_stream(dev, k, seed)
        streams = [(f"bench stream K={k}", msgs, seg, n),
                   (f"ragged tail K={k}", msgs[:99992], seg[:99992], 777)]
        for label, m, sg, ns in streams:
            m, sg = m.contiguous(), sg.contiguous()
            for name, fn in probe.VARIANTS.items():
                out = fn(m, sg, ns)
                torch.cuda.synchronize()
                ref = probe.PLAIN[name](m, sg, ns)
                if name == "stream":
                    check(torch.equal(out[1], ref[1]),
                          f"K5 stream {label}: check word {int(out[1])} != "
                          f"{int(ref[1])}")
                    out, ref = out[0], ref[0]
                if name == "full":
                    check(torch.equal(out, cs.sorted_segment_sum(
                        m, sg, ns, cs.segment_offsets(sg, ns))),
                          f"K5 full {label}: not bit-equal to K1")
                if name in ("noacc", "stream"):  # bit patterns and zeros
                    check(torch.equal(out, ref),
                          f"K5 {name} {label}: not equal to the plain version")
                    err = 0.0
                else:
                    err = max_err(torch, out, ref, f"K5 {name} {label}")
                if k == 128 and label.startswith("bench"):
                    rows[name] = {
                        "max_abs_err": err,
                        "plain_ms": cuda_ms(
                            torch, lambda: probe.PLAIN[name](m, sg, ns),
                            reps=10, warmup=2)}
            print(f"K5 variants ok on the {label}: msgs {tuple(m.shape)}, "
                  f"{ns} segments", flush=True)
    return rows


# ------------------------------------------------- phase 5: gradient check
def grad_errors(torch, loss_on, params, what: str,
                zero_below: float = 0.0, limit: float = 1e-4,
                zero_suffix: str = "") -> float:
    """Gradients of ``loss_on(params, device)`` on CUDA (kernels) against
    the CPU (plain versions): the largest error relative to its tensor's
    scale, which must stay within ``limit``. ``zero_below``: a tensor whose
    scale is under this fraction of the largest tensor's is measured
    against that floor instead (a gradient that is mathematically zero
    comes out as rounding noise on both sides). Tensors whose names end in
    ``zero_suffix`` have a gradient of exactly 0: their noise must stay
    under 1e-6 of the largest gradient on both sides."""
    grads = {}
    for dev in ("cuda", "cpu"):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        loss = loss_on(p, torch.device(dev))
        check(bool(torch.isfinite(loss)), f"{what}: loss on {dev} not finite")
        loss.backward()
        grads[dev] = {n: (q.grad if q.grad is not None
                          else torch.zeros_like(q)).cpu()
                      for n, q in p.named_parameters()}
        grads[dev]["(loss)"] = loss.detach().cpu().reshape(1)
    worst = 0.0
    top = max(float(r.abs().max()) for r in grads["cpu"].values())
    floor = zero_below * top
    for name, ref in grads["cpu"].items():
        if zero_suffix and name.endswith(zero_suffix):
            noise = max(float(ref.abs().max()),
                        float(grads["cuda"][name].abs().max()))
            check(noise <= 1e-6 * top, f"{what}: the gradient of {name}, "
                  f"exactly 0, is {noise:.3g} ({top:.3g} the largest)")
            continue
        scale = max(float(ref.abs().max()), floor)
        err = float((grads["cuda"][name] - ref).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        check(rel <= limit, f"{what}: gradient of {name} off by {rel:.3g} "
              f"of its scale {scale:.3g}")
        worst = max(worst, rel)
    return worst


# ------------------------------------------------------ phase 9: ablations
ORDER4_SET = "Syn_1827_test_max15"
ABLATION_CONVS = ("GIN", "GCN", "GAT", "PNA")
# per layer of the GAT and PNA aggregations: the K1 sums (PNA: the sum
# and the sum of squared deviations; its counts are the offsets apart),
# the K1 pairs (GAT: num and den in one launch), each with K4 (its pair)
# behind it, and the K4 gathers (PNA's mean back to the edges, K1 behind
# it)
CONV_SUMS = {"GAT": (0, 1, 0), "PNA": (2, 0, 1)}


def expected_conv_launches(conv: str, n_fwd: int, n_steps: int,
                           layers: int = 8) -> dict:
    """Launches of ``n_fwd`` ``forward_counts`` calls (both towers) or of
    ``n_steps`` train steps (forward and backward of both towers) at
    ``layers`` layers: GIN / GCN run K2 in the target tower and the
    gather-fused K1 in the query tower, GAT / PNA their K1 sums and pairs
    in both and neither K2 nor K3; every tower pools once (K1, and K4
    behind it in a train step)."""
    n = n_fwd + n_steps
    if conv in CONV_SUMS:
        s, pairs, gathers = CONV_SUMS[conv]
        return {"fused_typed_transform_aggregate": 0,
                "typed_aggregate_bwd": 0, "gather_segment_sum": 0,
                "gather_segment_sum_bwd": 0,
                "sorted_segment_sum": 2 * (n * (s * layers + 1)
                                           + n_steps * gathers * layers),
                "segment_sum_vjp": 2 * (n * gathers * layers
                                        + n_steps * (s * layers + 1)),
                "sorted_segment_sum_pair": 2 * n * pairs * layers,
                "segment_sum_vjp_pair": 2 * n_steps * pairs * layers}
    return {"fused_typed_transform_aggregate": layers * n,
            "typed_aggregate_bwd": layers * n_steps,
            "gather_segment_sum": layers * n,
            "gather_segment_sum_bwd": layers * n_steps,
            "sorted_segment_sum": 2 * n, "segment_sum_vjp": 2 * n_steps,
            "sorted_segment_sum_pair": 0, "segment_sum_vjp_pair": 0}


def typed_graph_ms(torch, cs, probe, case, dtype) -> tuple:
    """CUDA-graph times of K2 and K3 at ``case`` (as ``time_cases``
    times them): K2's function; K3's function and its kernel without the
    dW reduction launch."""
    x, w, st = case["x"].to(dtype), case["w"].to(dtype), case["st"]
    us = probe.graph_us(lambda i: cs.fused_typed_transform_aggregate(
        x, st.edge_src, st.keys, w, st.n_types, st.n_nodes, streams=st))
    g = case["g"]
    xp, wp = cs.pad_operands(x, w)
    dx = torch.empty_like(x)
    partial = torch.empty(
        (cs.k3_blocks(xp, wp, st), st.n_types,
         cs._tile_width(wp.shape[1]), cs._tile_width(wp.shape[2])),
        device=g.device)
    gt = g.to(dtype)
    k3_alone = probe.graph_us(
        lambda i: cs.launch_k3(gt, xp, wp, st, dx, partial))
    k3_fn = probe.graph_us(lambda i: cs.typed_aggregate_bwd(g, x, w, st))
    return ({"ms": us / 1e3, "kernel_only_ms": us / 1e3},
            {"ms": k3_fn / 1e3, "kernel_only_ms": k3_alone / 1e3})


def many_types_checks(torch, cs, probe, case, what: str) -> dict:
    """K2 and K3 at a stream of more types than one tile's buffers hold
    (``case``: x, w f32, g, streams with a permutation), f32 and bf16:
    against the plain versions (phase 2's tolerances), two runs
    bit-equal, CUDA-graph times, bound and yardstick (``k2_main``,
    ``k3_main``). {(kernel, dtype name): row}."""
    rows = {}
    x, w, g, st = case["x"], case["w"], case["g"], case["st"]
    t, h, k = w.shape
    for dtype in (torch.float32, torch.bfloat16):
        d = dname(dtype)
        xd, wd = x.to(dtype), w.to(dtype)
        tc = (cs.chunk_types(dtype, h, k, t),
              cs.chunk_types(dtype, h, k, t, backward=True))
        outs = [cs.fused_typed_transform_aggregate(
            xd, st.edge_src, st.keys, wd, t, st.n_nodes, streams=st)
            for _ in range(2)]
        bwds = [cs.typed_aggregate_bwd(g, xd, wd, st) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*outs) and torch.equal(bwds[0][0], bwds[1][0])
              and torch.equal(bwds[0][1], bwds[1][1]),
              f"K2 / K3 {d} at {what}: two runs are not bit-equal")
        timed2, timed3 = typed_graph_ms(torch, cs, probe, case, dtype)
        print(f"K2' / K3' {d} at {what}: {t} types in chunks of {tc[0]} "
              f"(K2') and {tc[1]} (K3'); two runs bit-equal", flush=True)
        rows["k2", d] = k2_main(torch, cs, x.device, case, dtype, timed2)
        rows["k3", d] = k3_main(torch, cs, x.device, case, dtype, timed3)
        rows["k2", d]["types_per_chunk"] = tc[0]
        rows["k3", d]["types_per_chunk"] = tc[1]
    return rows


def finite_figures(text: str, key: str) -> list:
    """The list printed after ``<key>: `` (a normed MSE or MAE per query
    size), which must be finite."""
    lines = [ln for ln in text.splitlines() if ln.startswith(key + ": ")]
    check(len(lines) == 1, f"no {key!r} line printed")
    vals = json.loads(lines[0].split(": ", 1)[1])
    check(len(vals) == 3 and all(np.isfinite(vals)),
          f"{key}: {vals} not three finite figures")
    return vals


def ablation_phase(torch, cs, probe, dev, seed: int, gen_root: str,
                   replay_root: str, work_dir: str, sb) -> dict:
    """Phase 9: K2' and K3' at T = 33, the four other conv types at the
    paper width, order 4, and the two ablation drivers and ``main
    --neigh_order 4`` on the card. ``gen_root`` holds Syn_1827 (phase
    8), ``replay_root`` the truth and samples of the replay set, ``sb``
    is a serving target batch (its shape for the synthetic 33-type
    stream). Returns what the record needs."""
    from desco_tpu_torch import ablation_gnns, ablation_wo_canonical
    from desco_tpu_torch import main as main_mod
    from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.models import neighborhood as neigh_mod
    from desco_tpu_torch.models.shmp_gnn import batch_typed_streams
    from desco_tpu_torch.pipeline import (
        PipelineConfig, build_query_batch, model_configs, prepare_stage_data)

    t9 = time.perf_counter()
    arng = np.random.default_rng(seed + 9)
    agen = torch.Generator(device=dev).manual_seed(seed + 9)

    def typed_inputs(st, n_rows, t):
        return {"x": torch.randn(n_rows, 64, device=dev, generator=agen),
                "w": torch.randn(t, 64, 64, device=dev, generator=agen)
                * 0.1,
                "g": torch.randn(st.n_nodes, 64, device=dev, generator=agen),
                "st": st}

    # (a) K2' and K3' at T = 33: a packed order-4 batch of Syn_1827_test
    # cut to graphs of at most 15 nodes (orbit typing is host Python),
    # and a random 33-type stream at the serving batch's shape
    o4_graphs = load_data(ORDER4_SET, gen_root)
    o4_wl = Workload(o4_graphs)
    o4_truth = o4_wl.compute_groundtruth(PipelineConfig().query_ids)
    o4_samples, _ = o4_wl.neighborhood_samples(4, order=4, truth=o4_truth)
    typing_s = o4_wl.typing_seconds
    o4_tb = pack_samples(o4_samples, *auto_capacities(o4_samples, g_cap=512),
                         n_queries=29)[0]
    o4_dev = o4_tb.to(dev, training=True)
    o4_case = typed_inputs(batch_typed_streams(o4_dev, 33), o4_dev.n_cap, 33)
    o4_case["x"] = o4_case["x"] * o4_dev.node_mask[:, None]
    print(f"order-4 typing of {ORDER4_SET}: {len(o4_graphs)} graphs, "
          f"{sum(g.n_nodes for g in o4_graphs)} nodes, {len(o4_samples)} "
          f"neighborhoods typed in {typing_s:.2f} s "
          f"({typing_s / len(o4_samples) * 1e3:.2f} s per 1000 "
          f"neighborhoods, host Python); first batch n_cap {o4_tb.n_cap}, "
          f"e_cap {o4_tb.e_cap}, "
          f"{len(np.unique(o4_tb.edge_type[o4_tb.edge_type < 33]))} of 33 "
          f"types present", flush=True)
    s_live = int((sb.edge_type != 63).sum())
    x33, src33, keys33, _ = k2_case(torch, arng, dev, torch.float32,
                                    sb.n_cap, 33, 64, 64, s_live,
                                    pad=sb.e_cap - s_live)
    syn_case = typed_inputs(
        k3_streams(torch, cs, dev, src33, keys33, 33, sb.n_cap), sb.n_cap, 33)
    syn_case["x"] = x33
    with torch.inference_mode():
        t33_rows = many_types_checks(torch, cs, probe, o4_case,
                                     f"the {ORDER4_SET} order-4 batch")
        t33_serving = many_types_checks(
            torch, cs, probe, syn_case,
            f"a 33-type stream at the serving batch's shape (n_cap "
            f"{sb.n_cap}, e_cap {sb.e_cap}, {s_live} live)")
    del syn_case, x33, src33, keys33

    # (b) GIN, GCN, GAT and PNA at the paper width on the first target
    # batches of the replay set (truth and samples from phase 8's caches)
    abl_cfg = PipelineConfig(data_root=replay_root, seed=seed)
    r40_stage = prepare_stage_data(abl_cfg, load_data(REPLAY_SET,
                                                      replay_root),
                                   name=REPLAY_SET, need_truth=True)
    conv_batches = r40_stage.batches[:2]
    qb_abl = build_query_batch(abl_cfg)
    abl_launches = {k: 0 for k in cs.read_launches()}

    # K1, K4 and their pairs at GAT's and PNA's use sites, over the N*T
    # (dst, type) keys of the first target batch (6 types)
    site = conv_batches[0].to(dev)
    keys6 = (site.edge_dst.int() * 6 + site.edge_type.int()).contiguous()
    n_seg6 = site.n_cap * 6
    with torch.inference_mode():
        site_rows = conv_site_rows(
            torch, cs, probe, dev, keys6, n_seg6,
            cs.segment_offsets(keys6, n_seg6), agen,
            f"packed ({REPLAY_SET} batch 0)")

    def add_launches(got):
        for key, n in got.items():
            abl_launches[key] += n

    def same_seed_grads(params, tgt, qry, batch):
        """Whether two train steps from the same weights on ``batch`` give
        bit-equal gradients on the card, and the tensors that differ."""
        b_dev, q_dev = batch.to(dev, training=True), qb_abl.to(dev)
        grads = []
        for _ in range(2):
            p = copy.deepcopy(params).to(dev).requires_grad_(True)
            neigh_mod.train_loss(p, tgt, qry, b_dev, q_dev).backward()
            grads.append({n: q.grad for n, q in p.named_parameters()
                          if q.grad is not None})
        return [n for n, gr in grads[0].items()
                if not torch.equal(gr, grads[1][n])]

    conv_report = {}
    for conv in ABLATION_CONVS:
        t0 = time.perf_counter()
        ccfg = dataclasses.replace(abl_cfg, conv_type=conv)
        tgt_c, qry_c = model_configs(ccfg, dev)
        tgt_h, qry_h = model_configs(ccfg, "cpu")
        check((tgt_c.layer_num, tgt_c.hidden_dim, tgt_c.n_edge_types,
               tgt_c.conv_type, qry_c.conv_type, len(ccfg.query_ids)) ==
              (8, 64, 6, conv, conv, 29), f"{conv}: not at the paper width")
        params_c = neigh_mod.init_neighborhood_model(
            tgt_c, qry_c, torch.Generator().manual_seed(seed))
        p_dev = copy.deepcopy(params_c).to(dev)
        cs.reset_launches()
        with torch.inference_mode():
            preds = [neigh_mod.forward_counts(p_dev, tgt_c, qry_c, b.to(dev),
                                              qb_abl.to(dev)).cpu()
                     for b in conv_batches]
            torch.cuda.synchronize()
            fwd_l = cs.read_launches()
            preds_h = [neigh_mod.forward_counts(params_c, tgt_h, qry_h,
                                                b.to("cpu"), qb_abl.to("cpu"))
                       for b in conv_batches]
        rel = max(close_counts(
            np.exp2(a.numpy()[b.graph_mask > 0]) - 1,
            np.exp2(h.numpy()[b.graph_mask > 0]) - 1,
            f"{conv} forward, CUDA vs CPU")
            for a, h, b in zip(preds, preds_h, conv_batches))
        cs.reset_launches()
        # GAT's a_src in the query tower has a gradient of exactly 0 (all
        # query nodes start from one row, so a segment's logits are
        # equal and its softmax does not depend on a_src): rounding
        # noise, 1e-19, on both sides
        worst = grad_errors(torch, lambda p, d: neigh_mod.train_loss(
            p, tgt_c, qry_c, conv_batches[0].to(d, training=True),
            qb_abl.to(d)), params_c, f"{conv} train_loss",
            zero_below=1e-9)
        step_l = cs.read_launches()
        for got, want, what in (
                (fwd_l, expected_conv_launches(conv, len(conv_batches), 0),
                 "forward"),
                (step_l, expected_conv_launches(conv, 0, 1), "train step")):
            bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
            check(not bad, f"{conv} {what}: launches (got, expected) "
                  f"{bad}")
            add_launches(got)
        differ = same_seed_grads(params_c, tgt_c, qry_c, conv_batches[0])
        if conv in ("GIN", "GCN"):
            check(not differ, f"{conv}: two same-seed train steps gave "
                  f"different gradients in {differ}")
        conv_report[conv] = {"max_count_rel": rel, "grad_rel": worst,
                             "same_seed_equal": not differ}
        print(f"{conv} at paper width: {len(conv_batches)} target batches "
              f"of {REPLAY_SET} (n_cap {conv_batches[0].n_cap}) forward, "
              f"counts CUDA vs CPU within {rel:.3g} (rtol 1e-3); one train "
              f"step, gradients within {worst:.3g} of a tensor's scale; "
              f"launches forward {json.dumps(fwd_l)}, train step "
              f"{json.dumps(step_l)} (as predicted); two same-seed train "
              f"steps bit-equal: {not differ}"
              f"{'; differ: ' + ', '.join(differ) if differ else ''} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # order 4 (33 types, SAGE) through a train step: CUDA vs CPU, and two
    # same-seed steps bit-equal
    o4_cfg = dataclasses.replace(abl_cfg, order=4)
    tgt_4, qry_4 = model_configs(o4_cfg, dev)
    check(tgt_4.n_edge_types == 33 and tgt_4.agg_mode == "kernel",
          "the order-4 target tower is not 33 types on the kernel")
    params_4 = neigh_mod.init_neighborhood_model(
        tgt_4, qry_4, torch.Generator().manual_seed(seed))
    # K2' and K3' multiply in split TF32, 2^-21 of each product where
    # f32 keeps 2^-24: at T = 6 this check sits at 1e-4 (phase 5), and 33
    # types sum 5.5 times the products into each row, so 1e-3 here (two
    # f32 paths on the CPU agree to 8e-7 at this batch)
    cs.reset_launches()
    worst4 = grad_errors(torch, lambda p, d: neigh_mod.train_loss(
        p, tgt_4, qry_4, o4_tb.to(d, training=True), qb_abl.to(d)),
        params_4, "order-4 train_loss", limit=1e-3)
    o4_l = cs.read_launches()
    check(o4_l["fused_typed_transform_aggregate"] == 8
          and o4_l["typed_aggregate_bwd"] == 8,
          f"order-4 train step launches {o4_l}: K2 and K3 not 8 each")
    differ = same_seed_grads(params_4, tgt_4, qry_4, o4_tb)
    check(not differ, f"order 4: two same-seed train steps gave different "
          f"gradients in {differ}")
    print(f"order 4 (33 types) train step on the {ORDER4_SET} batch: "
          f"gradients CUDA vs CPU within {worst4:.3g} of a tensor's scale; "
          f"K2 and K3 8 launches each; two same-seed steps bit-equal",
          flush=True)

    # (c) the ablation entry points, in this process, 2 epochs each
    abl_dir = os.path.join(work_dir, "ablations")

    def run_entry(fn, argv, what, own_rows=False):
        """Run an entry point in this process; its launches join the
        ablation path's unless ``own_rows`` (the order-4 run: K2' and K3'
        at T = 33 have rows of their own in the record)."""
        cs.reset_launches()
        t0 = time.perf_counter()
        rc, out = run_teed(fn, argv + [
            "--neigh_epoch_num", "2", "--seed", str(seed),
            "--data_root", replay_root,
            "--output_dir", os.path.join(abl_dir, what),
            "--neigh_model_path", os.path.join(abl_dir, what, "neigh")])
        got = cs.read_launches()
        check(rc == 0, f"{what} returned {rc}")
        check("(device cuda)" in out, f"{what} did not run on CUDA")
        if not own_rows:
            add_launches(got)
        return out, got, time.perf_counter() - t0

    on_r40 = ["--train_dataset", REPLAY_SET, "--valid_dataset", REPLAY_SET,
              "--test_dataset", REPLAY_SET]
    gnn_out, gnn_l, gnn_s = run_entry(
        ablation_gnns.main, ["--train_neigh", "--neigh_conv_type", "GIN"]
        + on_r40, "ablation_gnns")
    gnn_mse = finite_figures(gnn_out, "graphlet_norm_mse_neighborhood")
    check(gnn_l["fused_typed_transform_aggregate"] > 0
          and gnn_l["typed_aggregate_bwd"] > 0
          and gnn_l["gather_segment_sum"] > 0,
          f"ablation_gnns (GIN, one edge type) launches {gnn_l}")
    wo_out, wo_l, wo_s = run_entry(ablation_wo_canonical.main, on_r40,
                                    "ablation_wo_canonical")
    wo_mse = finite_figures(wo_out, "wo_canonical graphlet_norm_mse")
    check(wo_l["gather_segment_sum"] > 0 and wo_l["gather_segment_sum_bwd"] > 0
          and wo_l["fused_typed_transform_aggregate"] == 0,
          f"ablation_wo_canonical launches {wo_l}: the whole-graph towers "
          f"aggregate through the gather-fused K1 only")
    o4_out, o4_launches, o4_s = run_entry(
        main_mod.main, ["--train_neigh", "--neigh_order", "4",
                        "--train_dataset", ORDER4_SET, "--valid_dataset",
                        ORDER4_SET, "--test_dataset", ORDER4_SET],
        "main_order4", own_rows=True)
    o4_mse = finite_figures(o4_out, "graphlet_norm_mse_neighborhood")
    check(o4_launches["fused_typed_transform_aggregate"] > 0
          and o4_launches["typed_aggregate_bwd"] > 0,
          f"main --neigh_order 4 launches {o4_launches}")
    typing_lines = [ln for ln in o4_out.splitlines()
                    if ln.startswith("[timing] order-4 orbit typing")]
    check(len(typing_lines) == 1, "main printed no orbit-typing seconds")
    print(f"ablation entry points: ablation_gnns GIN {gnn_s:.1f} s, "
          f"normed MSE {gnn_mse}, "
          f"launches {json.dumps(gnn_l)}; ablation_wo_canonical "
          f"{wo_s:.1f} s, normed MSE {wo_mse}, launches {json.dumps(wo_l)}; "
          f"main --neigh_order 4 on {ORDER4_SET} {o4_s:.1f} s, normed MSE "
          f"{o4_mse}, {typing_lines[0]}, launches "
          f"{json.dumps(o4_launches)}", flush=True)
    print(f"phase 9 (ablations) took {time.perf_counter() - t9:.1f} s",
          flush=True)
    return {"t33_rows": t33_rows, "t33_serving": t33_serving,
            "abl_launches": abl_launches, "o4_launches": o4_launches,
            "site_rows": site_rows}


# ------------------------------------------- phase 10: the rest of serving
LABELED_SET = ORDER4_SET
N_LABELS = 2
DIAMNET_LAYERS = 3
# launches of one DIAMNet forward (both towers) and of one train step:
# the graph tower's 3 GIN layers on K2 at one edge type, the pattern
# tower's on the gather-fused K1; a train step adds their backwards (K3,
# the gather-fused K1's backward); no pooling (per-node output)
DIAMNET_FWD = {"fused_typed_transform_aggregate": DIAMNET_LAYERS,
               "gather_segment_sum": DIAMNET_LAYERS,
               "typed_aggregate_bwd": 0, "gather_segment_sum_bwd": 0,
               "sorted_segment_sum": 0, "segment_sum_vjp": 0}
DIAMNET_STEP = {**DIAMNET_FWD, "typed_aggregate_bwd": DIAMNET_LAYERS,
                "gather_segment_sum_bwd": DIAMNET_LAYERS}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def json_line(text: str, key: str, value) -> dict:
    """The one JSON line of ``text`` whose ``key`` is ``value``."""
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{") and f'"{key}": "{value}"' in ln]
    check(len(lines) == 1, f"no single JSON line with {key}={value}")
    return lines[0]


def labeled_part(torch, cs, dev, seed: int, gen_root: str,
                 work_dir: str) -> dict:
    """(a) Labeled mode at paper width on LABELED_SET: labeled truth and
    featured samples, 2 epochs of the neighborhood stage from scratch
    over the 784 expanded queries, then one request served from the
    checkpoint it wrote, CUDA against the CPU."""
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.pipeline import (
        PipelineConfig, build_query_batch, pipeline_queries,
        prepare_stage_data, stage_bounds, train_neighborhood_stage,
        verify_tail_counts)
    from desco_tpu_torch.serving import CountingService
    from desco_tpu_torch.train import loop as train_loop
    from desco_tpu_torch.truth.bounds import clamp_counts

    lrng = np.random.default_rng(seed + 10)
    eye = np.eye(N_LABELS, dtype=np.float32)
    graphs = [Graph(g.n_nodes, g.edges, eye[lrng.integers(0, N_LABELS,
                                                          g.n_nodes)])
              for g in load_data(LABELED_SET, gen_root)]
    cfg = PipelineConfig(use_node_feature=True, neigh_input_dim=N_LABELS,
                         neigh_epochs=2, seed=seed,
                         data_root=os.path.join(work_dir, "labeled"))
    queries = pipeline_queries(cfg)
    check(len(queries) == 784, f"{len(queries)} labeled queries, not 784")
    t0 = time.perf_counter()
    Workload(graphs, root=os.path.join(cfg.data_root, LABELED_SET),
             name=LABELED_SET).compute_groundtruth_labeled(queries)
    truth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage = prepare_stage_data(cfg, graphs, name=LABELED_SET,
                               need_truth=True)
    samples_s = time.perf_counter() - t0
    n_nodes = sum(g.n_nodes for g in graphs)
    check(stage.truth.shape == (n_nodes, 784)
          and all(s.x.shape[1] == N_LABELS for s in stage.samples),
          "labeled stage: truth or sample features malformed")
    print(f"labeled mode: {LABELED_SET} with {N_LABELS} labels from the "
          f"seed, {len(graphs)} graphs, {n_nodes} nodes, "
          f"{len(stage.samples)} neighborhoods in {len(stage.batches)} "
          f"batches; labeled truth for 784 queries {truth_s:.2f} s, "
          f"featured samples {samples_s:.2f} s", flush=True)
    ckpt = os.path.join(work_dir, "labeled", "neigh")
    t0 = time.perf_counter()
    res, _, _ = train_neighborhood_stage(
        cfg, stage, stage, build_query_batch(cfg), ckpt_path=ckpt,
        device=dev, log_fn=lambda line: print(f"  {line}", flush=True))
    train_s = time.perf_counter() - t0
    check(np.isfinite(res.train_losses).all()
          and np.isfinite(res.val_losses).all(),
          f"labeled training losses not finite: {res.train_losses}")
    svc = CountingService(ckpt + ".best", device=dev)
    check(svc.cfg.use_node_feature and svc.tgt_cfg.input_dim == N_LABELS
          and (svc.tgt_cfg.layer_num, svc.tgt_cfg.hidden_dim,
               svc.tgt_cfg.n_edge_types) == (8, 64, 6)
          and tuple(svc.member_embs[0].shape) == (784, 64),
          "the labeled service did not rehydrate the paper-width labeled "
          "config")
    # one request: the labeled graphs; host prep twice (pin the buckets)
    for _ in range(2):
        req_stage = prepare_stage_data(svc.cfg, graphs,
                                       capacities=svc._select_neigh_caps)
    n_tb = len(req_stage.batches)
    cs.reset_launches()
    t0 = time.perf_counter()
    out = svc.count(graphs)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    launches = cs.read_launches()
    # no gossip model: the node counts are the stage-1 counts, which a
    # de-log 2^pred - 1 leaves a little under 0 where pred < 0
    for name in ("graphlet_counts", "node_counts", "neighborhood_counts"):
        check(np.isfinite(getattr(out, name)).all(),
              f"labeled request: non-finite {name}")
    check((out.graphlet_counts >= 0).all(),
          "labeled request: negative graphlet counts")
    check(out.graphlet_counts.shape == (len(graphs), 784),
          f"labeled request: counts {out.graphlet_counts.shape}")
    rows = out.verified_rows
    truth_rows = stage.truth[stage.nindex.indicator]
    check(len(rows) > 0 and np.array_equal(out.neighborhood_counts[rows],
                                           truth_rows[rows]),
          "labeled request: verified rows differ from the labeled truth")
    want = {"fused_typed_transform_aggregate": 8 * n_tb,
            "sorted_segment_sum": n_tb, "gather_segment_sum": 0,
            "typed_aggregate_bwd": 0, "segment_sum_vjp": 0,
            "gather_segment_sum_bwd": 0}
    bad = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    check(not bad, f"labeled request launches (got, expected): {bad}")
    # host seconds of the guards on the same request
    counts = train_loop.predict_neighborhood_counts(
        svc.members[0], svc.tgt_cfg, svc.member_embs[0], req_stage.batches,
        dev)
    t0 = time.perf_counter()
    ubs = stage_bounds(req_stage, svc.cfg, device=dev)
    bounds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ver = verify_tail_counts(clamp_counts(counts, ubs), req_stage,
                                svc.cfg)
    verify_s = time.perf_counter() - t0
    # CUDA against the port on the CPU, without the tail recount
    nov = {"verify_budget": 0.0}
    on = {d: CountingService(ckpt + ".best", device=d,
                             config_overrides=nov).count(graphs)
          for d in ("cuda", "cpu")}
    rel = close_counts(on["cuda"].neighborhood_counts,
                       on["cpu"].neighborhood_counts,
                       "labeled request, CUDA vs CPU")
    print(f"labeled serving at paper width (8 layers, hidden 64, 6 types, "
          f"784 queries): trained {cfg.neigh_epochs} epochs in "
          f"{train_s:.1f} s (loss {res.train_losses[0]:.4f} -> "
          f"{res.train_losses[-1]:.4f}); request of {len(graphs)} graphs "
          f"in {n_tb} target batches {request_ms:.1f} ms, "
          f"{len(rows)} rows verified equal to the labeled truth; host "
          f"seconds: truth {truth_s:.2f}, bounds {bounds_s:.2f}, "
          f"verification {verify_s:.2f} ({len(ver)} rows); CUDA vs CPU "
          f"within {rel:.3g} (rtol 1e-3); launches {json.dumps(launches)}",
          flush=True)
    return {"launches": launches, "request_ms": request_ms,
            "truth_s": truth_s, "bounds_s": bounds_s, "verify_s": verify_s,
            "train_s": train_s}


def ensemble_part(torch, cs, dev, svc, request, second: str) -> dict:
    """(b) Ensembles: a one-member list is the single path bit for bit; a
    two-member ensemble (release/r4 and ``second``, a checkpoint of r4's
    config) without the guards equals the log-space mean of the two
    single services; with every guard it serves the request."""
    from desco_tpu_torch.pipeline import prepare_stage_data
    from desco_tpu_torch.serving import CountingService

    one = CountingService([R4_NEIGH], R4_GOSSIP, device=dev)
    a, b = one.count(request), svc.count(request)
    for name in ("graphlet_counts", "node_counts", "neighborhood_counts",
                 "verified_rows"):
        check(np.array_equal(getattr(a, name), getattr(b, name)),
              f"[release/r4] differs from release/r4 in {name}")
    raw = {"clamp_counts": False, "verify_budget": 0.0}
    singles = [CountingService(p, R4_GOSSIP, device=dev,
                               config_overrides=raw).count(
                                   request, refine=False).neighborhood_counts
               for p in (R4_NEIGH, second)]
    ens = CountingService([R4_NEIGH, second], R4_GOSSIP, device=dev,
                          config_overrides=raw)
    n_tb = len(prepare_stage_data(
        ens.cfg, request, capacities=ens._select_neigh_caps).batches)
    cs.reset_launches()
    got = ens.count(request, refine=False).neighborhood_counts
    launches = cs.read_launches()
    check(launches["fused_typed_transform_aggregate"] == 2 * 8 * n_tb,
          f"ensemble launches {launches}: K2 not 8 x {n_tb} target "
          f"batches per member")
    want = np.exp2(np.mean([np.log2(np.maximum(c, 0.0) + 1.0)
                            for c in singles], axis=0)) - 1.0
    # without the clamp a count may overflow to inf in both
    fin = np.isfinite(want)
    check(np.array_equal(fin, np.isfinite(got))
          and np.array_equal(got[~fin], want[~fin]),
          "the ensemble and the log-space mean overflow in other places")
    rel = float((np.abs(got[fin] - want[fin])
                 / np.maximum(np.abs(want[fin]), 1.0)).max(initial=0.0))
    check(rel <= 1e-6, f"the ensemble is {rel:.3g} from the log-space mean "
          f"of its members")
    check(not np.array_equal(singles[0], singles[1]),
          "the two ensemble members predict alike")
    full = CountingService([R4_NEIGH, second], R4_GOSSIP, device=dev)
    check_counts(full.count(request), len(request), "two-member ensemble")
    print(f"ensembles: [release/r4] bit-equal to release/r4; [r4, phase-7 "
          f"checkpoint] within {rel:.3g} of the log-space mean of the two "
          f"single services (bit-equal: {bool(np.array_equal(got, want))}); "
          f"K2 {launches['fused_typed_transform_aggregate']} launches for "
          f"{n_tb} target batches x 2 members; the guarded ensemble served "
          f"{len(request)} graphs", flush=True)
    return {"launches": launches}


def tcp_part(svc, request) -> None:
    """(c) ``python -m desco_tpu_torch.serve --tcp``: one request over a
    localhost socket answers what ``CountingService.count`` answers."""
    import socket
    import threading

    def start():
        """(process, port, seconds to listening, or None where another
        process took the free port before the daemon bound it). A thread
        reads the daemon's stderr: a buffered readline behind a select
        can take both of its lines at once and then wait on an empty
        pipe."""
        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "desco_tpu_torch.serve", "--neigh_ckpt",
             R4_NEIGH, "--gossip_ckpt", R4_GOSSIP, "--tcp",
             f"127.0.0.1:{port}"], cwd=REPO, stderr=subprocess.PIPE,
            text=True)
        lines = []

        def read():
            for line in proc.stderr:
                lines.append(line)

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        t0 = time.perf_counter()
        try:
            while not any("listening on" in ln for ln in list(lines)):
                if proc.poll() is not None:
                    reader.join(timeout=10)
                    seen = "".join(lines)
                    if "Address already in use" in seen:
                        return proc, port, None
                    fail(f"the TCP daemon exited (code {proc.returncode}) "
                         f"before listening: {seen[-2000:]}")
                check(time.perf_counter() - t0 < 300,
                      f"the TCP daemon is not listening after 300 s: "
                      f"{''.join(lines)[-2000:]}")
                time.sleep(0.1)
        except BaseException:
            proc.kill()
            raise
        return proc, port, time.perf_counter() - t0

    for attempt in range(3):
        proc, port, ready_s = start()
        if ready_s is not None:
            break
        print(f"daemon --tcp: port {port} was taken before the daemon "
              f"bound it; another port", flush=True)
    check(ready_s is not None, "the TCP daemon found no free port in 3 tries")
    try:
        req = {"id": 10, "graphs": [{"n": g.n_nodes,
                                     "edges": g.edges.tolist()}
                                    for g in request]}
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", port), timeout=300) as c:
            rf, wf = c.makefile("r"), c.makefile("w")
            wf.write(json.dumps(req) + "\nquit\n")
            wf.flush()
            reply = json.loads(rf.readline())
        reply_s = time.perf_counter() - t0
    finally:
        proc.kill()
        proc.wait(timeout=60)
    want = svc.count(request)
    check(reply.get("id") == 10 and "error" not in reply
          and np.array_equal(np.asarray(reply["graphlet_counts"]),
                             want.graphlet_counts)
          and reply["verified"] == len(want.verified_rows),
          f"the TCP daemon's answer differs from CountingService.count: "
          f"{str(reply)[:500]}")
    print(f"daemon --tcp: listening after {ready_s:.1f} s (process start, "
          f"kernel load, query tower), one {len(request)}-graph request "
          f"answered in {reply_s:.2f} s, equal to CountingService.count",
          flush=True)


def baselines_part(torch, cs, probe, dev, seed: int, replay_root: str,
                   sb) -> dict:
    """(d) The baselines: both drivers at their defaults for 2 epochs on
    the replay set; a DIAMNet forward and a train step at full width on
    two batches, CUDA against the CPU, launches as predicted, two
    same-seed steps bit-equal; K2' and K3' at one edge type against their
    plain versions, timed."""
    from desco_tpu_torch import baseline as base_mod
    from desco_tpu_torch.batch.build import query_sample
    from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import gen_queries, gen_query_ids
    from desco_tpu_torch.models import baseline_diamnet as bd
    from desco_tpu_torch.models.diamnet import DIAMNetConfig
    from desco_tpu_torch.models.shmp_gnn import batch_typed_streams

    drivers = {}
    driver_launches = {k: 0 for k in cs.read_launches()}
    for kind in ("DIAMNET", "LRP"):
        cs.reset_launches()
        t0 = time.perf_counter()
        rc, out = run_teed(base_mod.main, [
            "--baseline", kind, "--train_dataset", REPLAY_SET,
            "--test_dataset", REPLAY_SET, "--epoch_num", "2", "--seed",
            str(seed), "--data_root", replay_root])
        wall = time.perf_counter() - t0
        got = cs.read_launches()
        check(rc == 0 and f"(device {dev})" in out,
              f"baseline {kind} returned {rc} or not on the card")
        line = json_line(out, "baseline", kind)
        check(len(line["norm_mse"]) == 3 and np.isfinite(
            line["norm_mse"]).all(), f"baseline {kind}: normed MSE "
            f"{line['norm_mse']} not three finite figures")
        # the reference was computed for seed 0 (the default)
        ref = BASELINE_REFERENCE[kind] if seed == 0 else {}
        rel = max((float(np.max(np.abs(np.asarray(line[k]) - ref[k])
                                / np.abs(ref[k]))) for k in ref),
                  default=float("nan"))
        check(not ref or rel <= BASELINE_RTOL[kind], f"baseline {kind}: "
              f"normed MSE {line['norm_mse']} / MAE {line['mae']} are "
              f"{rel:.3g} from desco_tpu's {ref} (rtol "
              f"{BASELINE_RTOL[kind]})")
        if kind == "DIAMNET":
            check(got["fused_typed_transform_aggregate"] > 0
                  and got["typed_aggregate_bwd"] > 0
                  and got["gather_segment_sum"] > 0,
                  f"baseline DIAMNET launches {got}")
        for key, n in got.items():
            driver_launches[key] += n
        drivers[kind] = {"wall_s": wall, "norm_mse": line["norm_mse"],
                         "vs_desco_tpu": rel, "launches": got}
        print(f"baseline {kind} at its defaults, 2 epochs on {REPLAY_SET}: "
              f"{wall:.1f} s, normed MSE {line['norm_mse']} (MAE "
              f"{line['mae']}; {rel:.3g} from desco_tpu's from the same "
              f"weights), launches {json.dumps(got)}", flush=True)

    # DIAMNet at full width (hidden 64, 3 GIN layers, 4 heads, memory 4)
    qids = gen_query_ids([3, 4, 5])
    graphs = load_data(REPLAY_SET, replay_root)
    wl = Workload(graphs, root=os.path.join(replay_root, REPLAY_SET),
                  name=REPLAY_SET)
    samples = wl.wo_canonical_samples(qids, use_tconv=False,
                                      truth=wl.compute_groundtruth(qids))
    batches = pack_samples(samples, *auto_capacities(samples, g_cap=64),
                           n_queries=29)[:2]
    qs = [query_sample(q, use_tconv=False) for q in gen_queries(qids)]
    [qb] = pack_samples(qs, *auto_capacities(qs, g_cap=len(qs)))
    gcfg = bd.diamnet_tower_config(64, DIAMNET_LAYERS, agg_mode="kernel")
    pcfg = bd.diamnet_tower_config(64, DIAMNET_LAYERS)
    dn = DIAMNetConfig()
    params = bd.init_diamnet_pipeline(pcfg, dn,
                                      torch.Generator().manual_seed(seed))
    # DIAMNet's output layer starts at zero: a fresh model predicts 0 and
    # no other weight has a gradient. Drawn at random here, so that the
    # checks below see the whole network
    head, hgen = params["diamnet"]["pred2"], torch.Generator().manual_seed(
        seed + 11)
    with torch.no_grad():
        for t in (head.w, head.b):
            t.copy_(torch.randn(t.shape, generator=hgen) * 0.3)
    seq_len = max(int(np.bincount(b.node_graph[b.node_mask > 0]).max())
                  for b in batches)
    pos = [torch.as_tensor(bd.node_positions(b)) for b in batches]
    q_pos = torch.as_tensor(bd.node_positions(qb))

    def forward(p, b, bpos, d):
        return bd.diamnet_forward(p, gcfg, pcfg, dn, b.to(d), bpos.to(d),
                                  seq_len, qb.to(d), q_pos.to(d), 5)

    def loss_on(p, d, i=0):
        return bd.diamnet_train_loss(
            p, gcfg, pcfg, dn, batches[i].to(d, training=True),
            pos[i].to(d), seq_len, qb.to(d), q_pos.to(d), 5)

    p_dev = copy.deepcopy(params).to(dev)
    cs.reset_launches()
    with torch.inference_mode():
        preds = [forward(p_dev, b, bp, dev).cpu()
                 for b, bp in zip(batches, pos)]
        torch.cuda.synchronize()
        fwd_l = cs.read_launches()
        preds_h = [forward(params, b, bp, "cpu")
                   for b, bp in zip(batches, pos)]
    rel = max(close_counts(
        np.exp2(a.numpy()[b.graph_mask > 0]) - 1,
        np.exp2(h.numpy()[b.graph_mask > 0]) - 1,
        "DIAMNet forward, CUDA vs CPU")
        for a, h, b in zip(preds, preds_h, batches))
    cs.reset_launches()
    # the key layer norms' biases have a gradient of exactly 0 (a bias on
    # every key shifts a query's logits by one constant, which the softmax
    # cancels): rounding noise on both sides
    worst = grad_errors(torch, loss_on, params, "DIAMNet train_loss",
                        zero_suffix="ln_k.1")
    step_l = cs.read_launches()
    for got, want, what in ((fwd_l, {k: n * len(batches)
                                     for k, n in DIAMNET_FWD.items()},
                             "forward"), (step_l, DIAMNET_STEP,
                                          "train step")):
        bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        check(not bad, f"DIAMNet {what}: launches (got, expected) {bad}")
    grads = []
    for _ in range(2):
        p = copy.deepcopy(params).to(dev).requires_grad_(True)
        loss_on(p, dev).backward()
        grads.append({n: q.grad for n, q in p.named_parameters()})
    differ = [n for n, g in grads[0].items() if not torch.equal(g, grads[1][n])]
    check(not differ, f"DIAMNet: two same-seed train steps differ in "
          f"{differ}")
    print(f"DIAMNet at full width (hidden 64, {DIAMNET_LAYERS} GIN layers, "
          f"4 heads, memory 4) on {len(batches)} whole-graph batches of "
          f"{REPLAY_SET} (n_cap {batches[0].n_cap}): counts CUDA vs CPU "
          f"within {rel:.3g} (rtol 1e-3); train step gradients within "
          f"{worst:.3g} of a tensor's scale; launches forward "
          f"{json.dumps(fwd_l)}, train step {json.dumps(step_l)} (as "
          f"predicted); two same-seed train steps bit-equal", flush=True)

    # K2' and K3' at one edge type: the graph tower's batch, and a random
    # one-type stream at the serving batch's shape
    agen = torch.Generator(device=dev).manual_seed(seed + 10)
    b_dev = batches[0].to(dev, training=True)
    st = batch_typed_streams(b_dev, 1)
    case = {"x": torch.randn(b_dev.n_cap, 64, device=dev, generator=agen)
            * b_dev.node_mask[:, None],
            "w": torch.randn(1, 64, 64, device=dev, generator=agen) * 0.1,
            "g": torch.randn(b_dev.n_cap, 64, device=dev, generator=agen),
            "st": st}
    arng = np.random.default_rng(seed + 10)
    s_live = int((sb.edge_type != 63).sum())
    x1, src1, keys1, w1 = k2_case(torch, arng, dev, torch.float32,
                                  sb.n_cap, 1, 64, 64, s_live,
                                  pad=sb.e_cap - s_live)
    syn = {"x": x1, "w": w1,
           "g": torch.randn(sb.n_cap, 64, device=dev, generator=agen),
           "st": k3_streams(torch, cs, dev, src1, keys1, 1, sb.n_cap)}
    with torch.inference_mode():
        t1_rows = many_types_checks(
            torch, cs, probe, case,
            f"the DIAMNet graph tower's batch of {REPLAY_SET} (n_cap "
            f"{b_dev.n_cap}, one edge type)")
        t1_serving = many_types_checks(
            torch, cs, probe, syn,
            f"a one-type stream at the serving batch's shape (n_cap "
            f"{sb.n_cap}, e_cap {sb.e_cap}, {s_live} live)")
    return {"drivers": drivers, "driver_launches": driver_launches,
            "t1_rows": t1_rows, "t1_serving": t1_serving,
            "count_rel": rel, "grad_rel": worst}


def serving_rest_phase(torch, cs, probe, dev, seed: int, gen_root: str,
                       replay_root: str, work_dir: str, svc, request,
                       second: str, sb) -> dict:
    """Phase 10: labeled mode, checkpoint ensembles, the daemon's TCP
    mode and the DIAMNet and LRP baselines on the card. ``svc`` is the
    release/r4 service, ``request`` a list of graphs, ``second`` a
    neighborhood checkpoint of r4's config (phase 7's), ``sb`` a serving
    target batch (its shape for the one-type stream)."""
    t10 = time.perf_counter()
    lab = labeled_part(torch, cs, dev, seed, gen_root, work_dir)
    ens = ensemble_part(torch, cs, dev, svc, request, second)
    tcp_part(svc, request)
    base = baselines_part(torch, cs, probe, dev, seed, replay_root, sb)
    serving_launches = {k: lab["launches"][k] + ens["launches"][k]
                        for k in lab["launches"]}
    print(f"phase 10 (the rest of serving, the baselines) took "
          f"{time.perf_counter() - t10:.1f} s", flush=True)
    return {"serving_launches": serving_launches, **base,
            "labeled": {k: v for k, v in lab.items() if k != "launches"}}


# ----------------------------------------------------------- phase 13: halo
# desco_tpu's large-graph harness recipe (analysis/large_graph_serving.py:
# 31-36, 55-63): a BA-style graph, 20,000 nodes, degree 4, seed 3
HALO_NODES, HALO_DEGREE, HALO_GRAPH_SEED = 20000, 4, 3
HALO_SHARDS = 4
# the daemon's --large_threshold run: a 2,000-node graph of the same
# recipe over a threshold of 1,000 nodes
DAEMON_LARGE_NODES, DAEMON_THRESHOLD = 2000, 1000


def ba_graph(Graph, n: int, degree: int, seed: int):
    """desco_tpu's large-graph recipe: node v attaches to min(v, degree
    // 2) uniform earlier nodes (duplicates merged)."""
    rng = np.random.default_rng(seed)
    pairs = set()
    for v in range(1, n):
        m = min(v, max(1, degree // 2))
        for t in set(rng.integers(0, v, m).tolist()):
            pairs.add((t, v))
    return Graph(n, np.array(sorted(pairs), np.int32))


def halo_streams(shards) -> dict:
    """How many shards carry a live send stream and a boundary stream."""
    return {"send": sum(int(sh.send.edge_src.numel() > 0) for sh in shards),
            "boundary": sum(int(sh.boundary is not None) for sh in shards),
            "shards": len(shards)}


def per_aggregate(shards) -> int:
    """Gather-fused K1 launches of one ``halo_typed_aggregate``: the pull
    sends, the interior streams, the boundary streams."""
    c = halo_streams(shards)
    return c["send"] + c["shards"] + c["boundary"]


def expected_halo_conv(conv: str, shards, layers: int,
                       backward: bool) -> dict:
    """Launches of one halo GAT / PNA core (and its backward): per layer
    and stream the K1 sums, pairs and K4 gathers of ``CONV_SUMS``, the
    pull sends on the gather-fused K1; backward K4 behind every sum, the
    K4 pair behind every pair, K1 behind every K4 gather, K1' behind
    every send (every shard reads its halo table)."""
    s, pairs, gathers = CONV_SUMS[conv]
    c = halo_streams(shards)
    streams = c["shards"] + c["boundary"]
    out = {"sorted_segment_sum": layers * streams * s,
           "segment_sum_vjp": layers * streams * gathers,
           "sorted_segment_sum_pair": layers * streams * pairs,
           "segment_sum_vjp_pair": 0,
           "gather_segment_sum": layers * c["send"],
           "gather_segment_sum_bwd": 0}
    if backward:
        out["sorted_segment_sum"] += layers * streams * gathers
        out["segment_sum_vjp"] += layers * streams * s
        out["segment_sum_vjp_pair"] = layers * streams * pairs
        out["gather_segment_sum_bwd"] = layers * c["send"]
    return out


def launches_match(got: dict, want: dict) -> bool:
    return all(got[k] == v for k, v in want.items())


# library ops that would sum rows: none may run in a halo forward on the
# card (its sums are the kernels')
LIBRARY_SUMS = ("index_add", "scatter_add", "index_put", "sparse",
                "segment_reduce", "bincount")


@contextlib.contextmanager
def library_sums(torch, what: str):
    """Record every op dispatched inside the block and fail if one of
    them is a library sum (``LIBRARY_SUMS``); the kernels' launches go
    past the dispatcher and are counted by their wrappers instead."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        yield
    bad = sorted(n for n in mode.names
                 if any(s in n for s in LIBRARY_SUMS))
    check(not bad, f"{what}: library sums on the card: {bad}")
    print(f"{what}: {len(mode.names)} distinct ops dispatched, no library "
          f"sum", flush=True)


def gather_site(torch, cs, probe, dev, x, st, what: str) -> dict:
    """The gather-fused K1 and its backward at one stream of the card's
    run (a halo stream, or the serving gossip batch's degrees): checked against the plain versions (``gather_check``),
    timed in CUDA graphs of 8 launches, the plain versions eagerly, and
    ``sparse.mm`` of the stream's unit CSR adjacency (and its transpose)
    as the yardstick; the bound in HBM bytes over the live rows
    (``gather_bytes``)."""
    n_seg, k = st.n_nodes * st.n_types, x.shape[1]
    g = torch.randn(n_seg, k, device=dev)
    err = gather_check(torch, cs, x, g, st, what)
    e_live = int(st.fwd_toffs[-1])
    ones = torch.ones(e_live, device=dev)
    csr = torch.sparse_csr_tensor(st.fwd_toffs,
                                  st.edge_src[:e_live].contiguous(), ones,
                                  (n_seg, st.n_rows))
    csr_t = torch.sparse_csr_tensor(st.bwd_soffs,
                                    st.bwd_keys[:e_live].contiguous(), ones,
                                    (st.n_rows, n_seg))
    rows = {}
    for way in ("fwd", "bwd"):
        moved = gather_bytes(torch, st, k, 4, way)
        if way == "fwd":
            fn = lambda: cs.gather_segment_sum(x, st)  # noqa: E731
            plain = lambda: cs.gather_segment_sum_plain(x, st)  # noqa: E731
            lib = lambda: torch.sparse.mm(csr, x)  # noqa: E731
        else:
            fn = lambda: cs.gather_segment_sum_bwd(g, st)  # noqa: E731
            plain = lambda: cs.gather_segment_sum_bwd_plain(  # noqa: E731
                g, st)
            lib = lambda: torch.sparse.mm(csr_t, g)  # noqa: E731
        b_ms, b_by = bound(moved, e_live * k)
        rows[way] = {
            "ms": probe.graph_us(lambda i: fn()) / 1e3,
            "plain_ms": cuda_ms(torch, plain),
            "library_ms": library_yardstick(lib, f"K1' {way} {what}"),
            "library": "torch.sparse.mm of the stream's unit CSR adjacency"
                       + (" (transposed)" if way == "bwd" else ""),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved,
            "max_abs_err": err,
            "shape": f"x [{st.n_rows}, {k}] -> {n_seg} segments, "
                     f"{e_live} live edges"}
    print(f"K1' at {what}: {json.dumps(rows)}", flush=True)
    return rows


def halo_phase(torch, cs, probe, dev, seed: int, svc) -> dict:
    """Phase 13: the halo path on the card at D = 4 shards on the one
    card. (c) ``count_large_graph`` on the 20k-node graph, wall time by
    stage; (b) ``serve_gossip_counts`` at D = 4 against D = 1 and the CPU;
    (a) the sharded SHMP tower (r4's target tower) on the graph's
    whole-graph typed sample against the packed ``apply_shmp_core`` (K2'),
    and a GAT and a PNA tower at width 64 on a ``force_pull`` partition
    against their packed towers, forward and backward; (d) one halo
    gossip train step against the packed ``gossip_loss``, and two
    same-seed steps bit-equal; the daemon's ``--large_threshold``; (e)
    launches zeroed before and read after every run. Returns the halo
    path's launches and the use-site rows of the record."""
    from desco_tpu_torch.batch.build import gossip_sample
    from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.models import gossip as gossip_mod
    from desco_tpu_torch.models import shmp_gnn
    from desco_tpu_torch.parallel import halo
    from desco_tpu_torch.pipeline import prepare_stage_data
    from desco_tpu_torch.train.loop import make_adam

    t13 = time.perf_counter()
    hrng = np.random.default_rng(seed + 13)
    hgen = torch.Generator(device=dev).manual_seed(seed + 13)
    n = HALO_NODES
    g = ba_graph(Graph, n, HALO_DEGREE, HALO_GRAPH_SEED)
    print(f"halo graph: {n} nodes, {g.n_edges} undirected edges (BA, "
          f"degree {HALO_DEGREE}, seed {HALO_GRAPH_SEED}); {HALO_SHARDS} "
          f"shards on {torch.cuda.device_count()} card(s)", flush=True)
    halo_launches = {k: 0 for k in cs.read_launches()}
    # the daemon's --large_threshold over stdio, beside (c)-(d)
    g2 = ba_graph(Graph, DAEMON_LARGE_NODES, HALO_DEGREE, HALO_GRAPH_SEED)
    reqs = [{"id": 1, "graphs": [{"n": g2.n_nodes,
                                  "edges": g2.edges.tolist()}]},
            {"id": 2, "graphs": [{"n": 4, "edges": [[0, 1], [1, 2],
                                                    [2, 3]]}]}]
    daemon_job = start_beside(
        [sys.executable, "-m", "desco_tpu_torch.serve", "--neigh_ckpt",
         R4_NEIGH, "--gossip_ckpt", R4_GOSSIP, "--large_threshold",
         str(DAEMON_THRESHOLD)],
        "".join(json.dumps(r) + "\n" for r in reqs) + "quit\n")

    def add(got):
        for key, v in got.items():
            halo_launches[key] += v

    # the gossip partition serve_gossip_counts builds (metis order)
    gs = gossip_sample(g, np.zeros((n, 29), np.float32))
    order = halo.locality_order(n, gs.edge_src, gs.edge_dst)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    gpart = halo.partition_typed_graph(
        n, gs.node_type[order], gs.x[order],
        inv[gs.edge_src].astype(np.int32), inv[gs.edge_dst].astype(np.int32),
        gs.edge_type, HALO_SHARDS, n_types=2)
    g_agg = per_aggregate(halo.place_shards(gpart, [dev]))

    # (c) count_large_graph end to end, every guard on
    stage = prepare_stage_data(svc.cfg, [g], capacities=svc._select_neigh_caps)
    n_b = len(stage.batches)
    stats = {}
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = svc.count_large_graph(g, n_devices=HALO_SHARDS, stats=stats)
    wall = time.perf_counter() - t0
    got = cs.read_launches()
    add(got)
    check_counts(res, 1, "count_large_graph")
    check(res.node_counts.shape == (n, 29), "count_large_graph node counts")
    want = {"fused_typed_transform_aggregate": 8 * n_b,
            "sorted_segment_sum": n_b,
            "gather_segment_sum": (1 + 2 * 29) * g_agg,
            "typed_aggregate_bwd": 0, "segment_sum_vjp": 0,
            "gather_segment_sum_bwd": 0}
    print(f"count_large_graph launches: {json.dumps(got)}; expected "
          f"{json.dumps(want)} ({n_b} target batches; {g_agg} gather-fused "
          f"K1 per halo aggregate)", flush=True)
    check(launches_match(got, want), "count_large_graph launches")
    print(f"count_large_graph ({HALO_SHARDS} shards): {wall:.2f} s wall: "
          f"stage 1 {stats['stage1_s']:.2f} s ({len(stage.samples)} "
          f"neighborhoods, {n_b} batches, {len(res.verified_rows)} verified "
          f"rows), partition {stats['partition_s']:.2f} s, halo gossip "
          f"{stats['gossip_s']:.2f} s; n_loc / N = {stats['n_loc']} / {n} "
          f"= {stats['n_loc'] / n:.4f}; graphlet counts "
          f"{res.graphlet_counts[0].astype(int).tolist()}", flush=True)

    # (c) again through a service made for this request, as a daemon's
    # first request: no bucket pinned by smaller requests before it
    from desco_tpu_torch.serving import CountingService

    fresh = CountingService(R4_NEIGH, R4_GOSSIP, device=dev)
    fstats = {}
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f = fresh.count_large_graph(g, n_devices=HALO_SHARDS, stats=fstats)
    wall_f = time.perf_counter() - t0
    got = cs.read_launches()
    add(got)
    del fresh
    check_counts(res_f, 1, "count_large_graph, fresh service")
    rel_f = close_counts(res_f.graphlet_counts, res.graphlet_counts,
                         "count_large_graph, fresh vs warm service")
    n_bf = fstats["stage1_batches"]
    want = {**want, "fused_typed_transform_aggregate": 8 * n_bf,
            "sorted_segment_sum": n_bf}
    check(launches_match(got, want), "count_large_graph launches, fresh")
    print(f"count_large_graph ({HALO_SHARDS} shards), fresh service: "
          f"{wall_f:.2f} s wall: stage 1 {fstats['stage1_s']:.2f} s ({n_bf} "
          f"batches, {len(res_f.verified_rows)} verified rows), partition "
          f"{fstats['partition_s']:.2f} s, halo gossip "
          f"{fstats['gossip_s']:.2f} s; graphlet counts vs the warm "
          f"service's max rel {rel_f:.3g} (bound 1e-3, floored at 1)",
          flush=True)

    # (b) serve_gossip_counts: D = 4 against D = 1 and the CPU
    x_all = np.zeros((n, 29), np.float32)
    x_all[np.asarray(stage.nindex.indicator)] = res.neighborhood_counts
    q_embs = svc.member_embs[0]
    cs.reset_launches()
    t0 = time.perf_counter()
    with library_sums(torch, "serve_gossip_counts at 4 shards"):
        out4 = halo.serve_gossip_counts(svc.gossip_params, g, x_all,
                                        q_embs, n_devices=HALO_SHARDS,
                                        device=dev)
    s4 = time.perf_counter() - t0
    add(cs.read_launches())
    t0 = time.perf_counter()
    out1, st1 = halo.serve_gossip_counts(svc.gossip_params, g, x_all, q_embs,
                                         n_devices=1, return_stats=True,
                                         device=dev)
    s1 = time.perf_counter() - t0
    rel41 = float((np.abs(out4 - out1)
                   / np.maximum(np.abs(out1), 1.0)).max())
    check(np.isfinite(out4).all() and rel41 <= 1e-4,
          f"serve_gossip_counts D = 4 vs D = 1: {rel41:.3g} > 1e-4")
    t0 = time.perf_counter()
    out_cpu = halo.serve_gossip_counts(
        copy.deepcopy(svc.gossip_params).to("cpu"), g, x_all, q_embs.cpu(),
        n_devices=HALO_SHARDS, device="cpu")
    s_cpu = time.perf_counter() - t0
    rel_cpu = close_counts(out4, out_cpu, "serve_gossip_counts CUDA vs CPU")
    print(f"serve_gossip_counts: D = 4 {s4:.2f} s, D = 1 {s1:.2f} s "
          f"(n_loc {st1['n_loc']}), CPU D = 4 {s_cpu:.2f} s; D = 4 vs D = 1 "
          f"max rel {rel41:.3g} (bound 1e-4), CUDA vs CPU max rel "
          f"{rel_cpu:.3g} (bound 1e-3, floored at 1)", flush=True)

    # (a) the sharded SHMP tower on the whole-graph typed sample
    [ws] = Workload([g]).wo_canonical_samples(
        svc.cfg.query_ids, truth=np.zeros((n, 29)))
    ws.x = hrng.standard_normal((n, 1)).astype(np.float32)
    [wb] = pack_samples([ws], *auto_capacities([ws], g_cap=1), n_queries=29)
    wb_dev = wb.to(dev)
    tgt, tparams = svc.tgt_cfg, svc.members[0]["target"]
    check(tgt.agg_mode == "kernel", "the r4 target tower is not on K2")
    part = halo.partition_typed_graph(
        n, ws.node_type, ws.x, ws.edge_src, ws.edge_dst, ws.edge_type,
        HALO_SHARDS, n_types=tgt.n_edge_types)
    shards = halo.place_shards(part, [dev])
    with torch.inference_mode():
        ref = shmp_gnn.apply_shmp_core(tparams, tgt, wb_dev)[:n]
        cs.reset_launches()
        t0 = time.perf_counter()
        outs = halo.halo_shmp_core(tparams, tgt, shards)
        torch.cuda.synchronize()
        tower_s = time.perf_counter() - t0
        got = cs.read_launches()
        add(got)
        with library_sums(torch, "the halo SHMP tower"):
            halo.halo_shmp_core(tparams, tgt, shards)
        halo_out = torch.cat([o[:int(r[1] - r[0])]
                              for o, r in zip(outs, part.node_range)])
    scale = float(ref.abs().max())
    err = float((halo_out - ref).abs().max())
    want = {"gather_segment_sum": 8 * per_aggregate(shards),
            "fused_typed_transform_aggregate": 0, "sorted_segment_sum": 0}
    print(f"halo SHMP tower (r4 target, SAGE, 8 layers, hidden 64, T = 6) "
          f"on the whole-graph sample: n_loc {part.n_loc}, h_max "
          f"{part.h_max}, p_max {part.p_max}, e_int "
          f"{part.edge_src_int.shape[1]}, e_bnd {part.edge_src_bnd.shape[1]}"
          f"; {tower_s * 1e3:.1f} ms; max |halo - packed K2'| {err:.3g} of "
          f"max|out| {scale:.3g} ({err / scale:.3g}, bound 1e-3); launches "
          f"{json.dumps(got)}, expected {json.dumps(want)}", flush=True)
    check(err <= 1e-3 * scale, "halo SHMP tower vs the packed tower")
    check(launches_match(got, want), "halo SHMP tower launches")

    conv_rows = {}
    for conv in ("GAT", "PNA"):
        ccfg = shmp_gnn.neighborhood_target_config(conv_type=conv)
        cparams = shmp_gnn.init_shmp(
            ccfg, torch.Generator().manual_seed(seed + 13)).to(dev)
        cpart = halo.partition_typed_graph(
            n, ws.node_type, ws.x, ws.edge_src, ws.edge_dst, ws.edge_type,
            HALO_SHARDS, n_types=ccfg.n_edge_types, force_pull=True)
        cshards = halo.place_shards(cpart, [dev])
        check(cpart.p_max == 0 and halo_streams(cshards)["boundary"]
              == HALO_SHARDS, f"{conv}: the force_pull partition")
        w = torch.randn(n, ccfg.post_input_dim, device=dev, generator=hgen)
        grads = {}
        for way in ("packed", "halo"):
            cparams.zero_grad()
            cs.reset_launches()
            if way == "packed":
                out = shmp_gnn.apply_shmp_core(cparams, ccfg, wb_dev)[:n]
            else:
                with library_sums(torch, f"the halo {conv} tower"):
                    outs = halo.halo_shmp_core(cparams, ccfg, cshards)
                out = torch.cat([o[:int(r[1] - r[0])]
                                 for o, r in zip(outs, cpart.node_range)])
            fwd = cs.read_launches()
            (out * w).sum().backward()
            torch.cuda.synchronize()
            both = cs.read_launches()
            grads[way] = ({k: p.grad.clone()
                           for k, p in cparams.named_parameters()
                           if p.grad is not None}, out.detach())
        add(both)
        want_f = expected_halo_conv(conv, cshards, ccfg.layer_num, False)
        want_b = expected_halo_conv(conv, cshards, ccfg.layer_num, True)
        ref_out, out = grads["packed"][1], grads["halo"][1]
        scale = float(ref_out.abs().max())
        err = float((out - ref_out).abs().max())
        top = max(float(r.abs().max()) for r in grads["packed"][0].values())
        gerr = max(float((grads["halo"][0][k] - r).abs().max())
                   / max(float(r.abs().max()), 1e-9 * top)
                   for k, r in grads["packed"][0].items())
        print(f"halo {conv} tower (8 layers, hidden 64, force_pull): max "
              f"|halo - packed| {err:.3g} of {scale:.3g} ({err / scale:.3g}, "
              f"bound 1e-3); gradients max {gerr:.3g} of a tensor's scale "
              f"(bound 1e-4); launches forward {json.dumps(fwd)} (expected "
              f"{json.dumps(want_f)}), with the backward {json.dumps(both)} "
              f"(expected {json.dumps(want_b)})", flush=True)
        check(err <= 1e-3 * scale, f"halo {conv} tower vs the packed tower")
        check(all(torch.isfinite(v).all() for v in grads["halo"][0].values()),
              f"halo {conv}: non-finite gradients")
        check(gerr <= 1e-4, f"halo {conv} gradients vs the packed tower's: "
              f"{gerr:.3g} of a tensor's scale > 1e-4")
        check(launches_match(fwd, want_f) and launches_match(both, want_b),
              f"halo {conv} launches")
        conv_rows[conv] = {"err": err / scale, "grad_err": gerr}
        del cparams, cshards, grads

    # (d) one halo gossip train step at D = 4 (the natural-order
    # partition: push pairs in the backward too) against the packed loss
    truth = (x_all * hrng.uniform(0.5, 1.5, (n, 1))).astype(np.float32)
    s_tr = gossip_sample(g, x_all, truth)
    tpart = halo.partition_typed_graph(
        n, s_tr.node_type, x_all, s_tr.edge_src, s_tr.edge_dst,
        s_tr.edge_type, HALO_SHARDS, node_y=truth, n_types=2)
    tshards = halo.place_shards(tpart, [dev])
    check(tpart.p_max > 0, "the gossip training partition has no push pair")
    t_agg = per_aggregate(tshards)
    # the direction degrees: once for the partition, kept on its shards;
    # the loss and every step below read them
    cs.reset_launches()
    deg = halo.halo_direction_degrees(tshards)
    got = cs.read_launches()
    add(got)
    check(got["gather_segment_sum"] == t_agg
          and all(d is k for d, k in
                  zip(deg, halo.halo_direction_degrees(tshards)))
          and cs.read_launches() == got,
          f"halo direction degrees: launches {got}, expected {t_agg} "
          f"gather-fused K1 once for the partition")
    [tb] = pack_samples([s_tr], *auto_capacities([s_tr], g_cap=1),
                        n_queries=29, need_bwd_perm=True)
    tb_dev = tb.to(dev, training=True)
    gp0 = copy.deepcopy(svc.gossip_params).requires_grad_(True)
    q_embs = q_embs.clone()  # the service's are inference tensors
    grads, losses = {}, {}
    for way in ("packed", "halo"):
        p = copy.deepcopy(gp0)
        cs.reset_launches()
        if way == "packed":
            loss = gossip_mod.gossip_loss(p, tb_dev, q_embs)
        else:
            loss = halo.halo_gossip_loss(p, tshards, q_embs)
        loss.backward()
        torch.cuda.synchronize()
        if way == "halo":
            step_launches = cs.read_launches()
        losses[way] = float(loss.detach())
        grads[way] = {k: q.grad for k, q in p.named_parameters()
                      if q.grad is not None}
    gerr = max(float((grads["halo"][k] - r).abs().max())
               / max(float(r.abs().max()), 1e-30)
               for k, r in grads["packed"].items())
    lerr = abs(losses["halo"] - losses["packed"]) / abs(losses["packed"])
    want = {"gather_segment_sum": 2 * 29 * t_agg,
            "gather_segment_sum_bwd": 29 * t_agg, "sorted_segment_sum": 0,
            "segment_sum_vjp": 0}
    add(step_launches)
    print(f"halo gossip loss at D = {HALO_SHARDS} (p_max {tpart.p_max}) vs "
          f"the packed gossip_loss: loss {losses['halo']:.6g} vs "
          f"{losses['packed']:.6g} (rel {lerr:.3g}), gradients max "
          f"{gerr:.3g} of a tensor's scale (bound 1e-4); launches "
          f"{json.dumps(step_launches)}, expected {json.dumps(want)}",
          flush=True)
    check(gerr <= 1e-4 and lerr <= 1e-5, "halo gossip gradients vs packed")
    check(launches_match(step_launches, want), "halo gossip step launches")
    steps = []
    for _ in range(2):
        p = copy.deepcopy(gp0)
        opt = make_adam(p)
        step = halo.halo_gossip_step_fn(opt, dropout=0.01)
        t0 = time.perf_counter()
        loss, ok = step(p, tshards, q_embs, 1e-3, seed=seed)
        torch.cuda.synchronize()
        steps.append((loss, opt.grad.clone(), opt.flat.clone(),
                      time.perf_counter() - t0))
    check(bool(steps[0][0] == steps[1][0])
          and torch.equal(steps[0][1], steps[1][1])
          and torch.equal(steps[0][2], steps[1][2]),
          "two same-seed halo gossip train steps differ")
    print(f"halo gossip train step (dropout 0.01, Adam): loss "
          f"{float(steps[0][0]):.6g}, {steps[0][3] * 1e3:.1f} / "
          f"{steps[1][3] * 1e3:.1f} ms; two same-seed steps bit-equal "
          f"(loss, gradients, parameters)", flush=True)
    del tb_dev, grads, steps

    # the daemon's --large_threshold over stdio, started with the phase
    daemon_out, _, daemon_s = collect(daemon_job, 600,
                                      "the --large_threshold daemon")
    replies = [json.loads(line) for line in daemon_out.splitlines()
               if line.strip()]
    check([r.get("id") for r in replies] == [1, 2]
          and all("error" not in r for r in replies),
          f"daemon replies {replies}")
    want = svc.count_large_graph(g2).graphlet_counts
    got = np.asarray(replies[0]["graphlet_counts"])
    check(got.shape == want.shape
          and np.all(np.abs(got - want) <= np.maximum(1.0, 1e-3 * want)),
          "the daemon's large-graph reply differs from count_large_graph")
    print(f"daemon --large_threshold {DAEMON_THRESHOLD}: a "
          f"{DAEMON_LARGE_NODES}-node graph served by count_large_graph and "
          f"a 4-node one by count in {daemon_s:.1f} s (process start "
          f"included; the phase's parts (c)-(d) ran beside it)", flush=True)

    # (e) the halo use sites of the kernels, timed
    sites = {}
    with torch.inference_mode():
        sh0 = halo.place_shards(gpart, [dev])[0]
        xg = torch.randn(sh0.n_loc, 128, device=dev, generator=hgen)
        sites["k1g_interior"] = gather_site(
            torch, cs, probe, dev, xg, sh0.interior,
            f"the gossip's interior stream (shard 0 of {HALO_SHARDS}, layer "
            f"0, K = 128)")
        xh = torch.randn(sh0.send.n_nodes, 128, device=dev, generator=hgen)
        sites["k1g_boundary"] = gather_site(
            torch, cs, probe, dev, xh, sh0.boundary,
            "the gossip's boundary stream (shard 0, K = 128)")
        sites["k1g_send"] = gather_site(
            torch, cs, probe, dev, xg, sh0.send,
            "the gossip's pull sends (shard 0, K = 128)")
        sites["k1g_degrees"] = gather_site(
            torch, cs, probe, dev, sh0.node_mask[:, None].contiguous(),
            sh0.interior, "the direction degrees (shard 0, K = 1)")
        csh = halo.place_shards(halo.partition_typed_graph(
            n, ws.node_type, ws.x, ws.edge_src, ws.edge_dst, ws.edge_type,
            HALO_SHARDS, n_types=6, force_pull=True), [dev])[0]
        # as the halo GAT / PNA call them: shard 0's interior stream and
        # its offsets, derived once
        sites.update(conv_site_rows(
            torch, cs, probe, dev, csh.interior.keys, csh.n_loc * 6,
            csh.interior.fwd_toffs, hgen, "halo (shard 0's interior stream)"))
    print(f"phase 13 (halo) launches: {json.dumps(halo_launches)}", flush=True)
    for name in ("gather_segment_sum", "gather_segment_sum_bwd",
                 "sorted_segment_sum", "segment_sum_vjp",
                 "sorted_segment_sum_pair", "segment_sum_vjp_pair",
                 "fused_typed_transform_aggregate"):
        check(halo_launches[name] > 0, f"phase 13: {name} never launched")
    print(f"phase 13 (halo) took {time.perf_counter() - t13:.1f} s",
          flush=True)
    return {"launches": halo_launches, "sites": sites,
            "train_shards": tshards,
            "large_graph": {"wall_s": wall, **stats,
                            "graphlet_counts":
                                res.graphlet_counts[0].tolist(),
                            "fresh_service": {"wall_s": wall_f, **fstats}},
            "conv": conv_rows}


# ------------------------------------------- phase 14: data parallelism
# the second graph of the DP x halo run: desco_tpu's large-graph recipe
# at 12,000 nodes, seed 4 (the first is phase 13's 20,000 nodes, seed 3)
DP_HALO_SECOND = (12000, 4)


def flat_of(torch, params, loss) -> "torch.Tensor":
    """d loss / d params as one flat vector (zeros where none flows)."""
    ps = list(params.parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return torch.cat([(g if g is not None else torch.zeros_like(p))
                      .reshape(-1) for g, p in zip(grads, ps)])


def tensor_err(torch, params, got, ref) -> float:
    """The largest error of a flat gradient against a reference, relative
    to each parameter tensor's own scale (a tensor whose reference is all
    zero must come out zero)."""
    worst, off = 0.0, 0
    got, ref = got.double().cpu(), ref.double().cpu()
    for p in params.parameters():
        a, b = got[off:off + p.numel()], ref[off:off + p.numel()]
        off += p.numel()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / scale if scale > 0 else
                    (0.0 if err == 0 else float("inf")))
    return worst


def dp_step_checks(torch, cs, add, dp, params, loss_fn, loss_fn_cpu,
                   batches, kind, what: str) -> dict:
    """One D = 2 DP step's loss and reduced gradients against the
    single-device losses and gradients of its batches ('graphs': the
    valid-graph-weighted mean; 'sum': the sum), on the card (phase 5's
    bound, 1e-4 of each tensor's scale) and on the CPU (the same bound),
    plus two same-seed DP train steps bit-equal. ``add`` takes the
    launches of the DP runs alone; the single-device references run
    outside the counted windows."""
    from desco_tpu_torch.train.loop import make_adam

    mesh = dp.make_mesh(2)
    group = dp.place_batches(batches, mesh, training=True)
    cs.reset_launches()
    t0 = time.perf_counter()
    loss, flat = dp.dp_loss_and_grads(loss_fn, params, group, mesh, kind)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    add(cs.read_launches())
    ws = [float(b.graph_mask.sum()) if kind == "graphs" else 1.0
          for b in batches]
    wsum = max(sum(ws), 1.0) if kind == "graphs" else 1.0
    ref_loss, ref_flat = 0.0, None
    for b, w in zip(group, ws):
        one = loss_fn(params, b, None)
        g = flat_of(torch, params, one).double() * (w / wsum)
        ref_loss += float(one.detach()) * w / wsum
        ref_flat = g if ref_flat is None else ref_flat + g
    lerr = abs(float(loss) - ref_loss) / max(abs(ref_loss), 1e-30)
    gerr = tensor_err(torch, params, flat, ref_flat)
    # the same step on the CPU (the kernels' plain versions)
    cpu_params = copy.deepcopy(params).to("cpu")
    cmesh = dp.make_mesh(2, "cpu")
    t0 = time.perf_counter()
    closs, cflat = dp.dp_loss_and_grads(
        loss_fn_cpu, cpu_params, dp.place_batches(batches, cmesh,
                                                  training=True),
        cmesh, kind)
    cpu_s = time.perf_counter() - t0
    cerr = tensor_err(torch, params, flat, cflat)
    clerr = abs(float(loss) - float(closs)) / max(abs(float(closs)), 1e-30)
    # two same-seed train steps (Adam; the gossip draws dropout masks)
    steps = []
    for _ in range(2):
        p = copy.deepcopy(params)
        opt = make_adam(p)
        step = dp.DPStep(loss_fn, opt, mesh, kind)
        gens = dp.replica_generators(mesh, 14)
        cs.reset_launches()
        s_loss, ok = step(p, group, 1e-3, gens)
        add(cs.read_launches())
        steps.append((float(s_loss), bool(ok), opt.grad.clone(),
                      opt.flat.clone()))
    same = (steps[0][0] == steps[1][0] and steps[0][1]
            and torch.equal(steps[0][2], steps[1][2])
            and torch.equal(steps[0][3], steps[1][3]))
    print(f"{what}: D = 2 DP step loss {float(loss):.6g} vs the "
          f"{'weighted mean' if kind == 'graphs' else 'sum'} of the "
          f"single-device losses {ref_loss:.6g} (rel {lerr:.3g}, bound "
          f"1e-5); reduced gradients vs theirs max {gerr:.3g} of a tensor's "
          f"scale (bound 1e-4); CUDA vs CPU: loss rel {clerr:.3g}, "
          f"gradients {cerr:.3g} of a tensor's scale (bound 1e-4; CPU "
          f"{cpu_s:.1f} s); {step_ms:.1f} ms for the step's two replicas; "
          f"two same-seed train steps bit-equal: {same}", flush=True)
    check(lerr <= 1e-5 and gerr <= 1e-4, f"{what}: DP step vs single-device")
    check(clerr <= 1e-5 and cerr <= 1e-4, f"{what}: DP step CUDA vs CPU")
    check(same, f"{what}: two same-seed DP steps differ")
    return {"loss_rel": lerr, "grad_err": gerr, "cpu_grad_err": cerr,
            "step_ms": step_ms}


def dp_phase(torch, cs, dev, seed: int, svc, main_req, res_main,
             main_stage, train_stage, tcfg, qb, gbatches, best, tgt_cfg,
             qry_cfg) -> dict:
    """Phase 14: data parallelism on the one card, D = 2 and D = 4
    replicas. (a) DP serving: phase 3's 256-graph request through
    ``CountingService(n_devices=2)`` (every output bit-equal to phase 3's
    result) and both stages' DP predict at D = 2 and D = 4 (bit-equal to
    one device; K2 eight times per padded target batch, no backward
    kernel); (b) DP training: a D = 2 step of each stage against the
    single-device losses and gradients, on the card and the CPU, two
    same-seed steps bit-equal, and 2 epochs of each stage at D = 1 and
    D = 2 through ``train_*_stage(mesh=...)`` (launches per padded batch);
    (c) DP x halo on a 2 x 2 grid: two BA graphs (20,000 and 12,000 nodes)
    with harmonized partitions, the composed gossip loss and gradients
    against the sum of the replicas', two same-seed steps bit-equal, the
    composed SHMP forward against each replica's ``halo_shmp_core``; (d)
    ``graft_entry.dryrun_multichip(4)`` and the build cache across two
    processes. Returns the phase's launches and figures."""
    from desco_tpu_torch import graft_entry
    from desco_tpu_torch.batch.build import gossip_sample
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.models import gossip as gossip_mod
    from desco_tpu_torch.models import neighborhood as neigh_mod
    from desco_tpu_torch.parallel import dp, halo, topology
    from desco_tpu_torch.pipeline import (train_gossip_stage,
                                          train_neighborhood_stage)
    from desco_tpu_torch.serving import CountingService
    from desco_tpu_torch.train import loop as train_loop
    from desco_tpu_torch.train.loop import make_adam

    t14 = time.perf_counter()
    # (d), first half: a fresh process builds every library into a fresh
    # cache directory while the rest of the phase runs
    cache_dir = tempfile.TemporaryDirectory(prefix="desco_smoke_cache_")
    probe_cmd = [sys.executable, "-c", (
        "import json, os, sys, time\n"
        "from desco_tpu_torch.utils.compile_cache import "
        "enable_compilation_cache\n"
        "path = enable_compilation_cache(sys.argv[1])\n"
        "from desco_tpu_torch.ops import cuda_build\n"
        "from desco_tpu_torch.truth import native\n"
        "libs = cuda_build.build_all()\n"
        "t0 = time.perf_counter(); so = native._build()\n"
        "print(json.dumps({'path': path, 'libs': libs, 'native': so, "
        "'native_mtime': os.stat(so).st_mtime_ns, 'native_s': "
        "time.perf_counter() - t0, 'build_s': cuda_build.build_seconds}))\n"),
        cache_dir.name]
    first = subprocess.Popen(probe_cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=REPO)
    dp_launches = {k: 0 for k in cs.read_launches()}

    def add(got):
        for key, v in got.items():
            dp_launches[key] += v

    # (a) DP serving, phase 3's request
    n_main = len(main_stage.batches)
    svc2 = CountingService(R4_NEIGH, R4_GOSSIP, device=dev, n_devices=2)
    svc2._neigh_buckets.update(svc._neigh_buckets)  # the same batches
    svc2._gossip_buckets.update(svc._gossip_buckets)
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = svc2.count(main_req)
    dp_req_s = time.perf_counter() - t0
    got = cs.read_launches()
    add(got)
    padded = -(-n_main // 2) * 2
    differ = [f.name for f in dataclasses.fields(res_main)
              if not np.array_equal(getattr(res2, f.name),
                                    getattr(res_main, f.name))]
    print(f"CountingService(n_devices=2), phase 3's 256-graph request: "
          f"{dp_req_s * 1e3:.1f} ms; launches {json.dumps(got)}; expected "
          f"K2 = 8 x {padded} padded target batches; equal to phase 3's "
          f"result bit for bit: {not differ}"
          f"{' (differ: ' + ', '.join(differ) + ')' if differ else ''}",
          flush=True)
    check(not differ, "DP serving differs from phase 3's single-device "
          "result")
    check(got["fused_typed_transform_aggregate"] == 8 * padded
          and got["sorted_segment_sum"] == padded,
          "DP serving: K2 != 8 x padded target batches or K1 != one "
          "pooling per padded batch")
    check(all(got[k] == 0 for k in ("typed_aggregate_bwd", "segment_sum_vjp",
                                    "gather_segment_sum_bwd")),
          "DP serving launched a backward kernel")
    del svc2
    member, embs = svc.members[0], svc.member_embs[0]
    gb_main = prepare_gossip_batches_for(svc, main_stage,
                                         res_main.neighborhood_counts)
    single = train_loop.predict_neighborhood_counts(
        member, svc.tgt_cfg, embs, main_stage.batches, dev)
    single_g = train_loop.predict_gossip_counts(svc.gossip_params, embs,
                                                gb_main, dev)
    dp_ms = {}
    for d in (2, 4):
        mesh = dp.make_mesh(d)
        cs.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_n = dp.dp_predict_neighborhood_counts(
            member, svc.tgt_cfg, embs, main_stage.batches, mesh)
        t1 = time.perf_counter()
        got_g = dp.dp_predict_gossip_counts(svc.gossip_params, embs,
                                            gb_main, mesh)
        dp_ms[d] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        got = cs.read_launches()
        add(got)
        pad_n = -(-n_main // d) * d
        pad_g = -(-len(gb_main) // d) * d
        check(np.array_equal(got_n, single) and np.array_equal(got_g,
                                                               single_g),
              f"DP predict at D = {d} differs from one device")
        check(got["fused_typed_transform_aggregate"] == 8 * pad_n
              and got["gather_segment_sum"] == (1 + 2 * 29) * pad_g
              and got["typed_aggregate_bwd"] == 0
              and got["gather_segment_sum_bwd"] == 0,
              f"DP predict launches at D = {d}: {got}")
        print(f"DP predict at D = {d} ({pad_n} padded target batches, "
              f"{pad_g} gossip batches): stage 1 {dp_ms[d][0]:.1f} ms, "
              f"gossip {dp_ms[d][1]:.1f} ms; both bit-equal to one device; "
              f"launches {json.dumps(got)}", flush=True)

    # (b) DP training: one D = 2 step of each stage
    q_dev = qb.to(dev)
    p_neigh = neigh_mod.init_neighborhood_model(
        tgt_cfg, qry_cfg, torch.Generator().manual_seed(seed)).to(dev)
    neigh_rows = dp_step_checks(
        torch, cs, add, dp, p_neigh,
        train_loop.neighborhood_loss_fn(tgt_cfg, qry_cfg, q_dev),
        train_loop.neighborhood_loss_fn(tgt_cfg, qry_cfg, qb.to("cpu")),
        train_stage.batches[:2], "graphs",
        f"neighborhood stage (paper config, {train_stage.batches[0].n_cap} "
        f"node slots per batch)")
    with torch.no_grad():
        q_embs = neigh_mod.embed_queries(best, qry_cfg, q_dev).clone()
    p_gossip = gossip_mod.init_gossip_model(
        hidden_dim=tcfg.gossip_hidden_dim,
        emb_channels=tcfg.neigh_hidden_dim,
        generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    gpair = dp.pad_batches_to_multiple(list(gbatches[:2]), 2)
    gossip_rows = dp_step_checks(
        torch, cs, add, dp, p_gossip, train_loop.gossip_loss_fn(0.0, q_embs),
        train_loop.gossip_loss_fn(0.0, q_embs.cpu()), gpair, "sum",
        f"gossip stage (29 queries, {gpair[0].n_cap} node slots)")
    # the same step's dropout path (tcfg.gossip_dropout) repeats too
    steps = []
    mesh2 = dp.make_mesh(2)
    ggroup = dp.place_batches(gpair, mesh2, training=True)
    for _ in range(2):
        p = copy.deepcopy(p_gossip)
        opt = make_adam(p)
        step = dp.DPStep(
            train_loop.gossip_loss_fn(tcfg.gossip_dropout, q_embs), opt,
            mesh2, "sum")
        cs.reset_launches()
        s_loss, _ = step(p, ggroup, 1e-3, dp.replica_generators(mesh2, seed))
        add(cs.read_launches())
        steps.append((float(s_loss), opt.grad.clone(), opt.flat.clone()))
    check(steps[0][0] == steps[1][0] and torch.equal(steps[0][1], steps[1][1])
          and torch.equal(steps[0][2], steps[1][2]),
          "two same-seed DP gossip steps with dropout differ")
    print(f"DP gossip step with dropout {tcfg.gossip_dropout}: two same-seed "
          f"steps bit-equal (loss {steps[0][0]:.6g})", flush=True)

    # (b) two epochs of each stage at D = 1 and D = 2
    ecfg = dataclasses.replace(tcfg, neigh_epochs=2, gossip_epochs=2)
    n_b, n_gb = len(train_stage.batches), len(gbatches)
    epochs = {}
    for d in (1, 2):
        mesh = dp.make_mesh(d)
        pad_b, pad_g = -(-n_b // d) * d, -(-n_gb // d) * d
        cs.reset_launches()
        res, _, _ = train_neighborhood_stage(
            ecfg, train_stage, train_stage, qb, mesh=mesh,
            log_fn=lambda *_: None)
        got = cs.read_launches()
        add(got)
        check(np.isfinite(res.train_losses).all()
              and np.isfinite(res.val_losses).all(),
              f"D = {d} neighborhood epochs: losses not finite")
        check(got["typed_aggregate_bwd"] == 8 * 2 * pad_b
              and got["fused_typed_transform_aggregate"]
              == 8 * 2 * (pad_b + n_b),
              f"D = {d} neighborhood epochs: launches {got}, expected K3 = "
              f"8 x 2 x {pad_b}, K2 = 8 x 2 x ({pad_b} + {n_b} val)")
        cs.reset_launches()
        gres, _ = train_gossip_stage(
            ecfg, best, tgt_cfg, qry_cfg, qb, gbatches, gbatches, mesh=mesh,
            log_fn=lambda *_: None)
        got_g = cs.read_launches()
        add(got_g)
        check(np.isfinite(gres.train_losses).all(),
              f"D = {d} gossip epochs: losses not finite")
        want_fwd = (8 + 2 * pad_g * GOSSIP_FWD_PER_STEP
                    + 2 * n_gb * GOSSIP_FWD_PER_EVAL)
        check(got_g["gather_segment_sum"] == want_fwd
              and got_g["gather_segment_sum_bwd"]
              == 2 * pad_g * GOSSIP_BWD_PER_STEP,
              f"D = {d} gossip epochs: launches {got_g}, expected the "
              f"gather-fused K1 {want_fwd} forward")
        epochs[d] = {
            "neigh_epoch_ms": [1e3 * t for t in res.train_times],
            "neigh_losses": res.train_losses,
            "gossip_epoch_ms": [1e3 * t for t in gres.train_times],
            "gossip_losses": gres.train_losses,
            "padded_batches": [pad_b, pad_g]}
        print(f"D = {d}: 2 neighborhood epochs ({pad_b} batches, {pad_b // d}"
              f" steps each): train ms {[round(x, 1) for x in epochs[d]['neigh_epoch_ms']]}"
              f", loss {[round(x, 4) for x in res.train_losses]}; 2 gossip "
              f"epochs ({pad_g} batches): train ms "
              f"{[round(x, 1) for x in epochs[d]['gossip_epoch_ms']]}, loss "
              f"{[round(x, 1) for x in gres.train_losses]}; launches "
              f"neighborhood {json.dumps(got)}, gossip {json.dumps(got_g)}",
              flush=True)

    # (c) DP x halo: two BA graphs on a 2 x 2 grid of the one card
    hrng = np.random.default_rng(seed + 14)
    graphs = [ba_graph(Graph, HALO_NODES, HALO_DEGREE, HALO_GRAPH_SEED),
              ba_graph(Graph, DP_HALO_SECOND[0], HALO_DEGREE,
                       DP_HALO_SECOND[1])]
    specs = []
    for g in graphs:
        x = hrng.uniform(0.0, 8.0, (g.n_nodes, 29)).astype(np.float32)
        truth = (x * hrng.uniform(0.5, 1.5, (g.n_nodes, 1))).astype(
            np.float32)
        s = gossip_sample(g, x, truth)
        specs.append(dict(n_nodes=g.n_nodes, node_type=s.node_type, x=x,
                          edge_src=s.edge_src, edge_dst=s.edge_dst,
                          edge_type=s.edge_type, node_y=truth))
    t0 = time.perf_counter()
    parts = topology.harmonized_partitions(specs, 2, n_types=2)
    part_s = time.perf_counter() - t0
    caps = [halo.partition_caps(p) for p in parts]
    check(caps[0] == caps[1], f"harmonized partitions differ: {caps}")
    grid = topology.make_mesh2d(2, 2)
    replicas = topology.place_replicas(topology.stack_partitions(parts),
                                       grid)
    gp0 = copy.deepcopy(svc.gossip_params).requires_grad_(True)
    hq = embs.clone()  # the service's are inference tensors
    cs.reset_launches()
    t0 = time.perf_counter()
    loss, flat = topology.dp_halo_gossip_loss_and_grads(gp0, replicas, hq)
    torch.cuda.synchronize()
    halo_ms = (time.perf_counter() - t0) * 1e3
    add(cs.read_launches())
    ref_loss, ref_flat = 0.0, None
    for shards in replicas:
        one = halo.halo_gossip_loss(gp0, shards, hq)
        g = flat_of(torch, gp0, one)
        ref_loss += float(one.detach())
        ref_flat = g if ref_flat is None else ref_flat + g
    lerr = abs(float(loss) - ref_loss) / abs(ref_loss)
    gerr = tensor_err(torch, gp0, flat, ref_flat)
    steps = []
    for _ in range(2):
        p = copy.deepcopy(gp0)
        opt = make_adam(p)
        step = topology.dp_halo_gossip_step_fn(opt, dropout=0.01)
        cs.reset_launches()
        s_loss, ok = step(p, replicas, hq, 1e-3, seed=seed)
        add(cs.read_launches())
        steps.append((float(s_loss), bool(ok), opt.grad.clone(),
                      opt.flat.clone()))
    same = (steps[0][:2] == steps[1][:2] and steps[0][1]
            and torch.equal(steps[0][2], steps[1][2])
            and torch.equal(steps[0][3], steps[1][3]))
    print(f"DP x halo (2 x 2 on {torch.cuda.device_count()} card(s); "
          f"{graphs[0].n_nodes} and {graphs[1].n_nodes} nodes, harmonized "
          f"caps {json.dumps(caps[0])} in {part_s:.2f} s): composed loss "
          f"{float(loss):.6g} vs the sum of the replicas' "
          f"{ref_loss:.6g} (rel {lerr:.3g}, bound 1e-5); gradients max "
          f"{gerr:.3g} of a tensor's scale (bound 1e-5); {halo_ms:.1f} ms; "
          f"two same-seed steps (dropout 0.01) bit-equal: {same}",
          flush=True)
    check(lerr <= 1e-5 and gerr <= 1e-5, "DP x halo vs the replicas' sum")
    check(same, "two same-seed DP x halo steps differ")
    # the composed SHMP forward (r4's target tower) on the two graphs'
    # whole-graph typed samples
    tspecs = []
    for g in graphs:
        [ws] = Workload([g]).wo_canonical_samples(
            svc.cfg.query_ids, truth=np.zeros((g.n_nodes, 29)))
        tspecs.append(dict(n_nodes=g.n_nodes, node_type=ws.node_type,
                           x=hrng.standard_normal((g.n_nodes, 1)).astype(
                               np.float32),
                           edge_src=ws.edge_src, edge_dst=ws.edge_dst,
                           edge_type=ws.edge_type))
    tparts = topology.harmonized_partitions(
        tspecs, 2, n_types=svc.tgt_cfg.n_edge_types)
    treps = topology.place_replicas(topology.stack_partitions(tparts), grid)
    tparams = member["target"]
    with torch.inference_mode():
        cs.reset_launches()
        outs = topology.dp_halo_shmp_forward(svc.tgt_cfg)(tparams, treps)
        got = cs.read_launches()
        add(got)
        for d, part in enumerate(tparts):
            own = halo.halo_shmp_core(tparams, svc.tgt_cfg,
                                      halo.place_shards(part, [dev]))
            check(all(torch.equal(a, b) for a, b in zip(outs[d], own)),
                  f"composed SHMP forward, replica {d}, differs from its "
                  f"halo_shmp_core")
    want = 8 * sum(per_aggregate(r) for r in treps)
    check(got["gather_segment_sum"] == want
          and got["fused_typed_transform_aggregate"] == 0,
          f"composed SHMP forward launches {got}, expected {want} "
          f"gather-fused K1")
    print(f"dp_halo_shmp_forward (r4 target tower, 2 x 2): each replica "
          f"bit-equal to its halo_shmp_core; launches {json.dumps(got)}",
          flush=True)

    # (d) the graft entry's multi-chip drill, and the build cache; the
    # drill holds DP serving against one device's, so its launches stay
    # out of the path's counts
    cs.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        graft = graft_entry.dryrun_multichip(4)
    graft_launches = cs.read_launches()
    check("OK" in buf.getvalue(), "dryrun_multichip(4) printed no OK")
    print(f"graft_entry.dryrun_multichip(4) on the card in "
          f"{time.perf_counter() - t0:.2f} s (launches, not counted on the "
          f"path: {json.dumps(graft_launches)}): {buf.getvalue().strip()}",
          flush=True)
    out1, err1 = first.communicate(timeout=600)
    check(first.returncode == 0, f"the build-cache probe exited "
          f"{first.returncode}: {err1[-2000:]}")
    t0 = time.perf_counter()
    second = subprocess.run(probe_cmd, capture_output=True, text=True,
                            timeout=600, cwd=REPO)
    second_s = time.perf_counter() - t0
    check(second.returncode == 0, f"the second build-cache probe exited "
          f"{second.returncode}: {second.stderr[-2000:]}")
    b1, b2 = json.loads(out1.splitlines()[-1]), json.loads(
        second.stdout.splitlines()[-1])
    inside = all(p.startswith(os.path.join(b1["path"], "kernels"))
                 for p in b1["libs"].values()) and b1["native"].startswith(
        os.path.join(b1["path"], "native"))
    check(inside and b1["libs"] == b2["libs"],
          f"the build cache did not hold the libraries: {b1}, {b2}")
    check(all(v > 0 for v in b1["build_s"].values())
          and all(v == 0 for v in b2["build_s"].values())
          and b2["native_mtime"] == b1["native_mtime"],
          f"the second process rebuilt a library: {b2['build_s']}")
    cache_dir.cleanup()
    print(f"build cache: a fresh process built "
          f"{json.dumps({k: round(v, 2) for k, v in b1['build_s'].items()})} "
          f"s of nvcc and {b1['native_s']:.2f} s of g++ into it; a second "
          f"process loaded all four without a compiler "
          f"({json.dumps(b2['build_s'])}, native {b2['native_s']:.3f} s; "
          f"{second_s:.1f} s with process start)", flush=True)
    print(f"phase 14 (data parallelism) launches: {json.dumps(dp_launches)}",
          flush=True)
    for name in ("fused_typed_transform_aggregate", "typed_aggregate_bwd",
                 "sorted_segment_sum", "segment_sum_vjp",
                 "gather_segment_sum", "gather_segment_sum_bwd"):
        check(dp_launches[name] > 0, f"phase 14: {name} never launched")
    took = time.perf_counter() - t14
    print(f"phase 14 (data parallelism) took {took:.1f} s", flush=True)
    return {"launches": dp_launches, "serving_ms": dp_req_s * 1e3,
            "predict_ms": dp_ms, "neigh_step": neigh_rows,
            "gossip_step": gossip_rows, "epochs": epochs,
            "dp_halo": {"loss_rel": lerr, "grad_err": gerr, "ms": halo_ms},
            "grid": replicas, "grid_parts": parts, "grid_specs": specs,
            "graft": graft, "seconds": took}


# ------------------------------------------------------- phase 15: tools
# the verify budgets of desco_tpu's analysis/verify_sweep.py, its two
# slowest (1e-2, 3e-2) cut to 3e-3: r4's budget is 1e-3
VERIFY_BUDGETS = (0.0, 1e-3, 3e-3)
# the cut scales of phase 15: scaling's shard counts, large_graph_serving's
# nodes and dataset_statistics' neighborhoods
SCALING_DEVICES = (1, 4)
LARGE_TOOL_NODES = 8000
STATS_SAMPLE = 300
# seven size-6 atlas ids from 77-208 (the star, a path-like tree, cycles
# with chords, K6), each recounted alone by the per-query truth
GT_RECOUNT = (77, 100, 130, 150, 180, 200, 208)
# the kernels every tool run of the phase adds up to: K1 (pooling), the
# gather-fused K1 (query tower, gossip; on the halo streams it is K1')
# and K2 (the target tower)
TOOL_KERNELS = ("sorted_segment_sum", "gather_segment_sum",
                "fused_typed_transform_aggregate")


def tools_phase(torch, cs, card: str, gen_root: str,
                replay_root: str) -> dict:
    """Phase 15: the analysis and experimental tools through their
    ``run`` at the paper width on the card (see the module docstring).
    Launches are zeroed before and read after each tool run; the
    phase's are their sum."""
    from desco_tpu_torch.analysis import norm_mse
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.pipeline import PipelineConfig, pipeline_query_groups
    from desco_tpu_torch.tools import (
        complexity_analysis, compute_groundtruth, dataset_statistics,
        downstream_task, large_graph_serving, runtime, scaling,
        serving_bench, verify_sweep)

    t15 = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="desco_smoke_tools_")
    syn_root = os.path.join(work.name, "data")
    launches, secs, total = {}, {}, {}

    def tool_run(label, tool, argv, **kw):
        cs.reset_launches()
        t0 = time.perf_counter()
        out = tool.run(tool.build_parser().parse_args(
            [str(a) for a in argv]),
            log=lambda line: print(f"  [{label}] {line}", flush=True), **kw)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        launches[label] = cs.read_launches()
        for k, v in launches[label].items():
            total[k] = total.get(k, 0) + v
        check(out.get("device", "cuda") != "cpu",
              f"{label} ran on the CPU, not the card")
        return out

    print(f"phase 15 (tools) on {card}", flush=True)
    # (a) serving_bench: each mode its own fresh service
    sb = {mode: tool_run(f"serving_bench {mode}", serving_bench,
                         ["--mode", mode])
          for mode in ("raw", "service")}
    sb["latency"] = tool_run("serving_bench latency", serving_bench,
                             ["--mode", "latency", "--graphs", 32])
    sb["stream"] = tool_run("serving_bench stream", serving_bench,
                            ["--mode", "stream", "--requests", 4])
    sb["dp2"] = tool_run("serving_bench service --n_devices 2",
                         serving_bench, ["--mode", "service", "--n_devices",
                                         2])
    check(np.isfinite(sb["raw"]["graphlet_counts"]).all(),
          "serving_bench raw: graphlet counts not finite")
    for f in dataclasses.fields(sb["service"]["result"]):
        check(np.array_equal(getattr(sb["dp2"]["result"], f.name),
                             getattr(sb["service"]["result"], f.name)),
              f"serving_bench service: --n_devices 2 {f.name} differs "
              f"from --n_devices 1")
    for res in sb["stream"]["results"]:
        check(np.isfinite(res.graphlet_counts).all()
              and (res.graphlet_counts >= 0).all(),
              "serving_bench stream: counts not finite and >= 0")
    lat = sb["latency"]["latency_ms"]
    print(f"serving_bench on {card}: raw {sb['raw']['graphs_per_s']:.1f} "
          f"graphs/s, {sb['raw']['nodes_per_s']:.0f} nodes/s warm (host "
          f"{sb['raw']['host_s']:.2f} s, stage 1 cold / warm "
          f"{sb['raw']['stage1_s'][0]:.2f} / {sb['raw']['stage1_s'][1]:.2f}"
          f" s, gossip {sb['raw']['gossip_s'][0]:.2f} / "
          f"{sb['raw']['gossip_s'][1]:.2f} s); service "
          f"{sb['service']['graphs_per_s']:.1f} graphs/s "
          f"({sb['service']['warm_s']:.2f} s), --n_devices 2 "
          f"{sb['dp2']['graphs_per_s']:.1f} graphs/s, bit-equal; stream "
          f"{sb['stream']['graphs_per_s']:.1f} graphs/s, overlap gain "
          f"{sb['stream']['overlap_gain']:.2f}x; latency p50 / p90 / p99 "
          f"{lat[50]:.1f} / {lat[90]:.1f} / {lat[99]:.1f} ms", flush=True)

    # (b) compute_groundtruth: the 112 connected size-6 queries
    gt = tool_run("compute_groundtruth", compute_groundtruth, [
        "--dataset", ORDER4_SET, "--query_sizes", 6, "--data_root",
        gen_root])
    check(len(gt["query_ids"]) == 112 and set(gt["sizes"].tolist()) == {6},
          f"compute_groundtruth: {len(gt['query_ids'])} queries of sizes "
          f"{sorted(set(gt['sizes'].tolist()))}, not 112 of size 6")
    check(np.isfinite(gt["truth"]).all() and (gt["truth"] >= 0).all(),
          "compute_groundtruth: a count is negative or not finite")
    wl = Workload(gt["graphs"])
    t0 = time.perf_counter()
    for qid in GT_RECOUNT:
        one = wl.compute_groundtruth([qid])
        check(np.array_equal(
            one[:, 0], gt["truth"][:, gt["query_ids"].index(qid)]),
            f"compute_groundtruth: id {qid} differs from its own recount")
    print(f"compute_groundtruth on {ORDER4_SET} ({len(gt['graphs'])} "
          f"graphs): 112 size-6 queries in {secs['compute_groundtruth']:.2f}"
          f" s, totals {gt['total'].min()}-{gt['total'].max()}; ids "
          f"{list(GT_RECOUNT)} recounted alone, equal "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    # (c) verify_sweep: release/r4 on the replay set
    vs = tool_run("verify_sweep", verify_sweep, [
        "--dataset", REPLAY_SET, "--neigh_checkpoint", R4_NEIGH,
        "--data_root", replay_root, "--budgets", *VERIFY_BUDGETS])
    rows = vs["rows"]
    for a, b in zip(rows, rows[1:]):
        check(b["rows_verified"] > a["rows_verified"],
              f"verify_sweep: rows verified {a['rows_verified']} at "
              f"{a['budget']} -> {b['rows_verified']} at {b['budget']}")
        check(all(y <= x for x, y in zip(a["norm_mse"], b["norm_mse"])),
              f"verify_sweep: normed MSE rose from {a['norm_mse']} at "
              f"{a['budget']} to {b['norm_mse']} at {b['budget']}")
    with open(R4_NEIGH + ".json") as f:
        r4_budget = json.load(f)["config"]["verify_budget"]
    stored = np.load(os.path.join(REPO, "tests", "data",
                                  f"replay_r4_{REPLAY_SET}.npz"))
    want = norm_mse(stored["neighborhood"], stored["truth"],
                    pipeline_query_groups(PipelineConfig()))
    [at_r4] = [r["norm_mse"] for r in rows if r["budget"] == r4_budget]
    vs_rel = max(abs(g - w) / w for g, w in zip(at_r4, want))
    check(vs_rel <= REPLAY_RTOL,
          f"verify_sweep at r4's budget {r4_budget}: normed MSE {at_r4} vs "
          f"the stored replay's {want} (rtol {REPLAY_RTOL})")
    print(f"verify_sweep on {card}: " + "; ".join(
        f"budget {r['budget']:g}: {r['rows_verified']} rows, "
        f"{r['verify_s']:.2f} s, normed MSE "
        + " / ".join(f"{v:.4e}" for v in r["norm_mse"]) for r in rows)
        + f"; forward {vs['forward_s']:.2f} s; at r4's budget within "
        f"{vs_rel:.2e} of the stored replay", flush=True)

    # (d) scaling: the script's defaults at D = 1, 2, 4 on the one card
    sc = {}
    for kind in ("er", "comm"):
        sc[kind] = tool_run(f"scaling {kind}", scaling,
                            ["--graph", kind, "--devices", *SCALING_DEVICES])
        o1, o4 = sc[kind]["out"][1], sc[kind]["out"][4]
        err = float(np.abs(o4 - o1).max() / np.abs(o1).max())
        check(err <= 1e-4, f"scaling {kind}: D = 4 vs D = 1 {err:.2e} of "
                           f"max|out| (1e-4)")
        print(f"scaling {kind} on {card} ({sc[kind]['n_edges']} directed "
              f"edges, D = 4 vs 1 {err:.2e} of max|out|): " + "; ".join(
                  f"D={r['d']} {r['ms_fwd']:.2f} ms/fwd, "
                  f"{r['edge_layers_per_s'] / 1e6:.1f}M edge-layers/s, "
                  f"comm {r['comm'] * 100:.1f}%, pull/push per pair "
                  f"{r['pull_pair']}/{r['push_pair']}"
                  for r in sc[kind]["rows"]), flush=True)

    # (e) large_graph_serving with a fresh service
    lg = tool_run("large_graph_serving", large_graph_serving,
                  ["--nodes", LARGE_TOOL_NODES, "--devices", 4])
    check(np.isfinite(lg["result"].node_counts).all(),
          "large_graph_serving: counts not finite")
    print(f"large_graph_serving on {card}: {lg['nodes']} nodes, wall "
          f"{lg['wall_s']:.2f} s: stage 1 {lg['stage1_s']:.2f} s "
          f"({lg['stage1_batches']} batches), partition "
          f"{lg['partition_s']:.2f} s, halo gossip {lg['gossip_s']:.2f} s, "
          f"n_loc {lg['n_loc']}", flush=True)

    # (f)-(h) on Syn_64
    rt = tool_run("runtime", runtime, ["--dataset", "Syn_64", "--data_root",
                                       syn_root])
    print(f"runtime on {card}: {rt['ms']:.3f} ms per forward, "
          f"{rt['edges_per_s'] / 1e6:.2f}M valid edges/s, "
          f"{rt['graphs_per_s']:.0f} graphs/s ({rt['valid_edges']} valid "
          f"edges, {rt['graphs']} graphs)", flush=True)
    out_dir = os.path.join(work.name, "stats")
    st = tool_run("dataset_statistics", dataset_statistics, [
        "--datasets", "Syn_64", "--sample", STATS_SAMPLE, "--checkpoint",
        R4_NEIGH, "--data_root", syn_root, "--out", out_dir])
    for tag in ("neighborhood_features", "trained_embeddings"):
        check(np.isfinite(st[tag]["kl"]), f"dataset_statistics: t-SNE of "
                                          f"{tag} KL not finite")
        for ext in ("svg", "npy"):
            check(os.path.exists(os.path.join(out_dir, f"tsne_{tag}.{ext}")),
                  f"dataset_statistics wrote no tsne_{tag}.{ext}")
    check(os.path.exists(os.path.join(out_dir,
                                      "neighborhood_features.csv")),
          "dataset_statistics wrote no features CSV")
    print(f"dataset_statistics on {card}: {len(st['feat_rows'])} "
          f"neighborhoods, t-SNE KL {st['neighborhood_features']['kl']:.4f} "
          f"(features) / {st['trained_embeddings']['kl']:.4f} (r4 "
          f"embeddings), {secs['dataset_statistics']:.1f} s", flush=True)
    dt = tool_run("downstream_task", downstream_task,
                  ["--dataset", "Syn_64", "--data_root", syn_root])
    ca = tool_run("complexity_analysis", complexity_analysis,
                  ["--dataset", "Syn_64", "--data_root", syn_root])
    print(f"downstream_task: accuracy with exact counts "
          f"{dt['acc_exact']:.4f}; complexity_analysis ratios "
          + ", ".join(f"{k} {w / max(p, 1):.3g}"
                      for k, (w, p) in ca["sums"].items()), flush=True)
    work.cleanup()

    halo_k1 = (launches["scaling er"]["gather_segment_sum"]
               + launches["scaling comm"]["gather_segment_sum"])
    print(f"phase 15 (tools) launches: {json.dumps(total)}; per tool "
          f"{json.dumps({k: {n: v[n] for n in TOOL_KERNELS} for k, v in launches.items()})}; "
          f"K1' (the halo streams of scaling) {halo_k1}", flush=True)
    for name in TOOL_KERNELS:
        check(total[name] > 0, f"phase 15: {name} never launched")
    check(halo_k1 > 0, "phase 15: K1' never launched on the halo streams")
    check(total["typed_aggregate_bwd"] == total["segment_sum_vjp"]
          == total["gather_segment_sum_bwd"] == 0,
          "phase 15: a backward kernel launched in the tools")
    took = time.perf_counter() - t15
    print(f"phase 15 (tools) took {took:.1f} s: "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}",
          flush=True)
    return {"launches": total, "per_tool": launches, "seconds": took}


# ------------------------------------------- phase 16: compiled steps
@contextlib.contextmanager
def guard_watch(torch, loop):
    """Record the sync debug mode inside every ``no_sync`` block the
    training loop enters: a graphed loop must run under mode 2
    ("error")."""
    modes, orig = [], loop.no_sync

    @contextlib.contextmanager
    def watched(device):
        with orig(device):
            modes.append(torch.cuda.get_sync_debug_mode())
            yield

    loop.no_sync = watched
    try:
        yield modes
    finally:
        loop.no_sync = orig


def graphed_run(torch, cs, loop, train, ckpt: str, graphed: bool) -> dict:
    """One run of ``train(ckpt_path, graphed, **logging) -> TrainResult``
    (eager or graphed steps): its result, final parameters, ``.last`` Adam
    state, launches, wall seconds, log lines and the sync debug modes of
    its guarded loops."""
    from desco_tpu_torch.train.checkpoint import flatten_params

    lines = []
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with guard_watch(torch, loop) as modes:
        res = train(ckpt_path=ckpt, graphed=graphed, log_every=1,
                    log_fn=lines.append, snapshot_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(res=res, params=flatten_params(res.params),
                opt=dict(np.load(ckpt + ".last.opt.npz")),
                launches=cs.read_launches(), wall=wall, lines=lines,
                guard=modes)


def compare_runs(torch, cs, loop, name: str, train, epochs: int,
                 workdir: str, want: Optional[dict] = None,
                 lr_decays: bool = False) -> dict:
    """Run ``train`` eager and graphed from the same weights and seed:
    train and val losses, final parameters and Adam's ``.last`` state
    bit-equal, launches equal (and equal to ``want`` where given), every
    graphed loop under the guard and no eager one; prints and returns the
    launches per epoch and the epoch ms both ways."""
    runs = {g: graphed_run(torch, cs, loop, train,
                           os.path.join(workdir, f"{name}_{g}"), g)
            for g in (False, True)}
    e, g = runs[False], runs[True]
    check(torch.cuda.get_sync_debug_mode() == 0,
          f"phase 16 ({name}): the sync debug mode was not put back")
    check(not e["guard"] and len(g["guard"]) >= epochs
          and all(m == 2 for m in g["guard"]),
          f"phase 16 ({name}): guarded loops eager {e['guard']}, graphed "
          f"{g['guard']}")
    check(e["res"].train_losses == g["res"].train_losses
          and e["res"].val_losses == g["res"].val_losses,
          f"phase 16 ({name}): losses differ, eager "
          f"{e['res'].train_losses} / {e['res'].val_losses}, graphed "
          f"{g['res'].train_losses} / {g['res'].val_losses}")
    differ = [k for k, v in e["params"].items()
              if not np.array_equal(v, g["params"][k])]
    differ += [k for k, v in e["opt"].items()
               if not np.array_equal(v, g["opt"][k])]
    check(not differ, f"phase 16 ({name}): parameters or Adam state "
          f"differ: {differ[:5]}")
    check(e["launches"] == g["launches"],
          f"phase 16 ({name}): launches differ, eager {e['launches']}, "
          f"graphed {g['launches']}")
    if want is not None:
        check(launches_match(g["launches"], want),
              f"phase 16 ({name}): launches {g['launches']}, expected "
              f"{want}")
    lrs = [ln.split(" lr ")[1].split()[0] for ln in g["lines"]
           if " lr " in ln]
    if lr_decays:
        # the last epoch runs at the rate the schedule left after the one
        # before it
        check(float(lrs[-2]) < float(lrs[0]),
              f"phase 16: no plateau decay reached a later epoch's device "
              f"learning rate: {lrs}")
    row = {"epochs": epochs, "lr_per_epoch": lrs,
           "launches_per_epoch": {
               k: v / epochs for k, v in g["launches"].items() if v},
           "capture_lines": [ln for ln in g["lines"]
                             if ln.startswith("compiled steps")
                             or "runs eager" in ln]}
    for tag, r in (("eager", e), ("graphed", g)):
        res = r["res"]
        row[tag] = {"epoch_ms": [1e3 * t for t in res.epoch_times],
                    "train_ms": [1e3 * t for t in res.train_times],
                    "wall_s": r["wall"]}
    print(f"phase 16 ({name}): graphed == eager bit for bit over {epochs} "
          f"epochs (losses {g['res'].train_losses}, val "
          f"{g['res'].val_losses}, lr {lrs}); {len(g['guard'])} graphed "
          f"loops under the guard; launches per epoch "
          f"{json.dumps(row['launches_per_epoch'])}; epoch ms eager "
          f"{[round(x, 1) for x in row['eager']['epoch_ms']]} (train "
          f"{[round(x, 1) for x in row['eager']['train_ms']]}), graphed "
          f"{[round(x, 1) for x in row['graphed']['epoch_ms']]} (train "
          f"{[round(x, 1) for x in row['graphed']['train_ms']]}); wall "
          f"{e['wall']:.2f} / {g['wall']:.2f} s; {row['capture_lines']}",
          flush=True)
    return row


def placed_steps(torch, cs, loop, name: str, make_step, params, place,
                 q_embs, seed: int) -> dict:
    """A halo-style train step (``make_step(opt, graphed)``: the halo
    gossip step or the DP x halo step over ``place``) eager against
    graphed from the same weights: four calls each (seeds seed, seed + 1,
    seed, seed + 1; the graphed form's first call captures, the other
    three replay under the guard), losses, flags, gradients, parameters
    and Adam's moments bit-equal after every call, launches equal; ms per
    call both ways."""
    from desco_tpu_torch.utils import cuda_graphs as graphed_mod

    lr = torch.tensor(1e-3, device=q_embs.device)
    runs = {}
    for graphed in (False, True):
        p = copy.deepcopy(params)
        opt = loop.make_adam(p)
        step = make_step(opt, graphed)
        calls, ms = [], []
        cs.reset_launches()
        for i, sd in enumerate((seed, seed + 1, seed, seed + 1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (graphed_mod.no_sync(q_embs.device) if graphed and i
                  else contextlib.nullcontext()):
                loss, ok = step(p, place, q_embs, lr, seed=sd)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            calls.append((loss, ok, opt.grad.clone(), opt.flat.clone(),
                          opt.mu.clone(), opt.nu.clone()))
        runs[graphed] = dict(calls=calls, ms=ms,
                             launches=cs.read_launches())
    e, g = runs[False], runs[True]
    check(torch.cuda.get_sync_debug_mode() == 0,
          f"phase 16 ({name}): the sync debug mode was not put back")
    check(all(all(torch.equal(a, b) for a, b in zip(x, y))
              for x, y in zip(e["calls"], g["calls"]))
          and all(bool(c[1]) for c in g["calls"]),
          f"phase 16 ({name}): graphed differs from eager: losses "
          f"{[float(c[0]) for c in e['calls']]} / "
          f"{[float(c[0]) for c in g['calls']]}")
    check(e["launches"] == g["launches"],
          f"phase 16 ({name}): launches eager {e['launches']}, graphed "
          f"{g['launches']}")
    check(not torch.equal(e["calls"][0][0], e["calls"][2][0]),
          f"phase 16 ({name}): the steps did not move the loss")
    print(f"phase 16 ({name}): graphed == eager bit for bit over 4 calls "
          f"(losses {[float(c[0]) for c in g['calls']]}), launches "
          f"{json.dumps({k: v for k, v in g['launches'].items() if v})}; ms "
          f"per call eager {[round(x, 2) for x in e['ms']]}, graphed "
          f"{[round(x, 2) for x in g['ms']]} (the first captures)",
          flush=True)
    return {"eager_ms": e["ms"], "graphed_ms": g["ms"],
            "launches": g["launches"]}


def graphed_phase(torch, cs, dev, tcfg, train_stage, qb, gbatches,
                  gossip_params, q_embs, halo_shards, grid,
                  workdir: str) -> dict:
    """Phase 16: the compiled steps (utils/cuda_graphs.py) against the eager
    ones on the phase-6 training set, from the same weights and seed, on
    the card: (a) the guard the graphed loops run under raises on a
    read-back; (b) 2 neighborhood epochs in f32 and with ``train_bf16``,
    and 3 at a learning rate of 1e-9 with patience 0 (a plateau decay
    after every epoch past the first), each eager and graphed: train and
    val losses, final parameters and Adam's ``.last`` state bit-equal,
    the same launches, the graphed loops under the guard, epoch ms both
    ways; (c) the gossip eval pass over phase 6's gossip batches and
    trained model, graphed against eager, bit-equal, with its ms; (d) 2
    gossip epochs at dropout 0.01 and 0, the same checks, launches as
    counted per batch; (e) 2 epochs of each stage data-parallel at D = 2
    on the one card, the same checks; (f) the halo gossip step on phase
    13's training shards and the DP x halo step on phase 14's 2 x 2
    grid, eager against graphed, bit-equal, with ms. Returns the
    figures."""
    from desco_tpu_torch.batch.packed import stack_batches
    from desco_tpu_torch.parallel import dp, halo, topology
    from desco_tpu_torch.pipeline import train_neighborhood_stage
    from desco_tpu_torch.utils import cuda_graphs as graphed_mod
    from desco_tpu_torch.train import loop

    t16 = time.perf_counter()
    probe_t = torch.ones((), device=dev)
    try:
        with graphed_mod.no_sync(dev):
            probe_t.item()
    except RuntimeError:
        pass
    else:
        fail("phase 16: a read-back under set_sync_debug_mode('error') did "
             "not raise")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "phase 16: the sync debug mode was not put back")

    def neigh(cfg, **kw):
        return lambda **run: train_neighborhood_stage(
            cfg, train_stage, train_stage, qb, device=dev, **kw, **run)[0]

    cases = (
        ("f32", 2, neigh(dataclasses.replace(tcfg, neigh_epochs=2))),
        ("train_bf16", 2, neigh(dataclasses.replace(
            tcfg, neigh_epochs=2, train_bf16=True))),
        ("f32, plateau decay", 3, neigh(dataclasses.replace(
            tcfg, neigh_epochs=3, neigh_lr=1e-9), patience=0,
            min_lr=1e-12)),
        # masks drawn from the run's generator, registered with the graph
        ("f32, dropout 0.1", 2, neigh(dataclasses.replace(
            tcfg, neigh_epochs=2, neigh_dropout=0.1))))
    out = {"cases": {}}
    for name, epochs, train in cases:
        out["cases"][name] = compare_runs(
            torch, cs, loop, name, train, epochs, workdir,
            lr_decays="plateau" in name)

    # (c) the gossip eval pass, graphed against eager
    stacked = stack_batches(gbatches).to(dev, training=True)
    gdev = [stacked[i] for i in range(len(gbatches))]
    embs = q_embs.clone()
    lr_dev = torch.tensor(1e-3, device=dev)
    passes = {}
    for graphed in (False, True):
        p = copy.deepcopy(gossip_params).to(dev)
        steps = loop.Steps(
            p, loop.make_adam(p), loop.gossip_loss_fn(0.0, embs),
            loop.gossip_eval_fn(embs), gdev, gdev, lr_dev, None, dev,
            graphed=graphed, prepare=loop.gossip_prepare)
        check(isinstance(steps.eval, graphed_mod.GraphedStep) == graphed
              and isinstance(steps.train, graphed_mod.GraphedStep)
              == graphed,
              "phase 16: the gossip stage's steps are not both graphed")
        cs.reset_launches()
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            val = steps.val_loss(gdev)
            ms.append(1e3 * (time.perf_counter() - t0))
        passes[graphed] = dict(val=val, ms=ms,
                               carry=[t.clone() for t in steps.eval_carry],
                               launches=cs.read_launches())
        del steps
    e, g = passes[False], passes[True]
    check(all(torch.equal(a, b) for a, b in zip(e["carry"], g["carry"])),
          f"phase 16: the graphed gossip eval pass differs: {e['val']} / "
          f"{g['val']}")
    check(e["launches"] == g["launches"]
          and g["launches"]["gather_segment_sum"]
          == 4 * len(gdev) * GOSSIP_FWD_PER_EVAL,
          f"phase 16: gossip eval launches eager {e['launches']}, graphed "
          f"{g['launches']}")
    out["gossip_eval"] = {"batches": len(gdev), "val": g["val"],
                          "eager_ms": e["ms"], "graphed_ms": g["ms"]}
    print(f"phase 16 gossip eval pass ({len(gdev)} batches): graphed == "
          f"eager bit for bit ({g['val']}); ms eager "
          f"{[round(x, 2) for x in e['ms']]}, graphed "
          f"{[round(x, 2) for x in g['ms']]}", flush=True)
    del stacked, gdev

    # (d) the gossip train step: 2 epochs (train and val over the same
    # batches) at dropout 0.01, the paper's, and at 0
    n_gb = len(gbatches)

    def gossip(rate, mesh=None):
        return lambda **run: loop.train_gossip(
            copy.deepcopy(gossip_params), embs, gbatches, gbatches,
            epochs=2, lr=1e-3, dropout=rate, seed=16, device=dev, mesh=mesh,
            **run)

    for rate in (0.01, 0.0):
        name = f"gossip, dropout {rate}"
        out["cases"][name] = compare_runs(
            torch, cs, loop, name, gossip(rate), 2, workdir,
            want={"gather_segment_sum": 2 * n_gb * (GOSSIP_FWD_PER_STEP
                                                    + GOSSIP_FWD_PER_EVAL),
                  "gather_segment_sum_bwd": 2 * n_gb * GOSSIP_BWD_PER_STEP,
                  "fused_typed_transform_aggregate": 0,
                  "sorted_segment_sum": 0})

    # (e) data parallelism at D = 2 on the one card, both stages
    mesh2 = dp.make_mesh(2, dev)
    n_b = len(train_stage.batches)
    pad_b, pad_g = -(-n_b // 2) * 2, -(-n_gb // 2) * 2
    out["cases"]["DP D = 2, neighborhood"] = compare_runs(
        torch, cs, loop, "DP D = 2, neighborhood",
        neigh(dataclasses.replace(tcfg, neigh_epochs=2), mesh=mesh2), 2,
        workdir, want={"typed_aggregate_bwd": 8 * 2 * pad_b,
                       "fused_typed_transform_aggregate":
                           8 * 2 * (pad_b + n_b)})
    out["cases"]["DP D = 2, gossip, dropout 0.01"] = compare_runs(
        torch, cs, loop, "DP D = 2, gossip, dropout 0.01",
        gossip(0.01, mesh2), 2, workdir,
        want={"gather_segment_sum": 2 * (pad_g * GOSSIP_FWD_PER_STEP
                                         + n_gb * GOSSIP_FWD_PER_EVAL),
              "gather_segment_sum_bwd": 2 * pad_g * GOSSIP_BWD_PER_STEP})

    # (f) the halo steps of phases 13 and 14, dropout 0.01
    out["halo_step"] = placed_steps(
        torch, cs, loop, f"halo gossip step, {len(halo_shards)} shards",
        lambda opt, g: halo.halo_gossip_step_fn(opt, 0.01, graphed=g),
        gossip_params, halo_shards, embs, 16)
    out["dp_halo_step"] = placed_steps(
        torch, cs, loop, "DP x halo step, 2 x 2",
        lambda opt, g: topology.dp_halo_gossip_step_fn(opt, 0.01,
                                                       graphed=g),
        gossip_params, grid, embs, 16)
    out["seconds"] = time.perf_counter() - t16
    print(f"phase 16 (compiled steps) took {out['seconds']:.1f} s",
          flush=True)
    return out


# ----------------------------------------- phase 17: compiled serving
# the bounds are integer-valued f32 sums that ``index_add_`` adds in no
# fixed order on the card: every order gives the same bits where the sums
# stay integers below 2^24, and agrees to rtol 1e-6 above
EXACT_F32 = 2.0 ** 24
BOUNDS_RTOL = 1e-6


def same_result(a, b, what: str) -> int:
    """Two ``CountResult``s field by field: bit-equal, except counts of
    2^24 and more, which a bound at or above 2^24 may have clamped to
    values that differ within rtol 1e-6. Returns how many such entries
    differ."""
    loose = 0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            check(x.shape == y.shape, f"{what}: {f.name} shapes differ")
            diff = x != y
            big = np.abs(y) >= EXACT_F32
            rel = np.abs(x - y) / np.maximum(np.abs(y), 1.0)
            check(not (diff & ~big).any()
                  and (rel[diff] <= BOUNDS_RTOL).all(),
                  f"{what}: {f.name} differs graphed vs eager in "
                  f"{int(diff.sum())} entries ({int((diff & ~big).sum())} "
                  f"below 2^24)")
            loose += int(diff.sum())
        else:
            check(np.array_equal(x, y), f"{what}: {f.name} differs")
    return loose


def both_ways(torch, cs, run, what: str) -> dict:
    """``run(graphed)`` eager, then graphed: their results compared
    (``same_result``), launches equal; {way: (result, seconds,
    launches)}."""
    out = {}
    for graphed in (False, True):
        cs.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(graphed)
        torch.cuda.synchronize()
        out[graphed] = (res, time.perf_counter() - t0, cs.read_launches())
    loose = same_result(out[True][0], out[False][0], what)
    check(out[True][2] == out[False][2], f"{what}: launches graphed "
          f"{out[True][2]} != eager {out[False][2]}")
    print(f"{what}: graphed {out[True][1]:.2f} s, eager {out[False][1]:.2f} "
          f"s (the graphed one's first request captures); results "
          f"{'bit-equal' if not loose else f'equal but {loose} counts over 2^24 within rtol 1e-6'}; launches equal", flush=True)
    return out


# phase 17's stages of a request by the tracer's spans (utils/trace.py)
# that make them up; each device stage ends in a read-back to the host,
# so its device work finishes inside its spans
SERVING_STAGES = {
    "prepare (host)": ("request.prepare",),
    "neighborhood forward": ("stage1.stage", "stage1.replay",
                             "stage1.readback"),
    "bounds": ("bounds.host", "bounds.stage", "bounds.replay",
               "bounds.readback"),
    "verify (VF2)": ("verify",),
    "gossip packing (host)": ("gossip.pack",),
    "gossip forward": ("gossip.stage", "gossip.replay", "gossip.readback"),
    "guards": ("guards",)}


def traced_stages(fn):
    """(``fn()``, its wall seconds, {stage: seconds}): each stage of
    ``SERVING_STAGES`` the summed length of its spans, a span inside
    another stage's span counted under that one only. The tracer is on
    around ``fn`` and is turned on and drained outside the clock."""
    from desco_tpu_torch.utils import trace

    trace.drain()
    trace.enable()
    try:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    finally:
        trace.disable()
    spans, _ = trace.drain()
    stage_of = {name: stage for stage, names in SERVING_STAGES.items()
                for name in names}
    by_id = {sp.id: sp for sp in spans}
    stages = dict.fromkeys(SERVING_STAGES, 0.0)
    for sp in spans:
        if sp.name not in stage_of:
            continue
        up = by_id.get(sp.parent)
        while up is not None and up.name not in stage_of:
            up = by_id.get(up.parent)
        if up is None:
            stages[stage_of[sp.name]] += (sp.t1 - sp.t0) / 1e9
    return out, wall, stages


def compiled_serving_phase(torch, cs, dev, seed: int, svc, main_req,
                           res_main, main_stage, phase3_buckets,
                           gen_root: str, replay_root: str,
                           work_dir: str) -> dict:
    """Phase 17: the compiled serving forwards against the eager ones on
    the card. (a) phase 3's 256-graph request through a fresh graphed
    service and a fresh eager one, both with phase 3's buckets, in the
    order graphed, eager, graphed: every result bit-equal to phase 3's,
    the graphed service's second request (its captures made by its
    first) and the eager one's request timed per stage;
    the device stages' difference is the change's effect, the rest of the
    wall (host VF2 above all) no graph touches; the forwards' pool; every
    target batch's bounds through
    the compiled ``_batch_bounds`` against the eager one (bit-equal under
    2^24, rtol 1e-6 above); (b) a ``serve_bf16`` request, a two-member
    ensemble request and phase 10's labeled request (784 queries) both
    ways; (c) D = 2 DP serving
    both ways; (d) ``count_large_graph`` on phase 18's 8,000-node graph
    (phase 13 serves the 20,000-node one), fresh services both ways, the
    halo serve's capture and replay seconds; (e) the bench both ways in this process; (f) one epoch of
    the DIAMNet driver both ways. Launches equal both ways throughout."""
    from desco_tpu_torch import baseline as base_mod
    from desco_tpu_torch import bench as bench_mod
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.pipeline import pipeline_queries
    from desco_tpu_torch.serving import CountingService
    from desco_tpu_torch.utils.cuda_graphs import ForwardCache, no_sync
    from desco_tpu_torch.truth.bounds import (_batch_bounds,
                                              _hashable_schedules)

    t17 = time.perf_counter()
    out = {}

    def service(graphed, *a, **k):
        s = CountingService(*(a or (R4_NEIGH, R4_GOSSIP)), device=dev,
                            graphed=graphed, **k)
        s._neigh_buckets, s._gossip_buckets = (dict(b) for b in
                                               phase3_buckets)
        return s

    # (a) the 256-graph request: a fresh service each way (graphed, eager,
    # graphed); the graphed one's second request is timed, its captures
    # made by its first, and the eager one's only request, in a process
    # that phase 3 warmed
    services = {"graphed": service(True), "eager": service(False)}
    ways, captured = {}, []
    for name in ("graphed", "eager", "graphed"):
        cs.reset_launches()
        res, wall, stages = traced_stages(
            lambda: services[name].count(main_req))
        same_result(res, res_main, f"256-graph request {name} vs phase 3")
        ways[name] = (res, wall, dict(stages), cs.read_launches())
        if name == "graphed":
            captured.append(services[name].graphs.stats()["captures"])
    check(ways["graphed"][3] == ways["eager"][3],
          f"256-graph request launches graphed {ways['graphed'][3]} != "
          f"eager {ways['eager'][3]}")
    pool = services["graphed"].graphs.stats()
    check(captured[0] == captured[1],
          f"the graphed service's second request captured "
          f"{captured[1] - captured[0]} forwards again")
    for name, (res, wall, stages, _) in ways.items():
        print(f"256-graph request {name} "
              f"({'second' if name == 'graphed' else 'first'} request): "
              f"{wall * 1e3:.1f} ms; stage ms "
              f"{json.dumps({k: round(v * 1e3, 2) for k, v in stages.items()})}"
              f"; {len(res.verified_rows)} verified rows", flush=True)
    device_stages = ("neighborhood forward", "bounds", "gossip forward",
                     "guards")
    delta = {k: (ways["graphed"][2][k] - ways["eager"][2][k]) * 1e3
             for k in device_stages}
    rest = ((ways["graphed"][1] - sum(ways["graphed"][2][k]
                                      for k in device_stages))
            - (ways["eager"][1] - sum(ways["eager"][2][k]
                                      for k in device_stages))) * 1e3
    print(f"256-graph request, graphed minus eager: device stages ms "
          f"{json.dumps({k: round(v, 2) for k, v in delta.items()})} "
          f"(sum {sum(delta.values()):.2f}, the change's effect); the rest "
          f"of the wall {rest:.1f} ms (host VF2, preparation and packing, "
          f"which no graph touches: run-to-run noise)", flush=True)
    print(f"the graphed service: {pool['forwards']} compiled forwards "
          f"held, {pool['captures']} captured in {pool['capture_s']:.2f} s; "
          f"their memory pool {pool['pool_bytes']} bytes", flush=True)
    out["request"] = {name: {"ms": w * 1e3,
                             "stage_ms": {k: v * 1e3 for k, v in st.items()}}
                      for name, (_, w, st, _) in ways.items()}
    out["request"]["device_stage_delta_ms"] = delta
    out["pool"] = pool

    # the bounds of every target batch, compiled against eager
    sched = _hashable_schedules(pipeline_queries(svc.cfg))
    cache = ForwardCache()
    stacked = [b.to(dev) for b in main_stage.batches]
    n_big = n_diff = 0
    with torch.inference_mode():
        for b in stacked:
            ref = _batch_bounds(b, sched, 1)
            got = cache(lambda x: _batch_bounds(x, sched, 1), (b,),
                        static="bounds")
            with no_sync(dev):
                again = cache(lambda x: _batch_bounds(x, sched, 1), (b,),
                              static="bounds")
            for g in (got, again):
                big = ref >= EXACT_F32
                diff = g != ref
                check(not (diff & ~big).any(), "bounds under 2^24 differ "
                      "graphed vs eager")
                rel = ((g - ref).abs() / ref.abs().clamp(min=1.0))[diff]
                check(rel.numel() == 0 or float(rel.max()) <= BOUNDS_RTOL,
                      "bounds over 2^24 differ by more than rtol 1e-6")
                n_diff += int(diff.sum())
            n_big += int(big.sum())
    check(cache.captures == 1, f"{cache.captures} captures of one shape")
    print(f"bounds of {len(stacked)} target batches, compiled (one "
          f"capture, replays under no_sync) vs eager: bit-equal under "
          f"2^24; {n_big} values at or over 2^24, {n_diff} differing "
          f"within rtol {BOUNDS_RTOL}", flush=True)

    # (b) a bf16 request, an ensemble request and the labeled request
    small = main_req[:32]
    both_ways(torch, cs, lambda g: service(
        g, config_overrides={"serve_bf16": True}).count(small),
        "serve_bf16, 32 graphs")
    both_ways(torch, cs, lambda g: service(g, [R4_NEIGH, R4_NEIGH],
                                           R4_GOSSIP).count(small),
              "two-member ensemble, 32 graphs")
    eye = np.eye(N_LABELS, dtype=np.float32)
    lrng = np.random.default_rng(seed + 10)
    labeled = [Graph(g.n_nodes, g.edges, eye[lrng.integers(0, N_LABELS,
                                                           g.n_nodes)])
               for g in load_data(LABELED_SET, gen_root)]
    lab_ckpt = os.path.join(work_dir, "labeled", "neigh.best")

    def labeled_request(graphed):
        s = CountingService(lab_ckpt, device=dev, graphed=graphed)
        check(tuple(s.member_embs[0].shape) == (784, 64),
              "the labeled service's query set is not 784")
        return s.count(labeled)

    both_ways(torch, cs, labeled_request,
              f"labeled request (784 queries, {len(labeled)} graphs)")

    # (c) D = 2 DP serving on one card
    both_ways(torch, cs, lambda g: service(g, n_devices=2).count(
        main_req[:64]), "D = 2 DP serving, 64 graphs")

    # (d) count_large_graph on phase 18's third graph, fresh services
    big_g = ba_graph(Graph, DIST_GRID_THIRD[0], HALO_DEGREE,
                     DIST_GRID_THIRD[1])
    large_stats = {}

    def large(graphed):
        s = CountingService(R4_NEIGH, R4_GOSSIP, device=dev,
                            graphed=graphed)
        st = large_stats[graphed] = {}
        return s.count_large_graph(big_g, n_devices=HALO_SHARDS, stats=st)

    lg = both_ways(torch, cs, large, f"count_large_graph ({big_g.n_nodes} "
                   f"nodes, {HALO_SHARDS} shards)")
    check(large_stats[True]["graphed"] and not large_stats[False]["graphed"],
          "the halo serve did not run graphed / eager as asked")
    for g in (True, False):
        st = large_stats[g]
        print(f"count_large_graph {'graphed' if g else 'eager'}: "
              f"{lg[g][1]:.2f} s wall, stage 1 {st['stage1_s']:.2f} s, "
              f"partition {st['partition_s']:.2f} s, halo gossip "
              f"{st['gossip_s']:.3f} s (of it capture "
              f"{st['capture_s']:.3f} s)", flush=True)
    out["large"] = {("graphed" if g else "eager"):
                    {k: v for k, v in large_stats[g].items()
                     if k.endswith("_s")} | {"wall_s": lg[g][1]}
                    for g in (True, False)}

    # (e) the bench both ways, in this process
    bench_lines = {}
    for g in (False, True):
        rc, text = run_teed(bench_mod.main, [] if g else ["--eager"])
        check(rc == 0, f"bench {'graphed' if g else '--eager'} returned {rc}")
        bench_lines[g] = json.loads([ln for ln in text.splitlines()
                                     if ln.startswith("{")][-1])
    check(bench_lines[True]["launches"] == bench_lines[False]["launches"],
          "bench: launches per forward differ graphed vs eager")
    out["bench"] = {("graphed" if g else "eager"):
                    {k: bench_lines[g][k] for k in
                     ("forward_ms", "train_step_ms", "value",
                      "sol_fraction")} for g in (True, False)}
    print(f"bench (f32, this process): forward "
          f"{bench_lines[True]['forward_ms']} ms graphed, "
          f"{bench_lines[False]['forward_ms']} ms eager; train step "
          f"{bench_lines[True]['train_step_ms']} ms graphed, "
          f"{bench_lines[False]['train_step_ms']} ms eager; launches per "
          f"forward equal", flush=True)

    # (f) one epoch of the DIAMNet driver both ways
    texts, walls, dl = {}, {}, {}
    for g in (False, True):
        cs.reset_launches()
        t0 = time.perf_counter()
        rc, text = run_teed(base_mod.main, [
            "--baseline", "DIAMNET", "--train_dataset", REPLAY_SET,
            "--test_dataset", REPLAY_SET, "--epoch_num", "1", "--seed",
            str(seed), "--data_root", replay_root] + ([] if g else
                                                      ["--eager"]))
        walls[g] = time.perf_counter() - t0
        dl[g] = cs.read_launches()
        check(rc == 0, f"baseline DIAMNET {'graphed' if g else 'eager'} "
              f"returned {rc}")
        texts[g] = [re.sub(r" [0-9.]+s$", "", ln)
                    for ln in text.splitlines()]
    check(texts[True] == texts[False], "baseline DIAMNET: printed losses "
          "or figures differ graphed vs eager")
    check(dl[True] == dl[False], f"baseline DIAMNET launches graphed "
          f"{dl[True]} != eager {dl[False]}")
    out["baseline_s"] = {"graphed": walls[True], "eager": walls[False]}
    print(f"baseline DIAMNET, 1 epoch on {REPLAY_SET}: graphed "
          f"{walls[True]:.1f} s, eager {walls[False]:.1f} s (captures "
          f"included); losses and figures equal, launches equal", flush=True)
    print(f"phase 17 (compiled serving) took "
          f"{time.perf_counter() - t17:.1f} s", flush=True)
    return out


def prepare_gossip_batches_for(svc, stage, counts):
    """The gossip batches ``svc`` serves for ``stage`` (its pinned
    buckets)."""
    from desco_tpu_torch.pipeline import prepare_gossip_batches

    return prepare_gossip_batches(
        svc.cfg, stage, counts,
        capacities=lambda s: svc._pin_caps(svc._gossip_buckets, s,
                                           svc.cfg.gossip_batch_size))


# ------------------------------ phase 18: data parallelism across processes
# the ranks of phase 18 (two on the one card, gloo), the group's timeout
# and the children's (every child is killed past it and the phase fails)
DIST_WORLD = 2
DIST_GROUP_TIMEOUT_S = 240.0
DIST_JOIN_TIMEOUT_S = 300.0
# phase 18's torchrun run of ``main``: paper width, 1 epoch per stage
DIST_MAIN_FLAGS = ["--train_dataset", "SynNp_32_3", "--valid_dataset",
                   "SynNp_32_3", "--test_dataset", "SynNp_16_4",
                   "--neigh_epoch_num", "1", "--gossip_epoch_num", "1"]
# the kernels of the path, by counter name
PATH_KERNELS = ("sorted_segment_sum", "gather_segment_sum",
                "fused_typed_transform_aggregate", "typed_aggregate_bwd",
                "segment_sum_vjp")


def dist_steps(torch, dp, step_fn, params, group_of, n_steps, gens=None):
    """``n_steps`` calls of a DP step (``dp.DPStep``) over the groups
    ``group_of(i)``, the replica generators reseeded per step: (losses,
    flags, the first step's reduced gradient, the final parameters,
    Adam's first moment, ms per step after the first)."""
    opt = step_fn.opt
    losses, oks, grad1, ms = [], [], None, []
    for i in range(n_steps):
        if gens is not None:
            dp.reseed_replica_generators(gens, 18 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, ok = step_fn(params, group_of(i), 1e-3, gens)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        oks.append(bool(ok))
        if grad1 is None:
            grad1 = opt.grad.cpu().numpy().copy()
    return {"losses": losses, "oks": oks, "grad1": grad1,
            "flat": opt.flat.cpu().numpy().copy(),
            "mu": opt.mu.cpu().numpy().copy(), "ms": ms[1:]}


def dist_workload(torch, job, dev, reference: bool = False):
    """Phase 18's work on one process: the D = 2 DP neighborhood and
    gossip steps (eager and graphed), both DP predicts and the 2 x 2
    DP x halo step, over ``dp.make_mesh(2)`` and ``make_mesh2d(2, 2)``:
    across the ranks in a rank, in one process in the parent. Returns
    numpy results, ms and the gather's ms. ``reference`` (the parent):
    the predicts and the DP x halo step eager alone, no gather timed."""
    from desco_tpu_torch.models.shmp_gnn import prepare_batch
    from desco_tpu_torch.parallel import dp, topology
    from desco_tpu_torch.pipeline import model_configs
    from desco_tpu_torch.train import loop as train_loop
    from desco_tpu_torch.train.checkpoint import params_from_jax
    from desco_tpu_torch.utils import distributed

    tgt_cfg, qry_cfg = model_configs(job["tcfg"], dev)
    mesh = dp.make_mesh(2, dev)
    q_dev = job["qb"].to(dev)
    prepare_batch(q_dev, qry_cfg.n_edge_types, backward=True)
    q_embs = torch.from_numpy(job["q_embs"]).to(dev)
    out = {"local": list(mesh.local)}

    def groups(batches, prep):
        placed = dp.reshape_for_dp(dp.place_batches(
            dp.pad_batches_to_multiple(list(batches), 2), mesh,
            training=True), 2)
        for g in placed:
            for b in g:
                if not isinstance(b, dp.RemoteBatch):
                    prep(b)
        return placed

    stages = {
        "neighborhood": (
            groups(job["tbs"], lambda b: prepare_batch(
                b, tgt_cfg.n_edge_types, True)),
            train_loop.neighborhood_loss_fn(tgt_cfg, qry_cfg, q_dev),
            job["neigh"], "graphs"),
        "gossip": (
            groups(job["gbs"], lambda b: train_loop.gossip_prepare(b, True)),
            train_loop.gossip_loss_fn(job["dropout"], q_embs),
            job["gossip"], "sum")}
    for name, (grs, loss_fn, flat0, kind) in stages.items():
        for graphed in (False, True):
            params = params_from_jax(flat0).to(dev)
            opt = train_loop.make_adam(params)
            step = dp.DPStep(loss_fn, opt, mesh, kind, graphed=graphed)
            gens = dp.replica_generators(mesh, 18)
            out[name, graphed] = dist_steps(
                torch, dp, step, params, lambda i: grs[i % len(grs)],
                job["n_steps"], gens)
    if not reference:
        # the gather of one step's terms (a [1, n + 1] row per rank)
        n = sum(p.numel()
                for p in params_from_jax(job["neigh"]).parameters())
        row = torch.zeros((len(mesh.local), n + 1), device=dev)
        ms = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distributed.gather_in_rank_order(row)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["gather_ms"] = ms[5:]
        out["gather_bytes"] = 4 * (n + 1)
    # both DP predicts
    best = params_from_jax(job["best"]).to(dev).requires_grad_(False)
    gbest = params_from_jax(job["gbest"]).to(dev).requires_grad_(False)
    out["predict_neigh"] = dp.dp_predict_neighborhood_counts(
        best, tgt_cfg, q_embs, job["pred_tbs"], mesh, graphed=not reference)
    out["predict_gossip"] = dp.dp_predict_gossip_counts(
        gbest, q_embs, job["pred_gbs"], mesh, graphed=not reference)
    # the 2 x 2 DP x halo step, two calls each way
    grid = topology.make_mesh2d(2, 2, devices=[dev])
    replicas = topology.place_replicas(
        topology.stack_partitions(job["parts"]), grid)
    hq = torch.from_numpy(job["halo_q"]).to(dev)
    for graphed in (False,) if reference else (False, True):
        params = params_from_jax(job["halo_gossip"]).to(dev)
        opt = train_loop.make_adam(params)
        step = topology.dp_halo_gossip_step_fn(opt, dropout=job["dropout"],
                                               graphed=graphed)
        calls, ms = [], []
        for seed in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, ok = step(params, replicas, hq, 1e-3, seed=seed)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            calls.append([float(loss), bool(ok)] + [
                t.cpu().numpy().copy()
                for t in (opt.grad, opt.flat, opt.mu, opt.nu)])
        out["halo", graphed] = {"calls": calls, "ms": ms[1:]}
    return out


# phase 18's halo graph axis across the ranks: (a) the 12,000-node graph
# of phase 14 in 4 shards, 0-1 on rank 0 and 2-3 on rank 1; (b) a 3 x 2
# fallback grid over phase 14's two graphs and a third (BA, this many
# nodes and seed); (c) r4's target tower on a 1 x 2 grid over the ranks
DIST_HALO_SHARDS = 4
DIST_GRID_THIRD = (8000, 5)


def timed_replay(torch, compiled, fn):
    """(``fn()``, its ms between two synchronizes, and for a compiled
    step or forward the ms of the collectives its chain replayed in the
    call, else None): the ``step.collective`` spans (utils/trace.py) of
    ``compiled.held["step"]`` outside its capture, whose warm-up runs
    them too. The tracer is on only for a compiled one, and is turned on
    and drained outside the clock."""
    from desco_tpu_torch.utils import trace

    held = getattr(compiled, "held", None)
    if held is not None:
        trace.drain()
        trace.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        if held is not None:
            trace.disable()
    if held is None:
        return out, ms, None
    spans, _ = trace.drain()
    step = id(held["step"])
    captures = [(s.t0, s.t1) for s in spans if s.name == "graph.capture"]
    ns = sum(s.t1 - s.t0 for s in spans if s.name == "step.collective"
             and s.info.get("step") == step
             and not any(a <= s.t0 and s.t1 <= b for a, b in captures))
    return out, ms, ns / 1e6


def timed_calls(torch, step, opt, params, place, q, seeds) -> dict:
    """Calls of a placed train step: per call the loss, the flag, the
    reduced gradient, the parameters and Adam's moments (numpy), the ms
    of each call and, for a graphed step, the ms its collectives took
    inside each call and its chain's figures (``chain_figures``)."""
    calls, ms, exchange_ms = [], [], []
    held = getattr(step, "held", None)
    for seed in seeds:
        (loss, ok), call_ms, coll_ms = timed_replay(
            torch, step, lambda: step(params, place, q, 1e-3, seed=seed))
        ms.append(call_ms)
        if held:
            exchange_ms.append(coll_ms)
        calls.append([float(loss), bool(ok)] + [
            t.cpu().numpy().copy()
            for t in (opt.grad, opt.flat, opt.mu, opt.nu)])
    out = {"calls": calls, "ms": ms}
    if held:
        out.update(exchange_ms=exchange_ms, chain=chain_figures(held))
    return out


def chain_figures(held: dict) -> dict:
    """A graphed step's or forward's chain (utils/cuda_graphs.GraphedStep):
    graphs per call, split points, the capture's seconds (its warm-up
    included) and the bytes of its memory pool."""
    chained = held["step"]
    return {"graphs": len(chained.graphs),
            "split_points": len(chained.sequence),
            "capture_s": chained.capture_s,
            "pool_bytes": chained.pool_bytes()}


def exchange_parts(torch, dist, block, counts, reps: int = 12) -> dict:
    """One exchange of ``block`` as ``distributed.exchange_blocks`` stages
    it under gloo, timed part by part (each ends in a synchronize): the
    device-to-host copy into a pinned buffer, gloo's
    ``all_to_all_single`` between the pinned buffers, the host-to-device
    copy of what came back. Medians of the last ``reps - 2`` runs."""
    host_in = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
    host_out = torch.empty((sum(counts),) + tuple(block.shape[1:]),
                           dtype=block.dtype, pin_memory=True)
    out = torch.empty(host_out.shape, dtype=block.dtype, device=block.device)
    parts = {"d2h": [], "gloo": [], "h2d": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_in.copy_(block)
        t1 = time.perf_counter()
        dist.all_to_all_single(host_out, host_in, output_split_sizes=counts,
                               input_split_sizes=counts)
        t2 = time.perf_counter()
        out.copy_(host_out)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, (u, v) in zip(parts, ((t0, t1), (t1, t2), (t2, t3))):
            parts[k].append((v - u) * 1e3)
    return {k: float(np.median(v[2:])) for k, v in parts.items()}


def dist_halo_workload(torch, job, dev, reference: bool = False) -> dict:
    """Phase 18's halo graph axis across processes, on one process: (a)
    two calls of ``halo_gossip_step_fn`` at dropout 0 and two at 0.1 over
    ``make_mesh2d(1, 4)``'s shards (r4's gossip, 29 queries); (b) two calls
    of the DP x halo step over the 3 x 2 grid at the gossip's dropout;
    (c) two calls of ``dp_halo_shmp_forward`` of r4's target tower on a 1
    x 2 grid. Across the ranks each rank holds its slots and runs each
    part eager and graphed (chains of CUDA graphs split at their
    collectives); in one process (``reference``) every slot is here, each
    part eager. Returns numpy results, ms, the launches of each part and
    way; across the ranks also the chains' figures, the ms of one
    exchange of (a)'s layer-0 pull tables and its parts."""
    import torch.distributed as dist

    from desco_tpu_torch.ops import cuda_segment as cs
    from desco_tpu_torch.parallel import halo, topology
    from desco_tpu_torch.train import loop as train_loop
    from desco_tpu_torch.train.checkpoint import params_from_jax
    from desco_tpu_torch.utils import distributed

    hq = torch.from_numpy(job["halo_q"]).to(dev)
    out = {"launches": {}}
    ways = (False,) if reference else (False, True)

    def grid(n_data, n_graph, parts):
        return topology.place_replicas(
            topology.stack_partitions(parts),
            topology.make_mesh2d(n_data, n_graph, devices=[dev]))

    def counted(part, graphed, fn):
        cs.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        out["launches"][f"{part} {'graphed' if graphed else 'eager'}"] = (
            cs.read_launches())
        out[part, graphed] = result

    # (a) four shards of one graph, two per rank; the direction degrees,
    # kept on the shards, computed before either way counts
    [shards] = grid(1, DIST_HALO_SHARDS, [job["halo_part"]])
    halo.halo_direction_degrees(shards)
    out["held"] = [sh is not None for sh in shards]
    n_q = hq.shape[0]
    # gather-fused K1 per call: 2 layers x 29 queries forward, the second
    # layer's backward (the first reads detached rows), over this
    # process's shards
    agg_a = per_aggregate(halo.local_shards(shards))
    out["expected"] = {"a": {"gather_segment_sum": 4 * 2 * n_q * agg_a,
                             "gather_segment_sum_bwd": 4 * n_q * agg_a}}

    def part_a(graphed):
        res = {}
        for dropout in (0.0, 0.1):
            params = params_from_jax(job["halo_gossip"]).to(dev)
            opt = train_loop.make_adam(params)
            step = halo.halo_gossip_step_fn(opt, dropout=dropout,
                                            graphed=graphed)
            res[dropout] = timed_calls(torch, step, opt, params, shards, hq,
                                       (0, 1))
        return res

    for graphed in ways:
        counted("a", graphed, lambda: part_a(graphed))
    # (b) the 3 x 2 fallback grid: row 1 on both ranks
    replicas = grid(3, 2, job["grid3_parts"])
    for row in replicas:
        if row is not None:
            halo.halo_direction_degrees(row)
    agg_b = sum(per_aggregate(halo.local_shards(row)) for row in replicas
                if row is not None)
    out["expected"]["b"] = {
        "gather_segment_sum": 2 * 2 * n_q * agg_b,
        "gather_segment_sum_bwd": 2 * n_q * agg_b}

    def part_b(graphed):
        params = params_from_jax(job["halo_gossip"]).to(dev)
        opt = train_loop.make_adam(params)
        step = topology.dp_halo_gossip_step_fn(
            opt, dropout=job["dropout"], graphed=graphed)
        return timed_calls(torch, step, opt, params, replicas, hq, (0, 1))

    for graphed in ways:
        counted("b", graphed, lambda: part_b(graphed))
    # (c) the sharded SHMP forward, one shard per rank
    cfg, flat0, part = job["shmp"]
    rows = grid(1, 2, [part])
    out["expected"]["c"] = {
        "gather_segment_sum": 2 * cfg.layer_num * per_aggregate(
            halo.local_shards(rows[0])),
        "fused_typed_transform_aggregate": 0, "sorted_segment_sum": 0,
        "gather_segment_sum_bwd": 0}
    tparams = params_from_jax(flat0).to(dev).requires_grad_(False)

    def part_c(graphed):
        fwd = topology.dp_halo_shmp_forward(cfg, graphed=graphed)
        held = getattr(fwd, "held", None)
        ms, calls, exchange_ms = [], [], []
        with torch.inference_mode():
            for _ in range(2):
                out, call_ms, coll_ms = timed_replay(
                    torch, fwd, lambda: fwd(tparams, rows))
                embs = out[0]
                ms.append(call_ms)
                if held:
                    exchange_ms.append(coll_ms)
                calls.append([None if e is None else e.cpu().numpy()
                              for e in embs])
        res = {"calls": calls, "ms": ms}
        if held:
            res.update(exchange_ms=exchange_ms, chain=chain_figures(held))
        return res

    for graphed in ways:
        counted("c", graphed, lambda: part_c(graphed))
    if not reference:
        # one exchange of (a)'s layer-0 pull tables as the halo exchange
        # sends them: k * k blocks of [h_max, F] to the other rank (k
        # slots per rank), none to this one; whole, then part by part
        sh = next(s for s in shards if s is not None)
        width = hq.shape[1] + job["halo_gossip"]["pre/0"].shape[1]
        k = DIST_HALO_SHARDS // distributed.world()
        counts = [0 if q == distributed.rank() else k * k
                  for q in range(distributed.world())]
        block = torch.zeros((sum(counts), sh.h_max, width), device=dev)
        ms = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distributed.exchange_blocks(block, counts=(counts, counts))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["exchange_ms"] = ms[2:]
        out["exchange_bytes"] = block.numel() * 4
        out["exchange_parts_ms"] = exchange_parts(torch, dist, block,
                                                  counts)
    return out


def dist_rank_main(args) -> int:
    """One rank of phase 18 (``--dist_rank``): start the gloo group on the
    card, run ``dist_workload`` eager and graphed with the launch counters
    zeroed first, and write the results and the counts."""
    import pickle

    import torch

    from desco_tpu_torch.ops import cuda_segment as cs
    from desco_tpu_torch.utils import distributed

    if not torch.cuda.is_available():
        fail("a phase-18 rank needs a CUDA device")
    with open(args.dist_job, "rb") as f:
        job = pickle.load(f)
    backend = distributed.init(
        "cuda", init_method=job["init_method"], rank=args.dist_rank,
        world_size=DIST_WORLD, timeout_s=DIST_GROUP_TIMEOUT_S)
    try:
        dev = distributed.rank_device("cuda")
        cs.reset_launches()
        t0 = time.perf_counter()
        out = dist_workload(torch, job, dev)
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = cs.read_launches()
        out["backend"] = backend
        t0 = time.perf_counter()
        out["halo_ranks"] = dist_halo_workload(torch, job, dev)
        out["halo_seconds"] = time.perf_counter() - t0
        for part in out["halo_ranks"]["launches"].values():
            for k, v in part.items():
                out["launches"][k] += v
    finally:
        distributed.shutdown()
    with open(os.path.join(job["out_dir"], f"rank{args.dist_rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    return 0


def run_children(cmds, timeout: float, env=None) -> list:
    """Start every command in a session of its own from the repository
    root, wait for all of them for at most ``timeout`` s, kill them all
    on a timeout, and fail unless each exits 0; return their (stdout,
    stderr)."""
    import signal

    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        fail(f"a child process did not finish in {timeout:.0f} s: "
             f"{cmds}")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
    for c, p, (out, err) in zip(cmds, procs, outs):
        check(p.returncode == 0, f"{' '.join(c[:6])} ... exited "
              f"{p.returncode}:\n{out[-4000:]}\n{err[-4000:]}")
    return outs


def strip_ms(result: dict) -> dict:
    """A result without its timings and its chain's figures."""
    return {k: v for k, v in result.items()
            if k not in ("ms", "exchange_ms", "chain")}


def equal_results(a, b) -> bool:
    """Nested results (dicts, lists, arrays, floats) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal_results(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal_results(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def halo_ranks_report(ranks, href, rank_errs, extra: dict) -> dict:
    """Phase 18 (c)'s checks and figures: every rank's
    ``dist_halo_workload`` result, eager and graphed, against the
    one-process ``href`` bit for bit, no eager note in any rank's
    standard error, each graphed site a chain of one graph more than its
    split points, finite losses that move, each rank's launches of every
    part and way against what its shards' streams need; returns the
    figures (with ``extra``)."""
    hcomp = {}
    for r, res in enumerate(ranks):
        h = res["halo_ranks"]
        hcomp[f"rank {r} holds shards {2 * r}-{2 * r + 1}"] = (
            h["held"] == [q // 2 == r for q in range(DIST_HALO_SHARDS)])
        for graphed in (False, True):
            way = "graphed" if graphed else "eager"
            for dropout in (0.0, 0.1):
                hcomp[f"(a) halo step, dropout {dropout}, {way}, rank {r}"] = (
                    equal_results(h["a", graphed][dropout]["calls"],
                                  href["a", False][dropout]["calls"]))
            hcomp[f"(b) 3 x 2 DP x halo step, {way}, rank {r}"] = (
                equal_results(h["b", graphed]["calls"],
                              href["b", False]["calls"]))
            hcomp[f"(c) sharded SHMP forward, {way}, rank {r}"] = all(
                embs[1 - r] is None and embs[r] is not None
                and np.array_equal(embs[r], want[r])
                for embs, want in zip(h["c", graphed]["calls"],
                                      href["c", False]["calls"]))
        hcomp[f"no step ran eager for want of a capture, rank {r}"] = (
            "runs eager" not in rank_errs[r])
        for site, chain in (("(a) dropout 0", h["a", True][0.0]["chain"]),
                            ("(a) dropout 0.1",
                             h["a", True][0.1]["chain"]),
                            ("(b)", h["b", True]["chain"]),
                            ("(c)", h["c", True]["chain"])):
            hcomp[f"{site} graphed: a chain of {chain['graphs']} graphs, "
                  f"rank {r}"] = (chain["split_points"] > 0 and
                                  chain["graphs"] == chain["split_points"]
                                  + 1)
    print(f"phase 18 (c) halo graph axis across {DIST_WORLD} processes: "
          f"bit-equal to the same grids in one process: "
          f"{json.dumps(hcomp)}", flush=True)
    check(all(hcomp.values()), "phase 18 (c): a cross-rank halo result "
          "differs from one process, or a graphed site is no chain")
    for name, calls in (("(a) dropout 0", href["a", False][0.0]["calls"]),
                        ("(a) dropout 0.1", href["a", False][0.1]["calls"]),
                        ("(b)", href["b", False]["calls"])):
        check(all(c[1] and np.isfinite(c[0]) for c in calls)
              and calls[0][0] != calls[1][0],
              f"phase 18 {name}: the steps did not move a finite loss")
    check(all(np.isfinite(e).all() for e in href["c", False]["calls"][0]),
          "phase 18 (c): the sharded forward is not finite")
    for r, res in enumerate(ranks):
        h = res["halo_ranks"]
        for part in ("a", "b", "c"):
            for way in ("eager", "graphed"):
                got, want = h["launches"][f"{part} {way}"], h["expected"][part]
                print(f"phase 18 (c) rank {r} part {part} {way} launches: "
                      f"{json.dumps(got)}; expected {json.dumps(want)}",
                      flush=True)
                check(launches_match(got, want)
                      and got["gather_segment_sum"] > 0,
                      f"phase 18 (c): part {part}'s {way} launches on rank "
                      f"{r}")
        for way in ("eager", "graphed"):
            check(h["launches"][f"a {way}"]["gather_segment_sum_bwd"] > 0
                  and h["launches"][f"b {way}"]["gather_segment_sum_bwd"] > 0,
                  f"phase 18 (c): K1' backward never launched on rank {r} "
                  f"({way})")

    def per_rank(part, key, dropout=None):
        return [(r["halo_ranks"][part, key] if dropout is None
                 else r["halo_ranks"][part, key][dropout]) for r in ranks]

    def site(part, dropout=None):
        one = (href[part, False] if dropout is None
               else href[part, False][dropout])
        eager, graphed = per_rank(part, False, dropout), per_rank(
            part, True, dropout)
        return {"one_process_eager_ms": one["ms"],
                "ranks_eager_ms": [e["ms"] for e in eager],
                "ranks_graphed_ms": [g["ms"] for g in graphed],
                "ranks_graphed_exchange_ms": [g.get("exchange_ms")
                                              for g in graphed],
                "ranks_chain": [g["chain"] for g in graphed]}

    hfig = {
        "halo_step": {str(d): site("a", d) for d in (0.0, 0.1)},
        "grid_3x2_step": site("b"),
        "shmp_forward": site("c"),
        "exchange_ms_median": [float(np.median(r["halo_ranks"]
                                               ["exchange_ms"]))
                               for r in ranks],
        "exchange_parts_ms": [r["halo_ranks"]["exchange_parts_ms"]
                              for r in ranks],
        "exchange_bytes": ranks[0]["halo_ranks"]["exchange_bytes"],
        "rank_halo_seconds": [r["halo_seconds"] for r in ranks], **extra}
    print(f"phase 18 (c) figures (ms per call; the graphed first call "
          f"captures): {json.dumps(hfig)}", flush=True)
    return hfig


def dist_halo_job(seed: int, grid_specs: list, query_ids, shmp_cfg) -> dict:
    """Phase 18 (c)'s partitions: phase 14's 12,000-node graph
    (``grid_specs[1]``) in 4 shards; the 3 x 2 grid's three graphs
    (phase 14's two and a third); the 12,000-node graph's whole-graph
    typed sample in 2 shards for r4's target tower."""
    from desco_tpu_torch.batch.build import gossip_sample
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.parallel import halo, topology

    t0 = time.perf_counter()
    hrng = np.random.default_rng(seed + 18)
    g3 = ba_graph(Graph, DIST_GRID_THIRD[0], HALO_DEGREE, DIST_GRID_THIRD[1])
    x3 = hrng.uniform(0.0, 8.0, (g3.n_nodes, 29)).astype(np.float32)
    y3 = (x3 * hrng.uniform(0.5, 1.5, (g3.n_nodes, 1))).astype(np.float32)
    s3 = gossip_sample(g3, x3, y3)
    grid3 = topology.harmonized_partitions(
        [grid_specs[0], grid_specs[1],
         dict(n_nodes=g3.n_nodes, node_type=s3.node_type, x=x3,
              edge_src=s3.edge_src, edge_dst=s3.edge_dst,
              edge_type=s3.edge_type, node_y=y3)], 2, n_types=2)
    halo_part = halo.partition_typed_graph(
        n_devices=DIST_HALO_SHARDS, n_types=2, **grid_specs[1])
    g12 = ba_graph(Graph, DP_HALO_SECOND[0], HALO_DEGREE, DP_HALO_SECOND[1])
    [ws] = Workload([g12]).wo_canonical_samples(
        query_ids, truth=np.zeros((g12.n_nodes, 29)))
    ws.x = hrng.standard_normal((g12.n_nodes, 1)).astype(np.float32)
    shmp_part = halo.partition_typed_graph(
        g12.n_nodes, ws.node_type, ws.x, ws.edge_src, ws.edge_dst,
        ws.edge_type, 2, n_types=shmp_cfg.n_edge_types)
    print(f"phase 18 (c) partitions in {time.perf_counter() - t0:.2f} s: "
          f"(a) {g12.n_nodes} nodes in {DIST_HALO_SHARDS} shards (n_loc "
          f"{halo_part.n_loc}, h_max {halo_part.h_max}, p_max "
          f"{halo_part.p_max}); (b) 3 x 2 grid of {grid_specs[0]['n_nodes']}"
          f", {grid_specs[1]['n_nodes']} and {g3.n_nodes} nodes, caps "
          f"{json.dumps(halo.partition_caps(grid3[0]))}; (c) the typed "
          f"sample in 2 shards (n_loc {shmp_part.n_loc}, h_max "
          f"{shmp_part.h_max}, p_max {shmp_part.p_max})", flush=True)
    return dict(halo_part=halo_part, grid3_parts=grid3, shmp_part=shmp_part)


def dist_phase(torch, cs, dev, seed: int, tcfg, qb, train_stage, gbatches,
               best, gbest, q_embs, grid_parts, grid_specs, halo_gossip,
               halo_q, shmp_cfg, shmp_params, torchrun_job: dict,
               torchrun_dir: str) -> dict:
    """Phase 18: data parallelism across processes, two ranks of a gloo
    group on the one card. (a) Each rank (``chip_smoke.py --dist_rank``)
    runs the D = 2 DP steps of both stages (paper config, phase 6's
    batches, two groups; the gossip's at its dropout), eager and
    graphed, both DP predicts and phase 14's 2 x 2 DP x halo step (two
    calls each way): every result bit-equal on both ranks, graphed to
    eager and to the same D = 2 in this process (eager; the in-process
    graphed steps timed beside). Each rank's launches are printed; K1, K1',
    K2, K3 and K4 must have launched on both. (b) ``python -m
    torch.distributed.run --nproc_per_node 2 -m desco_tpu_torch.main
    --n_devices 2 --train_neigh --train_gossip --test_gossip`` at the
    paper width, 1 epoch per stage (started before phase 16, collected
    here): exit 0, one set of checkpoints,
    finite normed MSE. (c) The halo graph axis across the ranks
    (``dist_halo_workload``, the same ranks): r4's gossip train step on
    phase 14's 12,000-node graph in 4 shards, 2 per rank (two calls at
    dropout 0, two at 0.1), the DP x halo step on a 3 x 2 fallback grid
    whose middle row crosses the ranks, and r4's target tower sharded
    over a 1 x 2 grid, each eager and graphed (chains of CUDA graphs
    split at their collectives): every result bit-equal on both ranks to
    the same grid in this process (eager), the gather-fused K1 and its
    backward launched on both ranks, both ways, as many times as their
    shards' streams need. Returns the launches (both ranks) and
    figures."""
    import pickle

    from desco_tpu_torch.train.checkpoint import flatten_params

    t18 = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="desco_smoke_dist_")
    host = lambda m: {k: np.asarray(v)  # noqa: E731
                      for k, v in flatten_params(m).items()}
    p_neigh = neigh_init(torch, tcfg, seed)
    p_gossip = gossip_init(torch, tcfg, seed)
    t0 = time.perf_counter()
    halo_job = dist_halo_job(seed, grid_specs, tcfg.query_ids, shmp_cfg)
    halo_prep_s = time.perf_counter() - t0
    job = dict(
        init_method=f"file://{os.path.join(work.name, 'rendezvous')}",
        out_dir=work.name, tcfg=tcfg, qb=qb, n_steps=2,
        tbs=list(train_stage.batches[:6]), gbs=list(gbatches[:6]),
        pred_tbs=list(train_stage.batches[:8]), pred_gbs=list(gbatches[:8]),
        neigh=host(p_neigh), gossip=host(p_gossip), best=host(best),
        gbest=host(gbest), q_embs=q_embs.detach().cpu().numpy(),
        dropout=tcfg.gossip_dropout, parts=grid_parts,
        halo_gossip=host(halo_gossip),
        halo_q=halo_q.detach().cpu().numpy(), **halo_job)
    job["shmp"] = (shmp_cfg, host(shmp_params), job.pop("shmp_part"))
    path = os.path.join(work.name, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    # the same D = 2 in this process: the reference (eager; the DP steps
    # graphed too, timed)
    t0 = time.perf_counter()
    ref = dist_workload(torch, job, dev, reference=True)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    href = dist_halo_workload(torch, job, dev, reference=True)
    href_s = time.perf_counter() - t0
    # (a) and (c): the two ranks
    t0 = time.perf_counter()
    rank_outs = run_children(
        [[sys.executable, os.path.join(REPO, "chip_smoke.py"),
          "--dist_rank", str(r), "--dist_job", path]
         for r in range(DIST_WORLD)], DIST_JOIN_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(DIST_WORLD):
        with open(os.path.join(work.name, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    compared = {}
    for name in ("neighborhood", "gossip", "halo"):
        want = strip_ms(ref[name, False])
        for who, res in [("one process", ref)] + [
                (f"rank {r}", x) for r, x in enumerate(ranks)]:
            for graphed in (False, True):
                if (name, graphed) in res:
                    compared[f"{name}, {who}, "
                             f"{'graphed' if graphed else 'eager'}"] = (
                        equal_results(strip_ms(res[name, graphed]), want))
    for key in ("predict_neigh", "predict_gossip"):
        for r, res in enumerate(ranks):
            compared[f"{key}, rank {r}"] = np.array_equal(res[key], ref[key])
    print(f"phase 18 (data parallelism across {DIST_WORLD} processes, "
          f"backend {ranks[0]['backend']}, one card): bit-equal to the "
          f"eager D = 2 in one process: {json.dumps(compared)}", flush=True)
    check(all(compared.values()), "phase 18: a result differs from the "
          "eager D = 2 in one process")
    check([res["local"] for res in ranks] == [[0], [1]],
          "phase 18: rank r does not hold replica r")
    check(all(res["backend"] == "gloo" for res in ranks),
          "phase 18: two ranks on one card did not choose gloo")
    for name in ("neighborhood", "gossip"):
        check(all(ref[name, False]["oks"])
              and ref[name, False]["losses"][0]
              != ref[name, False]["losses"][-1],
              f"phase 18: the {name} steps did not move the loss")
    figures = {
        "neigh_step_ms": {"one_process": ref["neighborhood", True]["ms"],
                          "ranks": [r["neighborhood", True]["ms"]
                                    for r in ranks]},
        "gossip_step_ms": {"one_process": ref["gossip", True]["ms"],
                           "ranks": [r["gossip", True]["ms"]
                                     for r in ranks]},
        "halo_step_ms": {"one_process_eager": ref["halo", False]["ms"],
                         "ranks": [r["halo", True]["ms"] for r in ranks]},
        "gather_ms": [float(np.median(r["gather_ms"])) for r in ranks],
        "gather_bytes": ranks[0]["gather_bytes"],
        "rank_seconds": [r["seconds"] for r in ranks],
        "one_process_s": ref_s, "ranks_wall_s": ranks_s}
    print(f"phase 18 figures (graphed steps after the first, ms): "
          f"{json.dumps(figures)}", flush=True)
    figures["halo_ranks"] = halo_ranks_report(
        ranks, href, [err for _, err in rank_outs],
        {"one_process_halo_s": href_s, "partitions_s": halo_prep_s})
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    for r, res in enumerate(ranks):
        print(f"phase 18 rank {r} launches: {json.dumps(res['launches'])}",
              flush=True)
        for name in PATH_KERNELS + ("gather_segment_sum_bwd",):
            check(res["launches"][name] > 0,
                  f"phase 18: {name} never launched on rank {r}")
    # (b) main under torchrun, rank 0 writing: started before phase 16,
    # collected here
    out, _, main_s = collect(torchrun_job, DIST_JOIN_TIMEOUT_S,
                             "torchrun main")
    mesh_line = (f"data-parallel mesh: {DIST_WORLD} devices over "
                 f"{DIST_WORLD} processes (backend gloo)")
    check(out.count(mesh_line) == 1, f"torchrun main printed no "
          f"'{mesh_line}' once:\n{out[-3000:]}")
    ckpts = sorted(os.listdir(os.path.join(torchrun_dir, "ck")))
    check(ckpts == sorted(f"{s}.{x}" for s in ("gossip", "neigh")
                          for x in ("best.params.npz", "best.json",
                                    "last.params.npz", "last.opt.npz",
                                    "last.json")),
          f"torchrun main wrote checkpoints {ckpts}")
    mse = finite_figures(out, "graphlet_norm_mse_gossip")
    check(len(mse) == 3, f"torchrun main: normed MSE not finite: "
          f"{out[-2000:]}")
    print(f"torchrun main (2 ranks on the one card, paper width, "
          f"{' '.join(DIST_MAIN_FLAGS)}): exit 0 in {main_s:.1f} s (started "
          f"before phase 16, which ran beside it), checkpoints {ckpts}, "
          f"gossip normed MSE {mse}", flush=True)
    work.cleanup()
    took = time.perf_counter() - t18
    print(f"phase 18 (data parallelism across processes) launches (both "
          f"ranks): {json.dumps(launches)}", flush=True)
    print(f"phase 18 (data parallelism across processes) took {took:.1f} s",
          flush=True)
    return {"launches": launches, "figures": figures, "main_s": main_s,
            "seconds": took}


def neigh_init(torch, tcfg, seed: int):
    """Fresh neighborhood weights of ``tcfg`` from ``seed`` (on the CPU)."""
    from desco_tpu_torch.models import neighborhood as neigh_mod
    from desco_tpu_torch.pipeline import model_configs

    tgt_cfg, qry_cfg = model_configs(tcfg, "cpu")
    return neigh_mod.init_neighborhood_model(
        tgt_cfg, qry_cfg, torch.Generator().manual_seed(seed))


def gossip_init(torch, tcfg, seed: int):
    """Fresh gossip weights of ``tcfg`` from ``seed + 1`` (on the CPU)."""
    from desco_tpu_torch.models import gossip as gossip_mod

    return gossip_mod.init_gossip_model(
        hidden_dim=tcfg.gossip_hidden_dim,
        emb_channels=tcfg.neigh_hidden_dim,
        generator=torch.Generator().manual_seed(seed + 1))


# --------------------------------------------------------- phase 3 checks
def check_counts(res, n_graphs: int, what: str) -> None:
    check(res.graphlet_counts.shape == (n_graphs, 29),
          f"{what}: graphlet counts {res.graphlet_counts.shape}")
    for name in ("graphlet_counts", "node_counts", "neighborhood_counts"):
        check(np.isfinite(getattr(res, name)).all(),
              f"{what}: non-finite {name}")
    check((res.graphlet_counts >= 0).all() and (res.node_counts >= 0).all(),
          f"{what}: negative counts")
    check(res.refined, f"{what}: gossip refinement did not run")


def close_counts(a, b, what: str) -> float:
    """|a - b| <= 1e-3 * max(|b|, 1): rtol 1e-3 on de-logged counts,
    floored at one occurrence."""
    check(a.shape == b.shape, f"{what}: shapes {a.shape} != {b.shape}")
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    check(rel.max(initial=0.0) <= 1e-3,
          f"{what}: max relative difference {rel.max():.3g} > 1e-3")
    return float(rel.max(initial=0.0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 18 (the script starts them itself)
    ap.add_argument("--dist_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist_job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank is not None:
        return dist_rank_main(args)
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    from desco_tpu_torch.data.datasets import load_data
    from desco_tpu_torch.data.synthetic import random_connected_graphs
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.graph.canonical import canonical_neighborhood
    from desco_tpu_torch.models import gossip as gossip_mod
    from desco_tpu_torch.models import neighborhood as neigh_mod
    from desco_tpu_torch.models.shmp_gnn import batch_typed_streams
    from desco_tpu_torch.ops import cuda_build
    from desco_tpu_torch.ops import cuda_segment as cs
    from desco_tpu_torch.pipeline import (
        PipelineConfig, build_query_batch, model_configs,
        neighborhood_predictions, pipeline_queries, prepare_gossip_batches,
        prepare_stage_data, train_gossip_stage, train_neighborhood_stage)
    from desco_tpu_torch.serving import CountingService
    from desco_tpu_torch.tools import segsum_inner_ablation as probe
    from desco_tpu_torch.train import loop as train_loop
    from desco_tpu_torch.train.checkpoint import load_checkpoint
    from desco_tpu_torch.truth import native as truth_native

    # ---------------------------------------------------- 1. environment
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    cuda_build.build_all()  # one nvcc per source, started together
    cs.library()
    probe.library()
    cs.typed_library()
    print(f"kernels built from {os.path.relpath(cs.SOURCE, REPO)}, "
          f"{os.path.relpath(cs.TYPED_SOURCE, REPO)} and "
          f"{os.path.relpath(probe.SOURCE, REPO)} with nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)} in "
          f"{json.dumps({k: round(v, 2) for k, v in cuda_build.build_seconds.items()})} "
          f"s, in parallel (build and load {time.perf_counter() - t0:.2f} "
          f"s)", flush=True)
    t0 = time.perf_counter()
    engine = truth_native.engine()
    print(f"VF2 / sample-prep engine: {engine} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    dev = torch.device("cuda")

    # graphs of every request, made up front from the seed
    rng = np.random.default_rng(args.seed)
    warm = random_connected_graphs(16, rng)
    main_req = random_connected_graphs(256, rng)
    stream = [random_connected_graphs(64, rng) for _ in range(4)]
    print(f"graphs: 256-graph request has "
          f"{sum(g.n_nodes for g in main_req)} nodes, "
          f"{sum(g.n_edges for g in main_req)} edges", flush=True)

    svc = CountingService(R4_NEIGH, R4_GOSSIP, device="cuda")
    check(svc.tgt_cfg.agg_mode == "kernel",
          f"target tower agg_mode {svc.tgt_cfg.agg_mode!r}, not the kernel")
    check((svc.tgt_cfg.layer_num, svc.tgt_cfg.hidden_dim,
           svc.tgt_cfg.n_edge_types, len(pipeline_queries(svc.cfg))) ==
          (8, 64, 6, 29), "release/r4 is not at the paper width")

    # host prep of every request, twice: the first pass pins the serving
    # capacity buckets at their final size, the second counts the packed
    # target batches each request will run
    requests = [warm, main_req, main_req] + stream
    for g in requests:
        prepare_stage_data(svc.cfg, g, capacities=svc._select_neigh_caps)
    stages = [prepare_stage_data(svc.cfg, g,
                                 capacities=svc._select_neigh_caps)
              for g in requests]
    n_batches = [len(s.batches) for s in stages]
    main_stage = stages[1]
    print(f"target batches per request: {n_batches} (n_cap "
          f"{main_stage.batches[0].n_cap}, e_cap "
          f"{main_stage.batches[0].e_cap}, g_cap "
          f"{main_stage.batches[0].g_cap})", flush=True)

    # the training set of phase 6 (train = valid), with exact ground
    # truth: paper config, a few epochs per stage
    workdir = tempfile.TemporaryDirectory(prefix="desco_smoke_")
    tcfg = PipelineConfig(neigh_epochs=10, gossip_epochs=40, seed=args.seed,
                          data_root=os.path.join(workdir.name, "data"))
    train_name = f"SynNp_320_{args.seed}"
    train_graphs = load_data(train_name)
    n_train_nodes = sum(g.n_nodes for g in train_graphs)
    t0 = time.perf_counter()
    Workload(train_graphs, root=os.path.join(tcfg.data_root, train_name),
             name=train_name).compute_groundtruth(tcfg.query_ids)
    truth_s = time.perf_counter() - t0
    print(f"truth: {truth_s:.2f} s of C++ VF2 ({os.cpu_count()} host "
          f"threads) for {train_name}: {len(train_graphs)} graphs, "
          f"{n_train_nodes} nodes, "
          f"{sum(g.n_edges for g in train_graphs)} edges; "
          f"{truth_s / n_train_nodes * 1e3:.3f} s per 1000 nodes",
          flush=True)
    t0 = time.perf_counter()
    train_stage = prepare_stage_data(tcfg, train_graphs, name=train_name,
                                     need_truth=True)
    tb0 = train_stage.batches[0]
    print(f"training set staged in {time.perf_counter() - t0:.2f} s (truth "
          f"from its cache): {len(train_stage.samples)} neighborhoods in "
          f"{len(train_stage.batches)} batches of n_cap {tb0.n_cap}, e_cap "
          f"{tb0.e_cap}, g_cap {tb0.g_cap}", flush=True)

    phase_done("1 (environment)")
    # -------------------------------------------------------- 2. kernels
    krng = np.random.default_rng(args.seed + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    with torch.inference_mode():
        for dtype in (f32, bf16):
            k1_edge_cases(torch, cs, krng, dev, dtype)
            narrow_edge_cases(torch, cs, krng, dev, dtype)
            gather_edge_cases(torch, cs, krng, dev, dtype)
            k2_edge_cases(torch, cs, krng, dev, dtype)
            k3_edge_cases(torch, cs, krng, dev, dtype)
            k4_edge_cases(torch, cs, krng, dev, dtype)
        k5_rows = k5_checks(torch, cs, probe, dev, args.seed)
        # the main-path shapes: K2 at a packed target batch of the
        # 256-graph request; the gather-fused K1 and its backward in the
        # gossip direction aggregation (x [n_cap, 128] in layer 0); K1 in
        # the target tower's graph pooling; K3 behind every K2 of a
        # training step; K4 behind pooling
        tb = main_stage.batches[0].to(dev)
        conv_w = svc.members[0]["target"]["conv"].w[3].contiguous()
        gb = prepare_gossip_batches(
            svc.cfg, main_stage,
            np.zeros((len(main_stage.samples), 29)),
            capacities=lambda s: svc._pin_caps(
                svc._gossip_buckets, s, svc.cfg.gossip_batch_size))[0].to(dev)
        trb = tb0.to(dev, training=True)
        # the gossip batch of the phase-6 training set: the permutation
        # derived on the card equals the one pack_samples wrote
        tgb = prepare_gossip_batches(
            tcfg, train_stage, np.zeros((len(train_stage.samples), 29)),
            need_bwd_perm=True)[0].to(dev, training=True)
        tgst = batch_typed_streams(tgb, 2)
        check(torch.equal(cs.derive_bwd_perm(tgst), tgb.edge_bwd_perm),
              "the permutation derived on the card differs from "
              "pack_samples' edge_bwd_perm")
        for dtype in (f32, bf16):
            tx = (torch.randn(tgb.n_cap, 128, device=dev)
                  * tgb.node_mask[:, None]).to(dtype)
            err = gather_check(
                torch, cs, tx, torch.randn(2 * tgb.n_cap, 128, device=dev),
                tgst, "training gossip batch")
            print(f"K1' {dname(dtype)} at the training gossip batch (n_cap "
                  f"{tgb.n_cap}, e_cap {tgb.e_cap}; derived permutation == "
                  f"edge_bwd_perm): max err {err:.3g}", flush=True)
        del tgb, tgst
        cases = probe.kernel_cases(tb, gb, trb, conv_w)
        t0 = time.perf_counter()
        graph_rows = probe.time_cases(cases)
        print(f"CUDA-graph timings of K1-K4 (8 launches per graph; K2 alone "
              f"= its function, K3 alone = without its dW reduction "
              f"launch): {time.perf_counter() - t0:.1f} s", flush=True)
        k_rows = {}
        for dtype in (f32, bf16):
            d = dname(dtype)
            k_rows["k1g", d], k_rows["k1g_bwd", d] = gather_main(
                torch, cs, dev, cases["gossip"], dtype, graph_rows)
            c = cases["k1_pool"]
            k_rows["k1", d] = k1_main(
                torch, cs, dev, c["msgs"].to(dtype), c["seg"], c["n"],
                "the target-tower pooling",
                graph_ms(graph_rows, "k1_pool", dtype))
            k_rows["k2", d] = k2_main(torch, cs, dev, cases["k2"], dtype,
                                      graph_ms(graph_rows, "k2", dtype))
            k_rows["k3", d] = k3_main(torch, cs, dev, cases["k3"], dtype,
                                      graph_ms(graph_rows, "k3", dtype))
            c = cases["k4_pool"]
            k_rows["k4", d] = k4_main(
                torch, cs, dev, c["g"], c["seg"], dtype,
                "the target-tower pooling's backward",
                graph_ms(graph_rows, "k4_pool", dtype))
        # the gather-fused K1 at one column: the serving gossip batch's
        # direction degrees (models/gossip.direction_degrees)
        k_rows["k1g_degrees"] = gather_site(
            torch, cs, probe, dev, gb.node_mask[:, None].float().contiguous(),
            cases["gossip"]["st"],
            "the serving gossip batch's direction degrees (K = 1)")
        del cases, gb, trb

    phase_done("2 (kernels)")
    # -------------------------------------------------------- 3. serving
    cs.reset_launches()
    torch.cuda.synchronize()
    timings = {}
    t0 = time.perf_counter()
    res_warm = svc.count(warm)
    timings["warm-up 16 graphs (first request)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_main = svc.count(main_req)
    timings["256 graphs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_main2 = svc.count(main_req)
    timings["256 graphs, repeat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_stream = list(svc.count_stream(stream))
    timings["count_stream 4x64 graphs"] = time.perf_counter() - t0
    launches = cs.read_launches()
    # the capacity buckets these requests ran with (phase 14 serves the
    # 256-graph request again over data-parallel replicas)
    phase3_buckets = (dict(svc._neigh_buckets), dict(svc._gossip_buckets))
    print(f"serving-path launches: {json.dumps(launches)}; expected K2 = 8 "
          f"x {sum(n_batches)} target batches, K1 = one pooling per target "
          f"batch, the gather-fused K1 = 1 + 2 x 29 per gossip batch",
          flush=True)
    check(all(launches[k.__name__ + "_bf16"] == 0 for k in cs.KERNELS),
          "bf16 launches on the f32 serving path")
    check(launches["fused_typed_transform_aggregate"] == 8 * sum(n_batches),
          "K2 launches != 8 x packed target batches")
    check(launches["sorted_segment_sum"] == sum(n_batches),
          "K1 launches != one pooling per target batch (the gossip path "
          "must run the gather-fused K1 only)")
    check(launches["gather_segment_sum"] > 0
          and launches["gather_segment_sum"] % (1 + 2 * 29) == 0,
          "the gather-fused K1 did not run 1 + 2 x 29 times per gossip "
          "batch")
    for name in ("typed_aggregate_bwd", "segment_sum_vjp",
                 "gather_segment_sum_bwd"):
        check(launches[name] == 0,
              f"backward kernel {name} launched while serving")

    check_counts(res_warm, 16, "warm-up")
    check_counts(res_main, 256, "256-graph request")
    check_counts(res_main2, 256, "256-graph repeat")
    check(len(res_stream) == 4, "count_stream yielded "
          f"{len(res_stream)} results for 4 requests")
    for i, r in enumerate(res_stream):
        check_counts(r, 64, f"stream request {i}")
    close_counts(res_main2.neighborhood_counts, res_main.neighborhood_counts,
                 "repeat vs first 256-graph request")

    # verified rows equal an independent VF2 recount (a row's recount is
    # kept: both requests below verify mostly the same rows)
    recounted = {}

    def check_verified(res, what: str) -> None:
        rows = res.verified_rows
        check(len(rows) > 0, f"{what}: no neighborhood was verified")
        new = [int(r) for r in rows if int(r) not in recounted]
        idx = np.asarray(main_stage.nindex.index)[new]
        nbs = [canonical_neighborhood(main_req[int(g)], int(v),
                                      svc.cfg.depth) for g, v in idx]
        recount = truth_native.parallel_canonical_counts(
            [nb.graph for nb in nbs], pipeline_queries(svc.cfg))
        for r, nb, c in zip(new, nbs, recount):
            recounted[r] = c[nb.canonical]
        exact = np.stack([recounted[int(r)] for r in rows])
        got = res.neighborhood_counts[rows]
        check(np.array_equal(got, exact.astype(got.dtype)),
              f"{what}: verified rows differ from the VF2 recount")
        print(f"{what}: {len(rows)} verified rows equal the VF2 recount",
              flush=True)

    check_verified(res_main, "256-graph request")

    for name, sec in timings.items():
        n_g = {"warm-up 16 graphs (first request)": 16}.get(name, 256)
        print(f"serving {name}: {sec * 1e3:.1f} ms, "
              f"{n_g / sec:.1f} graphs/s", flush=True)

    # CUDA vs the port on the CPU, without the top-k recount, on the
    # request's first 64 graphs (the CPU's side costs a second per 16)
    over = {"verify_budget": 0.0}
    svc_gpu = CountingService(R4_NEIGH, R4_GOSSIP, config_overrides=over,
                              device="cuda")
    svc_cpu = CountingService(R4_NEIGH, R4_GOSSIP, config_overrides=over,
                              device="cpu")
    cpu_req = main_req[:64]
    r_gpu = svc_gpu.count(cpu_req)
    t0 = time.perf_counter()
    r_cpu = svc_cpu.count(cpu_req)
    cpu_s = time.perf_counter() - t0
    d_neigh = close_counts(r_gpu.neighborhood_counts, r_cpu.neighborhood_counts,
                           "CUDA vs CPU neighborhood counts")
    d_node = close_counts(r_gpu.node_counts, r_cpu.node_counts,
                          "CUDA vs CPU node counts")
    print(f"CUDA vs CPU (verify_budget=0, {len(cpu_req)} graphs): "
          f"neighborhood counts max rel {d_neigh:.3g}, node counts max rel "
          f"{d_node:.3g} (CPU request {cpu_s:.1f} s)", flush=True)

    # the same request on the bf16 target tower
    svc_bf = CountingService(R4_NEIGH, R4_GOSSIP, device="cuda",
                             config_overrides={"serve_bf16": True})
    svc_bf._neigh_buckets.update(svc._neigh_buckets)  # the same batches
    svc_bf._gossip_buckets.update(svc._gossip_buckets)
    cs.reset_launches()
    t0 = time.perf_counter()
    res_bf = svc_bf.count(main_req)
    bf_s = time.perf_counter() - t0
    launches_bf = cs.read_launches()
    n_main = n_batches[1]
    print(f"serve_bf16 launches: {json.dumps(launches_bf)}; expected K2 = 8 "
          f"x {n_main} target batches, all on bf16 rows", flush=True)
    check(launches_bf["fused_typed_transform_aggregate"] == 8 * n_main
          and launches_bf["fused_typed_transform_aggregate_bf16"]
          == 8 * n_main, "serve_bf16: K2 launches != 8 x target batches on "
          "bf16 rows")
    check(launches_bf["sorted_segment_sum_bf16"] == n_main
          and launches_bf["sorted_segment_sum"] == n_main,
          "serve_bf16: K1 did not run once per target batch (the bf16 "
          "tower's pooling), on bf16 rows")
    check(launches_bf["gather_segment_sum"] > 0
          and launches_bf["gather_segment_sum_bf16"] == 0,
          "serve_bf16: the f32 gossip stage did not run the gather-fused "
          "K1 on f32 rows")
    check(launches_bf["typed_aggregate_bwd"] == 0
          and launches_bf["segment_sum_vjp"] == 0
          and launches_bf["gather_segment_sum_bwd"] == 0,
          "serve_bf16: a backward kernel launched while serving")
    check_counts(res_bf, 256, "serve_bf16 request")
    check_verified(res_bf, "serve_bf16 request")
    print(f"serving 256 graphs with serve_bf16: {bf_s * 1e3:.1f} ms, "
          f"{256 / bf_s:.1f} graphs/s", flush=True)
    # raw predictions (before clamp and verification) in log2(count + 1)
    # space: bf16 against f32 on the card, bf16 on the card against bf16
    # on the CPU
    tgt_bf = dataclasses.replace(svc.tgt_cfg, dtype=torch.bfloat16)

    def log2_preds(service, tgt_cfg, batches):
        counts = train_loop.predict_neighborhood_counts(
            service.members[0], tgt_cfg, service.member_embs[0], batches,
            service.device)
        check(np.isfinite(counts).all() and (counts > -1).all(),
              "raw predictions not finite")
        return np.log2(counts + 1.0)

    p32 = log2_preds(svc, svc.tgt_cfg, main_stage.batches)
    pbf = log2_preds(svc, tgt_bf, main_stage.batches)
    d_bf = float(np.abs(pbf - p32).max())
    head = main_stage.batches[:2]
    cpu_bf = dataclasses.replace(tgt_bf)  # K2's plain version on the CPU
    t0 = time.perf_counter()
    pbf_cpu = log2_preds(svc_cpu, cpu_bf, head)
    d_cpu = float(np.abs(pbf[:len(pbf_cpu)] - pbf_cpu).max())
    print(f"bf16 tower in log2(count + 1) space, {p32.shape[0]} "
          f"neighborhoods x 29 queries: max |bf16 - f32| on the card "
          f"{d_bf:.4f} (mean {float(np.abs(pbf - p32).mean()):.4f}); max "
          f"|card bf16 - CPU bf16| {d_cpu:.4f} on the first "
          f"{len(pbf_cpu)} (CPU {time.perf_counter() - t0:.1f} s); bound "
          f"{BF16_LOG2_ATOL}", flush=True)
    check(d_bf <= BF16_LOG2_ATOL and d_cpu <= BF16_LOG2_ATOL,
          f"bf16 tower off by {max(d_bf, d_cpu):.3g} in log2 space "
          f"(bound {BF16_LOG2_ATOL})")
    del svc_bf, svc_gpu

    phase_done("3 (serving)")
    # --------------------------------------------------------- 4. daemon
    # (started here, collected after phase 5, which runs beside it)
    reqs = [
        {"id": 1, "graphs": [{"n": g.n_nodes, "edges": g.edges.tolist()}
                             for g in main_req[:3]]},
        {"id": 2, "graphs": [{"n": g.n_nodes, "edges": g.edges.tolist()}
                             for g in main_req[3:8]], "node_counts": True},
    ]
    stdin = "".join(json.dumps(r) + "\n" for r in reqs) + "quit\n"
    daemon_job = start_beside(
        [sys.executable, "-m", "desco_tpu_torch.serve",
         "--neigh_ckpt", R4_NEIGH, "--gossip_ckpt", R4_GOSSIP], stdin)
    # ------------------------------------------------------ 5. gradients
    tgt_cfg, qry_cfg = model_configs(tcfg, dev)
    check(tgt_cfg.agg_mode == "kernel" and (
        tgt_cfg.layer_num, tgt_cfg.hidden_dim, tgt_cfg.n_edge_types,
        len(tcfg.query_ids)) == (8, 64, 6, 29),
          "the training config is not at the paper width")
    qb = build_query_batch(tcfg)
    gen = torch.Generator().manual_seed(args.seed)
    neigh_params = neigh_mod.init_neighborhood_model(tgt_cfg, qry_cfg, gen)
    cs.reset_launches()
    t0 = time.perf_counter()
    worst = grad_errors(
        torch, lambda p, d: neigh_mod.train_loss(
            p, tgt_cfg, qry_cfg, tb0.to(d, training=True), qb.to(d)),
        neigh_params, "train_loss")
    grad_launches = cs.read_launches()
    check(grad_launches["typed_aggregate_bwd"] == 8,
          "train_loss's backward did not launch K3 once per layer")
    # the query batch is packed without a permutation: its backward
    # streams are derived on the card
    check(grad_launches["gather_segment_sum"] == 8
          and grad_launches["gather_segment_sum_bwd"] == 8,
          "the query tower did not run the gather-fused K1 forward and "
          "backward once per layer")
    print(f"gradients: train_loss through K1-K4 on CUDA vs the plain "
          f"versions on the CPU, {sum(p.numel() for p in neigh_params.parameters())} "
          f"parameters: max error {worst:.3g} of a tensor's scale "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with torch.no_grad():
        fresh_embs = neigh_mod.embed_queries(
            neigh_params.to(dev), qry_cfg, qb.to(dev)).cpu()
    neigh_params.to("cpu")
    fake_counts = (train_stage.truth[train_stage.nindex.indicator]
                   * np.random.default_rng(args.seed).uniform(
                       0.5, 1.5, (len(train_stage.samples), 1)))
    ggb = prepare_gossip_batches(tcfg, train_stage, fake_counts,
                                 need_bwd_perm=True)[0]
    gossip_params = gossip_mod.init_gossip_model(
        hidden_dim=tcfg.gossip_hidden_dim,
        emb_channels=tcfg.neigh_hidden_dim, generator=gen)
    cs.reset_launches()
    t0 = time.perf_counter()
    worst = grad_errors(
        torch, lambda p, d: gossip_mod.gossip_loss(
            p, ggb.to(d, training=True), fresh_embs.to(d)),
        gossip_params, "gossip_loss")
    grad_launches = cs.read_launches()
    print(f"gradients: gossip_loss (29 checkpointed queries) on CUDA vs "
          f"the CPU: max error {worst:.3g} of a tensor's scale "
          f"({time.perf_counter() - t0:.1f} s); launches "
          f"{json.dumps(grad_launches)}", flush=True)
    # per gossip loss: the degrees, then per query two layers forward and
    # again in the checkpoint's recomputation; the backward only behind
    # layer 1 (layer 0's input is detached); no K1 or K4 on this path
    check(grad_launches["gather_segment_sum"] == GOSSIP_FWD_PER_STEP
          and grad_launches["gather_segment_sum_bwd"] == GOSSIP_BWD_PER_STEP
          and grad_launches["sorted_segment_sum"] == 0
          and grad_launches["segment_sum_vjp"] == 0,
          f"gossip_loss launches {grad_launches}: expected the gather-fused "
          f"K1 {GOSSIP_FWD_PER_STEP} times forward and "
          f"{GOSSIP_BWD_PER_STEP} backward, K1 and K4 never")

    # same-seed reproducibility: two gossip train steps from the same
    # weights, batch and dropout seed
    ggb_dev, embs_dev = ggb.to(dev, training=True), fresh_embs.to(dev)
    step_grads = []
    for _ in range(2):
        p = copy.deepcopy(gossip_params).to(dev).requires_grad_(True)
        gossip_mod.gossip_loss(
            p, ggb_dev, embs_dev, dropout=0.01, train=True,
            generator=torch.Generator(device=dev).manual_seed(args.seed)
        ).backward()
        step_grads.append({n: q.grad for n, q in p.named_parameters()
                           if q.grad is not None})
    differ = [n for n, gr in step_grads[0].items()
              if not torch.equal(gr, step_grads[1][n])]
    gst = batch_typed_streams(ggb_dev, 2)
    gcot = torch.randn(2 * ggb_dev.n_cap, tcfg.gossip_hidden_dim,
                       device=dev)
    agg_equal = torch.equal(cs.gather_segment_sum_bwd(gcot, gst),
                            cs.gather_segment_sum_bwd(gcot, gst))
    n_equal = len(step_grads[0]) - len(differ)
    print(f"same-seed reproducibility: two gossip train steps give "
          f"bit-equal gradients: {not differ} ({n_equal} of "
          f"{len(step_grads[0])} tensors equal"
          f"{'; differ: ' + ', '.join(differ) if differ else ''}); the "
          f"aggregate's own dx over two runs bit-equal: {agg_equal}",
          flush=True)
    check(agg_equal, "the gather-fused backward gave two different dx")
    del ggb_dev, step_grads

    # the same for two neighborhood train steps (paper config: dropout 0)
    tb0_dev, qb_dev = tb0.to(dev, training=True), qb.to(dev)
    step_grads = []
    for _ in range(2):
        p = copy.deepcopy(neigh_params).to(dev).requires_grad_(True)
        neigh_mod.train_loss(
            p, tgt_cfg, qry_cfg, tb0_dev, qb_dev,
            generator=torch.Generator(device=dev).manual_seed(args.seed)
        ).backward()
        step_grads.append({n: q.grad for n, q in p.named_parameters()
                           if q.grad is not None})
    differ = [n for n, gr in step_grads[0].items()
              if not torch.equal(gr, step_grads[1][n])]
    print(f"same-seed reproducibility: two neighborhood train steps give "
          f"bit-equal gradients: {not differ} "
          f"({len(step_grads[0]) - len(differ)} of {len(step_grads[0])} "
          f"tensors equal{'; differ: ' + ', '.join(differ) if differ else ''})",
          flush=True)
    del tb0_dev, qb_dev, step_grads

    phase_done("5 (gradients; the daemon beside it)")
    # ------------------------------------------ 4. the daemon, collected
    daemon_out, _, daemon_s = collect(daemon_job, 600, "the daemon")
    replies = [json.loads(line) for line in daemon_out.splitlines()
               if line.strip()]
    check([r.get("id") for r in replies] == [1, 2],
          f"daemon replies {[r.get('id') for r in replies]}")
    for req, rep in zip(reqs, replies):
        check("error" not in rep, f"daemon error: {rep.get('error')}")
        got = np.asarray(rep["graphlet_counts"])
        n_g = len(req["graphs"])
        check(got.shape == (n_g, 29) and np.isfinite(got).all()
              and (got >= 0).all(), f"daemon reply {rep['id']} malformed")
        want = svc.count([Graph(g["n"], np.asarray(g["edges"], np.int32))
                          for g in req["graphs"]]).graphlet_counts
        check(np.all(np.abs(got - want) <= np.maximum(1.0, 1e-3 * want)),
              f"daemon reply {rep['id']} differs from the in-process "
              f"service")
    check(len(replies[1].get("node_counts", [])) ==
          sum(g["n"] for g in reqs[1]["graphs"]), "daemon node_counts")
    print(f"daemon: 2 requests answered in {daemon_s:.1f} s (process start "
          f"and model load included; phase 5 ran beside it)", flush=True)

    phase_done("4 (daemon)")
    # ------------------------------------------- 6. training, full width
    cs.reset_launches()
    n_b = len(train_stage.batches)
    logs = []

    def log(line):
        logs.append(line)
        print(f"  {line}", flush=True)

    t0 = time.perf_counter()
    res, tgt_cfg, qry_cfg = train_neighborhood_stage(
        tcfg, train_stage, train_stage, qb, log_fn=log, log_every=1,
        ckpt_path=os.path.join(workdir.name, "ck", "neigh"))
    neigh_s = time.perf_counter() - t0
    after_neigh = cs.read_launches()
    steps = tcfg.neigh_epochs * n_b
    check(np.isfinite(res.train_losses).all()
          and np.isfinite(res.val_losses).all(),
          f"neighborhood losses not finite: {res.train_losses}")
    check(res.train_losses[-1] < res.train_losses[0],
          f"neighborhood train loss did not fall: {res.train_losses}")
    check(after_neigh["typed_aggregate_bwd"] == 8 * steps,
          f"K3 launches {after_neigh['typed_aggregate_bwd']} != 8 x "
          f"{steps} neighborhood train steps")
    check(after_neigh["fused_typed_transform_aggregate"] == 8 * 2 * steps,
          f"K2 launches {after_neigh['fused_typed_transform_aggregate']} "
          f"!= 8 x ({steps} train steps + {steps} val batches)")
    check(after_neigh["segment_sum_vjp"] > 0 and
          after_neigh["sorted_segment_sum"] > 0,
          "K1 / K4 never launched in the neighborhood stage")
    # the query tower (8 layers) runs in every train step and val batch
    check(after_neigh["gather_segment_sum"] == 8 * 2 * steps
          and after_neigh["gather_segment_sum_bwd"] == 8 * steps,
          f"gather-fused K1 launches {after_neigh['gather_segment_sum']} / "
          f"{after_neigh['gather_segment_sum_bwd']} != 8 x (train steps + "
          f"val batches) / 8 x train steps")
    live_edges = int(sum((b.edge_type != 63).sum()
                         for b in train_stage.batches))
    neigh_step_ms = 1e3 * float(np.mean(res.train_times[1:])) / n_b
    print(f"neighborhood stage: {tcfg.neigh_epochs} epochs x {n_b} steps in "
          f"{neigh_s:.1f} s; train loss {res.train_losses[0]:.4f} -> "
          f"{res.train_losses[-1]:.4f}, best val {res.best_val:.4f}; "
          f"{neigh_step_ms:.2f} ms per train step (epochs after the "
          f"first), {live_edges / np.mean(res.train_times[1:]) / 1e6:.2f}M "
          f"live edges/s per epoch; launches {json.dumps(after_neigh)}",
          flush=True)

    best = res.best_params.requires_grad_(False).to(dev)
    with torch.inference_mode():
        q_embs = neigh_mod.embed_queries(best, qry_cfg, qb.to(dev))
    t0 = time.perf_counter()
    counts_train, _ = neighborhood_predictions(
        best, tgt_cfg, q_embs, train_stage, tcfg, dev)
    check(counts_train.shape == (len(train_stage.samples), 29)
          and np.isfinite(counts_train).all(),
          "stage-1 predictions of the training set malformed")
    print(f"stage-1 predictions of the training set (clamp + VF2 tail "
          f"verification): {time.perf_counter() - t0:.1f} s", flush=True)
    after_pred = cs.read_launches()
    check(after_pred["fused_typed_transform_aggregate"]
          == 8 * (2 * steps + n_b),
          "K2 launches != 8 x (train steps + val batches + predict batches)")
    gbatches = prepare_gossip_batches(tcfg, train_stage, counts_train,
                                      need_bwd_perm=True)
    n_gb = len(gbatches)
    t0 = time.perf_counter()
    gres, _ = train_gossip_stage(
        tcfg, best, tgt_cfg, qry_cfg, qb, gbatches, gbatches, log_fn=log,
        log_every=5, ckpt_path=os.path.join(workdir.name, "ck", "gossip"))
    gossip_s = time.perf_counter() - t0
    train_launches = cs.read_launches()
    check(np.isfinite(gres.train_losses).all()
          and np.isfinite(gres.val_losses).all(),
          f"gossip losses not finite: {gres.train_losses}")
    check(gres.train_losses[-1] < gres.train_losses[0],
          f"gossip train loss did not fall: {gres.train_losses}")
    # the gossip stage: the query tower once (no grad: its pooling is the
    # one K1), then per train step and val batch the gather-fused K1 only
    n_gval = int(np.isfinite(gres.val_losses).sum())
    g_steps = tcfg.gossip_epochs * n_gb
    want_fwd = 8 + g_steps * GOSSIP_FWD_PER_STEP \
        + n_gval * n_gb * GOSSIP_FWD_PER_EVAL
    stage = {name: train_launches[name] - after_pred[name]
             for name in train_launches}
    print(f"gossip-stage launches: {json.dumps(stage)}; expected the "
          f"gather-fused K1 8 + {g_steps} x {GOSSIP_FWD_PER_STEP} + "
          f"{n_gval * n_gb} x {GOSSIP_FWD_PER_EVAL} = {want_fwd} forward, "
          f"{g_steps} x {GOSSIP_BWD_PER_STEP} backward", flush=True)
    check(stage["segment_sum_vjp"] == 0 and stage["sorted_segment_sum"] == 1,
          "the gossip path launched K1 or K4 (only the query tower's "
          "pooling may)")
    check(stage["gather_segment_sum"] == want_fwd
          and stage["gather_segment_sum_bwd"]
          == g_steps * GOSSIP_BWD_PER_STEP,
          "gather-fused K1 launches in the gossip stage off their count")
    check(train_launches["typed_aggregate_bwd"] == 8 * steps and
          train_launches["fused_typed_transform_aggregate"]
          == 8 * (2 * steps + n_b),
          "the gossip stage launched K2 or K3")
    g_edges = int(sum((b.edge_type != 63).sum() for b in gbatches))
    gossip_step_ms = 1e3 * float(np.mean(gres.train_times[1:])) / n_gb
    print(f"gossip stage: {tcfg.gossip_epochs} epochs x {n_gb} steps (n_cap "
          f"{gbatches[0].n_cap}, e_cap {gbatches[0].e_cap}) in "
          f"{gossip_s:.1f} s; train loss {gres.train_losses[0]:.1f} -> "
          f"{gres.train_losses[-1]:.1f}, best val {gres.best_val:.4f}; "
          f"{gossip_step_ms:.2f} ms per train step (epochs after the "
          f"first), {g_edges / np.mean(gres.train_times[1:]) / 1e6:.3f}M "
          f"live edges/s per epoch", flush=True)
    print(f"training-path launches: {json.dumps(train_launches)}; K3 = 8 x "
          f"{steps} train steps, K2 = 8 x ({steps} train steps + {steps} "
          f"val batches + {n_b} predict batches)", flush=True)
    for kern in cs.KERNELS:
        # GAT's pairs run on the ablation and halo paths only
        check(train_launches[kern.__name__] > 0 or kern.__name__ in
              ("sorted_segment_sum_pair", "segment_sum_vjp_pair"),
              f"kernel {kern.__name__} never launched on the training path")
        check(train_launches[kern.__name__ + "_bf16"] == 0,
              f"kernel {kern.__name__}: bf16 launches on the f32 training "
              f"path")

    # the neighborhood stage again, on the bf16 target tower
    bcfg = dataclasses.replace(tcfg, train_bf16=True)
    bf_ckpt = os.path.join(workdir.name, "ck", "neigh_bf16")
    cs.reset_launches()
    t0 = time.perf_counter()
    bres, b_tgt_cfg, _ = train_neighborhood_stage(
        bcfg, train_stage, train_stage, qb, log_fn=log, log_every=1,
        ckpt_path=bf_ckpt)
    bf_train_s = time.perf_counter() - t0
    bf_launches = cs.read_launches()
    steps_bf = bcfg.neigh_epochs * n_b
    print(f"train_bf16 launches: {json.dumps(bf_launches)}; expected K3 = "
          f"8 x {steps_bf} train steps on bf16 rows, K2 = 8 x ({steps_bf} "
          f"bf16 train steps + {steps_bf} f32 val batches)", flush=True)
    check(np.isfinite(bres.train_losses).all()
          and np.isfinite(bres.val_losses).all(),
          f"train_bf16 losses not finite: {bres.train_losses}")
    check(bres.train_losses[-1] < bres.train_losses[0],
          f"train_bf16 loss did not fall: {bres.train_losses}")
    check(bf_launches["typed_aggregate_bwd"] == 8 * steps_bf
          and bf_launches["typed_aggregate_bwd_bf16"] == 8 * steps_bf,
          "train_bf16: K3 launches != 8 x train steps on bf16 rows")
    check(bf_launches["fused_typed_transform_aggregate_bf16"] == 8 * steps_bf
          and bf_launches["fused_typed_transform_aggregate"]
          == 8 * 2 * steps_bf,
          "train_bf16: K2 != 8 x train steps on bf16 rows + 8 x val batches "
          "on f32 rows (validation runs the f32 tower)")
    check(bf_launches["sorted_segment_sum_bf16"] == steps_bf
          and bf_launches["segment_sum_vjp_bf16"] == steps_bf,
          "train_bf16: the bf16 tower's pooling did not run K1 and K4 on "
          "bf16 rows once per train step")
    check(b_tgt_cfg.dtype == torch.float32,
          "train_bf16: the returned target config is not f32")
    check(all(p.dtype == torch.float32 for p in bres.best_params.parameters()),
          "train_bf16: the master parameters are not f32")
    saved = np.load(bf_ckpt + ".best.params.npz")
    check(all(saved[k].dtype == np.float32 for k in saved.files),
          "train_bf16: the saved checkpoint is not f32")
    load_checkpoint(bf_ckpt + ".best")
    bf_step_ms = 1e3 * float(np.mean(bres.train_times[1:])) / n_b
    print(f"train_bf16 neighborhood stage: {bcfg.neigh_epochs} epochs x "
          f"{n_b} steps in {bf_train_s:.1f} s; train loss "
          f"{bres.train_losses[0]:.4f} -> {bres.train_losses[-1]:.4f}, best "
          f"val (f32 tower) {bres.best_val:.4f}; {bf_step_ms:.2f} ms per "
          f"train step (epochs after the first)", flush=True)

    phase_done("6 (training)")
    # --------------------------------------------------- 7. entry point
    # (started here, collected after phase 8, which runs beside it)
    cli_dir = os.path.join(workdir.name, "cli")
    cmd = [sys.executable, "-m", "desco_tpu_torch.main", "--train_neigh",
           "--train_gossip", "--test_gossip",
           "--train_dataset", "SynNp_24", "--valid_dataset", "SynNp_24",
           "--test_dataset", "SynNp_8_1", "--neigh_epoch_num", "2",
           "--gossip_epoch_num", "2", "--seed", str(args.seed),
           "--data_root", os.path.join(cli_dir, "data"),
           "--output_dir", os.path.join(cli_dir, "out"),
           "--neigh_model_path", os.path.join(cli_dir, "neigh"),
           "--gossip_model_path", os.path.join(cli_dir, "gossip")]
    cli_job = start_beside(cmd)

    # ------------------------------------- 8. datasets and the r4 replay
    from desco_tpu_torch import gen_dataset as gen_mod
    from desco_tpu_torch import main as main_mod
    from desco_tpu_torch.data.datasets import fingerprint

    data_dir = tempfile.TemporaryDirectory(prefix="desco_smoke_data_")
    gen_root = os.path.join(data_dir.name, "data")
    gen_s = {}
    for name, want in DATASETS.items():
        t0 = time.perf_counter()
        graphs = load_data(name, gen_root)
        gen_s[name] = time.perf_counter() - t0
        got = (len(graphs), sum(g.n_nodes for g in graphs),
               sum(g.n_edges for g in graphs), fingerprint(graphs))
        check(got == want, f"dataset {name}: (graphs, nodes, edges, "
              f"fingerprint) {got} != desco_tpu's {want}")
    print(f"datasets without networkx: {len(DATASETS)} equal desco_tpu's "
          f"(counts and fingerprints); seconds to make "
          f"{json.dumps({k: round(v, 2) for k, v in gen_s.items()})} "
          f"(Syn_1827_test reads the Syn_1827 cache)", flush=True)

    # a fresh data root: truth and sample cache by gen_dataset, then the
    # replay of release/r4 through main(), both in this process
    replay_root = os.path.join(data_dir.name, "replay")
    t0 = time.perf_counter()
    rc, gen_out = run_teed(gen_mod.main, [
        "--dataset", REPLAY_SET, "--depth", "4", "--data_root", replay_root])
    replay_gen_s = time.perf_counter() - t0
    check(rc == 0, f"gen_dataset {REPLAY_SET} returned {rc}")
    truth_line = [ln for ln in gen_out.splitlines()
                  if ln.startswith("ground truth")]
    check(len(truth_line) == 1, "gen_dataset printed no truth line")
    replay_out_dir = os.path.join(data_dir.name, "replay_out")
    cs.reset_launches()
    t0 = time.perf_counter()
    rc, replay_out = run_teed(main_mod.main, [
        "--test_gossip", "--neigh_checkpoint", R4_NEIGH,
        "--gossip_checkpoint", R4_GOSSIP, "--test_dataset", REPLAY_SET,
        "--data_root", replay_root, "--output_dir", replay_out_dir])
    replay_s = time.perf_counter() - t0
    replay_launches = cs.read_launches()
    check(rc == 0, f"the replay's main() returned {rc}")
    check("(device cuda)" in replay_out, "the replay did not run on CUDA")
    n_tb = n_gb_r = None
    for line in replay_out.splitlines():
        if line.startswith(f"{REPLAY_SET}: ") and "target batches" in line:
            n_tb = int(line.split(" in ")[-1].split()[0])
        if line.startswith(f"{REPLAY_SET}: ") and "gossip batches" in line:
            n_gb_r = int(line.split(": ")[1].split()[0])
    check(n_tb and n_gb_r, "the replay printed no batch counts")
    metrics = {}
    with open(os.path.join(replay_out_dir,
                           f"analyze_results_{REPLAY_SET}.txt")) as f:
        for line in f:
            key, val = line.split(": ", 1)
            metrics[key] = json.loads(val)
    worst_rel = 0.0
    for stage_name, want in REPLAY_CPU_MSE.items():
        got = metrics[f"graphlet_norm_mse_{stage_name}"]
        check(len(got) == 3 and all(np.isfinite(got)),
              f"replay {stage_name} normed MSE malformed: {got}")
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        worst_rel = max(worst_rel, *rel)
        check(max(rel) <= REPLAY_RTOL,
              f"replay {stage_name} normed MSE {got} differs from "
              f"desco_tpu's CPU figures {want} by {max(rel):.3g} (rtol "
              f"{REPLAY_RTOL})")
    ref = np.load(REPLAY_CPU_COUNTS)
    worst_count = {}
    for stem, key in (("graphlet_truth", "truth"),
                      ("neighborhood_graphlet", "neighborhood"),
                      ("gossip_graphlet", "gossip"),
                      ("graphlet_count", "gossip")):
        got = np.loadtxt(os.path.join(
            replay_out_dir, f"{stem}_{REPLAY_SET}.csv"), delimiter=",",
            skiprows=1, ndmin=2)[:, 1:]
        want = ref[key]
        check(got.shape == want.shape == (354, 29)
              and np.isfinite(got).all() and (got >= 0).all(),
              f"replay {stem} malformed: {got.shape}")
        diff = np.abs(got - want)
        if key == "truth":
            check(not diff.any(), f"replay truth differs from desco_tpu's "
                  f"in {int((diff > 0).sum())} entries")
            continue
        excess = diff - (1 + REPLAY_COUNT_RTOL * np.abs(want))
        worst_count[stem] = [int(diff.max()), int((diff > 0).sum())]
        check((excess <= 0).all(),
              f"replay {stem}: {int((excess > 0).sum())} per-graph counts "
              f"differ from desco_tpu's CPU counts by more than 1 + "
              f"{REPLAY_COUNT_RTOL} x count (worst {diff.max():.0f} at "
              f"{want.flat[int(np.argmax(excess))]:.0f})")
    # what serving launches for the same batches, plus the query tower
    # that main() embeds once (8 gather-fused K1 and one pooling K1)
    want_l = {"fused_typed_transform_aggregate": 8 * n_tb,
              "sorted_segment_sum": n_tb + 1,
              "gather_segment_sum": 8 + GOSSIP_FWD_PER_EVAL * n_gb_r,
              "typed_aggregate_bwd": 0, "segment_sum_vjp": 0,
              "gather_segment_sum_bwd": 0}
    print(f"replay launches: {json.dumps(replay_launches)}; expected "
          f"{json.dumps(want_l)} ({n_tb} target batches, {n_gb_r} gossip "
          f"batches), no bf16", flush=True)
    for name, n in want_l.items():
        check(replay_launches[name] == n,
              f"replay: {name} launched {replay_launches[name]} times, "
              f"serving's count for these batches is {n}")
    check(all(replay_launches[k.__name__ + "_bf16"] == 0
              for k in cs.KERNELS), "bf16 launches in the f32 replay")
    print(f"replay of release/r4 on {REPLAY_SET}: normed MSE neighborhood "
          f"{metrics['graphlet_norm_mse_neighborhood']}, gossip "
          f"{metrics['graphlet_norm_mse_gossip']}: within "
          f"{worst_rel:.3g} of desco_tpu's CPU figures (rtol "
          f"{REPLAY_RTOL}); per-graph truth equal, counts within 1 + "
          f"{REPLAY_COUNT_RTOL} x count (largest difference, entries "
          f"that differ: {json.dumps(worst_count)}); gen_dataset {replay_gen_s:.1f} s "
          f"({truth_line[0]}); main() {replay_s:.1f} s: load + stage "
          f"{timing_of(replay_out, 'load+truth+stage')} s, stage-1 "
          f"predict + verify "
          f"{timing_of(replay_out, 'stage-1 predict+verify')} s, gossip "
          f"predict {timing_of(replay_out, 'gossip predict')} s", flush=True)

    phase_done("8 (datasets, replay; the entry point beside it)")
    # ------------------------------------- 7. the entry point, collected
    cli_out, _, cli_s = collect(cli_job, 900,
                                "python -m desco_tpu_torch.main")
    metric_lines = [ln for ln in cli_out.splitlines()
                    if ln.startswith("graphlet_")]
    check(len(metric_lines) == 4 and "done" in cli_out,
          f"entry point printed no metrics: {cli_out[-2000:]}")
    check("(device cuda)" in cli_out,
          "the entry point did not default to the CUDA device")
    for stem in ("neigh", "gossip"):
        check(os.path.exists(os.path.join(
            cli_dir, stem + ".best.params.npz")),
            f"entry point wrote no {stem}.best checkpoint")
    print(f"entry point: python -m desco_tpu_torch.main trained and "
          f"evaluated in {cli_s:.1f} s (process start and kernel load "
          f"included; phase 8 ran beside it); {metric_lines[-2]}",
          flush=True)
    svc_new = CountingService(os.path.join(cli_dir, "neigh.best"),
                              os.path.join(cli_dir, "gossip.best"),
                              device="cuda")
    check(svc_new.tgt_cfg.agg_mode == "kernel"
          and svc_new.cfg.neigh_hidden_dim == 64,
          "the service did not rehydrate the trained config")
    check_counts(svc_new.count(main_req[:16]), 16,
                 "request served from the trained checkpoints")
    print("service: one 16-graph request served on the card from the two "
          "checkpoints the entry point wrote", flush=True)
    # phase 10's second ensemble member: this checkpoint of r4's config
    keep_dir = tempfile.TemporaryDirectory(prefix="desco_smoke_keep_")
    for ext in (".params.npz", ".json"):
        shutil.copy(os.path.join(cli_dir, "neigh.best" + ext), keep_dir.name)
    second_member = os.path.join(keep_dir.name, "neigh.best")
    workdir.cleanup()

    phase_done("7 (entry point)")
    # ---------------------------------------------------- 9. ablations
    abl = ablation_phase(torch, cs, probe, dev, args.seed, gen_root,
                         replay_root, data_dir.name, main_stage.batches[0])
    t33_rows, t33_serving = abl["t33_rows"], abl["t33_serving"]
    site_rows = abl["site_rows"]
    abl_launches, o4_launches = abl["abl_launches"], abl["o4_launches"]

    phase_done("9 (ablations)")
    # ------------------------------------------- 10. the rest of serving
    rest = serving_rest_phase(torch, cs, probe, dev, args.seed, gen_root,
                              replay_root, data_dir.name, svc,
                              main_req[:32], second_member,
                              main_stage.batches[0])
    keep_dir.cleanup()

    phase_done("10 (the rest of serving)")
    # ----------------------------------------------- 11. bench and probe
    bench_keys = ("metric", "value", "unit", "vs_baseline", "graphs_per_s",
                  "bytes_per_edge_layer", "sol_fraction", "hbm_gbps_assumed",
                  "train_edges_per_s", "train_step_ms", "dtype", "device",
                  "launches")
    bench = {}
    for dt_name in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "desco_tpu_torch.bench", "--dtype",
             dt_name], capture_output=True, text=True, timeout=600, cwd=REPO)
        check(proc.returncode == 0, f"python -m desco_tpu_torch.bench --dtype "
              f"{dt_name} exited {proc.returncode}: {proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        check(len(lines) == 1, f"bench printed {len(lines)} lines, not one")
        line = json.loads(lines[0])
        check(all(k in line for k in bench_keys),
              f"bench line lacks {[k for k in bench_keys if k not in line]}")
        check(line["metric"] ==
              "shmp_neighborhood_forward_edges_per_s_per_chip"
              and line["dtype"] == dt_name and line["value"] > 0
              and line["hbm_gbps_assumed"] == 3350.0
              and line["device"] == card,
              f"bench line malformed: {lines[0]}")
        check(line["launches"]["fused_typed_transform_aggregate"] == 8,
              f"bench: K2 launches per forward "
              f"{line['launches']['fused_typed_transform_aggregate']} != 8")
        check(0 < line["sol_fraction"] <= 1.05,
              f"bench: sol_fraction {line['sol_fraction']} outside (0, 1.05]")
        bench[dt_name] = line
        print(f"bench --dtype {dt_name} ({time.perf_counter() - t0:.1f} s "
              f"with process start): {lines[0]}", flush=True)

    for fn in probe.VARIANTS.values():
        fn.launches = 0
    probe_row = probe.probe_series(
        dev, 128, args.seed, log=lambda line: print(f"  {line}", flush=True))
    probe_launches = {name: fn.launches
                      for name, fn in probe.VARIANTS.items()}
    print(f"probe launches: {json.dumps(probe_launches)}", flush=True)
    for name, n in probe_launches.items():
        check(n > 0, f"probe variant {name} never launched in its series")

    phase_done("11 (bench, probe)")
    # ------------------------------------------------------- 13. halo
    hal = halo_phase(torch, cs, probe, dev, args.seed, svc)

    phase_done("13 (halo)")
    # -------------------------------------------- 14. data parallelism
    svc._neigh_buckets, svc._gossip_buckets = (dict(b) for b in
                                               phase3_buckets)
    dpr = dp_phase(torch, cs, dev, args.seed, svc, main_req, res_main,
                   main_stage, train_stage, tcfg, qb, gbatches, best,
                   tgt_cfg, qry_cfg)

    phase_done("14 (data parallelism)")
    # ------------------------------------------------------- 15. tools
    tools = tools_phase(torch, cs, card, gen_root, replay_root)

    phase_done("15 (tools)")
    # phase 18 (b)'s torchrun main, started here to run beside phase 16
    torchrun_dir = tempfile.TemporaryDirectory(prefix="desco_smoke_trun_")
    torchrun_job = start_beside([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(DIST_WORLD), "-m", "desco_tpu_torch.main",
        "--n_devices", str(DIST_WORLD), "--train_neigh", "--train_gossip",
        "--test_gossip", *DIST_MAIN_FLAGS,
        "--data_root", os.path.join(torchrun_dir.name, "data"),
        "--output_dir", os.path.join(torchrun_dir.name, "out"),
        "--neigh_model_path", os.path.join(torchrun_dir.name, "ck", "neigh"),
        "--gossip_model_path", os.path.join(torchrun_dir.name, "ck",
                                            "gossip")])
    # ---------------------------------------------- 16. compiled steps
    with tempfile.TemporaryDirectory(prefix="desco_smoke_g16_") as g16_dir:
        graphed_phase(torch, cs, dev, tcfg, train_stage, qb, gbatches,
                      gres.best_params, q_embs, hal.pop("train_shards"),
                      dpr.pop("grid"), g16_dir)

    phase_done("16 (compiled steps)")
    # -------------------------------------------- 17. compiled serving
    compiled = compiled_serving_phase(
        torch, cs, dev, args.seed, svc, main_req, res_main, main_stage,
        phase3_buckets, gen_root, replay_root, data_dir.name)
    print(f"compiled serving summary: {json.dumps(compiled)}", flush=True)
    data_dir.cleanup()

    phase_done("17 (compiled serving)")
    # ------------------------- 18. data parallelism across processes
    dist = dist_phase(torch, cs, dev, args.seed, tcfg, qb, train_stage,
                      gbatches, best, gres.best_params, q_embs,
                      dpr.pop("grid_parts"), dpr.pop("grid_specs"),
                      svc.gossip_params, svc.member_embs[0], svc.tgt_cfg,
                      svc.members[0]["target"], torchrun_job,
                      torchrun_dir.name)
    torchrun_dir.cleanup()

    phase_done("18 (across processes)")
    # ----------------------------------------------------- 12. the record
    seg_src = "desco_tpu_torch/csrc/segment_sum.cu"
    typed_src = "desco_tpu_torch/csrc/typed_aggregate.cu"
    wrappers = {"k1": ("sorted_segment_sum", 310, seg_src),
                "k2": ("fused_typed_transform_aggregate", 476, typed_src),
                "k3": ("typed_aggregate_bwd", 559, typed_src),
                "k4": ("segment_sum_vjp", 448, seg_src)}
    kernels = []
    serving_rest = rest["serving_launches"]
    for key, (wrapper, line_no, src_file) in wrappers.items():
        for d, suffix, paths in (
                ("f32", "", (launches, train_launches, launches_bf,
                             bf_launches, replay_launches, abl_launches,
                             serving_rest, hal["launches"],
                             dpr["launches"], dist["launches"],
                             tools["launches"])),
                ("bf16", "_bf16", (launches_bf, bf_launches,
                                   tools["launches"]))):
            # f32 rows: every launch of the eleven paths (serving,
            # training, their bf16 runs, the r4 replay, the ablations
            # but the order-4 run, labeled serving and the ensembles, the
            # halo path, data parallelism in one process and across
            # processes (both ranks), the tools) that was not on bf16
            # rows; bf16 rows: the bf16 launches of the bf16 paths and of
            # the tools (none: they run the f32 tower)
            if d == "f32":
                per_path = [p[wrapper] - p[wrapper + "_bf16"] for p in paths]
            else:
                per_path = [p[wrapper + "_bf16"] for p in paths]
            kernels.append(dict(
                name=f"{wrapper} (K{key[1]}, {d})", route="cuda",
                source=src_file,
                replaces=f"desco_tpu/ops/pallas_segment.py:{line_no}",
                launches=sum(per_path), launches_per_path=per_path,
                **k_rows[key, d]))
            if d == "f32" and key in ("k1", "k4"):
                # the GAT / PNA use sites, measured in phase 9, and the
                # halo ones, in phase 13 (K4 has no one-column use left)
                ks = (64, 1) if key == "k1" else (64,)
                kernels[-1]["gat_pna_sites"] = {
                    f"K={k}": site_rows[key, k] for k in ks}
                kernels[-1]["halo_sites"] = {
                    f"K={k}": hal["sites"][key, k] for k in ks}
            check(sum(per_path) > 0,
                  f"kernel {wrapper} ({d}) never launched on a main path")
    # GAT's pairs: num and den in one K1 launch, their cotangents in one
    # K4 launch, on the f32 paths that run GAT (the ablations and the
    # halo path), measured at the packed site (phase 9) and the halo
    # site (phase 13)
    for key, wrapper, line_no in (("k1_pair", "sorted_segment_sum_pair",
                                   310),
                                  ("k4_pair", "segment_sum_vjp_pair", 464)):
        paths = (launches, train_launches, launches_bf, bf_launches,
                 replay_launches, abl_launches, serving_rest,
                 hal["launches"], dpr["launches"], dist["launches"],
                 tools["launches"])
        per_path = [p[wrapper] - p[wrapper + "_bf16"] for p in paths]
        check(sum(per_path) > 0,
              f"kernel {wrapper} never launched on a main path")
        kernels.append(dict(
            name=f"{wrapper} (K{key[1]} on an operand pair, GAT, f32)",
            route="cuda", source=seg_src,
            replaces=f"desco_tpu/ops/pallas_segment.py:{line_no}",
            launches=sum(per_path), launches_per_path=per_path,
            **site_rows[key], halo_site=hal["sites"][key]))
    # the gather-fused K1 and its backward: every main path runs them on
    # f32 rows (the query tower and the gossip model are f32; the bf16
    # tower aggregates through K2); the bf16 instantiation is checked and
    # timed in phase 2 and reported beside the f32 one
    paths = (launches, train_launches, launches_bf, bf_launches,
             replay_launches, abl_launches, serving_rest,
             rest["driver_launches"], hal["launches"], dpr["launches"],
             dist["launches"], tools["launches"])
    for key, wrapper, line_no in (("k1g", "gather_segment_sum", 310),
                                  ("k1g_bwd", "gather_segment_sum_bwd", 464)):
        per_path = [p[wrapper] - p[wrapper + "_bf16"] for p in paths]
        check(sum(per_path) > 0 and all(p[wrapper + "_bf16"] == 0
                                        for p in paths),
              f"kernel {wrapper} did not run on f32 rows only on the main "
              f"paths")
        kernels.append(dict(
            name=f"{wrapper} (K1', gather-fused "
                 f"{'backward' if key.endswith('bwd') else 'forward'}, f32)",
            route="cuda", source=seg_src,
            replaces=f"desco_tpu/ops/pallas_segment.py:{line_no}",
            launches=sum(per_path), launches_per_path=per_path,
            **k_rows[key, "f32"],
            bf16_rows={"launches": 0, **k_rows[key, "bf16"]},
            # the halo streams of the gossip partition, measured in
            # phase 13 (forward or backward)
            halo_sites={site: hal["sites"][site][
                "bwd" if key.endswith("bwd") else "fwd"]
                for site in ("k1g_interior", "k1g_boundary", "k1g_send",
                             "k1g_degrees")},
            # the serving gossip batch's degrees, one column, phase 2
            serving_degrees=k_rows["k1g_degrees"][
                "bwd" if key.endswith("bwd") else "fwd"]))
    # K2' and K3' at T = 33 (type chunks): launched by the order-4 run,
    # measured at its packed batch and at the serving batch's shape; the
    # bf16 instantiation is checked and timed in phase 9
    for key, wrapper, line_no in (("k2", "fused_typed_transform_aggregate",
                                   476),
                                  ("k3", "typed_aggregate_bwd", 559)):
        n = o4_launches[wrapper]
        check(n > 0, f"kernel {wrapper} never launched at T = 33")
        kernels.append(dict(
            name=f"{wrapper} (K{key[1]}', f32, T = 33 in type chunks)",
            route="cuda", source=typed_src,
            replaces=f"desco_tpu/ops/pallas_segment.py:{line_no}",
            # the tools run T = 6 only: their entry is 0
            launches=n, launches_per_path=[n, 0], **t33_rows[key, "f32"],
            bf16_rows={"launches": 0, **t33_rows[key, "bf16"]},
            at_serving_shape={d: t33_serving[key, d]
                              for d in ("f32", "bf16")}))
    # K2' and K3' at one edge type: launched by the DIAMNet graph tower
    # (the baseline driver), measured at its batch and at the serving
    # batch's shape
    for key, wrapper, line_no in (("k2", "fused_typed_transform_aggregate",
                                   476),
                                  ("k3", "typed_aggregate_bwd", 559)):
        n = rest["driver_launches"][wrapper]
        check(n > 0 and rest["driver_launches"][wrapper + "_bf16"] == 0,
              f"kernel {wrapper} never launched at T = 1")
        kernels.append(dict(
            name=f"{wrapper} (K{key[1]}', f32, T = 1, DIAMNet graph tower)",
            route="cuda", source=typed_src,
            replaces=f"desco_tpu/ops/pallas_segment.py:{line_no}",
            launches=n, launches_per_path=[n, 0],
            **rest["t1_rows"][key, "f32"],
            bf16_rows={"launches": 0, **rest["t1_rows"][key, "bf16"]},
            at_serving_shape={d: rest["t1_serving"][key, d]
                              for d in ("f32", "bf16")}))
    for name, r in probe_row["variants"].items():
        kernels.append(dict(
            name=f"probe_{name} (K5)", route="cuda",
            source="desco_tpu_torch/csrc/segment_sum_probe.cu",
            replaces="analysis/segsum_inner_ablation.py:178",
            launches=probe_launches[name],
            launches_per_path=[probe_launches[name], 0],
            max_abs_err=k5_rows[name]["max_abs_err"],
            ms=r["cold_us"] / 1e3, hot_ms=r["hot_us"] / 1e3,
            plain_ms=k5_rows[name]["plain_ms"],
            bound_ms=r["bound_us"] / 1e3, bound_by="bytes",
            library_ms=None))
    print(f"training summary: truth {truth_s:.2f} s "
          f"({truth_s / n_train_nodes * 1e3:.3f} s per 1000 nodes), "
          f"{neigh_step_ms:.2f} ms per neighborhood train step, "
          f"{gossip_step_ms:.2f} ms per gossip train step", flush=True)
    phase_done("12 (the record)")
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}; "
          f"the run took {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
